"""The weights of a run, made by the benchmark from the seed.

Every dense layer of the configured Point-GNN, in a fixed order, with
glorot-uniform weights (the model's own init draws the same
distribution) and uniform biases, drawn on the device in a few large
calls and handed to the program (through ``core/adapter.py``) and to the
reference alike.  The draw is one model per configuration
(``BASE_SEED``), each entry scaled by ``1 +- JITTER`` drawn from the
run's seed: every seed runs other weights, while where the model puts
its hypotheses, which sets the host NMS's work, stays that one model's.

With random weights the class probabilities are nearly uniform (their
logits spread by ~0.05 across vertices, and by up to ~0.6 between
classes, depending on the draw), so whether a foreground class clears
the hypothesis threshold 1 / num_classes, and how the hypotheses split
between classes, would depend on the seed.  :func:`calibrate_classes`
sets the class head's output biases so that, over one frame, the
foreground classes' mean logit lies ``FG_LOGIT_BIAS`` above the other
classes' and all foreground classes have the same mean: every seed
fills the hypothesis cap, as the model's own init at seed 0 happens to,
with the classes evenly split, and the host NMS works at that cap.
"""

import math

import torch

# the recipe, the same for every configuration: the one draw's seed, the
# biases' range, the seed's relative jitter of each entry, and how far
# the foreground classes' mean logit lies above the others'
BASE_SEED = 1
BIAS_LIMIT = 0.05
JITTER = 0.01
FG_LOGIT_BIAS = 1.5

PREDICTOR_WIDTHS = {"classaware_predictor": ((64,), (64, 64))}


def layer_table(config, input_dim):
    """``[(path, din, dout, is_last_of_mlp), ...]`` for every dense layer,
    ``path = (scope, mlp, index)`` (``mlp = ("loc", c)`` for class
    ``c``'s box head)."""
    rows = []

    def mlp(scope, name, din, widths):
        dims = [din] + list(widths)
        for i in range(len(widths)):
            rows.append(((scope, name, i), dims[i], dims[i + 1]))

    dim = input_dim
    layers = config["model_kwargs"]["layer_configs"]
    for cfg in layers[:-1]:
        kw = cfg["kwargs"]
        if cfg["type"] == "scatter_max_point_set_pooling":
            mlp(cfg["scope"], "point_mlp", dim + 3, kw["point_MLP_depth_list"])
            mlp(cfg["scope"], "output_mlp", kw["point_MLP_depth_list"][-1],
                kw["output_MLP_depth_list"])
            dim = kw["output_MLP_depth_list"][-1]
        elif cfg["type"] == "scatter_max_graph_auto_center_net":
            mlp(cfg["scope"], "edge_mlp", dim + 3, kw["edge_MLP_depth_list"])
            mlp(cfg["scope"], "update_mlp", kw["edge_MLP_depth_list"][-1],
                kw["update_MLP_depth_list"])
            if kw.get("auto_offset"):
                mlp(cfg["scope"], "auto_offset_mlp", dim,
                    kw["auto_offset_MLP_depth_list"])
            dim = kw["update_MLP_depth_list"][-1]
        else:
            raise ValueError("unknown layer type %r" % cfg["type"])
    pred = layers[-1]
    cls_ks, loc_ks = PREDICTOR_WIDTHS[pred["type"]]
    nc = config["num_classes"]
    mlp(pred["scope"], "cls", dim, list(cls_ks) + [nc])
    for c in range(nc):
        mlp(pred["scope"], ("loc", c), dim, list(loc_ks) + [7])
    return rows


def _uniform(n, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return torch.rand(n, generator=gen, device=device) * 2.0 - 1.0


def make_weights(config, input_dim, base_seed, seed, device, bias_limit,
                 jitter):
    """``{path: (w [din, dout], b [dout])}`` float32 on ``device``: one
    draw from ``base_seed``, each entry scaled by ``1 + jitter * u`` with
    ``u`` uniform in [-1, 1] drawn from ``seed``."""
    rows = layer_table(config, input_dim)
    n_w = sum(din * dout for _, din, dout in rows)
    n_b = sum(dout for _, _, dout in rows)
    uw = _uniform(n_w, 2 * base_seed, device)
    ub = _uniform(n_b, 2 * base_seed + 1, device)
    uw *= 1.0 + jitter * _uniform(n_w, 2 * seed, device)
    ub *= 1.0 + jitter * _uniform(n_b, 2 * seed + 1, device)
    out, ow, ob = {}, 0, 0
    for path, din, dout in rows:
        limit = math.sqrt(6.0 / (din + dout))
        w = (uw[ow:ow + din * dout] * limit).reshape(din, dout)
        b = ub[ob:ob + dout] * bias_limit
        out[path] = (w.contiguous(), b.contiguous())
        ow += din * dout
        ob += dout
    return out


def calibrate_classes(weights, config, mean_logits, fg_logit_bias):
    """Shift the class head's output biases in place: ``mean_logits``
    ``[C]`` are the classes' mean logits over a frame's vertices (any
    common offset); afterwards the foreground classes' means lie
    ``fg_logit_bias`` above the mean of the other classes'."""
    pred = config["model_kwargs"]["layer_configs"][-1]["scope"]
    last = max(i for (scope, name, i) in weights
               if scope == pred and name == "cls")
    nc = config["num_classes"]
    m = torch.as_tensor(mean_logits, dtype=torch.float32)
    fg = torch.zeros(nc, dtype=torch.bool)
    fg[1:nc - 1] = True
    target = torch.where(fg, torch.tensor(float(fg_logit_bias)),
                         torch.tensor(0.0))
    shift = target - (m - m[~fg].mean())
    b = weights[(pred, "cls", last)][1]
    b += shift.to(b.device)
