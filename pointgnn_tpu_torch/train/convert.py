"""Reference (TF1/slim) checkpoint -> the port's parameter tree (copy of
:mod:`pointgnn_tpu.train.convert`, the same name map).

The reference trains with TF 1.15 slim layers; its checkpoints store
variables named by the nesting of ``tf.variable_scope`` calls:

- each layer config wraps its variables in ``layer_config['scope']``;
- PointSetPooling builds the point MLP under ``extract_vertex_features``
  and the output MLP under ``combined_features``;
- GraphNetAutoCenter builds the auto-offset MLP directly in the layer
  scope, the edge MLP under ``extract_vertex_features`` and the update
  MLP under ``combined_features``;
- predictors nest ``predictor/cls`` and ``predictor/loc/cls_<i>``;
- within one scope, slim names consecutive dense layers
  ``fully_connected``, ``fully_connected_1``, ... with variables
  ``weights`` [in, out] and ``biases`` [out], the orientation of the
  port's ``{"w", "b"}`` dense params, so no transposes are needed.

TF is not a dependency: the converter consumes a plain ``.npz`` mapping
variable names to arrays.  Dump one from a reference checkpoint on any
machine with TF installed::

    import numpy as np, tensorflow as tf
    r = tf.train.NewCheckpointReader("checkpoints/car_auto_T3_train/model-1400000")
    np.savez("car_T3.npz", **{k: r.get_tensor(k)
                              for k in r.get_variable_to_shape_map()})

then convert with ``tools_torch/convert_reference_checkpoint.py``.

All five normalization variants convert:

- ``NONE``: ``weights``/``biases`` per dense layer.
- BN family (``fused_BN_center``/``BN_center``/``BN``): slim drops the
  dense biases on normalized layers and stores
  ``<fc>/BatchNorm/{beta, moving_mean, moving_variance}`` (beta only for
  the ``center=True`` variants; slim never stores a gamma).  The final
  layer of an ``is_logits`` stack (auto-offset/update MLPs, predictor
  heads) is plain dense with biases; the parameter tree keeps a norm
  slot there too, filled with the init values.
- ``IN``: no stored variables; normalized layers lose their biases.
"""

from typing import Dict, List, Sequence

import numpy as np

from pointgnn_tpu_torch.params import params_from_jax

_POOLING_TYPES = ("scatter_max_point_set_pooling",)
_GNN_TYPES = ("scatter_max_graph_auto_center_net",)
_PREDICTOR_TYPES = (
    "classaware_predictor",
    "classaware_predictor_128",
    "classaware_separated_predictor",
)
_BN_TYPES = ("fused_BN_center", "BN_center", "BN")
# the reference's in-code default when a config omits the key
# (its models/gnn.py)
_DEFAULT_NORM = "fused_BN_center"


def _fc_prefix(prefix: str, j: int) -> str:
    fc = "fully_connected" if j == 0 else "fully_connected_%d" % j
    return "/".join(p for p in (prefix, fc) if p)


def _mlp_names(
    prefix: str, n_layers: int, norm: str = "NONE",
    is_logits: bool = False,
) -> List[dict]:
    """Per-dense-layer variable descriptors of a slim MLP stack.

    Each descriptor: ``{"w", "b" (None when slim drops biases),
    "bn" (BatchNorm scope or None), "center" (beta present),
    "norm_slot" (the tree carries a norm dict for this layer)}``.
    """
    descs = []
    for j in range(n_layers):
        base = _fc_prefix(prefix, j)
        plain = norm == "NONE" or (is_logits and j == n_layers - 1)
        descs.append({
            "w": base + "/weights",
            "b": base + "/biases" if plain else None,
            "bn": None if (plain or norm not in _BN_TYPES)
            else base + "/BatchNorm",
            "center": norm in ("fused_BN_center", "BN_center"),
            "norm_slot": norm in _BN_TYPES,
        })
    return descs


def reference_name_map(
    layer_configs: Sequence[dict], num_classes: int
) -> Dict[str, Dict]:
    """Map the parameter tree onto reference variable names.

    Returns ``{scope: {mlp_key: [descriptor, ...]}}`` with the
    predictor's per-class loc heads under ``("loc",)`` as a list of
    per-class descriptor stacks (see :func:`_mlp_names`).
    """
    out = {}
    for cfg in layer_configs:
        scope, typ, kw = cfg["scope"], cfg["type"], cfg["kwargs"]

        def norm_of(key):
            return kw.get(key, _DEFAULT_NORM)

        entry = {}
        if typ in _POOLING_TYPES:
            entry["point_mlp"] = _mlp_names(
                scope + "/extract_vertex_features",
                len(kw["point_MLP_depth_list"]),
                norm_of("point_MLP_normalization_type"),
            )
            entry["output_mlp"] = _mlp_names(
                scope + "/combined_features",
                len(kw["output_MLP_depth_list"]),
                norm_of("output_MLP_normalization_type"),
            )
        elif typ in _GNN_TYPES:
            if kw.get("auto_offset", False):
                entry["auto_offset_mlp"] = _mlp_names(
                    scope, len(kw["auto_offset_MLP_depth_list"]),
                    norm_of("auto_offset_MLP_normalization_type"),
                    is_logits=True,
                )
            entry["edge_mlp"] = _mlp_names(
                scope + "/extract_vertex_features",
                len(kw["edge_MLP_depth_list"]),
                norm_of("edge_MLP_normalization_type"),
            )
            entry["update_mlp"] = _mlp_names(
                scope + "/combined_features",
                len(kw["update_MLP_depth_list"]),
                norm_of("update_MLP_normalization_type"),
                is_logits=True,
            )
        elif typ in _PREDICTOR_TYPES:
            norm = norm_of("normalization_type")
            # multi_layer_fc_fn: len(Ks) hidden + 1 output layer
            # cls head: Ks=(64,) or (128,) -> 2 dense layers
            entry["cls"] = _mlp_names(
                scope + "/predictor/cls", 2, norm, is_logits=True
            )
            # loc heads: Ks=(64, 64) or (128, 128) -> 3 dense layers
            entry[("loc",)] = [
                _mlp_names(
                    scope + "/predictor/loc/cls_%d" % ci, 3, norm,
                    is_logits=True,
                )
                for ci in range(num_classes)
            ]
        else:
            raise ValueError("unknown layer type: %s" % typ)
        out[scope] = entry
    return out


def convert_reference_weights(
    tf_vars: Dict[str, np.ndarray],
    layer_configs: Sequence[dict],
    num_classes: int,
    device=None,
) -> Dict:
    """Build the port's parameter tree (torch tensors on ``device``, the
    card by default; batch-norm moving averages and betas in each
    layer's ``"norm"``) from reference checkpoint arrays.

    ``tf_vars`` maps TF variable names (no ``:0`` suffix) to numpy
    arrays; optimizer slots / global_step are ignored.  Raises KeyError
    listing any missing variable.
    """
    name_map = reference_name_map(layer_configs, num_classes)
    missing = []

    def fetch(name):
        if name not in tf_vars:
            missing.append(name)
            return None
        return np.asarray(tf_vars[name], np.float32)

    def one_layer(d):
        w = fetch(d["w"])
        out_dim = 0 if w is None else w.shape[1]
        layer = {
            "w": w,
            # slim omits dense biases on normalized layers (a matmul
            # without bias == bias 0)
            "b": fetch(d["b"]) if d["b"] else
            np.zeros((out_dim,), np.float32),
        }
        if d["bn"]:
            norm = {
                "ema_mean": fetch(d["bn"] + "/moving_mean"),
                "ema_var": fetch(d["bn"] + "/moving_variance"),
            }
            if d["center"]:
                norm["beta"] = fetch(d["bn"] + "/beta")
            layer["norm"] = norm
        elif d["norm_slot"]:
            # the init gives EVERY layer of a BN-config MLP a norm
            # slot, including the plain final layer of an is_logits
            # stack that slim never normalizes — fill with the init
            # values so the tree structure matches model.init
            norm = {
                "ema_mean": np.zeros((out_dim,), np.float32),
                "ema_var": np.ones((out_dim,), np.float32),
            }
            if d["center"]:
                norm["beta"] = np.zeros((out_dim,), np.float32)
            layer["norm"] = norm
        else:
            layer["norm"] = None
        return layer

    def stack(descs):
        return [one_layer(d) for d in descs]

    params = {}
    for scope, entry in name_map.items():
        p = {}
        for key, descs in entry.items():
            if key == ("loc",):
                p["loc"] = [stack(ds) for ds in descs]
            else:
                p[key] = stack(descs)
        params[scope] = p
    if missing:
        raise KeyError(
            "reference checkpoint is missing %d expected variables, "
            "e.g. %s" % (len(missing), missing[:5])
        )
    return params_from_jax(params, device)


def used_variable_names(
    layer_configs: Sequence[dict], num_classes: int
) -> List[str]:
    """Every TF variable name the converter consumes (for audits)."""
    names = []
    for entry in reference_name_map(layer_configs, num_classes).values():
        for key, descs in entry.items():
            groups = descs if key == ("loc",) else [descs]
            for g in groups:
                for d in g:
                    names.append(d["w"])
                    if d["b"]:
                        names.append(d["b"])
                    if d["bn"]:
                        names.append(d["bn"] + "/moving_mean")
                        names.append(d["bn"] + "/moving_variance")
                        if d["center"]:
                            names.append(d["bn"] + "/beta")
    return names
