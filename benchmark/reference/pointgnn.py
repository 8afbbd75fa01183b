"""Plain reference of Point-GNN serving: graph, network, tail.

Written from the published description (Shi and Rajkumar, "Point-GNN:
Graph Neural Network for 3D Object Detection in a Point Cloud", CVPR
2020, and the configs of WeijingShi/Point-GNN), in plain PyTorch on
float32 with TF32 off.  It imports nothing of the program.

- Keypoints: one per occupied voxel of the runtime voxel size, the
  lowest-index point of the voxel, on a grid anchored at the cloud's
  minimum; voxels are ordered by their packed key.
- Neighborhoods: every pair within the level's radius, tested as
  ``(dx*dx + dy*dy) + dz*dz <= float32(r*r)`` on float32 coordinates.
- Layer 1 (set pooling): ``max_j MLP(concat(f_j, x_j - x_k))``, then an
  output MLP.
- Layers 2..T+1 (graph net with auto-registration): ``dx_k =
  MLP_h(s_k)``, ``e = max_j MLP_f(concat(s_j, x_j - x_k - dx_k))``,
  ``s_k += MLP_g(e)``.
- Predictor: a class head and one box head per class; softmax; the
  hypotheses are the foreground (class, vertex) pairs whose probability
  exceeds 1 / num_classes, the best ``max_hypotheses`` of them; boxes
  are decoded with the class-aware all-class encoding.

The first layer of each edge MLP is computed folded, as Point-GNN
implementations do, by the identity ``concat(f_j, x_j - c_k) @ W + b =
(f_j @ W_f + x_j @ W_x + b) - c_k @ W_x``: a table ``A`` per source
vertex and a table ``B`` per center, then ``relu(A[j] - B[k])`` and the
rest of the MLP per pair.  In float32 the two forms differ by rounding
only; the fold fixes where a lower precision rounds (the tables, whose
entries carry absolute coordinates).

``precision`` names where each product rounds its operands before it
multiplies (accumulating in float32 always):

- ``"f32"``: nowhere; the reference.
- ``"bf16_tables"``: the folded tables alone, to bfloat16, as a program
  that folds and computes in bfloat16 stores them; the second
  reference.
- ``"fp8"``: the control, the network in float8 e4m3 as a cheaper
  program would run it: the folded tables rounded to bfloat16, as the
  program stores them, and every product (the pair chain after the fold
  and every dense layer) on float8 operands.
- ``"fp8_unfolded"``: every product on float8 operands, the first layer
  of each edge MLP included, computed on ``concat(f_j, x_j - c_k)``
  without the fold.

Departure from the description: a voxel's index is ``floor((x - min) *
float32(1 / voxel))`` in float32, not ``floor((x - min) / voxel)``; the
two differ only for points within a rounding error of a voxel face,
where either choice is the description's voxel.
"""

import math

import numpy as np
import torch


# packed voxel keys: 1024 x 128 x 1024 cells, clamped at the edges
_DX, _DY, _DZ = 1024, 128, 1024
FP8_MAX = 448.0

MEDIAN_SIZE = {"Car": (3.88, 1.5, 1.63), "Pedestrian": (0.88, 1.77, 0.65),
               "Cyclist": (1.76, 1.75, 0.6)}
LABEL_MAPS = {
    "Car": {"Car": 1},
    "Pedestrian_and_Cyclist": {"Pedestrian": 1, "Cyclist": 3},
}


def runtime_geometry(config):
    """``(voxel, r0, r1)`` of the runtime graph."""
    kw = config["runtime_graph_gen_kwargs"]
    levels = kw["level_configs"]
    voxel = kw["base_voxel_size"] * levels[0]["graph_scale"]
    return (float(voxel), float(levels[0]["graph_gen_kwargs"]["radius"]),
            float(levels[1]["graph_gen_kwargs"]["radius"]))


def keypoints(xyz, voxel):
    """Indices of the keypoints of ``xyz`` ([N, 3] float32, numpy), in
    voxel-key order."""
    xyz = np.asarray(xyz, np.float32)
    origin = xyz.min(axis=0)
    ijk = np.floor((xyz - origin) * (np.float32(1.0) / np.float32(voxel)))
    ijk = ijk.astype(np.int64)
    ijk = np.clip(ijk, 0, np.array([_DX - 1, _DY - 1, _DZ - 1]))
    key = ijk[:, 0] + _DX * (ijk[:, 1] + _DY * ijk[:, 2])
    _, first = np.unique(key, return_index=True)
    return first


def radius_pairs(ctr, src, radius, block=2048):
    """All ``(k, j)`` with ``|src_j - ctr_k|^2 <= float32(r^2)`` (torch,
    float32), grouped by center."""
    r2 = float(np.float32(float(radius) * float(radius)))
    ks, js = [], []
    for lo in range(0, ctr.shape[0], block):
        c = ctr[lo:lo + block]
        dx = src[None, :, 0] - c[:, None, 0]
        dy = src[None, :, 1] - c[:, None, 1]
        dz = src[None, :, 2] - c[:, None, 2]
        hit = ((dx * dx + dy * dy) + dz * dz) <= r2
        k, j = torch.nonzero(hit, as_tuple=True)
        ks.append(k + lo)
        js.append(j)
        del dx, dy, dz, hit
    return torch.cat(ks), torch.cat(js)


# precision -> (folded tables, pair chain, other dense layers); tables
# None: the first edge layer unfolded
PRECISIONS = {
    "f32": ("f32", "f32", "f32"),
    "bf16_tables": ("bf16", "f32", "f32"),
    "fp8": ("bf16", "fp8", "fp8"),
    "fp8_unfolded": (None, "fp8", "fp8"),
}


def _round(x, kind):
    if kind == "f32":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        x = torch.clamp(x, -FP8_MAX, FP8_MAX)
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError("unknown rounding %r" % (kind,))


def _mlp(weights, scope, name, x, kind, linear_last):
    i = 0
    while (scope, name, i) in weights:
        w, b = weights[(scope, name, i)]
        x = _round(x, kind) @ _round(w, kind) + b
        last = (scope, name, i + 1) not in weights
        if not (last and linear_last):
            x = torch.relu(x)
        i += 1
    return x


def _edge_max(weights, scope, name, src_feat, src_xyz, ctr_xyz, pairs,
              tables, chain, chunk):
    """``max_j MLP(concat(src_feat[j], src_xyz[j] - ctr_xyz[k]))`` per
    center: the first layer folded into the tables ``A`` and ``B``
    rounded as ``tables`` says, or unfolded (``tables`` None); the rest
    of the MLP per pair on ``chain`` operands."""
    w0, b0 = weights[(scope, name, 0)]
    c = src_feat.shape[1]
    if tables is not None:
        table_a = _round(src_feat @ w0[:c] + src_xyz @ w0[c:] + b0, tables)
        table_b = _round(ctr_xyz @ w0[c:], tables)
    pk, pj = pairs
    out = None
    for lo in range(0, pk.shape[0], chunk):
        k, j = pk[lo:lo + chunk], pj[lo:lo + chunk]
        if tables is not None:
            h = torch.relu(table_a[j] - table_b[k])
        else:
            x = torch.cat([src_feat[j], src_xyz[j] - ctr_xyz[k]], dim=1)
            h = torch.relu(_round(x, chain) @ _round(w0, chain) + b0)
        i = 1
        while (scope, name, i) in weights:
            w, b = weights[(scope, name, i)]
            h = torch.relu(_round(h, chain) @ _round(w, chain) + b)
            i += 1
        if out is None:
            out = torch.full((ctr_xyz.shape[0], h.shape[1]), -math.inf,
                             device=h.device)
        out.index_reduce_(0, k, h, "amax")
    return out


class FrameGraph:
    """The reference graph of one frame: keypoints and both levels' pairs."""

    def __init__(self, xyz, config, device):
        voxel, r0, r1 = runtime_geometry(config)
        self.kp_index = keypoints(xyz, voxel)
        self.xyz = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
        self.kp_xyz = self.xyz[torch.as_tensor(self.kp_index, device=device)]
        self.l0 = radius_pairs(self.kp_xyz, self.xyz, r0)
        self.l1 = radius_pairs(self.kp_xyz, self.kp_xyz, r1)

    @property
    def counts(self):
        return {"points": int(self.xyz.shape[0]),
                "keypoints": int(self.kp_xyz.shape[0]),
                "pairs_l0": int(self.l0[0].numel()),
                "pairs_l1": int(self.l1[0].numel())}


def forward(graph, intensity, weights, config, precision="f32",
            chunk=1 << 18):
    """``(probs [K, C], box encodings [K, C, 7])`` of one frame."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(graph, intensity, weights, config, precision,
                            chunk)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _forward(graph, intensity, weights, config, precision, chunk):
    tables, chain, dense = PRECISIONS[precision]
    kp, pts = graph.kp_xyz, graph.xyz
    feat_pts = torch.as_tensor(np.asarray(intensity, np.float32),
                               device=pts.device).reshape(-1, 1)
    layers = config["model_kwargs"]["layer_configs"]
    feat = None
    for cfg in layers[:-1]:
        scope, kw = cfg["scope"], cfg["kwargs"]
        if cfg["type"] == "scatter_max_point_set_pooling":
            agg = _edge_max(weights, scope, "point_mlp", feat_pts, pts, kp,
                            graph.l0, tables, chain, chunk)
            feat = _mlp(weights, scope, "output_mlp", agg, dense,
                        linear_last=False)
        else:
            if kw.get("auto_offset"):
                shifted = kp + _mlp(weights, scope, "auto_offset_mlp", feat,
                                    dense, linear_last=True)
            else:
                shifted = kp
            agg = _edge_max(weights, scope, "edge_mlp", feat, kp, shifted,
                            graph.l1, tables, chain, chunk)
            feat = feat + _mlp(weights, scope, "update_mlp", agg, dense,
                               linear_last=True)
    pred = layers[-1]["scope"]
    nc = config["num_classes"]
    logits = _mlp(weights, pred, "cls", feat, dense, linear_last=True)
    enc = torch.stack([_mlp(weights, pred, ("loc", c), feat, dense,
                            linear_last=True) for c in range(nc)], dim=1)
    return torch.softmax(logits, dim=-1), enc


def class_tables(config):
    """``(sizes [C, 3] (l, h, w), yaw offset [C], active [C])``."""
    nc = config["num_classes"]
    sizes = np.ones((nc, 3))
    yaw = np.zeros(nc)
    active = np.zeros(nc, bool)
    for name, cid in LABEL_MAPS[config["label_method"]].items():
        for off, yoff in ((0, 0.0), (1, 0.5 * np.pi)):
            sizes[cid + off] = MEDIAN_SIZE[name]
            yaw[cid + off] = yoff
            active[cid + off] = True
    return sizes, yaw, active


def decode(enc, cls, xyz, config):
    """Boxes ``[N, 7]`` (x, y, z, l, h, w, yaw), float64, of encodings
    ``enc [N, 7]`` of classes ``cls`` at vertices ``xyz``."""
    sizes, yoff, active = class_tables(config)
    enc = np.asarray(enc, np.float64)
    sz, yo, act = sizes[cls], yoff[cls], active[cls]
    xyz_out = np.where(act[:, None], enc[:, 0:3] * sz, enc[:, 0:3]) + xyz
    lhw = np.where(act[:, None], np.exp(enc[:, 3:6]) * sz, enc[:, 3:6])
    yaw = np.where(act, enc[:, 6] * 0.25 * np.pi + yo, enc[:, 6])
    return np.concatenate([xyz_out, lhw, yaw[:, None]], axis=1)


def candidate_scores(probs, config):
    """``[K, C]`` numpy: the probability where (vertex, class) may be a
    hypothesis (foreground and above 1 / C), else -1."""
    p = probs.detach().cpu().numpy().astype(np.float64)
    nc = config["num_classes"]
    fg = np.zeros(nc, bool)
    fg[1:nc - 1] = True
    return np.where(fg[None, :] & (p > 1.0 / nc), p, -1.0)


def hypotheses(graph, probs, enc, config, max_hypotheses):
    """The reference's own hypotheses: ``(scores, classes, boxes, xyz)``
    of the best ``max_hypotheses`` candidates, best first."""
    cand = candidate_scores(probs, config)
    flat = cand.reshape(-1)
    order = np.argsort(-flat, kind="stable")[:max_hypotheses]
    order = order[flat[order] > 0]
    nc = config["num_classes"]
    k, cls = order // nc, order % nc
    xyz = graph.kp_xyz.cpu().numpy()[k].astype(np.float64)
    e = enc.detach().cpu().numpy()[k, cls]
    return flat[order], cls, decode(e, cls, xyz, config), xyz
