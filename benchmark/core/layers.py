"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``).

Each reader gets the traced run's context: ``trace`` (a
``core.trace.DeviceTrace`` of the window), ``window_s``, ``cfg`` (the
configuration file), ``loop``, ``frames`` (pool index of each frame
served in the window), ``k1_frames`` (pool index of each frame whose
device program ran in the window), ``pool_counts`` (the reference
graph's points, keypoints and in-radius pairs of those pool frames) and
``nms_s`` (the window's growth of ``time_dict["nms"]``).
"""

import math

from benchmark.frozen import flops
from benchmark.reference.pointgnn import runtime_geometry

# K1 (csrc/slab_edge_max.cu): its pair-list kernels and the forward
# chain instantiations of slab_mma::chain_kernel<bf16, train, tail>
K1_KERNELS = r"^pair_kernel<(true|false)>$|^chain_kernel<(true|false), false, false>$"
WORLD_EXTENT = 130.0


def frame_flops(cfg, counts):
    return flops.pointgnn_forward_flops(
        cfg["config"], 1, counts["points"], counts["keypoints"],
        counts["pairs_l0"], counts["pairs_l1"])


def mfu(ctx, loop):
    """The whole device program's share of the bf16 peak, %: the useful
    FLOPs of the device programs that ran in the traced window."""
    if ctx["loop"] != loop or not ctx["k1_frames"]:
        return None
    total = sum(frame_flops(ctx["cfg"], ctx["pool_counts"][f])
                for f in ctx["k1_frames"])
    return 100.0 * total / ctx["window_s"] / flops.PEAK_BF16_FLOPS


def _slab_grid(radius):
    cell = max(radius, WORLD_EXTENT / 256.0)
    return int(math.ceil(WORLD_EXTENT / cell))


def k1_frame_bound(cfg, counts):
    """Least seconds of one frame's K1 calls: level 0 once, level 1 once
    per graph-net layer, at the serving spec's padded table sizes."""
    config = cfg["config"]
    serving = cfg["serving"]
    _, r0, r1 = runtime_geometry(config)
    layers = config["model_kwargs"]["layer_configs"]
    pool_kw = layers[0]["kwargs"]
    point = list(pool_kw["point_MLP_depth_list"])
    total = 0.0
    total += flops.k1_bound(counts["pairs_l0"], serving["num_points"],
                            serving["num_keypoints"], point[0], point,
                            _slab_grid(r0) ** 2, flops.PEAK_BF16_FLOPS)[0]
    for lc in layers[1:-1]:
        edge = list(lc["kwargs"]["edge_MLP_depth_list"])
        total += flops.k1_bound(counts["pairs_l1"], serving["num_keypoints"],
                                serving["num_keypoints"], edge[0], edge,
                                _slab_grid(r1) ** 2,
                                flops.PEAK_BF16_FLOPS)[0]
    return total


def k1_roofline(ctx, loop):
    """K1's least time over its device time in the window, %."""
    if ctx["loop"] != loop:
        return None
    spent = ctx["trace"].seconds_of(K1_KERNELS)
    if spent <= 0 or not ctx["k1_frames"]:
        return None
    bound = sum(k1_frame_bound(ctx["cfg"], ctx["pool_counts"][f])
                for f in ctx["k1_frames"])
    return 100.0 * bound / spent


def device_idle(ctx, loop):
    if ctx["loop"] != loop or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s / ctx["window_s"])


def nms_ms(ctx, loop):
    if ctx["loop"] != loop or not ctx["frames"]:
        return None
    return 1e3 * ctx["nms_s"] / len(ctx["frames"])
