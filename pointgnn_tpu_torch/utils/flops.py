"""Analytic FLOP accounting for the slab/device-graph paths (copy of
:mod:`pointgnn_tpu.utils.flops`, the same results).

- **useful (model) FLOPs** (:func:`pointgnn_forward_flops`): what the
  Point-GNN forward computes on a frame in the folded formulation the
  layers use (per-vertex A/B projections, the remaining MLP chain on
  every real edge, per-vertex update/output/predictor MLPs).  Real edges
  are the exact in-radius pairs, the uncapped runtime graph
  (:func:`count_inradius_pairs`).
- **walked (kernel) FLOPs** (:func:`slab_walk_pairs`,
  :func:`slab_walk_pairs_subblock`): a host replica of the TPU slab
  kernel's block / column / tile walk (``pointgnn_tpu/nn/pallas_kernels.py``
  ``_slab_kernel``), kept to compare with the JAX package's figures.  The
  CUDA K1 and K2 walk no tiles: they build the CSR list of exactly the
  ``count_inradius_pairs`` pairs (``nn/slab.py`` ``pair_list``) and run
  the chain on those, so their walked pairs equal the useful ones.

A share of peak = useful FLOPs / time / the card's peak.
"""

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = [
    "dense_chain_flops",
    "count_inradius_pairs",
    "slab_walk_pairs",
    "slab_walk_pairs_subblock",
    "pointgnn_forward_flops",
]


def _legal_sub(sub, bk):
    """Largest divisor of ``bk`` that is <= ``sub`` (0 stays 0)."""
    if not sub:
        return 0
    sub = min(sub, bk)
    while bk % sub:
        sub -= 1
    return sub


def dense_chain_flops(rows: int, dims: Sequence[int]) -> float:
    """2 * rows * sum(d_i * d_{i+1}) — multiply-add counted as 2."""
    return 2.0 * rows * float(
        sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    )


def count_inradius_pairs(
    centers: np.ndarray,        # [K, 3] float
    candidates: np.ndarray,     # [P, 3] float
    radius: float,
    chunk: int = 1024,
) -> int:
    """Exact number of (center, candidate) pairs with ||c - s|| <= r.

    Blocked pairwise distances (no scipy dependency); ~300M pairs run
    in a few seconds of numpy, fine for bench-time accounting."""
    centers = np.asarray(centers, np.float32)
    candidates = np.asarray(candidates, np.float32)
    r2 = np.float32(radius * radius)
    total = 0
    cand2 = (candidates * candidates).sum(axis=1)
    for lo in range(0, len(centers), chunk):
        c = centers[lo:lo + chunk]
        d2 = (
            (c * c).sum(axis=1)[:, None]
            - 2.0 * (c @ candidates.T)
            + cand2[None, :]
        )
        total += int((d2 <= r2).sum())
    return total


def slab_walk_pairs(
    offsets: np.ndarray,      # [gx*gz + 1] int32 cell row offsets
    center_cell: np.ndarray,  # [K] int32 (pad rows = gx*gz)
    grid_g: int,
    bk: int,
    tile: int,
    halo: int = 1,
) -> Dict[str, int]:
    """Host replica of the slab kernel's candidate walk.

    Returns the pair counts the kernel actually computes
    (``walked_pairs`` = DMA'd rows x bk centers per block) plus two
    counterfactuals that attribute the overfetch:

    - ``span_pairs``: pairs if tiles were NOT 'tile'-row aligned (exact
      [lo, hi) spans) — isolates tile-alignment waste;
    - ``tiles``: total DMA'd tiles (each is one async copy).

    Mirrors the TPU ``_slab_kernel``'s col_body/zscan exactly.
    """
    offsets = np.asarray(offsets, np.int64)
    center_cell = np.asarray(center_cell, np.int64)
    k = len(center_cell)
    ncells = grid_g * grid_g
    walked_rows = 0
    span_rows = 0
    tiles = 0
    for b0 in range(0, k, bk):
        cells = center_cell[b0:b0 + bk]
        valid = cells < ncells
        if not valid.any():
            continue
        vc = cells[valid]
        cmin, cmax = int(vc.min()), int(vc.max())
        x0 = max(cmin // grid_g - halo, 0)
        x1 = min(cmax // grid_g + halo, grid_g - 1)
        xs = vc // grid_g
        zs = vc % grid_g
        for xc in range(x0, x1 + 1):
            use = np.abs(xs - xc) <= halo
            if use.any():
                zlo = int(zs[use].min())
                zhi = int(zs[use].max())
            else:
                # the kernel walks this column anyway (a block whose
                # x-cells have a gap > 2*halo): its zscan sentinel
                # (grid_g, -1) collapses to hi == lo, but when lo is
                # not tile-aligned the base rounding still DMAs and
                # computes ONE partial tile (_slab_kernel col_body) —
                # mirror it or walked counts under-report
                zlo, zhi = grid_g, -1
            zlo_c = max(zlo - halo, 0)
            zhi_c = min(zhi + halo, grid_g - 1)
            lo = int(offsets[xc * grid_g + zlo_c])
            hi = int(offsets[xc * grid_g + zhi_c + 1]) if zhi >= 0 else lo
            base = (lo // tile) * tile
            span = hi - base
            nt = (span + tile - 1) // tile if span > 0 else 0
            walked_rows += nt * tile
            span_rows += max(hi - lo, 0)
            tiles += nt
    return {
        "walked_pairs": walked_rows * bk,
        "span_pairs": span_rows * bk,
        "tiles": tiles,
        "blocks": (k + bk - 1) // bk,
    }


def slab_walk_pairs_subblock(
    offsets: np.ndarray,      # [gx*gz + 1] int32 cell row offsets
    center_cell: np.ndarray,  # [K] int32 (pad rows = gx*gz)
    cand_xyz: np.ndarray,     # [P(+pad), >=3] candidate coords in the
    #                           offsets' cell-sorted order (pad = 1e6)
    ctr_xyz: np.ndarray,      # [K, >=3] center coords (pad = -1e6)
    grid_g: int,
    radius: float,
    bk: int,
    tile: int,
    sub: int,
    halo: int = 1,
) -> Dict[str, int]:
    """Counterfactual: the slab walk with per-(sub-block, tile) MLP skip.

    The kernel computes the exact [bk, tile] distance mask BEFORE the
    edge MLP, so splitting each block's MLP into ``bk/sub`` sub-blocks
    and skipping a (sub-block, tile) whose mask has no hit costs only a
    mask reduction — this sim counts the pairs the MLP would then
    actually execute (``computed_pairs``) against the unconditional
    walk (``walked_pairs``).  DMA volume is unchanged (tiles are still
    fetched per block).  Mirrors _slab_kernel's col_body/zscan walk.
    """
    offsets = np.asarray(offsets, np.int64)
    center_cell = np.asarray(center_cell, np.int64)
    cand_xyz = np.asarray(cand_xyz, np.float32)[:, :3]
    ctr_xyz = np.asarray(ctr_xyz, np.float32)[:, :3]
    # normalize ``sub`` as the TPU kernel does: 0 disables the skip
    # entirely (the kernel then runs the MLP unconditionally, so
    # computed == walked), non-divisors round down to the largest
    # divisor of bk; sub == bk is whole-block-tile granularity skipping
    sub = _legal_sub(sub, bk)
    # the kernel's fused table is padded with one sentinel tile past P
    # (_slab_prep_fused), so the last tile of a window may read past P
    pad = np.full((tile, 3), 1e6, np.float32)
    cand_xyz = np.concatenate([cand_xyz, pad], axis=0)
    k = len(center_cell)
    if k % bk:
        # partial tail block: pad with sentinel cells/coords (matches
        # slab_walk_pairs' ceil-div block handling)
        kpad = bk - k % bk
        center_cell = np.concatenate(
            [center_cell, np.full(kpad, grid_g * grid_g, np.int64)]
        )
        ctr_xyz = np.concatenate(
            [ctr_xyz, np.full((kpad, 3), -1e6, np.float32)], axis=0
        )
        k = len(center_cell)
    ncells = grid_g * grid_g
    r2 = np.float32(radius * radius)
    walked_rows = 0
    computed_pairs = 0
    tiles = 0
    computed_subtiles = 0
    for b0 in range(0, k, bk):
        cells = center_cell[b0:b0 + bk]
        valid = cells < ncells
        if not valid.any():
            continue
        ctr = ctr_xyz[b0:b0 + bk]            # [bk, 3]
        vc = cells[valid]
        cmin, cmax = int(vc.min()), int(vc.max())
        x0 = max(cmin // grid_g - halo, 0)
        x1 = min(cmax // grid_g + halo, grid_g - 1)
        xs = vc // grid_g
        zs = vc % grid_g
        for xc in range(x0, x1 + 1):
            use = np.abs(xs - xc) <= halo
            if use.any():
                zlo = int(zs[use].min())
                zhi = int(zs[use].max())
            else:
                zlo, zhi = grid_g, -1
            zlo_c = max(zlo - halo, 0)
            zhi_c = min(zhi + halo, grid_g - 1)
            lo = int(offsets[xc * grid_g + zlo_c])
            hi = int(offsets[xc * grid_g + zhi_c + 1]) if zhi >= 0 else lo
            base = (lo // tile) * tile
            span = hi - base
            nt = (span + tile - 1) // tile if span > 0 else 0
            if nt == 0:
                continue
            walked_rows += nt * tile
            tiles += nt
            if sub == 0:
                # skip disabled: the kernel executes every walked
                # (block, tile) pair unconditionally
                computed_subtiles += nt
                computed_pairs += nt * tile * bk
                continue
            rows = cand_xyz[base:base + nt * tile]      # [nt*tile, 3]
            d2 = (
                ((ctr[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
            )                                            # [bk, nt*tile]
            hit = (d2 <= r2).reshape(
                bk // sub, sub, nt, tile
            ).any(axis=(1, 3))                           # [bk/sub, nt]
            nsub = int(hit.sum())
            computed_subtiles += nsub
            computed_pairs += nsub * sub * tile
    return {
        "walked_pairs": walked_rows * bk,
        "computed_pairs": computed_pairs,
        "tiles": tiles,
        "computed_subtiles": computed_subtiles,
    }


def _gnn_layer_flops(k: int, pairs: int, in_dim: int, kw: dict) -> float:
    """One GraphNetAutoCenter layer in the folded formulation
    (nn/layers.py GraphNetAutoCenter.apply, NONE-norm fast path)."""
    edge = list(kw["edge_MLP_depth_list"])
    update = list(kw["update_MLP_depth_list"])
    f = 0.0
    if kw.get("auto_offset"):
        f += dense_chain_flops(k, [in_dim] + list(
            kw["auto_offset_MLP_depth_list"]
        ))
    # table A = feat @ W0a + xyz @ W0b + b0; table B = xyz' @ W0b
    f += dense_chain_flops(k, [in_dim, edge[0]])      # feat @ W0a
    f += 2 * dense_chain_flops(k, [3, edge[0]])       # two xyz @ W0b
    # per-real-edge remaining chain
    f += dense_chain_flops(pairs, edge)
    # update MLP on K vertices
    f += dense_chain_flops(k, [edge[-1]] + update)
    return f


def _pooling_layer_flops(
    p: int, k: int, pairs: int, in_dim: int, kw: dict
) -> float:
    """PointSetPooling in the folded formulation."""
    point = list(kw["point_MLP_depth_list"])
    out = list(kw["output_MLP_depth_list"])
    f = dense_chain_flops(p, [in_dim, point[0]])      # feat @ W0a
    f += dense_chain_flops(p, [3, point[0]])          # point xyz @ W0b
    f += dense_chain_flops(k, [3, point[0]])          # center xyz @ W0b
    f += dense_chain_flops(pairs, point)              # per-pair chain
    f += dense_chain_flops(k, [point[-1]] + out)
    return f


def pointgnn_forward_flops(
    config: dict,
    input_dim: int,
    num_points: int,
    num_keypoints: int,
    pairs_l0: int,
    pairs_l1: int,
    cls_ks: Tuple[int, ...] = (64,),
    loc_ks: Tuple[int, ...] = (64, 64),
    box_encoding_len: int = 7,
) -> float:
    """Useful forward FLOPs of one frame through the configured model.

    ``pairs_l0``/``pairs_l1`` are the REAL in-radius edge counts (the
    exact uncapped graph).  Predictor head dims mirror
    nn/layers.ClassAwarePredictor's defaults."""
    nc = config["num_classes"]
    total = 0.0
    feat_dim = input_dim
    for lc in config["model_kwargs"]["layer_configs"]:
        kw = lc["kwargs"]
        if lc["type"] == "scatter_max_point_set_pooling":
            total += _pooling_layer_flops(
                num_points, num_keypoints, pairs_l0, feat_dim, kw
            )
            feat_dim = kw["output_MLP_depth_list"][-1]
        elif lc["type"] == "scatter_max_graph_auto_center_net":
            total += _gnn_layer_flops(
                num_keypoints, pairs_l1, feat_dim, kw
            )
            feat_dim = kw["update_MLP_depth_list"][-1]
        elif "predictor" in lc["type"]:
            total += dense_chain_flops(
                num_keypoints, [feat_dim] + list(cls_ks) + [nc]
            )
            loc_in = (
                feat_dim // nc if "separated" in lc["type"] else feat_dim
            )
            total += nc * dense_chain_flops(
                num_keypoints,
                [loc_in] + list(loc_ks) + [box_encoding_len],
            )
    return total
