"""Fused radius search + edge MLP + per-center max over slab graphs.

Counterpart of the slab part of :mod:`pointgnn_tpu.nn.pallas_kernels`
(``slab_edge_max``, ``_slab_forward``, ``_slab_kernel``,
``column_row_windows``).  For each center ``k`` and each candidate row
``j`` inside the center block's per-column row windows::

    mask   = |p_j - c_k|^2 <= r^2          (exact f32, x, y, z order)
    h      = relu(A[j] - B[k]) -> dense+ReLU chain
    out[k] = max over masked j of h        (0 where no neighbor)

Candidates (``table_a``/``src_xyz``) are rows in cell order, so each
grid column's candidates are one contiguous row range; pad sources
carry +1e6 coordinates and pad centers -1e6, so pad pairs fail the
distance test.

Rounding points in the compute dtype (as in the JAX kernel): tables and
weights/biases are rounded to the compute dtype, ``relu(a - b)`` is
rounded, each layer accumulates in f32 and adds the bias in f32, and
the activations are re-rounded between layers but not after the last.

On a CUDA tensor :func:`slab_edge_max` launches the hand-written kernel
(``csrc/slab_edge_max.cu``) or raises; on a CPU tensor it runs
:func:`slab_edge_max_reference`, the plain PyTorch version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.nn.mlp import round_to

NEG = -1e30
DEFAULT_BLOCK_CENTERS = 32
MAX_LAYERS = 8  # kMaxLayers in the CUDA source

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "slab_edge_max.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_loaded = {}  # source hash -> ctypes library (one build per process)


def column_row_windows(offsets, center_cell, grid_g, bk, halo):
    """Candidate row windows ``[lo, hi)`` per (center block, column).

    For block ``b`` and grid column ``xc``: the z-range of the block's
    valid center cells whose x lies within ``halo`` of ``xc``, widened
    by ``halo`` and mapped through ``offsets``.  Columns no center
    reaches get ``hi == lo``.  Returns ``(win_lo, win_hi)`` int32
    ``[ceil(K / bk), grid_g]``; the last block is padded with invalid
    centers.
    """
    ncells = grid_g * grid_g
    k = center_cell.shape[0]
    nb = -(-k // bk)
    cells = torch.full((nb * bk,), ncells, dtype=torch.int64,
                       device=center_cell.device)
    cells[:k] = center_cell
    cells = cells.reshape(nb, bk)
    valid = cells < ncells
    xs = cells // grid_g
    zs = cells % grid_g
    xc = torch.arange(grid_g, device=cells.device)
    use = valid[:, :, None] & (
        (xs[:, :, None] - xc[None, None, :]).abs() <= halo
    )
    zlo = torch.where(use, zs[:, :, None], grid_g).amin(dim=1)
    zhi = torch.where(use, zs[:, :, None], -1).amax(dim=1)
    zlo_c = torch.clamp(zlo - halo, min=0)
    zhi_c = torch.clamp(zhi + halo, max=grid_g - 1)
    offsets = offsets.to(torch.int64)
    lo = offsets[xc[None, :] * grid_g + zlo_c]
    hi = torch.where(
        zhi >= 0, offsets[xc[None, :] * grid_g + zhi_c + 1], lo
    )
    return lo.to(torch.int32), hi.to(torch.int32)


def _radius2(radius):
    """r^2 as the float32 the JAX kernel compares against."""
    return float(np.float32(float(radius) * float(radius)))


def _inradius_pairs(src_xyz, ctr_xyz, win_lo, win_hi, bk, radius,
                    max_candidates=1 << 22):
    """Yield ``(k, j)`` index tensors of the in-radius (center,
    candidate) pairs inside the walked windows, in chunks of center
    blocks holding at most ``max_candidates`` candidate pairs."""
    k_total = ctr_xyz.shape[0]
    nb, g = win_lo.shape
    dev = src_xyz.device
    r2 = _radius2(radius)
    counts = (win_hi.to(torch.int64) - win_lo.to(torch.int64)).clamp(min=0)
    per_block = (counts.sum(dim=1) * bk).tolist()
    lane = torch.arange(bk, device=dev)
    b0 = 0
    while b0 < nb:
        b1, budget = b0, 0
        while b1 < nb and (b1 == b0 or budget + per_block[b1]
                           <= max_candidates):
            budget += per_block[b1]
            b1 += 1
        cnt = counts[b0:b1].reshape(-1)
        total = int(cnt.sum())
        if total:
            seg_lo = win_lo[b0:b1].reshape(-1).to(torch.int64)
            seg_blk = torch.arange(b0, b1, device=dev).repeat_interleave(g)
            seg_start = torch.cumsum(cnt, 0) - cnt
            within = torch.arange(total, device=dev) - torch.repeat_interleave(
                seg_start, cnt
            )
            rows = torch.repeat_interleave(seg_lo, cnt) + within
            blk = torch.repeat_interleave(seg_blk, cnt)
            kk = blk[:, None] * bk + lane[None, :]
            jj = rows[:, None].expand(-1, bk)
            ok = kk < k_total
            kk, jj = kk[ok], jj[ok]
            s, c = src_xyz[jj], ctr_xyz[kk]
            dx = s[:, 0] - c[:, 0]
            dy = s[:, 1] - c[:, 1]
            dz = s[:, 2] - c[:, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            hit = d2 <= r2
            yield kk[hit], jj[hit]
        b0 = b1


def inradius_pair_count(src_xyz, ctr_xyz, offsets, center_cell, grid_g,
                        radius, halo=1, block_centers=DEFAULT_BLOCK_CENTERS):
    """Number of in-radius (center, candidate) pairs: the pairs whose
    chain the kernel runs."""
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    return sum(
        int(k.numel()) for k, _ in _inradius_pairs(
            src_xyz, ctr_xyz, win_lo, win_hi, block_centers, radius
        )
    )


def _chain_out_dim(weights, h):
    return weights[-1][0].shape[1] if weights else h


def slab_edge_max_reference(
    table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    grid_g: int, radius: float, halo: int = 1,
    compute_dtype="bfloat16",
    block_centers: int = DEFAULT_BLOCK_CENTERS,
    pair_chunk: int = 1 << 17,
):
    """Plain PyTorch version of :func:`slab_edge_max`: the same walk
    (gather the candidate rows of the same windows, exact distance
    mask), the chain only on the in-radius pairs with the same rounding
    points, and a ``scatter_reduce("amax")`` from ``NEG``."""
    k, h = table_b.shape[0], table_a.shape[1]
    h_out = _chain_out_dim(weights, h)
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    a = round_to(table_a.to(torch.float32), compute_dtype)
    b = round_to(table_b.to(torch.float32), compute_dtype)
    chain = [
        (round_to(w.to(torch.float32), compute_dtype),
         round_to(bb.to(torch.float32), compute_dtype))
        for w, bb in weights
    ]
    out = torch.full((k, h_out), NEG, dtype=torch.float32,
                     device=table_a.device)
    for kk, jj in _inradius_pairs(
        src_xyz, ctr_xyz, win_lo, win_hi, block_centers, radius
    ):
        for s in range(0, kk.numel(), pair_chunk):
            kc, jc = kk[s:s + pair_chunk], jj[s:s + pair_chunk]
            x = round_to(torch.relu(a[jc] - b[kc]), compute_dtype)
            for li, (w, bb) in enumerate(chain):
                x = torch.relu(x @ w + bb)
                if li + 1 < len(chain):
                    x = round_to(x, compute_dtype)
            out.scatter_reduce_(
                0, kc[:, None].expand(-1, h_out), x, "amax",
                include_self=True,
            )
    return torch.where(out > NEG / 2, out, torch.zeros((), device=out.device))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def _source_hash():
    return hashlib.sha256(_CSRC.read_bytes()).hexdigest()[:16]


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build_kernel():
    """Compile ``csrc/slab_edge_max.cu`` for sm_90a into
    ``build/torch_kernels/`` (keyed by the source hash) unless that
    library exists.  Returns ``(path, seconds, compiler output)``."""
    lib_path = _BUILD_DIR / ("slab_edge_max_%s.so" % _source_hash())
    if lib_path.exists():
        return lib_path, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(".so.tmp%d" % os.getpid())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed building %s:\n%s%s"
            % (_CSRC, proc.stdout, proc.stderr)
        )
    os.replace(tmp, lib_path)
    return lib_path, time.perf_counter() - t0, proc.stdout + proc.stderr


def _kernel_lib():
    key = _source_hash()
    if key not in _loaded:
        path, _, _ = build_kernel()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.slab_edge_max_launch.restype = ci
        lib.slab_edge_max_launch.argtypes = [
            vp, vp, vp, vp,          # table_a, src_xyz, table_b, ctr_xyz
            vp, vp,                  # win_lo, win_hi
            vp, vp, ci,              # weights, layer table (host), layers
            vp,                      # out
            ci, ci, ci, ci, ci,      # K, H, H_out, grid_g, bk
            ctypes.c_float, ci,      # r^2, bf16
            ci, vp,                  # device index, stream
        ]
        _loaded[key] = lib
    return _loaded[key]


def _require(cond, msg):
    if not cond:
        raise ValueError("slab_edge_max: " + msg)


def _check_inputs(table_a, src_xyz, table_b, ctr_xyz, offsets,
                  center_cell, weights, grid_g):
    dev = table_a.device
    tensors = [table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell]
    tensors += [t for wb in weights for t in wb]
    for t in tensors:
        _require(t.device == dev, "all inputs must be on %s" % dev)
        _require(t.is_contiguous(), "inputs must be contiguous")
    for t in (table_a, src_xyz, table_b, ctr_xyz):
        _require(t.dtype == torch.float32, "tables/coords must be float32")
    for t in (offsets, center_cell):
        _require(t.dtype == torch.int32, "offsets/cells must be int32")
    p, h = table_a.shape
    k = table_b.shape[0]
    _require(table_b.shape == (k, h), "table_b must be [K, H]")
    _require(src_xyz.shape == (p, 4), "src_xyz must be [P, 4]")
    _require(ctr_xyz.shape == (k, 4), "ctr_xyz must be [K, 4]")
    _require(offsets.shape == (grid_g * grid_g + 1,),
             "offsets must be [grid_g^2 + 1]")
    _require(center_cell.shape == (k,), "center_cell must be [K]")
    _require(len(weights) <= MAX_LAYERS,
             "at most %d chain layers" % MAX_LAYERS)
    din = h
    for w, b in weights:
        _require(w.ndim == 2 and w.shape[0] == din, "chain widths differ")
        _require(b.shape == (w.shape[1],), "bias width differs")
        din = w.shape[1]


def slab_edge_max(
    table_a,        # [P, H] float32 candidate table A (cell-sorted rows)
    src_xyz,        # [P, 4] float32 xyz + pad lane; pad rows +1e6
    table_b,        # [K, H] float32 per-center table B
    ctr_xyz,        # [K, 4] float32 center coords; pad rows -1e6
    offsets,        # [grid_g^2 + 1] int32 cell row offsets into P
    center_cell,    # [K] int32 cell per center (pad = grid_g^2)
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # tail (w, b)
    grid_g: int,
    radius: float,
    halo: int = 1,
    compute_dtype="bfloat16",
    block_centers: int = DEFAULT_BLOCK_CENTERS,
):
    """Fused uncapped radius search + edge MLP + per-center max;
    returns [K, H_out] float32.  ``compute_dtype`` is "bfloat16" (the
    serving path) or "float32" (full f32, no TF32)."""
    weights = [tuple(wb) for wb in weights]
    _check_inputs(table_a, src_xyz, table_b, ctr_xyz, offsets,
                  center_cell, weights, grid_g)
    if table_a.device.type == "cpu":
        return slab_edge_max_reference(
            table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
            weights, grid_g, radius, halo, compute_dtype, block_centers,
        )
    if table_a.device.type != "cuda":
        raise ValueError("slab_edge_max: unsupported device %s"
                         % table_a.device)
    cd = str(compute_dtype).replace("torch.", "")
    _require(cd in ("bfloat16", "float32"),
             "compute_dtype must be bfloat16 or float32")
    k, h = table_b.shape
    h_out = _chain_out_dim(weights, h)
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    flat, meta, off = [], [], 0
    for w, b in weights:
        wr = round_to(w, cd).reshape(-1)
        br = round_to(b, cd).reshape(-1)
        meta += [off, off + wr.numel(), w.shape[0], w.shape[1]]
        flat += [wr, br]
        off += wr.numel() + br.numel()
    flat_w = (torch.cat(flat) if flat
              else torch.zeros(1, device=table_a.device))
    meta_host = (ctypes.c_int * max(len(meta), 1))(*meta)
    out = torch.empty((k, h_out), dtype=torch.float32, device=table_a.device)
    stream = torch.cuda.current_stream(table_a.device)
    rc = _kernel_lib().slab_edge_max_launch(
        table_a.data_ptr(), src_xyz.data_ptr(), table_b.data_ptr(),
        ctr_xyz.data_ptr(), win_lo.data_ptr(), win_hi.data_ptr(),
        flat_w.data_ptr(), ctypes.addressof(meta_host), len(weights),
        out.data_ptr(), k, h, h_out, grid_g, block_centers,
        _radius2(radius), int(cd == "bfloat16"),
        table_a.device.index or 0, stream.cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("slab_edge_max kernel launch failed: CUDA "
                           "error %d" % rc)
    slab_edge_max.launches += 1
    return out


slab_edge_max.launches = 0
