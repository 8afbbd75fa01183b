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

On a CUDA tensor :func:`slab_edge_max` launches the hand-written kernels
(``csrc/slab_edge_max.cu``) or raises; on a CPU tensor it runs
:func:`slab_edge_max_reference`, the plain PyTorch version.  The kernels
first build the pair list (:func:`pair_list`: every in-radius pair,
grouped by center) and then run the chain over chunks of
:data:`PAIR_CHUNK` pairs spread evenly over the SMs, so a crowded center
block does not hold up the call (:func:`pair_chunks`).

Training: :func:`slab_edge_max_train` is the differentiable version (the
counterpart of the JAX ``slab_edge_max_train`` custom VJP).  Its forward
is :func:`slab_edge_max`; its backward, :func:`slab_edge_max_backward`,
recomputes every in-radius pair's chain, routes the output cotangent to
each pair whose output equals the per-channel max (every tied winner gets
the full cotangent) and backpropagates through the chain.  On a CUDA
tensor that is the kernels of ``csrc/slab_edge_max_bwd.cu`` over the same
pair list (and its source-sorted view, :func:`source_order`); on a CPU
tensor :func:`slab_edge_max_backward_reference`.  Coordinates and cell
metadata get no gradient.  Both kernels take their chain arithmetic from
``csrc/slab_chain.cuh``, so the backward's recompute equals the forward
bit for bit.
"""

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.nn import cuda_build
from pointgnn_tpu_torch.nn.cuda_build import MAX_LAYERS
from pointgnn_tpu_torch.nn.mlp import round_to

NEG = -1e30
DEFAULT_BLOCK_CENTERS = 32


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


def winner_counts(table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
                  weights, out, grid_g, radius, halo=1,
                  compute_dtype="float32",
                  block_centers=DEFAULT_BLOCK_CENTERS):
    """``(winner entries, winning pairs)`` of a backward: the (pair,
    channel) entries whose positive output equals ``out`` (the only
    entries a cotangent reaches), and the pairs holding at least one of
    them (the only pairs whose lower layers get a cotangent)."""
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    a, b, chain = _rounded_operands(table_a, table_b, weights,
                                    compute_dtype)
    entries = pairs = 0
    for kc, jc in _pair_chunks(src_xyz, ctr_xyz, win_lo, win_hi,
                               block_centers, radius, 1 << 17):
        x = _chain_acts(a, b, chain, kc, jc, compute_dtype)[-1]
        won = (x == out[kc]) & (x > 0)
        entries += int(won.sum())
        pairs += int(won.any(dim=1).sum())
    return entries, pairs


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
    a, b, chain = _rounded_operands(table_a, table_b, weights,
                                    compute_dtype)
    out = torch.full((k, h_out), NEG, dtype=torch.float32,
                     device=table_a.device)
    for kc, jc in _pair_chunks(src_xyz, ctr_xyz, win_lo, win_hi,
                               block_centers, radius, pair_chunk):
        x = _chain_acts(a, b, chain, kc, jc, compute_dtype)[-1]
        out.scatter_reduce_(
            0, kc[:, None].expand(-1, h_out), x, "amax", include_self=True,
        )
    return torch.where(out > NEG / 2, out, torch.zeros((), device=out.device))


def _rounded_operands(table_a, table_b, weights, compute_dtype):
    """Tables and chain rounded to the compute dtype, kept float32."""
    a = round_to(table_a.to(torch.float32), compute_dtype)
    b = round_to(table_b.to(torch.float32), compute_dtype)
    chain = [
        (round_to(w.to(torch.float32), compute_dtype),
         round_to(bb.to(torch.float32), compute_dtype))
        for w, bb in weights
    ]
    return a, b, chain


def _pair_chunks(src_xyz, ctr_xyz, win_lo, win_hi, bk, radius, pair_chunk):
    """The in-radius pairs in chunks of at most ``pair_chunk``: the plain
    forward and the plain backward walk the same chunks, so the
    backward's recompute repeats the forward's products bit for bit."""
    for kk, jj in _inradius_pairs(src_xyz, ctr_xyz, win_lo, win_hi, bk,
                                  radius):
        for s in range(0, kk.numel(), pair_chunk):
            yield kk[s:s + pair_chunk], jj[s:s + pair_chunk]


def _chain_acts(a, b, chain, kc, jc, compute_dtype):
    """Every activation of the chain on the pairs ``(kc, jc)``:
    ``[relu(A - B), layer 1, ..., layer L]`` with the kernel's rounding
    points."""
    x = round_to(torch.relu(a[jc] - b[kc]), compute_dtype)
    acts = [x]
    for li, (w, bb) in enumerate(chain):
        x = torch.relu(x @ w + bb)
        if li + 1 < len(chain):
            x = round_to(x, compute_dtype)
        acts.append(x)
    return acts


def slab_edge_max_backward_reference(
    table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    out, g, grid_g: int, radius: float, halo: int = 1,
    compute_dtype="bfloat16",
    block_centers: int = DEFAULT_BLOCK_CENTERS,
    pair_chunk: int = 1 << 17,
):
    """Plain PyTorch version of :func:`slab_edge_max_backward`.

    Recomputes the chain on the same pair chunks as
    :func:`slab_edge_max_reference`, gives ``g[k, c]`` to every pair
    whose output equals ``out[k, c]`` (all tied winners; a zero output
    is masked by the last ReLU), backpropagates with explicit products
    (no autograd through a max, whose rule would split ties) and adds
    the table cotangents with ``index_add_``.  Returns ``(d_table_a,
    d_table_b, [(d_w, d_b), ...])`` in float32."""
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    a, b, chain = _rounded_operands(table_a, table_b, weights,
                                    compute_dtype)
    out = out.to(torch.float32)
    g = g.to(torch.float32)
    d_a = torch.zeros_like(a)
    d_b = torch.zeros_like(b)
    d_chain = [(torch.zeros_like(w), torch.zeros_like(bb))
               for w, bb in chain]
    for kc, jc in _pair_chunks(src_xyz, ctr_xyz, win_lo, win_hi,
                               block_centers, radius, pair_chunk):
        acts = _chain_acts(a, b, chain, kc, jc, compute_dtype)
        dy = torch.where(acts[-1] == out[kc], g[kc],
                         torch.zeros((), device=g.device))
        for li in range(len(chain) - 1, -1, -1):
            dz = dy * (acts[li + 1] > 0)
            d_chain[li][0].add_(acts[li].T @ dz)
            d_chain[li][1].add_(dz.sum(0))
            dy = dz @ chain[li][0].T
        dab = dy * (acts[0] > 0)
        d_a.index_add_(0, jc, dab)
        d_b.index_add_(0, kc, dab, alpha=-1.0)
    return d_a, d_b, d_chain


# ---------------------------------------------------------------------------
# the pair list and its chunks (the kernels' work plan)
# ---------------------------------------------------------------------------

PAIR_CHUNK = 64  # pairs per chunk: slab_mma::kChunk in csrc/slab_chain.cuh


def pair_list_reference(src_xyz, ctr_xyz, win_lo, win_hi, bk, radius):
    """Plain version of the kernels' pair list: every in-radius ``(k, j)``
    of the walked windows, grouped by center ``k`` (CSR), rows ascending
    within a center.  Returns ``(row_ptr [K + 1], pair_k, pair_j)``, all
    int32."""
    k_total = ctr_xyz.shape[0]
    dev = src_xyz.device
    ks, js = [], []
    for kk, jj in _inradius_pairs(src_xyz, ctr_xyz, win_lo, win_hi, bk,
                                  radius):
        ks.append(kk)
        js.append(jj)
    kk = torch.cat(ks) if ks else torch.zeros(0, dtype=torch.int64,
                                              device=dev)
    jj = torch.cat(js) if js else torch.zeros(0, dtype=torch.int64,
                                              device=dev)
    order = torch.argsort(kk * max(src_xyz.shape[0], 1) + jj)
    kk, jj = kk[order], jj[order]
    counts = torch.bincount(kk, minlength=k_total)
    row_ptr = torch.zeros(k_total + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return (row_ptr.to(torch.int32), kk.to(torch.int32),
            jj.to(torch.int32))


def pair_list(src_xyz, ctr_xyz, win_lo, win_hi, bk, radius):
    """The CSR pair list of :func:`pair_list_reference`.  On a CUDA
    tensor two kernels build it (``slab_pairs_launch`` in
    ``csrc/slab_edge_max.cu``: a count pass, ``torch.cumsum``, a write
    pass), so its order is the same on every run; on a CPU tensor it is
    the plain version."""
    if src_xyz.device.type == "cpu":
        return pair_list_reference(src_xyz, ctr_xyz, win_lo, win_hi, bk,
                                   radius)
    dev = src_xyz.device
    k, grid_g = ctr_xyz.shape[0], win_lo.shape[1]
    entry = cuda_build.kernel_entry("slab_edge_max", "slab_pairs_launch",
                                    _PAIR_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = torch.empty(max(k, 1), dtype=torch.int32, device=dev)
    ints = dict(dtype=torch.int32, device=dev)

    def run(write, row_ptr, pair_k, pair_j):
        rc = entry(src_xyz.data_ptr(), ctr_xyz.data_ptr(),
                   win_lo.data_ptr(), win_hi.data_ptr(), counts.data_ptr(),
                   row_ptr.data_ptr(), pair_k.data_ptr(), pair_j.data_ptr(),
                   k, grid_g, bk, _radius2(radius), write, dev.index or 0,
                   stream)
        if rc != 0:
            raise RuntimeError("slab pair list kernel launch failed: CUDA "
                               "error %d" % rc)

    empty = torch.zeros(1, **ints)
    run(0, empty, empty, empty)
    row_ptr = torch.zeros(k + 1, **ints)
    row_ptr[1:] = torch.cumsum(counts[:k], 0)
    n = int(row_ptr[-1])
    pair_k = torch.empty(max(n, 1), **ints)
    pair_j = torch.empty(max(n, 1), **ints)
    run(1, row_ptr, pair_k, pair_j)
    return row_ptr, pair_k[:n], pair_j[:n]


def pair_chunks(n_pairs, chunk=PAIR_CHUNK):
    """``[start, end)`` of every chunk of the pair list, in order: the
    kernels cut the list into chunks of ``chunk`` pairs and hand chunk
    ``c`` to CTA ``c mod grid``, so no CTA carries a center block's
    skew."""
    return [(s, min(s + chunk, n_pairs)) for s in range(0, n_pairs, chunk)]


def source_order(pair_j, p_rows):
    """The source-sorted view of the pair list: ``(perm, src_ptr)`` with
    ``perm`` the pair indices in stable row order and ``src_ptr [P + 1]``
    each row's offsets into it (int32), for a fixed-order sum per row."""
    perm = torch.argsort(pair_j, stable=True)
    counts = torch.bincount(pair_j.to(torch.int64), minlength=p_rows)
    src_ptr = torch.zeros(p_rows + 1, dtype=torch.int64,
                          device=pair_j.device)
    src_ptr[1:] = torch.cumsum(counts, 0)
    return perm.to(torch.int32), src_ptr.to(torch.int32)


def pair_stats(src_xyz, ctr_xyz, offsets, center_cell, grid_g, radius,
               halo=1, block_centers=DEFAULT_BLOCK_CENTERS):
    """``(pairs, chunks, heaviest block's pairs)`` of a call's pair list
    (on the inputs' device)."""
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    row_ptr, _, _ = pair_list(src_xyz, ctr_xyz, win_lo, win_hi,
                              block_centers, radius)
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    k = counts.numel()
    nb = -(-k // block_centers)
    per_block = torch.zeros(nb * block_centers, dtype=torch.int64,
                            device=counts.device)
    per_block[:k] = counts
    n = int(row_ptr[-1])
    return n, len(pair_chunks(n)), int(per_block.reshape(nb, -1).sum(1)
                                       .max()) if nb else 0


# ---------------------------------------------------------------------------
# the CUDA kernels: launch (built and loaded by nn/cuda_build.py)
# ---------------------------------------------------------------------------

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PAIR_ARGS = [
    _vp, _vp, _vp, _vp,          # src_xyz, ctr_xyz, win_lo, win_hi
    _vp, _vp, _vp, _vp,          # counts, row_ptr, pair_k, pair_j
    _ci, _ci, _ci, _cf, _ci,     # K, grid_g, bk, r^2, write
    _ci, _vp,                    # device index, stream
]
_FWD_ARGS = [
    _vp, _vp, _vp, _vp, _ci,     # table_a, table_b, weights^T, table, L
    _vp, _vp, _ci,               # pair_k, pair_j, pairs
    _vp, _ci, _ci, _ci,          # out, H, H_out, bf16
    _ci, _vp,                    # device index, stream
]
_BWD_ARGS = [
    _vp, _vp, _vp, _vp,          # table_a, table_b, weights, weights^T
    _vp, _ci, _ci,               # layer table (host), L, n_w
    _vp, _vp, _vp, _vp, _vp, _ci,  # pair_k, pair_j, row_ptr, perm, src_ptr, n
    _vp, _vp,                    # forward out, cotangent
    _vp, _vp,                    # acts, act offsets (host)
    _vp, _vp, _vp,               # dz_last, dz_a, dz_b
    _vp, _ci,                    # dw_part, partial slots
    _vp, _vp, _vp,               # d_a, d_b, d_w
    _ci, _ci, _ci, _ci,          # K, P, H, H_out
    _ci, _vp,                    # device index, stream
]


def _require(cond, msg):
    if not cond:
        raise ValueError("slab_edge_max: " + msg)


def _compute_dtype_name(compute_dtype):
    cd = str(compute_dtype).replace("torch.", "")
    _require(cd in ("bfloat16", "float32"),
             "compute_dtype must be bfloat16 or float32")
    return cd


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


def _cuda_pairs(table_a, src_xyz, ctr_xyz, offsets, center_cell, grid_g,
                radius, halo, block_centers, name):
    if table_a.device.type != "cuda":
        raise ValueError("%s: unsupported device %s"
                         % (name, table_a.device))
    win_lo, win_hi = column_row_windows(
        offsets, center_cell, grid_g, block_centers, halo
    )
    return pair_list(src_xyz, ctr_xyz, win_lo, win_hi, block_centers,
                     radius)


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
    serving path) or "float32" (f32-accurate products)."""
    weights = [tuple(wb) for wb in weights]
    _check_inputs(table_a, src_xyz, table_b, ctr_xyz, offsets,
                  center_cell, weights, grid_g)
    if table_a.device.type == "cpu":
        return slab_edge_max_reference(
            table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
            weights, grid_g, radius, halo, compute_dtype, block_centers,
        )
    cd = _compute_dtype_name(compute_dtype)
    _, pair_k, pair_j = _cuda_pairs(table_a, src_xyz, ctr_xyz, offsets,
                                    center_cell, grid_g, radius, halo,
                                    block_centers, "slab_edge_max")
    k, h = table_b.shape
    h_out = _chain_out_dim(weights, h)
    flat_t, meta_host, _ = cuda_build.flat_chain(weights, cd, table_a.device,
                                                 transpose=True)
    out = torch.zeros((k, h_out), dtype=torch.float32, device=table_a.device)
    stream = torch.cuda.current_stream(table_a.device)
    rc = cuda_build.kernel_entry(
        "slab_edge_max", "slab_edge_max_launch", _FWD_ARGS)(
        table_a.data_ptr(), table_b.data_ptr(), flat_t.data_ptr(),
        ctypes.addressof(meta_host), len(weights), pair_k.data_ptr(),
        pair_j.data_ptr(), pair_k.numel(), out.data_ptr(), h, h_out,
        int(cd == "bfloat16"), table_a.device.index or 0, stream.cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("slab_edge_max kernel launch failed: CUDA "
                           "error %d" % rc)
    slab_edge_max.launches += 1
    return out


slab_edge_max.launches = 0


def slab_edge_max_backward(
    table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    out,            # [K, H_out] float32 forward output of slab_edge_max
    g,              # [K, H_out] float32 cotangent of ``out``
    grid_g: int,
    radius: float,
    halo: int = 1,
    compute_dtype="float32",
    block_centers: int = DEFAULT_BLOCK_CENTERS,
):
    """Backward of :func:`slab_edge_max` in float32 (training's compute
    dtype): ``(d_table_a [P, H], d_table_b [K, H], [(d_w, d_b), ...])``.
    Winners are the pairs whose recomputed output equals ``out`` (pass
    the forward's own output)."""
    _require(_compute_dtype_name(compute_dtype) == "float32",
             "the backward runs in float32 only")
    weights = [tuple(wb) for wb in weights]
    _check_inputs(table_a, src_xyz, table_b, ctr_xyz, offsets,
                  center_cell, weights, grid_g)
    k, h = table_b.shape
    h_out = _chain_out_dim(weights, h)
    for name, t in (("out", out), ("g", g)):
        _require(t.shape == (k, h_out), "%s must be [K, H_out]" % name)
        _require(t.dtype == torch.float32, "%s must be float32" % name)
        _require(t.device == table_a.device,
                 "all inputs must be on %s" % table_a.device)
    if table_a.device.type == "cpu":
        return slab_edge_max_backward_reference(
            table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
            weights, out, g, grid_g, radius, halo, compute_dtype,
            block_centers,
        )
    row_ptr, pair_k, pair_j = _cuda_pairs(
        table_a, src_xyz, ctr_xyz, offsets, center_cell, grid_g, radius,
        halo, block_centers, "slab_edge_max_backward")
    dev = table_a.device
    p = table_a.shape[0]
    n = pair_k.numel()
    perm, src_ptr = source_order(pair_j, p)
    flat_w, meta_host, n_weights = cuda_build.flat_chain(weights,
                                                          "float32", dev)
    flat_t, _, _ = cuda_build.flat_chain(weights, "float32", dev,
                                         transpose=True)
    dims = [h] + [w.shape[1] for w, _ in weights[:-1]]  # layer inputs
    act_off = np.cumsum([0] + [n * d for d in dims[:-1]]) if weights else []
    act_off_host = (ctypes.c_longlong * max(len(weights), 1))(
        *[int(o) for o in act_off])
    n_parts = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    acts = torch.empty(max(n * sum(dims) if weights else 0, 1), **f32)
    dz_last = torch.empty(max(n * h_out, 1), **f32)
    dz_a = torch.empty(max(n * max(dims), 1), **f32)
    dz_b = torch.empty_like(dz_a)
    dw_part = torch.empty(max(n_parts * n_weights, 1), **f32)
    d_w = torch.empty(max(n_weights, 1), **f32)
    d_a = torch.empty((p, h), **f32)
    d_b = torch.empty((k, h), **f32)
    g = g.contiguous()
    out = out.contiguous()
    stream = torch.cuda.current_stream(dev)
    rc = cuda_build.kernel_entry(
        "slab_edge_max_bwd", "slab_edge_max_bwd_launch", _BWD_ARGS)(
        table_a.data_ptr(), table_b.data_ptr(), flat_w.data_ptr(),
        flat_t.data_ptr(), ctypes.addressof(meta_host), len(weights),
        n_weights, pair_k.data_ptr(), pair_j.data_ptr(), row_ptr.data_ptr(),
        perm.data_ptr(), src_ptr.data_ptr(), n, out.data_ptr(),
        g.data_ptr(), acts.data_ptr(), ctypes.addressof(act_off_host),
        dz_last.data_ptr(), dz_a.data_ptr(), dz_b.data_ptr(),
        dw_part.data_ptr(), n_parts, d_a.data_ptr(), d_b.data_ptr(),
        d_w.data_ptr(), k, p, h, h_out, dev.index or 0, stream.cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("slab_edge_max_backward kernel launch failed: "
                           "CUDA error %d" % rc)
    slab_edge_max_backward.launches += 1
    d_chain, off = [], 0
    for w, b in weights:
        dw = d_w[off:off + w.numel()].view(w.shape)
        off += w.numel()
        db = d_w[off:off + b.numel()].view(b.shape)
        off += b.numel()
        d_chain.append((dw, db))
    return d_a, d_b, d_chain


slab_edge_max_backward.launches = 0


class _SlabEdgeMaxTrain(torch.autograd.Function):
    """Forward :func:`slab_edge_max`, backward
    :func:`slab_edge_max_backward`; the chain arrives flattened as
    ``w_0, b_0, w_1, b_1, ...`` after the static options."""

    @staticmethod
    def forward(ctx, table_a, src_xyz, table_b, ctr_xyz, offsets,
                center_cell, opts, *flat):
        weights = list(zip(flat[0::2], flat[1::2]))
        out = slab_edge_max(table_a, src_xyz, table_b, ctr_xyz, offsets,
                            center_cell, weights, **opts)
        ctx.save_for_backward(table_a, src_xyz, table_b, ctr_xyz, offsets,
                              center_cell, out, *flat)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        (table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell, out,
         *flat) = ctx.saved_tensors
        weights = list(zip(flat[0::2], flat[1::2]))
        d_a, d_b, d_chain = slab_edge_max_backward(
            table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
            weights, out, g.to(torch.float32).contiguous(), **ctx.opts,
        )
        d_flat = [t for wb in d_chain for t in wb]
        # coordinates and cell metadata are graph structure: no gradient
        return (d_a, None, d_b, None, None, None, None, *d_flat)


def slab_edge_max_train(
    table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    grid_g: int,
    radius: float,
    halo: int = 1,
    compute_dtype="bfloat16",
    block_centers: int = DEFAULT_BLOCK_CENTERS,
):
    """Differentiable :func:`slab_edge_max` for the training path: the
    same forward; gradients reach ``table_a``, ``table_b`` and the chain
    weights through :func:`slab_edge_max_backward`, which runs in
    float32 only (the backward raises for another compute dtype)."""
    opts = dict(grid_g=grid_g, radius=radius, halo=halo,
                compute_dtype=compute_dtype, block_centers=block_centers)
    flat = [t for wb in weights for t in wb]
    return _SlabEdgeMaxTrain.apply(table_a, src_xyz, table_b, ctr_xyz,
                                   offsets, center_cell, opts, *flat)
