"""Edge-list inference tail: masked per-center max of a dense chain.

Counterpart of ``edge_tail_max`` and ``fused_edge_max`` in
:mod:`pointgnn_tpu.nn.pallas_kernels`.  Edges come in the device
builder's blocked SRC-sentinel layout: slot ``(c, s)`` of center ``c``
holds one source row, and ``slot_valid[c, s] > 0`` marks a real edge::

    x      = act(row(c, s) - B[c])            act = ReLU or identity
    x      = relu(x @ W_l + b_l)              for each chain layer
    out[c] = max over valid slots of x        (0 where none is valid)

:func:`edge_tail_max` (K3) takes the rows pre-gathered, ``G[c * S + s]
= A[min(src, N-1)]``; :func:`fused_edge_max` (K4) takes ``A`` and
``edges_src`` and gathers inside (an out-of-range source, the sentinel,
is clamped; its slot is masked).  Both compute the same function.

Rounding points, as in the TPU kernels (they differ from
``slab_edge_max``'s): the compute dtype is the dtype of the rows (bf16
or f32); ``B`` is in that dtype, and the weights and biases are rounded
to it; ``row - B`` is rounded to it; each layer accumulates in f32, adds
the bias in f32, applies ReLU and is rounded to the compute dtype, the
last layer too; the masked max is taken in f32.  An empty chain is
legal (``H_out = H``).

On a CUDA tensor each wrapper launches its hand-written kernels
(``csrc/edge_tail_max.cu``, ``csrc/fused_edge_max.cu``, sharing
``csrc/edge_tail.cuh``) or raises; on a CPU tensor it runs the plain
PyTorch version.  The kernels first list the valid slots as (center,
row) pairs in center order (:func:`tail_pair_list`: a count pass,
``torch.cumsum`` and a write pass, all on the card) and then run the
chain over chunks of :data:`PAIR_CHUNK` pairs spread evenly over the
SMs, so a center with many valid slots does not hold up the call.
Inference only: the TPU kernels have no backward.
"""

import ctypes
from typing import Sequence, Tuple

import torch

from pointgnn_tpu_torch.nn import cuda_build
from pointgnn_tpu_torch.nn.mlp import round_to
# pairs per chunk of the plan, shared with the slab kernels
from pointgnn_tpu_torch.nn.slab import PAIR_CHUNK  # noqa: F401

NEG = -1e30
ROW_CHUNK = 1 << 17  # rows in flight in the plain versions

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_PAIR_ARGS = [
    _vp, _vp, _vp, _vp,          # valid, edges, counts, row_ptr
    _vp, _vp, _vp,               # pair_k, pair_r, out
    _ci, _ci, _ci, _ci, _ci,     # K, S, H_out, rows of A, write
    _ci, _vp,                    # device index, stream
]
_CHAIN_ARGS = [
    _vp, _vp, _vp, _vp, _ci,     # rows, table_b, weights^T, table, L
    _vp, _vp, _vp, _ci,          # pair_k, pair_r, pair count, capacity
    _vp, _ci, _ci, _ci,          # out, K, H, H_out
    _ci, _ci,                    # bf16, act_first
    _ci, _vp,                    # device index, stream
]
# kernel name -> (pair-list entry, chain entry)
_ENTRIES = {
    "edge_tail_max": ("edge_tail_pairs_launch", "edge_tail_max_launch"),
    "fused_edge_max": ("fused_edge_pairs_launch", "fused_edge_max_launch"),
}


def _require(name, cond, msg):
    if not cond:
        raise ValueError("%s: %s" % (name, msg))


def _compute_dtype(name, rows):
    _require(name, rows.dtype in (torch.bfloat16, torch.float32),
             "rows must be bfloat16 or float32 (the compute dtype)")
    return str(rows.dtype).replace("torch.", "")


def _check(name, rows, table_b, slot_valid, weights, extra=()):
    """Common checks; returns ``(K, S, H, H_out)``."""
    dev = rows.device
    for t in (rows, table_b, slot_valid, *extra,
              *[x for wb in weights for x in wb]):
        _require(name, t.device == dev, "all inputs must be on %s" % dev)
        _require(name, t.is_contiguous(), "inputs must be contiguous")
    _require(name, rows.ndim == 2, "rows must be [rows, H]")
    h = rows.shape[1]
    _require(name, table_b.ndim == 2 and table_b.shape[1] == h,
             "table_b must be [K, H]")
    _require(name, table_b.dtype == rows.dtype,
             "table_b must have the rows' dtype")
    k = table_b.shape[0]
    _require(name, slot_valid.ndim == 2 and slot_valid.shape[0] == k,
             "slot_valid must be [K, S]")
    _require(name, slot_valid.dtype == torch.float32,
             "slot_valid must be float32")
    _require(name, len(weights) <= cuda_build.MAX_LAYERS,
             "at most %d chain layers" % cuda_build.MAX_LAYERS)
    din = h
    for w, b in weights:
        _require(name, w.ndim == 2 and w.shape[0] == din,
                 "chain widths differ")
        _require(name, b.shape == (w.shape[1],), "bias width differs")
        din = w.shape[1]
    return k, slot_valid.shape[1], h, din


def _tail_max(rows_of, table_b, slot_valid, weights, compute_dtype,
              apply_act_first):
    """The plain masked max, ``rows_of(c0, c1)`` giving the float32 rows
    of centers ``[c0, c1)`` as ``[(c1 - c0) * S, H]``."""
    k, h = table_b.shape
    s = slot_valid.shape[1]
    b = table_b.to(torch.float32)
    chain = [(round_to(w.to(torch.float32), compute_dtype),
              round_to(bb.to(torch.float32), compute_dtype))
             for w, bb in weights]
    h_out = chain[-1][0].shape[1] if chain else h
    out = torch.zeros((k, h_out), dtype=torch.float32, device=b.device)
    step = max(1, ROW_CHUNK // max(s, 1))
    for c0 in range(0, k, step):
        c1 = min(k, c0 + step)
        x = rows_of(c0, c1).reshape(c1 - c0, s, h) - b[c0:c1, None, :]
        x = round_to(x, compute_dtype).reshape(-1, h)
        if apply_act_first:
            x = torch.relu(x)
        for w, bb in chain:
            x = round_to(torch.relu(x @ w + bb), compute_dtype)
        x = torch.where(slot_valid[c0:c1, :, None] > 0,
                        x.reshape(c1 - c0, s, h_out),
                        torch.full((), NEG, device=x.device))
        agg = x.amax(dim=1)
        out[c0:c1] = torch.where(agg > NEG / 2, agg,
                                 torch.zeros((), device=x.device))
    return out


def edge_tail_max_reference(
    gathered, table_b, slot_valid,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    apply_act_first: bool = True,
):
    """Plain PyTorch version of :func:`edge_tail_max`: the chain on every
    slot (valid or not, as the TPU kernel) with the kernels' rounding
    points, then the masked max, ``ROW_CHUNK`` rows at a time."""
    k = table_b.shape[0]
    s = slot_valid.shape[1]
    cd = _compute_dtype("edge_tail_max", gathered)

    def rows_of(c0, c1):
        return gathered[c0 * s:c1 * s].to(torch.float32)

    _require("edge_tail_max", gathered.shape[0] == k * s,
             "gathered must be [K * S, H]")
    return _tail_max(rows_of, table_b, slot_valid, weights, cd,
                     apply_act_first)


def fused_edge_max_reference(
    table_a, table_b, edges_src, slot_valid,
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    apply_act_first: bool = True,
):
    """Plain PyTorch version of :func:`fused_edge_max`: the gather
    ``A[clamp(src, 0, rows - 1)]`` per chunk of centers, then
    :func:`edge_tail_max_reference`'s arithmetic, so both plain versions
    give the same output on ``G = A[clamp(src)]``."""
    cd = _compute_dtype("fused_edge_max", table_a)
    idx = edges_src.to(torch.int64).clamp(0, table_a.shape[0] - 1)

    def rows_of(c0, c1):
        return table_a.index_select(0, idx[c0:c1].reshape(-1)).to(
            torch.float32)

    return _tail_max(rows_of, table_b, slot_valid, weights, cd,
                     apply_act_first)


# ---------------------------------------------------------------------------
# the valid-slot pair list (the kernels' work plan)
# ---------------------------------------------------------------------------


def tail_pair_list_reference(slot_valid, edges_src=None, n_rows_a=None):
    """Plain version of the kernels' pair list: every valid slot ``(c,
    s)`` as the pair ``(c, row)``, in center order and slots ascending
    within a center, with ``row = c * S + s`` (K3's row of ``G``) or,
    given ``edges_src``, ``clamp(src[c, s], 0, n_rows_a - 1)`` (K4's row
    of ``A``).  Returns ``(row_ptr [K + 1], pair_k, pair_r)``, int32."""
    k, s = slot_valid.shape
    hit = (slot_valid > 0).reshape(-1)
    t = torch.nonzero(hit).reshape(-1)
    pair_k = torch.div(t, max(s, 1), rounding_mode="floor")
    if edges_src is None:
        pair_r = t
    else:
        pair_r = edges_src.reshape(-1).to(torch.int64)[t].clamp(
            0, n_rows_a - 1)
    row_ptr = torch.zeros(k + 1, dtype=torch.int64, device=slot_valid.device)
    row_ptr[1:] = torch.cumsum(hit.reshape(k, s).sum(1), 0)
    return (row_ptr.to(torch.int32), pair_k.to(torch.int32),
            pair_r.to(torch.int32))


def _card_pair_list(name, slot_valid, edges_src, n_rows_a, out=None):
    """The pair list built on the card at its capacity ``K * S``, with no
    host sync: ``(row_ptr, pair_k, pair_r)``, the pair count in
    ``row_ptr[K]``.  Sets ``out`` (where given) to the "no value" key."""
    dev = slot_valid.device
    k, s = slot_valid.shape
    entry = cuda_build.kernel_entry(name, _ENTRIES[name][0], _PAIR_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ints = dict(dtype=torch.int32, device=dev)
    counts = torch.empty(max(k, 1), **ints)
    row_ptr = torch.zeros(k + 1, **ints)
    pair_k = torch.empty(max(k * s, 1), **ints)
    pair_r = torch.empty(max(k * s, 1), **ints)
    h_out = out.shape[1] if out is not None else 1

    def run(write):
        rc = entry(slot_valid.data_ptr(),
                   edges_src.data_ptr() if edges_src is not None else None,
                   counts.data_ptr(), row_ptr.data_ptr(), pair_k.data_ptr(),
                   pair_r.data_ptr(),
                   out.data_ptr() if out is not None else None,
                   k, s, h_out, n_rows_a, write, dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError("%s pair list kernel launch failed: CUDA "
                               "error %d" % (name, rc))

    run(0)
    torch.cumsum(counts[:k], 0, dtype=torch.int32, out=row_ptr[1:])
    run(1)
    return row_ptr, pair_k, pair_r


def tail_pair_list(slot_valid, edges_src=None, n_rows_a=None):
    """The pair list of :func:`tail_pair_list_reference`.  On a CUDA
    tensor the kernels build it (K3's without ``edges_src``, K4's with
    it), in the same order on every run; on a CPU tensor it is the plain
    version."""
    name = "edge_tail_max" if edges_src is None else "fused_edge_max"
    _require(name, slot_valid.ndim == 2 and
             slot_valid.dtype == torch.float32,
             "slot_valid must be [K, S] float32")
    if edges_src is not None:
        _require(name, edges_src.shape == slot_valid.shape and
                 edges_src.dtype == torch.int32 and
                 edges_src.device == slot_valid.device,
                 "edges_src must be [K, S] int32 beside slot_valid")
        _require(name, n_rows_a is not None and n_rows_a > 0,
                 "n_rows_a must be the rows of table_a")
    if slot_valid.device.type == "cpu":
        return tail_pair_list_reference(slot_valid, edges_src, n_rows_a)
    row_ptr, pair_k, pair_r = _card_pair_list(
        name, slot_valid.contiguous(),
        None if edges_src is None else edges_src.contiguous(),
        1 if n_rows_a is None else n_rows_a)
    n = int(row_ptr[-1])
    return row_ptr, pair_k[:n], pair_r[:n]


def _tail_on_card(name, rows, table_b, slot_valid, edges_src, weights, cd,
                  apply_act_first):
    """Pair list, chain and max of one K3 or K4 call on the card."""
    dev = rows.device
    k, s = slot_valid.shape
    h = table_b.shape[1]
    h_out = weights[-1][0].shape[1] if weights else h
    if k == 0 or s == 0:
        return torch.zeros((k, h_out), dtype=torch.float32, device=dev)
    flat_t, meta_host, _ = cuda_build.flat_chain(weights, cd, dev,
                                                 transpose=True)
    out = torch.empty((k, h_out), dtype=torch.float32, device=dev)
    row_ptr, pair_k, pair_r = _card_pair_list(name, slot_valid, edges_src,
                                              rows.shape[0], out)
    rc = cuda_build.kernel_entry(name, _ENTRIES[name][1], _CHAIN_ARGS)(
        rows.data_ptr(), table_b.data_ptr(), flat_t.data_ptr(),
        ctypes.addressof(meta_host), len(weights), pair_k.data_ptr(),
        pair_r.data_ptr(), row_ptr.data_ptr() + 4 * k, k * s,
        out.data_ptr(), k, h, h_out, int(cd == "bfloat16"),
        int(apply_act_first), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
    return out


def edge_tail_max(
    gathered,       # [K*S, H] table_a[min(src, N-1)], compute dtype
    table_b,        # [K, H] compute dtype
    slot_valid,     # [K, S] float32 (1 = real edge)
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # tail (w, b)
    apply_act_first: bool = True,
):
    """``act(G - B[dst])`` -> dense chain -> masked max over slots;
    returns [K, H_out] float32.  The compute dtype is ``gathered``'s."""
    name = "edge_tail_max"
    weights = [tuple(wb) for wb in weights]
    k, s, _, _ = _check(name, gathered, table_b, slot_valid, weights)
    _require(name, gathered.shape[0] == k * s, "gathered must be [K * S, H]")
    cd = _compute_dtype(name, gathered)
    dev = gathered.device
    if dev.type == "cpu":
        return edge_tail_max_reference(gathered, table_b, slot_valid,
                                       weights, apply_act_first)
    _require(name, dev.type == "cuda", "unsupported device %s" % dev)
    out = _tail_on_card(name, gathered, table_b, slot_valid, None, weights,
                        cd, apply_act_first)
    cuda_build.count_launch(edge_tail_max)
    return out


edge_tail_max.launches = 0


def fused_edge_max(
    table_a,        # [N, H] compute dtype
    table_b,        # [K, H] compute dtype
    edges_src,      # [K, S] int32 source rows (N = sentinel)
    slot_valid,     # [K, S] float32 (1 = real edge)
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # tail (w, b)
    apply_act_first: bool = True,
):
    """:func:`edge_tail_max` with the gather ``A[clamp(src)]`` inside the
    kernel; returns [K, H_out] float32."""
    name = "fused_edge_max"
    weights = [tuple(wb) for wb in weights]
    k, s, _, _ = _check(name, table_a, table_b, slot_valid, weights,
                        extra=(edges_src,))
    _require(name, edges_src.shape == (k, s) and
             edges_src.dtype == torch.int32,
             "edges_src must be [K, S] int32")
    _require(name, table_a.shape[0] > 0, "table_a has no rows")
    cd = _compute_dtype(name, table_a)
    dev = table_a.device
    if dev.type == "cpu":
        return fused_edge_max_reference(table_a, table_b, edges_src,
                                        slot_valid, weights, apply_act_first)
    _require(name, dev.type == "cuda", "unsupported device %s" % dev)
    out = _tail_on_card(name, table_a, table_b, slot_valid, edges_src,
                        weights, cd, apply_act_first)
    cuda_build.count_launch(fused_edge_max)
    return out


fused_edge_max.launches = 0
