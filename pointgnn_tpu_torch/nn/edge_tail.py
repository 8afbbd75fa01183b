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

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/edge_tail_max.cu``, ``csrc/fused_edge_max.cu``, sharing
``csrc/edge_tail.cuh``) or raises; on a CPU tensor it runs the plain
PyTorch version.  Inference only: the TPU kernels have no backward.
"""

import ctypes
from typing import Sequence, Tuple

import torch

from pointgnn_tpu_torch.nn import cuda_build
from pointgnn_tpu_torch.nn.mlp import round_to

NEG = -1e30
BLOCK_CENTERS = 32   # centers per CTA; also sizes the kernels' shared memory
ROW_CHUNK = 1 << 17  # rows in flight in the plain versions

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_TAIL_ARGS = [
    _vp, _vp, _vp, _vp,          # gathered, table_b, valid, weights
    _vp, _ci, _vp,               # layer table (host), layers, out
    _ci, _ci, _ci, _ci, _ci,     # K, S, H, H_out, bk
    _ci, _ci,                    # bf16, act_first
    _ci, _vp,                    # device index, stream
]
_FUSED_ARGS = [
    _vp, _vp, _vp, _vp, _vp,     # table_a, edges, table_b, valid, weights
    _vp, _ci, _vp,               # layer table (host), layers, out
    _ci, _ci, _ci, _ci, _ci,     # K, S, H, H_out, bk
    _ci, _ci, _ci,               # rows of A, bf16, act_first
    _ci, _vp,                    # device index, stream
]


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


def _launch(name, symbol, argtypes, args):
    rc = cuda_build.kernel_entry(name, symbol, argtypes)(*args)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))


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
    k, s, h, h_out = _check(name, gathered, table_b, slot_valid, weights)
    _require(name, gathered.shape[0] == k * s, "gathered must be [K * S, H]")
    cd = _compute_dtype(name, gathered)
    dev = gathered.device
    if dev.type == "cpu":
        return edge_tail_max_reference(gathered, table_b, slot_valid,
                                       weights, apply_act_first)
    _require(name, dev.type == "cuda", "unsupported device %s" % dev)
    flat_w, meta_host, _ = cuda_build.flat_chain(weights, cd, dev)
    out = torch.empty((k, h_out), dtype=torch.float32, device=dev)
    _launch(name, "edge_tail_max_launch", _TAIL_ARGS, (
        gathered.data_ptr(), table_b.data_ptr(), slot_valid.data_ptr(),
        flat_w.data_ptr(), ctypes.addressof(meta_host), len(weights),
        out.data_ptr(), k, s, h, h_out, BLOCK_CENTERS,
        int(cd == "bfloat16"), int(apply_act_first), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    edge_tail_max.launches += 1
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
    k, s, h, h_out = _check(name, table_a, table_b, slot_valid, weights,
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
    flat_w, meta_host, _ = cuda_build.flat_chain(weights, cd, dev)
    out = torch.empty((k, h_out), dtype=torch.float32, device=dev)
    _launch(name, "fused_edge_max_launch", _FUSED_ARGS, (
        table_a.data_ptr(), edges_src.data_ptr(), table_b.data_ptr(),
        slot_valid.data_ptr(), flat_w.data_ptr(),
        ctypes.addressof(meta_host), len(weights), out.data_ptr(),
        k, s, h, h_out, BLOCK_CENTERS, table_a.shape[0],
        int(cd == "bfloat16"), int(apply_act_first), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    fused_edge_max.launches += 1
    return out


fused_edge_max.launches = 0
