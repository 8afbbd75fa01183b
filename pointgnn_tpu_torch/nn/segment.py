"""Segment aggregations over padded, sentinel-terminated edge lists
(counterpart of :mod:`pointgnn_tpu.nn.segment`).

The padded edge layout (:mod:`pointgnn_tpu_torch.graph.pad`) puts the
real edges first and gives padded edges the destination
``num_centers``, so a reduction into ``num_centers + 1`` segments routes
every padded edge into the last segment, which is dropped.  Empty real
segments become 0.

The max is ``Tensor.scatter_reduce(..., "amax", include_self=False)``
into a ``-inf`` buffer: its gradient splits the cotangent evenly among
tied winners, as the gradient of ``jax.ops.segment_max`` does.  The
torch reductions take destinations in any order, so the JAX functions'
``sorted`` flag has no counterpart.

:func:`chunked_aggregate` keeps the JAX function's chunk boundaries and
carry: a ``-inf`` start, then ``torch.maximum(carry, part)`` per chunk,
in order (a tie between chunks splits 0.5 / 0.5 before the split within
a chunk, as ``jnp.maximum`` does), and each chunk's body runs under
``torch.utils.checkpoint`` (``jax.checkpoint``'s remat), so the backward
holds ``E / num_chunks`` edge rows at a time too.

Padded edges (destination ``num_centers``) reach only the dropped
segment, and on the card every one of them would land on that
segment's atomics (the host-padded runtime graph is more than half
padding).  So, unlike the JAX function, :func:`chunked_aggregate` leaves
them out.  It relies on the padded layout putting every real edge before
the padding (``graph/pad.py``; the device builder's ``"src"`` layout
pads no destination: its pad slots carry a real destination and a
sentinel source, so every slot runs and the layers mask the pad slots to
the identity), counts the real edges once, and stops there: one block
runs ``edge_fn`` on that prefix; of several blocks, those past it are
skipped, and the one it ends in runs ``edge_fn`` on the whole block, as
JAX does, and reduces the block's real prefix.  Every block that runs
keeps the block shape, so identical edge rows in two blocks come out of
the same arithmetic and still tie exactly.  An edge function that
normalizes over its rows (``coupled_rows``: instance norm, batch norm)
sees what the JAX function gives it: one block runs it on the whole edge
list, padding included, and reduces the real prefix; a skipped block's
rows reach only the dropped segment and normalize among themselves.
"""

import torch
from torch.utils.checkpoint import checkpoint


def _index(edges_dst, values):
    return edges_dst.to(torch.int64)[:, None].expand(values.shape)


def _max_segments(values, edges_dst, num_segments):
    """[num_segments, C] per-segment max; empty segments stay -inf."""
    out = torch.full((num_segments, values.shape[1]), float("-inf"),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, _index(edges_dst, values), values, "amax",
                              include_self=False)


def _sum_segments(values, edges_dst, num_segments):
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, edges_dst.to(torch.int64), values)


def _finite_or_zero(agg):
    return torch.where(torch.isfinite(agg), agg, torch.zeros((), dtype=agg.dtype,
                                                             device=agg.device))


def segment_max(edge_features, edges_dst, num_centers: int):
    """[E, C] features, [E] destinations -> [num_centers, C]; empty
    segments yield 0."""
    agg = _max_segments(edge_features, edges_dst, num_centers + 1)
    return _finite_or_zero(agg[:num_centers])


def segment_sum(edge_features, edges_dst, num_centers: int):
    return _sum_segments(edge_features, edges_dst, num_centers + 1)[
        :num_centers]


def segment_mean(edge_features, edges_dst, num_centers: int):
    s = _sum_segments(edge_features, edges_dst, num_centers + 1)
    ones = torch.ones((edge_features.shape[0], 1), dtype=edge_features.dtype,
                      device=edge_features.device)
    c = _sum_segments(ones, edges_dst, num_centers + 1)
    return (s / torch.clamp(c, min=1.0))[:num_centers]


AGGREGATIONS = {
    "max": segment_max,
    "sum": segment_sum,
    "mean": segment_mean,
}


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward when grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def chunked_aggregate(
    edge_fn,
    edges_src,
    edges_dst,
    num_centers: int,
    out_dim: int,
    aggregation: str,
    num_chunks: int,
    dtype=torch.float32,
    coupled_rows: bool = False,
):
    """``agg(edge_fn(src, dst))`` over ``num_chunks`` consecutive blocks of
    the edge list, each block's edge rows recomputed in the backward.

    ``edge_fn(src [B], dst [B]) -> [B, out_dim]`` gathers and transforms
    one block.  With ``num_chunks <= 1`` or ``E % num_chunks != 0`` the
    whole list is one block, as in the JAX function.  Real edges come
    first (see the module docstring): edges past the last one with a
    destination below ``num_centers`` are not reduced.  ``coupled_rows``:
    ``edge_fn`` normalizes over its rows, so one block runs it on the
    whole list."""
    E = edges_src.shape[0]
    # the one host sync: where the real prefix ends
    n_real = int((edges_dst < num_centers).sum())
    if num_chunks <= 1 or E % num_chunks != 0:
        rows = E if coupled_rows else n_real

        def whole(src, dst):
            h = edge_fn(src, dst)[:n_real]
            return AGGREGATIONS[aggregation](h, dst[:n_real], num_centers)

        return _remat(whole, edges_src[:rows], edges_dst[:rows])
    block = E // num_chunks
    src_chunks = edges_src.reshape(num_chunks, block)
    dst_chunks = edges_dst.reshape(num_chunks, block)
    # (src, dst, rows to reduce) of every block that holds a real edge
    blocks = [(src_chunks[i], dst_chunks[i], min(block, n_real - i * block))
              for i in range(-(-n_real // block))]
    n_seg = num_centers + 1
    dev = edges_src.device

    if aggregation == "max":
        def body(src, dst, rows):
            h = edge_fn(src, dst).to(dtype)
            return _max_segments(h[:rows], dst[:rows], n_seg)

        agg = torch.full((n_seg, out_dim), float("-inf"), dtype=dtype,
                         device=dev)
        for b in blocks:
            agg = torch.maximum(agg, _remat(body, *b))
        return _finite_or_zero(agg[:num_centers])

    if aggregation not in ("sum", "mean"):
        raise ValueError("unknown aggregation %s" % aggregation)

    def body(src, dst, rows):
        ef, d = edge_fn(src, dst).to(dtype)[:rows], dst[:rows]
        ones = torch.ones((rows, 1), dtype=dtype, device=dev)
        return (_sum_segments(ef, d, n_seg),
                _sum_segments(ones, d, n_seg))

    vals = torch.zeros((n_seg, out_dim), dtype=dtype, device=dev)
    counts = torch.zeros((n_seg, 1), dtype=dtype, device=dev)
    for b in blocks:
        v, c = _remat(body, *b)
        vals, counts = vals + v, counts + c
    if aggregation == "sum":
        return vals[:num_centers]
    return (vals / torch.clamp(counts, min=1.0))[:num_centers]
