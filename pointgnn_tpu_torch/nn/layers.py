"""Graph layers (counterpart of :mod:`pointgnn_tpu.nn.layers`), on the
slab, the edge-list and the generic segment paths.

- :class:`PointSetPooling`: raw points -> keypoint features, through
  ``slab_edge_max`` at level 0 (slab metadata given) or through
  ``fused_edge_max`` over the level-0 edge list (``pallas_tail``), then
  the output MLP.
- :class:`GraphNetAutoCenter`: auto-offset MLP, the A/B fold of the
  first edge-MLP layer, ``slab_edge_max`` or ``fused_edge_max`` at level
  1, the update MLP and the residual.
- :class:`ClassAwarePredictor`: shared class head + per-class box heads
  (``separated``: each box head reads its own slice of the features).

The fold: ``concat(feat_j, x_j - x_k) @ W0 + b0 == A[j] - B[k]`` with
``A = feat @ W0a + x @ W0b + b0`` and ``B = x_k @ W0b``, so the kernels
only gather rows of A.  The edge-list branch takes the device builder's
blocked SRC-sentinel layout (``edge_sentinel="src"``: slot ``(c, s)``
belongs to center ``c``, pad slots carry ``src == N``) and calls
``fused_edge_max``, which gathers ``A[min(src, N-1)]`` inside the
kernel.  The JAX layer gathers with XLA and calls ``edge_tail_max``:
the same function, but on the card the fused kernel is faster than the
gather and ``edge_tail_max`` together (``chip_smoke.py`` phase 8).  In
training (``slab["train"]`` set) the slab layers call the differentiable
``slab_edge_max_train``: gradients reach the kernel's tail weights, and
through the folded tables ``W0``, ``b0``, the features and the
auto-offset MLP; the coordinates of the radius test get none.
Everything else takes the generic segment path, as in the JAX layers:
host-built graphs (``edge_sentinel="dst"``: padded edges carry the
destination ``K``), and device-built edge lists without the tail
(``"src"``: the sentinel slots are masked to ``-inf``), which is how
edge-list training runs.  Its edge function is the GNN layer's fold
``act(A[src] - B[dst])`` followed by the rest of the edge MLP (NONE
normalization), the GNN layer's MLP over ``concat(feat[src], xyz[src] -
shifted[dst])`` (any other normalization), or the pooling layer's MLP
over ``concat(feat[src], xyz[src] - ctr[dst])``; the per-center
aggregation is :func:`~pointgnn_tpu_torch.nn.segment.chunked_aggregate`
(``edge_chunks`` blocks, each recomputed in the backward).  The JAX
layers' other max, a reshape of a blocked edge list to ``[K, S]``
(``blocked_edges``), has no caller there and is not ported.

Normalized MLPs (``nn/mlp.py``) run on the segment path only: the slab
layers raise, and the tail is skipped.  Each MLP normalizes over its
valid rows (the vertex or center mask; on edges, slots whose source and
destination are both real), and a batch norm of an edge MLP needs the
whole edge list in one block (``edge_chunks=1``).  ``bn_use_stored``,
``bn_collect`` and ``bn_prefix`` carry the batch norms' mode and their
statistics' keys (paths into the parameters) down to each MLP.
"""

from typing import Optional

import torch

from pointgnn_tpu_torch.nn import edge_tail, mlp, segment, slab as slab_ops


def _fast_path_ok(agg, norm, act):
    return agg == "max" and norm == "NONE" and act == "ReLU"


def _check_slab(agg, norm, act):
    if not _fast_path_ok(agg, norm, act):
        raise ValueError(
            "slab mode requires max aggregation, NONE normalization and "
            "ReLU activation; got agg=%r norm=%r act=%r" % (agg, norm, act)
        )


def _tail_applies(pallas_tail, edge_sentinel, edges_src, num_centers, agg,
                  norm, act):
    """The JAX layers' condition for the edge-list tail; anything else
    without slab metadata takes the generic segment path."""
    return bool(pallas_tail and edge_sentinel == "src"
                and edges_src is not None
                and _fast_path_ok(agg, norm, act)
                and edges_src.shape[0] % num_centers == 0)


def _rows(table, index):
    """``table[index]`` as ``index_select``, whose backward is an
    ``index_add`` (the backward of ``table[index]`` sorts the indices
    first: most of a host-graph train step on the card)."""
    return torch.index_select(table, 0, index)


def _apply_sentinel(edge_fn, edge_sentinel, num_src, agg_name):
    """Adapt an edge function to the graph's padding convention: "dst"
    (host-padded graphs) leaves it, the segment reduction drops the
    padded edges; "src" (device-built graphs, pad slots carry ``src ==
    num_src`` and a valid destination) masks those slots to the
    aggregation's identity."""
    if edge_sentinel == "dst":
        return edge_fn
    if edge_sentinel != "src":
        raise ValueError("unknown edge_sentinel %r" % (edge_sentinel,))
    fill = float("-inf") if agg_name == "max" else 0.0

    def masked_fn(src, dst):
        h = edge_fn(torch.clamp(src, max=num_src - 1), dst)
        return torch.where((src >= num_src)[:, None],
                           torch.full((), fill, dtype=h.dtype,
                                      device=h.device), h)

    return masked_fn


def _segment_agg(edge_fn, edges_src, edges_dst, num_src, num_centers,
                 out_dim, agg_name, edge_sentinel, edge_chunks, dtype,
                 coupled_rows=False):
    """The generic segment path: ``edge_fn`` over the edge list, then the
    chunked per-center segment reduction (``coupled_rows``: the edge
    MLP normalizes over its block's rows)."""
    src, dst = edges_src.to(torch.int64), edges_dst.to(torch.int64)
    edge_fn = _apply_sentinel(edge_fn, edge_sentinel, num_src, agg_name)
    return segment.chunked_aggregate(
        edge_fn, src, dst, num_centers, out_dim=out_dim,
        aggregation=agg_name, num_chunks=edge_chunks, dtype=dtype,
        coupled_rows=coupled_rows,
    )


def _edge_bn_mask(norm, edge_chunks, edges_src, edges_dst, num_src,
                  num_centers):
    """The rows a batch norm of an edge MLP counts (real source and
    destination), or None for other normalizations.  Its statistics are
    over the whole edge list, so it runs in one block."""
    if norm not in mlp.BN_TYPES:
        return None
    if edge_chunks > 1:
        raise ValueError(
            "a batch norm in an edge MLP needs edge_chunks=1: chunks would "
            "take its statistics per chunk (PointGNN sets this itself)")
    return (edges_src < num_src) & (edges_dst < num_centers)


def _tail_agg(tail, table_a, table_b, edges_src, compute_dtype):
    """The per-center max of the edge MLP's tail over the blocked edge
    list: mask the sentinel slots, then K4, which gathers ``A[min(src,
    N-1)]`` inside the kernel (the same output as the gather followed by
    K3, bit for bit, without the ``[K * S, H]`` row table)."""
    cd = mlp.as_compute_dtype(compute_dtype) or torch.float32
    n, k = table_a.shape[0], table_b.shape[0]
    src = edges_src.to(torch.int32).reshape(k, -1).contiguous()
    slot_valid = (src < n).to(torch.float32)
    weights = [(layer["w"], layer["b"]) for layer in tail]
    return edge_tail.fused_edge_max(table_a.to(cd).contiguous(),
                                    table_b.to(cd).contiguous(), src,
                                    slot_valid, weights)


def _xyz4(xyz, mask, sentinel):
    """[N, 4] float32 coordinates with pad rows set to ``sentinel``."""
    pad = torch.zeros((xyz.shape[0], 1), dtype=torch.float32,
                      device=xyz.device)
    xyz4 = torch.cat([xyz.to(torch.float32), pad], dim=1)
    return torch.where(mask[:, None], xyz4,
                       torch.full((), sentinel, device=xyz.device))


def _folded_tables(first, features, src_xyz, ctr_xyz, compute_dtype):
    """A = feat @ W0a + x @ W0b + b0 and B = x_ctr @ W0b, rounded through
    the compute dtype and kept float32."""
    w0, b0 = first["w"], first["b"]
    c = features.shape[1]
    w0b = w0[c:]
    table_a = features @ w0[:c] + src_xyz.to(w0.dtype) @ w0b + b0
    table_b = ctr_xyz.to(w0.dtype) @ w0b
    return (
        mlp.round_to(table_a, compute_dtype).contiguous(),
        mlp.round_to(table_b, compute_dtype).contiguous(),
    )


def _slab_agg(tail, table_a, src4, table_b, ctr4, slab, compute_dtype):
    cd = mlp.as_compute_dtype(compute_dtype) or torch.float32
    weights = [(layer["w"], layer["b"]) for layer in tail]
    fn = (slab_ops.slab_edge_max_train if slab.get("train")
          else slab_ops.slab_edge_max)
    return fn(
        table_a, src4, table_b, ctr4,
        slab["offsets"], slab["center_cell"], weights,
        grid_g=slab["grid_g"], radius=slab["radius"],
        halo=slab.get("halo", 1),
        compute_dtype=str(cd).replace("torch.", ""),
        block_centers=slab.get("block_centers",
                               slab_ops.DEFAULT_BLOCK_CENTERS),
    )


class PointSetPooling:
    """Downsampling layer: raw points -> keypoint set features."""

    def __init__(self, aggregation: str = "max"):
        self._agg_name = aggregation

    def apply(
        self,
        params,
        point_features,     # [P, C]
        point_xyz,          # [P, 3]
        center_xyz,         # [K, 3]
        center_mask=None,   # [K]
        point_mask=None,    # [P] (slab mode only)
        edges_src=None,     # [E] -> points
        edges_dst=None,     # [E] -> centers
        point_MLP_normalization_type="NONE",
        point_MLP_activation_type="ReLU",
        output_MLP_normalization_type="NONE",
        output_MLP_activation_type="ReLU",
        compute_dtype=None,
        edge_chunks=1,
        edge_sentinel="dst",
        pallas_tail=False,
        slab=None,
        bn_use_stored=False,
        bn_collect=None,
        bn_prefix=(),
        **_unused,
    ):
        num_src, num_centers = point_xyz.shape[0], center_xyz.shape[0]
        dev = point_xyz.device
        pp = params["point_mlp"]
        bn = dict(bn_use_stored=bn_use_stored, bn_collect=bn_collect)
        edge_bn_mask = _edge_bn_mask(
            point_MLP_normalization_type, edge_chunks, edges_src, edges_dst,
            num_src, num_centers)
        if slab is not None:
            _check_slab(self._agg_name, point_MLP_normalization_type,
                        point_MLP_activation_type)
            table_a, table_b = _folded_tables(
                pp[0], point_features, point_xyz, center_xyz, compute_dtype
            )
            p_mask = (point_mask.to(torch.bool) if point_mask is not None
                      else torch.ones(num_src, dtype=torch.bool, device=dev))
            c_mask = (center_mask.to(torch.bool) if center_mask is not None
                      else torch.ones(num_centers, dtype=torch.bool,
                                      device=dev))
            agg = _slab_agg(
                pp[1:], table_a, _xyz4(point_xyz, p_mask, 1e6),
                table_b, _xyz4(center_xyz, c_mask, -1e6), slab,
                compute_dtype,
            )
        elif _tail_applies(pallas_tail, edge_sentinel, edges_src,
                           num_centers, self._agg_name,
                           point_MLP_normalization_type,
                           point_MLP_activation_type):
            table_a, table_b = _folded_tables(
                pp[0], point_features, point_xyz, center_xyz, compute_dtype
            )
            agg = _tail_agg(pp[1:], table_a, table_b, edges_src,
                            compute_dtype)
        else:
            def edge_fn(src, dst_raw):
                # relative coordinates to the set's keypoint
                dst = torch.clamp(dst_raw, max=num_centers - 1)
                sf = _rows(point_features, src)
                rel = _rows(point_xyz, src) - _rows(center_xyz, dst)
                edge_in = torch.cat([sf, rel.to(sf.dtype)], dim=-1)
                # a batch norm sees the whole edge list: the mask is
                # the list's
                return mlp.apply_mlp(
                    pp, edge_in, is_logits=False,
                    normalization_type=point_MLP_normalization_type,
                    activation_type=point_MLP_activation_type,
                    compute_dtype=compute_dtype, mask=edge_bn_mask,
                    bn_prefix=bn_prefix + ("point_mlp",), **bn,
                )

            agg = _segment_agg(
                edge_fn, edges_src, edges_dst, num_src, num_centers,
                pp[-1]["w"].shape[1], self._agg_name, edge_sentinel,
                edge_chunks,
                mlp.as_compute_dtype(compute_dtype) or point_features.dtype,
                coupled_rows=point_MLP_normalization_type != "NONE",
            )
        agg = agg.to(point_features.dtype)
        out = mlp.apply_mlp(
            params["output_mlp"], agg, is_logits=False,
            normalization_type=output_MLP_normalization_type,
            activation_type=output_MLP_activation_type,
            mask=center_mask, compute_dtype=compute_dtype,
            bn_prefix=bn_prefix + ("output_mlp",), **bn,
        )
        if center_mask is not None:
            out = out * center_mask[:, None].to(out.dtype)
        return out


class GraphNetAutoCenter:
    """GNN layer with auto-registration and residual update."""

    def __init__(self, aggregation: str = "max"):
        self._agg_name = aggregation

    def apply(
        self,
        params,
        vertex_features,    # [N, C]
        vertex_xyz,         # [N, 3]
        vertex_mask=None,   # [N]
        edges_src=None,     # [E] -> vertices
        edges_dst=None,     # [E] -> vertices
        edge_MLP_normalization_type="NONE",
        edge_MLP_activation_type="ReLU",
        update_MLP_normalization_type="NONE",
        update_MLP_activation_type="ReLU",
        auto_offset=False,
        auto_offset_MLP_normalization_type="NONE",
        auto_offset_MLP_feature_activation_type="ReLU",
        compute_dtype=None,
        edge_chunks=1,
        edge_sentinel="dst",
        pallas_tail=False,
        slab=None,
        bn_use_stored=False,
        bn_collect=None,
        bn_prefix=(),
        **_unused,
    ):
        n = vertex_features.shape[0]
        bn = dict(bn_use_stored=bn_use_stored, bn_collect=bn_collect)
        edge_norm = edge_MLP_normalization_type
        edge_bn_mask = _edge_bn_mask(edge_norm, edge_chunks, edges_src,
                                     edges_dst, n, n)
        if slab is not None:
            _check_slab(self._agg_name, edge_norm, edge_MLP_activation_type)
        tail = slab is None and _tail_applies(
            pallas_tail, edge_sentinel, edges_src, n, self._agg_name,
            edge_norm, edge_MLP_activation_type)
        # auto-registration offsets shift only the center coordinates
        if auto_offset:
            offset = mlp.apply_mlp(
                params["auto_offset_mlp"], vertex_features, is_logits=True,
                normalization_type=auto_offset_MLP_normalization_type,
                activation_type=auto_offset_MLP_feature_activation_type,
                mask=vertex_mask, compute_dtype=compute_dtype,
                bn_prefix=bn_prefix + ("auto_offset_mlp",), **bn,
            )
            shifted_xyz = vertex_xyz + offset.to(vertex_xyz.dtype)
        else:
            shifted_xyz = vertex_xyz
        ep = params["edge_mlp"]
        act = mlp.ACTIVATIONS[edge_MLP_activation_type]
        if edge_norm != "NONE":
            # a normalization between the layers stops the fold: the
            # edge MLP runs on concat(feat[src], xyz[src] - shifted[dst]),
            # the source side on the unshifted coordinates (the slab and
            # tail branches below need NONE)
            def edge_fn(src, dst_raw):
                dst = torch.clamp(dst_raw, max=n - 1)
                s_feat = _rows(vertex_features, src)
                rel = _rows(vertex_xyz, src) - _rows(shifted_xyz, dst)
                edge_in = torch.cat([s_feat, rel.to(s_feat.dtype)], dim=-1)
                # a batch norm sees the whole edge list: the mask is
                # the list's
                return mlp.apply_mlp(
                    ep, edge_in, is_logits=False,
                    normalization_type=edge_norm,
                    activation_type=edge_MLP_activation_type,
                    compute_dtype=compute_dtype, mask=edge_bn_mask,
                    bn_prefix=bn_prefix + ("edge_mlp",), **bn,
                )
        else:
            table_a, table_b = _folded_tables(
                ep[0], vertex_features, vertex_xyz, shifted_xyz,
                compute_dtype)

            def edge_fn(src, dst_raw):
                dst = torch.clamp(dst_raw, max=n - 1)
                h = _rows(table_a, src) - _rows(table_b, dst)
                if act is not None:
                    h = act(h)
                for layer in ep[1:]:
                    h = mlp.dense(layer, h, compute_dtype)
                    if act is not None:
                        h = act(h)
                return h

        if slab is not None:
            maskb = (vertex_mask.to(torch.bool) if vertex_mask is not None
                     else torch.ones(n, dtype=torch.bool,
                                     device=vertex_xyz.device))
            # the distance test uses the unshifted coordinates on both
            # sides
            agg = _slab_agg(
                ep[1:], table_a, _xyz4(vertex_xyz, maskb, 1e6),
                table_b, _xyz4(vertex_xyz, maskb, -1e6), slab,
                compute_dtype,
            )
        elif tail:
            agg = _tail_agg(ep[1:], table_a, table_b, edges_src,
                            compute_dtype)
        else:
            agg = _segment_agg(
                edge_fn, edges_src, edges_dst, n, n, ep[-1]["w"].shape[1],
                self._agg_name, edge_sentinel, edge_chunks,
                mlp.as_compute_dtype(compute_dtype) or vertex_features.dtype,
                coupled_rows=edge_norm != "NONE",
            )
        agg = agg.to(vertex_features.dtype)
        update = mlp.apply_mlp(
            params["update_mlp"], agg, is_logits=True,
            normalization_type=update_MLP_normalization_type,
            activation_type=update_MLP_activation_type,
            mask=vertex_mask, compute_dtype=compute_dtype,
            bn_prefix=bn_prefix + ("update_mlp",), **bn,
        )
        out = update + vertex_features
        if vertex_mask is not None:
            out = out * vertex_mask[:, None].to(out.dtype)
        return out


class ClassAwarePredictor:
    """Shared cls head + per-class loc heads; ``separated``: the features
    split into ``num_classes`` equal slices, class ``c``'s box head reads
    slice ``c``."""

    def __init__(self, cls_Ks=(64,), loc_Ks=(64, 64), separated=False):
        self.cls_Ks = tuple(cls_Ks)
        self.loc_Ks = tuple(loc_Ks)
        self.separated = separated

    def loc_in_dim(self, in_dim: int, num_classes: int) -> int:
        """The input width of each box head."""
        if not self.separated:
            return in_dim
        if in_dim % num_classes:
            raise ValueError(
                "the separated predictor splits %d features over %d "
                "classes" % (in_dim, num_classes))
        return in_dim // num_classes

    def apply(
        self,
        params,
        features,           # [N, C]
        num_classes: int,
        normalization_type="NONE",
        activation_type="ReLU",
        vertex_mask=None,
        compute_dtype=None,
        bn_use_stored=False,
        bn_collect=None,
        bn_prefix=(),
        **_unused,
    ):
        """Returns ``(logits [N, C], box_encodings [N, C, L])``."""
        kw = dict(is_logits=True, normalization_type=normalization_type,
                  activation_type=activation_type, mask=vertex_mask,
                  compute_dtype=compute_dtype, bn_use_stored=bn_use_stored,
                  bn_collect=bn_collect)
        logits = mlp.apply_fc(params["cls"], features,
                              bn_prefix=bn_prefix + ("cls",), **kw)
        if self.separated:
            width = self.loc_in_dim(features.shape[1], num_classes)
            inputs = torch.split(features, width, dim=-1)
        else:
            inputs = [features] * num_classes
        boxes = [
            mlp.apply_fc(params["loc"][ci], inputs[ci],
                         bn_prefix=bn_prefix + ("loc", ci), **kw)
            for ci in range(num_classes)
        ]
        return logits, torch.stack(boxes, dim=1)


def predictor_widths(predictor_type: str) -> Optional[dict]:
    """The predictor arguments of the types the reference registers."""
    return {
        "classaware_predictor": dict(cls_Ks=(64,), loc_Ks=(64, 64)),
        "classaware_predictor_128": dict(cls_Ks=(128,), loc_Ks=(128, 128)),
        "classaware_separated_predictor": dict(
            cls_Ks=(64,), loc_Ks=(64, 64), separated=True),
    }.get(predictor_type)
