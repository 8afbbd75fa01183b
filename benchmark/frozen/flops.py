"""Frozen yardstick arithmetic: useful forward FLOPs of a Point-GNN frame
and the least time of one ``slab_edge_max`` (K1) call.

``pointgnn_forward_flops`` is a copy of the program's
``pointgnn_tpu_torch/utils/flops.py`` function of that name: the folded
formulation the layers compute (per-vertex A/B projections, the rest of
the edge MLP on every in-radius pair, the per-vertex update, output and
predictor MLPs), fed with exact in-radius pair counts.

``k1_bound`` is ``chip_smoke.bound`` for a forward call, written over the
call's shapes instead of its tensors: the larger of the call's unique
bytes over the memory rate and the operations its pairs need over the
peak rate.  The peaks are NVIDIA's data sheet figures for one H100 SXM
(dense, no sparsity), at the full 700 W power limit.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def dense_chain_flops(rows, dims):
    """2 * rows * sum(d_i * d_{i+1}): a multiply-add counts as 2."""
    return 2.0 * rows * float(sum(a * b for a, b in zip(dims[:-1], dims[1:])))


def _gnn_layer_flops(k, pairs, in_dim, kw):
    edge = list(kw["edge_MLP_depth_list"])
    update = list(kw["update_MLP_depth_list"])
    f = 0.0
    if kw.get("auto_offset"):
        f += dense_chain_flops(k, [in_dim] + list(kw["auto_offset_MLP_depth_list"]))
    f += dense_chain_flops(k, [in_dim, edge[0]])
    f += 2 * dense_chain_flops(k, [3, edge[0]])
    f += dense_chain_flops(pairs, edge)
    f += dense_chain_flops(k, [edge[-1]] + update)
    return f


def _pooling_layer_flops(p, k, pairs, in_dim, kw):
    point = list(kw["point_MLP_depth_list"])
    out = list(kw["output_MLP_depth_list"])
    f = dense_chain_flops(p, [in_dim, point[0]])
    f += dense_chain_flops(p, [3, point[0]])
    f += dense_chain_flops(k, [3, point[0]])
    f += dense_chain_flops(pairs, point)
    f += dense_chain_flops(k, [point[-1]] + out)
    return f


def pointgnn_forward_flops(config, input_dim, num_points, num_keypoints,
                           pairs_l0, pairs_l1, cls_ks=(64,), loc_ks=(64, 64),
                           box_encoding_len=7):
    """Useful forward FLOPs of one frame through the configured model."""
    nc = config["num_classes"]
    total = 0.0
    feat_dim = input_dim
    for lc in config["model_kwargs"]["layer_configs"]:
        kw = lc["kwargs"]
        if lc["type"] == "scatter_max_point_set_pooling":
            total += _pooling_layer_flops(num_points, num_keypoints, pairs_l0,
                                          feat_dim, kw)
            feat_dim = kw["output_MLP_depth_list"][-1]
        elif lc["type"] == "scatter_max_graph_auto_center_net":
            total += _gnn_layer_flops(num_keypoints, pairs_l1, feat_dim, kw)
            feat_dim = kw["update_MLP_depth_list"][-1]
        elif "predictor" in lc["type"]:
            total += dense_chain_flops(num_keypoints,
                                       [feat_dim] + list(cls_ks) + [nc])
            loc_in = feat_dim // nc if "separated" in lc["type"] else feat_dim
            total += nc * dense_chain_flops(
                num_keypoints, [loc_in] + list(loc_ks) + [box_encoding_len])
    return total


def k1_bound(pairs, n_src, n_ctr, h, tail_dims, n_cells, peak_flops):
    """Least time (s) of one forward ``slab_edge_max`` call and what bounds
    it.  ``tail_dims`` are the widths of the chain after the folded first
    layer (``[h, d1, ..., d_out]``); the tables are float32 ``[n_src, h]``
    and ``[n_ctr, h]``, the coordinates ``[n, 4]`` float32, the offsets
    ``n_cells + 1`` int32, the output ``[n_ctr, d_out]`` float32."""
    flops = 2 * h  # relu(a - b)
    n_bytes = 0
    for din, dout in zip(tail_dims[:-1], tail_dims[1:]):
        flops += 2 * din * dout + 2 * dout
        n_bytes += 4 * (din * dout + dout)
    flops *= pairs
    n_bytes += 4 * n_src * h + 16 * n_src      # table_a, src_xyz
    n_bytes += 4 * n_ctr * h + 16 * n_ctr      # table_b, ctr_xyz
    n_bytes += 4 * (n_cells + 1) + 4 * n_ctr   # offsets, center_cell
    n_bytes += 4 * n_ctr * tail_dims[-1]       # out
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, n_bytes
