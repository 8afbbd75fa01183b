"""Multi-level proximity graph built on the host (counterpart of
:mod:`pointgnn_tpu.graph.builder`), under the reference's registry names.

``gen_multi_level_local_graph_v3`` downsamples the points into the
configured scales (random point per voxel, or voxel averages snapped to
the nearest point) and links each level's points to the next level's
centers by a radius search (:mod:`pointgnn_tpu_torch.graph.radius`).
Every random draw comes from the one ``rng`` in the JAX package's order,
so the same generator state gives the same graph bit for bit.
"""

from typing import List, Optional

import numpy as np

from pointgnn_tpu_torch.graph import radius as radius_search
from pointgnn_tpu_torch.graph import voxel


def gen_disjointed_rnn_local_graph_v3(
    points_xyz: np.ndarray,
    center_xyz: np.ndarray,
    radius: float,
    num_neighbors: int,
    neighbors_downsample_method: str = "random",
    scale=None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Radius-neighbor edges: [E, 2] int64 (point_index, center_index)."""
    if neighbors_downsample_method != "random":
        raise ValueError("unknown neighbors_downsample_method: %s"
                         % neighbors_downsample_method)
    if scale is not None:
        scale = np.asarray(scale)
        points_xyz = points_xyz / scale
        center_xyz = center_xyz / scale
    edges = radius_search.radius_neighbors(
        points_xyz, center_xyz, radius, num_neighbors=num_neighbors, rng=rng
    )
    return edges.astype(np.int64)


def gen_multi_level_local_graph_v3(
    points_xyz: np.ndarray,
    base_voxel_size: float,
    level_configs: List[dict],
    add_rnd3d: bool = False,
    downsample_method: str = "random",
    rng: Optional[np.random.Generator] = None,
):
    """``(vertex_coord_list, keypoint_indices_list, edges_list)``: level
    i's edges link ``vertex_coord_list[graph_level]`` (points) to
    ``vertex_coord_list[graph_level + 1]`` (centers)."""
    if rng is None:
        rng = np.random.default_rng()
    if isinstance(base_voxel_size, list):
        base_voxel_size = np.array(base_voxel_size)
    scales = [cfg["graph_scale"] for cfg in level_configs]
    downsample = {
        "center": voxel.multi_level_downsample_select,
        "random": voxel.multi_level_downsample_random,
    }.get(downsample_method)
    if downsample is None:
        raise ValueError("unknown downsample_method: %s" % downsample_method)
    vertex_coord_list, keypoint_indices_list = downsample(
        points_xyz, base_voxel_size, scales, add_rnd3d=add_rnd3d, rng=rng
    )
    edges_list = []
    for cfg in level_configs:
        graph_level = cfg["graph_level"]
        gen_graph_fn = get_graph_generate_fn(cfg["graph_gen_method"])
        edges_list.append(gen_graph_fn(
            vertex_coord_list[graph_level],
            vertex_coord_list[graph_level + 1],
            rng=rng, **cfg["graph_gen_kwargs"],
        ))
    return vertex_coord_list, keypoint_indices_list, edges_list


_GRAPH_FNS = {
    "disjointed_rnn_local_graph_v3": gen_disjointed_rnn_local_graph_v3,
    "multi_level_local_graph_v3": gen_multi_level_local_graph_v3,
}


def get_graph_generate_fn(method_name: str):
    return _GRAPH_FNS[method_name]
