"""Static-shape graphs (counterpart of :mod:`pointgnn_tpu.graph.pad`).

:class:`PaddedGraph` holds one padded multi-level graph, with the JAX
container's field names.  The host-built graph is padded here, in numpy,
as the JAX package pads it:

- vertex levels padded to ``capacity.vertices[i]`` with a float32 mask;
- edge lists padded to ``capacity.edges[i]``, padded edges carrying the
  destination level's capacity ``K`` as a sentinel destination (the
  segment reduction drops segment ``K``);
- labels, encoded boxes and box validity padded along the last level;
- overflow truncates vertices, then drops the edges of each center with
  the highest ranks first (balanced truncation), with a warning through
  :mod:`~pointgnn_tpu_torch.utils.thread_warnings`.

:func:`batch_and_pad` returns a :class:`PaddedGraph` of numpy arrays;
:func:`to_device` puts it on a device (int32 edges, float32 masks).
"""

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.utils import thread_warnings


class GraphCapacity(NamedTuple):
    """Static capacities: vertices per level (L+1) and edges per level
    (L)."""

    vertices: Tuple[int, ...]
    edges: Tuple[int, ...]

    @property
    def num_levels(self) -> int:
        return len(self.edges)

    def scaled(self, factor: int) -> "GraphCapacity":
        return GraphCapacity(
            vertices=tuple(v * factor for v in self.vertices),
            edges=tuple(e * factor for e in self.edges),
        )


class FrameData(NamedTuple):
    """Ragged per-frame arrays, the host pipeline's output."""

    features: np.ndarray                 # [P0, C]
    vertex_coord_list: List[np.ndarray]  # [L+1][Pi, 3]
    keypoint_indices_list: List[np.ndarray]  # [L][Ki, 1]
    edges_list: List[np.ndarray]         # [L][Ei, 2]
    cls_labels: Optional[np.ndarray] = None       # [K_last, 1]
    encoded_boxes: Optional[np.ndarray] = None    # [K_last, 1, 7]
    valid_boxes: Optional[np.ndarray] = None      # [K_last, 1, 1]


class PaddedGraph(NamedTuple):
    """One padded multi-level graph.  In slab mode the edge lists are
    1-element dummies: the slab metadata replaces them."""

    features: torch.Tensor                     # [P0, C] float32
    vertex_xyz: Tuple[torch.Tensor, ...]       # [L+1][Pi, 3] float32
    vertex_mask: Tuple[torch.Tensor, ...]      # [L+1][Pi] float32
    keypoint_indices: Tuple[torch.Tensor, ...]  # [L][K(i+1)] int32
    edges_src: Tuple[torch.Tensor, ...]        # [L][Ei] int32
    edges_dst: Tuple[torch.Tensor, ...]        # [L][Ei] int32
    cls_labels: torch.Tensor                   # [K_last] int32
    encoded_boxes: torch.Tensor                # [K_last, 7] float32
    valid_boxes: torch.Tensor                  # [K_last] float32
    # slab level 1: cell row offsets + per-keypoint cell ids
    slab_offsets: Optional[torch.Tensor] = None      # [g*g+1] int32
    slab_center_cell: Optional[torch.Tensor] = None  # [K1] int32
    # slab level 0: offsets index point rows; center cells are the
    # keypoints' cells on the level-0 grid
    slab0_offsets: Optional[torch.Tensor] = None      # [g0*g0+1] int32
    slab0_center_cell: Optional[torch.Tensor] = None  # [K1] int32

    @property
    def num_levels(self) -> int:
        return len(self.edges_src)


def to_device(graph: PaddedGraph, device) -> PaddedGraph:
    """A numpy-valued :class:`PaddedGraph` as torch tensors on
    ``device``."""
    def put(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(put(y) for y in x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return PaddedGraph(*[put(x) for x in graph])


def _pad_rows(arr: np.ndarray, size: int, fill=0):
    """Pad or truncate the leading dim of ``arr`` to ``size``; returns
    the array and the count of real rows."""
    n = arr.shape[0]
    if n >= size:
        return arr[:size], min(n, size)
    pad_shape = (size - n,) + arr.shape[1:]
    return (
        np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], 0),
        n,
    )


def _balanced_truncate_edges(
    edges: np.ndarray, cap: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Drop edges above ``cap`` keeping per-center balance: rank each
    edge within its (grouped) center, keep the globally lowest ranks,
    restore the grouped order.  ``rng`` is accepted for the JAX signature
    and unused."""
    if len(edges) <= cap:
        return edges
    dst = edges[:, 1]
    group_start = np.ones(len(dst), dtype=bool)
    group_start[1:] = dst[1:] != dst[:-1]
    first = np.flatnonzero(group_start)
    group_idx = np.cumsum(group_start) - 1
    rank = np.arange(len(dst)) - first[group_idx]
    keep = np.argsort(rank, kind="stable")[:cap]
    keep.sort()  # restores grouped-by-center order
    return edges[keep]


def pad_frame(
    frame: FrameData,
    capacity: GraphCapacity,
    rng: Optional[np.random.Generator] = None,
) -> PaddedGraph:
    return batch_and_pad([frame], capacity, rng)


def _bucket(n: int, headroom: float, multiple: int) -> int:
    """``n`` x headroom rounded up to ``multiple``: the capacity rounding
    of :func:`suggest_capacity` and :func:`grow_to_fit`."""
    return int(np.ceil(n * headroom / multiple) * multiple)


def suggest_capacity(
    frames: Sequence[FrameData],
    headroom: float = 1.25,
    multiple: int = 1024,
) -> GraphCapacity:
    """A capacity from sample frames: the largest counts x headroom,
    rounded up to ``multiple``."""
    num_levels = len(frames[0].edges_list)
    vertices = tuple(
        _bucket(max(f.vertex_coord_list[li].shape[0] for f in frames),
                headroom, multiple)
        for li in range(num_levels + 1)
    )
    edges = tuple(
        _bucket(max(f.edges_list[li].shape[0] for f in frames),
                headroom, multiple)
        for li in range(num_levels)
    )
    return GraphCapacity(vertices=vertices, edges=edges)


def grow_to_fit(
    capacity: GraphCapacity,
    frames: Sequence[FrameData],
    headroom: float = 1.25,
    multiple: int = 4096,
) -> Tuple[GraphCapacity, bool]:
    """``(capacity, grew)``: the capacity enlarged (never shrunk) so the
    union of ``frames`` fits without truncation.  A level grows only when
    it overflows, to the headroomed bucket of its need."""
    num_levels = capacity.num_levels
    # the union holds all frames at once: sums, not maxima
    need_v = [sum(f.vertex_coord_list[li].shape[0] for f in frames)
              for li in range(num_levels + 1)]
    need_e = [sum(f.edges_list[li].shape[0] for f in frames)
              for li in range(num_levels)]
    vertices = tuple(
        max(c, _bucket(n, headroom, multiple)) if n > c else c
        for c, n in zip(capacity.vertices, need_v)
    )
    edges = tuple(
        max(c, _bucket(n, headroom, multiple)) if n > c else c
        for c, n in zip(capacity.edges, need_e)
    )
    grew = vertices != tuple(capacity.vertices) or edges != tuple(
        capacity.edges)
    if grew:
        capacity = GraphCapacity(vertices=vertices, edges=edges)
    return capacity, grew


def batch_and_pad(
    frames: Sequence[FrameData],
    capacity: GraphCapacity,
    rng: Optional[np.random.Generator] = None,
) -> PaddedGraph:
    """Graph-union batching (offset indices) and capacity padding: one
    disjoint graph covering all frames, numpy-valued."""
    num_levels = capacity.num_levels
    for f in frames:
        if len(f.edges_list) != num_levels:
            raise ValueError("frame has %d edge levels, capacity %d"
                             % (len(f.edges_list), num_levels))

    # ---- union with offsets ---------------------------------------------
    vertex_levels = [
        np.concatenate([f.vertex_coord_list[li] for f in frames], 0)
        for li in range(num_levels + 1)
    ]
    keypoint_levels, edge_levels = [], []
    for li in range(num_levels):
        kp_parts, e_parts = [], []
        point_off = center_off = 0
        for f in frames:
            kp = f.keypoint_indices_list[li].reshape(-1)
            e = f.edges_list[li]
            kp_parts.append(kp + point_off)
            e_parts.append(
                np.stack([e[:, 0] + point_off, e[:, 1] + center_off], 1))
            point_off += f.vertex_coord_list[li].shape[0]
            center_off += kp.shape[0]
        keypoint_levels.append(np.concatenate(kp_parts, 0))
        # center offsets increase, so the union stays grouped by center
        edge_levels.append(np.concatenate(e_parts, 0))

    features = np.concatenate([f.features for f in frames], 0)
    has_labels = frames[0].cls_labels is not None
    if has_labels:
        cls_labels = np.concatenate(
            [f.cls_labels.reshape(-1) for f in frames], 0)
        encoded_boxes = np.concatenate(
            [f.encoded_boxes.reshape(-1, 7) for f in frames], 0)
        valid_boxes = np.concatenate(
            [f.valid_boxes.reshape(-1) for f in frames], 0)

    # ---- capacity truncation (vertices first, then dependents) ----------
    caps_v = capacity.vertices
    for li in range(num_levels + 1):
        nv = vertex_levels[li].shape[0]
        if nv > caps_v[li]:
            thread_warnings.warn(
                "vertex overflow at level %d: %d > capacity %d; "
                "truncating (detections may be lost: raise the "
                "GraphCapacity for this workload)" % (li, nv, caps_v[li]),
                RuntimeWarning,
                stacklevel=2,
            )
            vertex_levels[li] = vertex_levels[li][: caps_v[li]]
    for li in range(num_levels):
        nv_src = vertex_levels[li].shape[0]
        nv_dst = vertex_levels[li + 1].shape[0]
        # keypoints align with the next level's vertices: truncate to
        # the surviving count and clamp dangling references
        kp = keypoint_levels[li][:nv_dst]
        keypoint_levels[li] = np.clip(kp, 0, max(nv_src - 1, 0))
        e = edge_levels[li]
        e = e[(e[:, 0] < nv_src) & (e[:, 1] < nv_dst)]
        if len(e) > capacity.edges[li]:
            thread_warnings.warn(
                "edge overflow at level %d: %d > capacity %d; dropping "
                "%d edges (balanced per center). Aggregated features "
                "shift when the model was trained on uncapped "
                "neighborhoods; raise GraphCapacity.edges for this "
                "workload"
                % (li, len(e), capacity.edges[li],
                   len(e) - capacity.edges[li]),
                RuntimeWarning,
                stacklevel=2,
            )
        edge_levels[li] = _balanced_truncate_edges(e, capacity.edges[li], rng)
    features = features[: caps_v[0]]

    # ---- pad to capacity -------------------------------------------------
    out_xyz, out_mask = [], []
    for li in range(num_levels + 1):
        padded, n = _pad_rows(vertex_levels[li].astype(np.float32),
                              caps_v[li])
        mask = np.zeros((caps_v[li],), np.float32)
        mask[:n] = 1.0
        out_xyz.append(padded)
        out_mask.append(mask)
    out_kp, out_esrc, out_edst = [], [], []
    for li in range(num_levels):
        kp, _ = _pad_rows(keypoint_levels[li].astype(np.int32),
                          caps_v[li + 1])
        out_kp.append(kp)
        e = edge_levels[li].astype(np.int32)
        ne = e.shape[0]
        cap_e = capacity.edges[li]
        src = np.zeros((cap_e,), np.int32)
        dst = np.full((cap_e,), caps_v[li + 1], np.int32)  # sentinel
        src[:ne] = e[:, 0]
        dst[:ne] = e[:, 1]
        out_esrc.append(src)
        out_edst.append(dst)

    feat, _ = _pad_rows(features.astype(np.float32), caps_v[0])
    k_last = caps_v[-1]
    if has_labels:
        cls_p, _ = _pad_rows(cls_labels.astype(np.int32), k_last)
        box_p, _ = _pad_rows(encoded_boxes.astype(np.float32), k_last)
        val_p, _ = _pad_rows(valid_boxes.astype(np.float32), k_last)
    else:
        cls_p = np.zeros((k_last,), np.int32)
        box_p = np.zeros((k_last, 7), np.float32)
        val_p = np.zeros((k_last,), np.float32)

    return PaddedGraph(
        features=feat,
        vertex_xyz=tuple(out_xyz),
        vertex_mask=tuple(out_mask),
        keypoint_indices=tuple(out_kp),
        edges_src=tuple(out_esrc),
        edges_dst=tuple(out_edst),
        cls_labels=cls_p,
        encoded_boxes=box_p,
        valid_boxes=val_p,
    )
