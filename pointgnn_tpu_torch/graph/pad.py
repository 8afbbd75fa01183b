"""Static-shape graph container (counterpart of
:class:`pointgnn_tpu.graph.pad.PaddedGraph`, with torch tensor fields of
the same names) and the per-level capacities of a config family."""

from typing import NamedTuple, Optional, Tuple

import torch


class GraphCapacity(NamedTuple):
    """Static capacities: vertices per level and edges per level."""

    vertices: Tuple[int, ...]
    edges: Tuple[int, ...]


class PaddedGraph(NamedTuple):
    """One padded two-level graph.  In slab mode the edge lists are
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
