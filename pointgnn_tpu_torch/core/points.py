"""Point-cloud container (copy of :mod:`pointgnn_tpu.core.points`):
``xyz`` is an ``[N, 3]`` float array, ``attr`` an optional ``[N, C]``
array of per-point attributes (reflectance, RGB, ...)."""

from typing import NamedTuple, Optional

import numpy as np


class Points(NamedTuple):
    xyz: np.ndarray
    attr: Optional[np.ndarray] = None

    def mask(self, keep: np.ndarray) -> "Points":
        """Select a subset of points by boolean mask or index array."""
        attr = self.attr[keep] if self.attr is not None else None
        return Points(xyz=self.xyz[keep], attr=attr)
