"""Point-cloud container (copy of :mod:`pointgnn_tpu.core.points`):
``xyz`` is an ``[N, 3]`` float array, ``attr`` an optional ``[N, C]``
array of per-point attributes (reflectance, RGB, ...)."""

from typing import NamedTuple, Optional

import numpy as np


class Points(NamedTuple):
    xyz: np.ndarray
    attr: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.xyz.shape[0])

    def mask(self, keep: np.ndarray) -> "Points":
        """Select a subset of points by boolean mask or index array."""
        attr = self.attr[keep] if self.attr is not None else None
        return Points(xyz=self.xyz[keep], attr=attr)

    def concat(self, other: "Points") -> "Points":
        if (self.attr is None) != (other.attr is None):
            raise ValueError("cannot concat Points with and without attr")
        attr = (
            np.concatenate([self.attr, other.attr], axis=0)
            if self.attr is not None
            else None
        )
        return Points(
            xyz=np.concatenate([self.xyz, other.xyz], axis=0), attr=attr
        )
