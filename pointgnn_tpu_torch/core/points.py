"""Point-cloud container (copy of :mod:`pointgnn_tpu.core.points`):
``xyz`` is an ``[N, 3]`` float array, ``attr`` an optional ``[N, C]``
array of per-point attributes (reflectance, RGB, ...)."""

from typing import NamedTuple, Optional

import numpy as np


class Points(NamedTuple):
    xyz: np.ndarray
    attr: Optional[np.ndarray] = None
