"""Class label maps (copy of the maps in :mod:`pointgnn_tpu.data.labels`).

Every class splits into a horizontal id ``c`` and a vertical id
``c + 1``; 0 is background and ``num_classes - 1`` is DontCare.
"""

from typing import Dict

LABEL_MAP_YAW: Dict[str, int] = {
    "Background": 0,
    "Car": 1,
    "Pedestrian": 3,
    "Cyclist": 5,
    "DontCare": 7,
}
LABEL_MAP_CAR: Dict[str, int] = {"Background": 0, "Car": 1, "DontCare": 3}
LABEL_MAP_PED_CYC: Dict[str, int] = {
    "Background": 0,
    "Pedestrian": 1,
    "Cyclist": 3,
    "DontCare": 5,
}

# label_method name (config "label_method") -> (label_map, num_classes)
LABEL_METHODS = {
    "yaw": (LABEL_MAP_YAW, 8),
    "Car": (LABEL_MAP_CAR, 4),
    "Pedestrian_and_Cyclist": (LABEL_MAP_PED_CYC, 6),
}
