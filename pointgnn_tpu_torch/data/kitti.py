"""KITTI 3D-object dataset reader (copy of
:mod:`pointgnn_tpu.data.kitti`), with the class-aware label assigners in
method form.

Velodyne ``.bin`` point loading, calibration parsing (object and raw
recordings) and the velo->rect->cam->image chain (with its sanity
check), label parsing and formatting with per-difficulty filtering,
camera-frustum point selection, per-point RGB attachment, every
coordinate transform, voxel downsampling, box selection and per-class
statistics.  Images are read with
:func:`pointgnn_tpu_torch.data.png.read_png` (BGR, as ``cv2.imread``
gives them).
"""

import os
from typing import Dict, List, Optional

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.data import labels as label_lib
from pointgnn_tpu_torch.data.png import read_png
from pointgnn_tpu_torch.graph import voxel

# KITTI difficulty thresholds: index 0/1/2 = easy/moderate/hard.
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)

_LABEL_FIELDS = (
    "truncation occlusion alpha xmin ymin xmax ymax "
    "height width length x3d y3d z3d yaw"
).split()


def parse_label_line(line: str) -> Optional[Dict]:
    """One KITTI label/detection line -> dict."""
    line = line.strip()
    if not line:
        return None
    fields = line.split(" ")
    label = {"name": fields[0]}
    for i, key in enumerate(_LABEL_FIELDS):
        label[key] = float(fields[1 + i])
    label["occlusion"] = int(label["occlusion"])
    if len(fields) > 15:
        label["score"] = float(fields[15])
    return label


def format_label_line(label: Dict) -> str:
    """Dict -> KITTI label/detection line (inverse of parse_label_line)."""
    parts = [label["name"]]
    parts += ["%.2f" % label["truncation"], "%d" % label["occlusion"]]
    parts += ["%.6f" % label[k] for k in _LABEL_FIELDS[2:]]
    if "score" in label:
        parts.append("%.6f" % label["score"])
    return " ".join(parts)


class KittiDataset:
    """Random access to a KITTI object-detection directory layout.

    ``difficulty`` of 0/1/2 filters labels to easy/moderate/hard;
    anything below 0 keeps all labels.  ``num_classes`` records the
    label-assignment variant (8 = yaw, 4 = Car, 6 = Ped+Cyc).
    """

    def __init__(
        self,
        image_dir: str,
        point_dir: str,
        calib_dir: str,
        label_dir: str,
        index_filename: Optional[str] = None,
        is_training: bool = True,
        is_raw: bool = False,
        difficulty: int = -100,
        num_classes: int = 8,
    ):
        self._image_dir = image_dir
        self._point_dir = point_dir
        self._calib_dir = calib_dir
        self._label_dir = label_dir
        self._index_filename = index_filename
        if index_filename:
            with open(index_filename) as f:
                self._file_list = [
                    line.rstrip("\n").split(".")[0] for line in f if line.strip()
                ]
        else:
            self._file_list = sorted(
                f.split(".")[0]
                for f in os.listdir(image_dir)
                if os.path.isfile(os.path.join(image_dir, f))
            )
        self._verify_file_list(is_training, is_raw)
        self._is_training = is_training
        self._is_raw = is_raw
        self.num_classes = num_classes
        self.difficulty = difficulty

    # -- file handling ----------------------------------------------------

    @property
    def num_files(self) -> int:
        return len(self._file_list)

    def get_filename(self, frame_idx: int) -> str:
        return self._file_list[frame_idx]

    def _verify_file_list(self, is_training: bool, is_raw: bool) -> None:
        """Raise if a referenced file is missing."""
        for f in self._file_list:
            paths = [
                (self._image_dir, ".png", True),
                (self._point_dir, ".bin", True),
                (self._calib_dir, ".txt", not is_raw),
                (self._label_dir, ".txt", is_training),
            ]
            for d, ext, required in paths:
                p = os.path.join(d, f) + ext
                if required and not os.path.isfile(p):
                    raise FileNotFoundError("%s does not exist" % p)

    # -- raw data ----------------------------------------------------------

    def get_velo_points(self, frame_idx: int, xyz_range=None) -> Points:
        """Velodyne points + reflectance."""
        path = os.path.join(self._point_dir, self._file_list[frame_idx]) + ".bin"
        data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        xyz, refl = data[:, :3], data[:, [3]]
        if xyz_range is not None:
            mask = np.ones(len(xyz), dtype=bool)
            for axis, (lo, hi) in enumerate(xyz_range):
                mask &= (xyz[:, axis] > lo) & (xyz[:, axis] < hi)
            xyz, refl = xyz[mask], refl[mask]
        return Points(xyz=xyz, attr=refl)

    def get_image(self, frame_idx: int) -> np.ndarray:
        """BGR image array."""
        path = os.path.join(self._image_dir, self._file_list[frame_idx]) + ".png"
        return read_png(path)

    def get_calib(self, frame_idx: int) -> Dict[str, np.ndarray]:
        """Parse a calibration file and build the transform chain:
        ``velo_to_rect``, ``cam_to_image``, ``rect_to_cam`` (R0 and a
        camera-2 baseline translation recovered from P2),
        ``velo_to_cam``, ``cam_to_velo``, ``velo_to_image``."""
        path = os.path.join(self._calib_dir, self._file_list[frame_idx]) + ".txt"
        calib: Dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                fields = line.split(" ")
                if not fields[0]:
                    continue
                calib[fields[0].rstrip(":")] = np.array(
                    fields[1:], dtype=np.float32
                )
        calib["P2"] = calib["P2"].reshape(3, 4)
        calib["R0_rect"] = calib["R0_rect"].reshape(3, 3)
        calib["Tr_velo_to_cam"] = calib["Tr_velo_to_cam"].reshape(3, 4)

        calib["velo_to_rect"] = np.vstack(
            [calib["Tr_velo_to_cam"], [0, 0, 0, 1]]
        )
        calib["cam_to_image"] = np.hstack(
            [calib["P2"][:, 0:3], np.zeros((3, 1))]
        )
        # camera-2 position offset folded into rect->cam so that
        # cam_to_image needs no translation column.
        t2 = np.linalg.inv(calib["P2"][:, 0:3]) @ calib["P2"][:, [3]]
        rect_to_cam = np.hstack([calib["R0_rect"], t2])
        calib["rect_to_cam"] = np.vstack([rect_to_cam, [0, 0, 0, 1]])
        calib["velo_to_cam"] = calib["rect_to_cam"] @ calib["velo_to_rect"]
        calib["cam_to_velo"] = np.linalg.inv(calib["velo_to_cam"])
        calib["velo_to_image"] = calib["cam_to_image"] @ calib["velo_to_cam"]
        R0 = np.eye(4)
        R0[:3, :3] = calib["R0_rect"]
        if not np.isclose(
            calib["velo_to_image"],
            calib["P2"] @ R0 @ calib["velo_to_rect"],
        ).all():
            raise ValueError("%s: calibration chain mismatch" % path)
        return calib

    @staticmethod
    def get_raw_calib(calib_velo_to_cam_path: str,
                      calib_cam_to_cam_path: str) -> Dict[str, np.ndarray]:
        """Calibration of the raw KITTI recordings: parse the two raw
        calib files and derive ``velo_to_cam`` / ``cam_to_velo`` /
        ``cam_to_image`` / ``velo_to_image`` for rectified camera 2."""
        calib: Dict[str, np.ndarray] = {}
        with open(calib_cam_to_cam_path) as f:
            entries = {}
            for line in f:
                if ":" not in line:
                    continue
                key, value = line.rstrip("\n").split(":", 1)
                entries[key] = value
        shapes = {
            "S": (1, 2), "K": (3, 3), "D": (1, 5), "R": (3, 3),
            "T": (3, 1), "S_rect": (1, 2), "R_rect": (3, 3),
            "P_rect": (3, 4),
        }
        for i in range(4):
            for prefix, shape in shapes.items():
                key = "%s_0%d" % (prefix, i)
                calib[key] = np.array(
                    entries[key].split(), dtype=np.float32
                ).reshape(shape)
        with open(calib_velo_to_cam_path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, value = line.rstrip("\n").split(":", 1)
                if key in ("R", "T"):
                    calib[key] = np.array(
                        value.split(), dtype=np.float32
                    ).reshape((3, 3) if key == "R" else (3, 1))
        calib["Tr_velo_to_cam"] = np.vstack(
            [np.hstack([calib["R"], calib["T"]]), [0, 0, 0, 1]]
        )
        R0 = np.eye(4, dtype=np.float32)
        R0[:3, :3] = calib["R_rect_00"]
        T2 = np.eye(4, dtype=np.float32)
        T2[0, 3] = calib["P_rect_02"][0, 3] / calib["P_rect_02"][0, 0]
        calib["velo_to_cam"] = T2 @ R0 @ calib["Tr_velo_to_cam"]
        calib["cam_to_velo"] = np.linalg.inv(calib["velo_to_cam"])
        calib["cam_to_image"] = np.hstack(
            [calib["P_rect_02"][:, 0:3], np.zeros((3, 1), np.float32)]
        )
        calib["velo_to_image"] = calib["cam_to_image"] @ calib["velo_to_cam"]
        return calib

    def get_label(self, frame_idx: int, no_orientation: bool = False
                  ) -> List[Dict]:
        """Labels, filtered by ``difficulty`` when it is 0, 1 or 2.
        ``no_orientation`` is the reference's flag, accepted as the JAX
        package accepts it: the labels keep their yaw either way."""
        path = os.path.join(self._label_dir, self._file_list[frame_idx]) + ".txt"
        out = []
        with open(path) as f:
            for line in f:
                label = parse_label_line(line)
                if label is None:
                    continue
                if self.difficulty > -1:
                    d = self.difficulty
                    if (
                        label["truncation"] > MAX_TRUNCATION[d]
                        or label["occlusion"] > MAX_OCCLUSION[d]
                        or label["ymax"] - label["ymin"] < MIN_HEIGHT[d]
                    ):
                        continue
                out.append(label)
        return out

    # -- coordinate transforms ----------------------------------------------

    @staticmethod
    def velo_points_to_cam(points: Points, calib: Dict) -> Points:
        T = calib["velo_to_cam"].astype(np.float32)
        xyz = points.xyz @ T[:3, :3].T + T[:3, 3]
        return Points(xyz=xyz.astype(np.float32), attr=points.attr)

    @staticmethod
    def velo_to_cam(points_xyz: np.ndarray, calib: Dict) -> np.ndarray:
        T = calib["velo_to_cam"]
        return points_xyz @ T[:3, :3].T + T[:3, 3]

    @staticmethod
    def cam_points_to_velo(points: Points, calib: Dict) -> Points:
        T = calib["cam_to_velo"]
        xyz = points.xyz @ T[:3, :3].T + T[:3, 3]
        return Points(xyz=xyz, attr=points.attr)

    @staticmethod
    def cam_to_velo(points_xyz: np.ndarray, calib: Dict) -> np.ndarray:
        T = calib["cam_to_velo"]
        return points_xyz @ T[:3, :3].T + T[:3, 3]

    @staticmethod
    def cam_points_to_image(points: Points, calib: Dict) -> Points:
        """Project to pixel coordinates; z keeps homogeneous scale = 1."""
        P = calib["cam_to_image"]
        uvw = points.xyz @ P[:3, :3].T + P[:3, 3]
        uvw = uvw / uvw[:, [2]]
        return Points(xyz=uvw, attr=points.attr)

    def velo_points_to_image(self, points: Points, calib: Dict) -> Points:
        return self.cam_points_to_image(
            self.velo_points_to_cam(points, calib), calib
        )

    @staticmethod
    def rgb_to_cam_points(points: Points, image: np.ndarray, calib: Dict) -> Points:
        """Append normalized per-point RGB sampled from the (BGR) image."""
        img_points = KittiDataset.cam_points_to_image(points, calib)
        rgb = image[
            np.int32(img_points.xyz[:, 1]),
            np.int32(img_points.xyz[:, 0]),
            ::-1,
        ].astype(np.float32) / 255.0
        return Points(points.xyz, np.hstack([points.attr, rgb]))

    # -- composite loaders ----------------------------------------------------

    def get_cam_points(
        self,
        frame_idx: int,
        downsample_voxel_size: Optional[float] = None,
        calib: Optional[Dict] = None,
        xyz_range=None,
    ) -> Points:
        """Velodyne points in camera coordinates."""
        velo_points = self.get_velo_points(frame_idx, xyz_range=xyz_range)
        if calib is None:
            calib = self.get_calib(frame_idx)
        cam_points = self.velo_points_to_cam(velo_points, calib)
        if downsample_voxel_size is not None:
            cam_points = voxel.voxel_downsample_average(
                cam_points, downsample_voxel_size
            )
        return cam_points

    def _in_image_mask(self, points: Points, calib, height, width):
        img_points = self.cam_points_to_image(points, calib)
        u, v = img_points.xyz[:, 0], img_points.xyz[:, 1]
        return (u > 0) & (u < width) & (v > 0) & (v < height)

    def _points_in_image(self, frame_idx, downsample_voxel_size, calib,
                         xyz_range):
        """``(points in the image, image)``: camera-frame points in front
        of the camera (z > 0.1) that project inside the image."""
        cam_points = self.get_cam_points(
            frame_idx, downsample_voxel_size, calib=calib, xyz_range=xyz_range
        )
        image = self.get_image(frame_idx)
        front = cam_points.mask(cam_points.xyz[:, 2] > 0.1)
        return front.mask(
            self._in_image_mask(front, calib, image.shape[0], image.shape[1])
        ), image

    def get_cam_points_in_image(
        self,
        frame_idx: int,
        downsample_voxel_size: Optional[float] = None,
        calib: Optional[Dict] = None,
        xyz_range=None,
    ) -> Points:
        """Camera-frame points visible in the image."""
        if calib is None:
            calib = self.get_calib(frame_idx)
        return self._points_in_image(frame_idx, downsample_voxel_size, calib,
                                     xyz_range)[0]

    def get_cam_points_in_image_with_rgb(
        self,
        frame_idx: int,
        downsample_voxel_size: Optional[float] = None,
        calib: Optional[Dict] = None,
        xyz_range=None,
    ) -> Points:
        """Frustum-cropped points with RGB attributes appended."""
        if calib is None:
            calib = self.get_calib(frame_idx)
        in_img, image = self._points_in_image(
            frame_idx, downsample_voxel_size, calib, xyz_range)
        return self.rgb_to_cam_points(in_img, image, calib)

    # -- geometry ------------------------------------------------------------

    def downsample_by_voxel(self, points: Points, voxel_size: float,
                            method: str = "AVERAGE") -> Points:
        """Voxel downsampling (:mod:`graph.voxel`): ``"AVERAGE"`` or
        ``"RANDOM"``."""
        if method == "AVERAGE":
            return voxel.voxel_downsample_average(points, voxel_size)
        if method == "RANDOM":
            return voxel.voxel_downsample_random(points, voxel_size)
        raise ValueError("unknown downsample method %s" % method)

    @staticmethod
    def box3d_to_cam_points(label: Dict,
                            expend_factor=(1.0, 1.0, 1.0)) -> Points:
        """The label's box corners in camera coordinates."""
        corners = box_ops.box_to_corners(
            box_ops.label_to_box(label), expend_factor
        )
        return Points(xyz=corners, attr=None)

    @staticmethod
    def sel_xyz_in_box3d(label, xyz, expend_factor=(1.0, 1.0, 1.0)):
        """Mask of the points inside the label's (expanded) 3D box."""
        return box_ops.points_in_box(
            xyz, box_ops.label_to_box(label), expend_factor
        )

    @staticmethod
    def sel_xyz_in_box2d(label, xyz, expend_factor=(1.0, 1.0, 1.0)):
        """Mask of the points inside the label's bird's-eye footprint."""
        return box_ops.points_in_box_bev(
            xyz, box_ops.label_to_box(label), expend_factor
        )

    # -- label assignment (the JAX dataset's method form) -------------------

    def assign_classaware_label_to_points(self, labels, xyz, expend_factor):
        if self.num_classes != 8:
            raise ValueError("the 8-class assigner on a %d-class dataset"
                             % self.num_classes)
        return label_lib.assign_classaware_label_to_points(
            labels, xyz, expend_factor)

    def assign_classaware_car_label_to_points(self, labels, xyz,
                                              expend_factor):
        if self.num_classes != 4:
            raise ValueError("the Car assigner on a %d-class dataset"
                             % self.num_classes)
        return label_lib.assign_classaware_car_label_to_points(
            labels, xyz, expend_factor)

    def assign_classaware_ped_and_cyc_label_to_points(self, labels, xyz,
                                                      expend_factor):
        if self.num_classes != 6:
            raise ValueError("the Pedestrian/Cyclist assigner on a %d-class "
                             "dataset" % self.num_classes)
        return label_lib.assign_classaware_ped_and_cyc_label_to_points(
            labels, xyz, expend_factor)

    # -- statistics --------------------------------------------------------

    def get_statistics(self) -> Dict[str, Dict[str, float]]:
        """Per-class size/position statistics over the whole dataset:
        ``{class: {field: median}}`` over the labels whose 2D box starts
        below the image's top edge and is taller than 25 px."""
        acc: Dict[str, Dict[str, List[float]]] = {}
        for frame_idx in range(self.num_files):
            for label in self.get_label(frame_idx):
                if label["ymin"] > 0 and label["ymax"] - label["ymin"] > 25:
                    rec = acc.setdefault(label["name"], {})
                    for k in ("height", "width", "length", "x3d", "y3d",
                              "z3d", "yaw"):
                        rec.setdefault(k, []).append(label[k])
        return {
            name: {k: float(np.median(v)) for k, v in rec.items()}
            for name, rec in acc.items()
        }

    def __str__(self) -> str:
        return (
            "KittiDataset(image_dir=%s, point_dir=%s, calib_dir=%s, "
            "label_dir=%s, index=%s, frames=%d)"
            % (
                self._image_dir,
                self._point_dir,
                self._calib_dir,
                self._label_dir,
                self._index_filename,
                self.num_files,
            )
        )
