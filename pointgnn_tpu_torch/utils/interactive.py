"""Optional interactive 3D viewers (Open3D), with headless fallbacks
(counterpart of :mod:`pointgnn_tpu.utils.interactive`).

Open3D is not a dependency: each viewer tries to import it, as the JAX
package does, and when that fails writes the matching headless PNG of
:mod:`pointgnn_tpu_torch.utils.vis` instead.  Pass ``save_path`` to
render to a file even when a display is available.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.utils import vis

# RGB class palette of the Open3D views
_CLASS_COLORS = {
    "Pedestrian": (255, 20, 147),
    "Person_sitting": (255, 255, 147),
    "Car": (255, 0, 0),
    "Van": (255, 255, 0),
    "Cyclist": (250, 128, 114),
    "DontCare": (0, 0, 255),
}
_DEFAULT_COLOR = (0, 128, 0)


def _try_open3d():
    try:
        import open3d

        return open3d
    except Exception:
        return None


def _box_lineset(o3d, box, color):
    """12-edge wireframe of one [x, y, z, l, h, w, yaw] camera box."""
    corners = box_ops.boxes_to_corners(np.asarray(box)[None])[0]
    ls = o3d.geometry.LineSet(
        points=o3d.utility.Vector3dVector(corners.reshape(-1, 3)),
        lines=o3d.utility.Vector2iVector([list(e) for e in vis.BOX_EDGES]),
    )
    ls.colors = o3d.utility.Vector3dVector(
        [np.asarray(color) / 255.0] * len(vis.BOX_EDGES)
    )
    return ls


def _show(o3d, geometries, save_path=None):
    if save_path:
        viewer = o3d.visualization.Visualizer()
        viewer.create_window(visible=False)
        for g in geometries:
            viewer.add_geometry(g)
        viewer.capture_screen_image(save_path, do_render=True)
        viewer.destroy_window()
        return save_path
    o3d.visualization.draw_geometries(geometries)
    return None


def _labels_to_boxes(label_list):
    """``(boxes, names)`` of label dicts: a ``"box"`` entry, or the KITTI
    fields ``x3d y3d z3d length height width yaw``."""
    boxes, names = [], []
    for lab in label_list or []:
        if "box" in lab:
            boxes.append(np.asarray(lab["box"], np.float64))
        else:
            boxes.append(
                np.array(
                    [
                        lab["x3d"], lab["y3d"], lab["z3d"],
                        lab["length"], lab["height"], lab["width"],
                        lab["yaw"],
                    ],
                    np.float64,
                )
            )
        names.append(lab.get("name", "Car"))
    return boxes, names


def vis_points(
    points_xyz: np.ndarray,
    colors: Optional[np.ndarray] = None,
    label_list: Optional[List[Dict]] = None,
    save_path: Optional[str] = None,
):
    """Point cloud with optional label wireframes; without Open3D, the
    BEV of :func:`vis.plot_bev` (to ``save_path`` or
    ``vis_points_bev.png``)."""
    o3d = _try_open3d()
    boxes, names = _labels_to_boxes(label_list)
    if o3d is None:
        out = save_path or "vis_points_bev.png"
        vis.plot_bev(points_xyz,
                     boxes_3d=(np.asarray(boxes) if boxes else None),
                     path=out)
        return out
    pcd = o3d.geometry.PointCloud(o3d.utility.Vector3dVector(points_xyz))
    if colors is not None:
        pcd.colors = o3d.utility.Vector3dVector(np.clip(colors, 0, 1))
    geoms = [pcd]
    for box, name in zip(boxes, names):
        geoms.append(_box_lineset(o3d, box,
                                  _CLASS_COLORS.get(name, _DEFAULT_COLOR)))
    return _show(o3d, geoms, save_path)


def vis_graph(
    points_xyz: np.ndarray,
    edges_src: np.ndarray,
    edges_dst: np.ndarray,
    save_path: Optional[str] = None,
):
    """Graph edges as 3D segments; without Open3D, the BEV of
    :func:`vis.plot_graph_bev` (to ``save_path`` or
    ``vis_graph_bev.png``)."""
    o3d = _try_open3d()
    if o3d is None:
        out = save_path or "vis_graph_bev.png"
        vis.plot_graph_bev(points_xyz,
                           np.stack([edges_src, edges_dst], axis=1),
                           path=out)
        return out
    lines = np.stack([edges_src, edges_dst], axis=1).astype(np.int32)
    ls = o3d.geometry.LineSet(
        points=o3d.utility.Vector3dVector(points_xyz),
        lines=o3d.utility.Vector2iVector(lines),
    )
    ls.colors = o3d.utility.Vector3dVector([[1.0, 0.0, 0.0]] * len(lines))
    pcd = o3d.geometry.PointCloud(o3d.utility.Vector3dVector(points_xyz))
    return _show(o3d, [pcd, ls], save_path)


def vis_detections(
    points_xyz: np.ndarray,
    boxes_3d: Sequence,
    names: Optional[Sequence[str]] = None,
    save_path: Optional[str] = None,
):
    """Detections over the cloud (``names`` one per box, Car without)."""
    labels = [
        {"name": (names[i] if names is not None else "Car"),
         "box": np.asarray(boxes_3d[i])}
        for i in range(len(boxes_3d))
    ]
    return vis_points(points_xyz, label_list=labels, save_path=save_path)


def vis_crop_aug(
    frame_xyz: np.ndarray,
    crop_xyz: np.ndarray,
    crop_box,
    save_path: Optional[str] = None,
):
    """One crop-paste: the frame (grey), the pasted object's points (red)
    and its box; without Open3D, the BEV of both clouds with the box (to
    ``save_path`` or ``vis_crop_aug_bev.png``)."""
    o3d = _try_open3d()
    if o3d is None:
        out = save_path or "vis_crop_aug_bev.png"
        all_xyz = np.concatenate([frame_xyz, crop_xyz], axis=0)
        vis.plot_bev(all_xyz, boxes_3d=np.asarray(crop_box)[None], path=out)
        return out
    frame = o3d.geometry.PointCloud(o3d.utility.Vector3dVector(frame_xyz))
    frame.paint_uniform_color([0.6, 0.6, 0.6])
    crop = o3d.geometry.PointCloud(o3d.utility.Vector3dVector(crop_xyz))
    crop.paint_uniform_color([1.0, 0.0, 0.0])
    geoms = [frame, crop, _box_lineset(o3d, crop_box, (255, 0, 0))]
    return _show(o3d, geoms, save_path)
