"""Visualization helpers, headless: files, not windows (counterpart of
:mod:`pointgnn_tpu.utils.vis`).

The JAX package draws with OpenCV and matplotlib; the port draws in
numpy on BGR ``uint8`` arrays and writes PNGs with
:func:`pointgnn_tpu_torch.data.png.write_png`:

- lines by Bresenham's integer rule, stamped ``thickness`` pixels wide
  (OpenCV's thickness 2 for boxes), clipped to the image;
- text in a built-in 5x7 bitmap font (letters drawn upper case, digits
  and ``. | _ - :``), its lower-left corner at the anchor as OpenCV's;
- bird's-eye views rasterized into a fixed square canvas with one scale
  for both axes (camera x to the right, z up).

The geometry equals the JAX package's: the projected corner pixels of a
box (:func:`project_box_corners`, truncated to int32 as JAX does), its
12 wireframe edges (:data:`BOX_EDGES`) and the BEV polygons of box top
faces (:func:`bev_polygons`).  The pixels do not equal OpenCV's or
matplotlib's.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.data.kitti import KittiDataset
from pointgnn_tpu_torch.data.png import write_png

# box corner connectivity: top face, bottom face, verticals
BOX_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)

# BGR, as the JAX package's OpenCV calls take them
OCCLUSION_COLORS = ((0, 128, 0), (0, 255, 255), (0, 0, 128), (255, 255, 255))
DONTCARE_COLOR = (255, 191, 0)
GREEN = (0, 255, 0)
RED = (0, 0, 255)
POINT_COLOR = (119, 119, 119)
EDGE_COLOR = (180, 119, 31)
VERTEX_COLOR = (51, 51, 51)
BEV_SIZE = 1000  # canvas side of the bird's-eye views, pixels

# 5x7 glyphs: seven rows, each a base-32 digit whose five bits are the
# row's pixels, most significant on the left
_FONT = {
    'A': "EHHVHHH", 'B': "UHHUHHU", 'C': "EHGGGHE", 'D': "UHHHHHU",
    'E': "VGGUGGV", 'F': "VGGUGGG", 'G': "EHGNHHF", 'H': "HHHVHHH",
    'I': "E44444E", 'J': "72222IC", 'K': "HIKOKIH", 'L': "GGGGGGV",
    'M': "HRLLHHH", 'N': "HHPLJHH", 'O': "EHHHHHE", 'P': "UHHUGGG",
    'Q': "EHHHLID", 'R': "UHHUKIH", 'S': "FGGE11U", 'T': "V444444",
    'U': "HHHHHHE", 'V': "HHHHHA4", 'W': "HHHLLLA", 'X': "HHA4AHH",
    'Y': "HHHA444", 'Z': "V1248GV", '0': "EHJLPHE", '1': "4C4444E",
    '2': "EH1248V", '3': "V2421HE", '4': "26AIV22", '5': "VGU11HE",
    '6': "68GUHHE", '7': "V124888", '8': "EHHEHHE", '9': "EHHF12C",
    '.': "00000CC", '|': "4444444", '_': "000000V", '-': "000V000",
    ':': "0CC0CC0", ' ': "0000000", '?': "EH12404",
}
_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUV"


def _glyph(ch: str) -> np.ndarray:
    """[7, 5] bool pixels of one character (unknown ones as ``?``)."""
    rows = _FONT.get(ch.upper(), _FONT["?"])
    bits = np.array([_DIGITS.index(r) for r in rows])
    return (bits[:, None] >> np.arange(4, -1, -1)[None, :]) & 1 == 1


def _stamp(image, xs, ys, color, thickness):
    """Set the pixels ``(xs, ys)``, each widened to a ``thickness``
    square, inside the image."""
    h, w = image.shape[:2]
    offs = np.arange(-(thickness // 2), thickness - thickness // 2)
    xx = (xs[:, None, None] + offs[None, :, None]).ravel()
    yy = (ys[:, None, None] + offs[None, None, :]).ravel()
    keep = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    image[yy[keep], xx[keep]] = color


def _clip_segment(p0, p1, lo, hi):
    """Liang-Barsky: the part of segment ``p0 -> p1`` inside the box
    ``[lo, hi]`` (per axis), or None."""
    p0 = np.asarray(p0, np.float64)
    d = np.asarray(p1, np.float64) - p0
    t0, t1 = 0.0, 1.0
    for axis in range(2):
        for p, q in ((-d[axis], p0[axis] - lo[axis]),
                     (d[axis], hi[axis] - p0[axis])):
            if p == 0:
                if q < 0:
                    return None
                continue
            t = q / p
            if p < 0:
                t0 = max(t0, t)
            else:
                t1 = min(t1, t)
            if t0 > t1:
                return None
    return p0 + t0 * d, p0 + t1 * d


def bresenham(x0: int, y0: int, x1: int, y1: int):
    """The integer pixels of a line from ``(x0, y0)`` to ``(x1, y1)``,
    ends included: one pixel per step of the major axis, the minor axis
    at the rounded (half up) offset ``i * d_minor / d_major``."""
    dx, dy = x1 - x0, y1 - y0
    n = max(abs(dx), abs(dy))
    i = np.arange(n + 1, dtype=np.int64)
    if n == 0:
        return np.array([x0]), np.array([y0])

    def minor(d):
        return np.sign(d) * ((2 * i * abs(d) + n) // (2 * n))

    if abs(dx) >= abs(dy):
        return x0 + np.sign(dx) * i, y0 + minor(dy)
    return x0 + minor(dx), y0 + np.sign(dy) * i


def draw_line(image, p0, p1, color, thickness=1):
    """A ``thickness``-wide line between two pixel positions (floats are
    truncated toward zero after clipping to the image's margin)."""
    h, w = image.shape[:2]
    pad = thickness + 1
    seg = _clip_segment(p0, p1, (-pad, -pad), (w + pad, h + pad))
    if seg is None:
        return image
    (x0, y0), (x1, y1) = (np.trunc(p).astype(np.int64) for p in seg)
    xs, ys = bresenham(int(x0), int(y0), int(x1), int(y1))
    _stamp(image, xs, ys, color, thickness)
    return image


def draw_rectangle(image, p1, p2, color, thickness=2):
    """The outline of the axis-aligned rectangle with corners p1, p2."""
    (x0, y0), (x1, y1) = p1, p2
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                 ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        draw_line(image, a, b, color, thickness)
    return image


def draw_text(image, text: str, org, color, scale: int = 1):
    """``text`` in the bitmap font, the lower-left corner of its first
    character at ``org``; each font pixel ``scale`` pixels wide."""
    x, y = int(org[0]), int(org[1])
    top = y - 7 * scale
    for k, ch in enumerate(text):
        g = np.repeat(np.repeat(_glyph(ch), scale, 0), scale, 1)
        ys, xs = np.nonzero(g)
        _stamp(image, xs + x + 6 * scale * k, ys + top, color, 1)
    return image


def project_box_corners(boxes_3d: np.ndarray, calib: Dict) -> np.ndarray:
    """[N, 8, 2] int32 image pixels of each 7-DoF camera box's corners
    (the JAX ``draw_3d_boxes`` projection and truncation)."""
    boxes_3d = np.asarray(boxes_3d).reshape(-1, 7)
    corners = box_ops.boxes_to_corners(boxes_3d)
    out = np.zeros((len(corners), 8, 2), np.int32)
    for i in range(len(corners)):
        img_pts = KittiDataset.cam_points_to_image(
            Points(xyz=corners[i], attr=None), calib
        )
        out[i] = img_pts.xyz[:, :2].astype(np.int32)
    return out


def bev_polygons(boxes_3d) -> np.ndarray:
    """[N, 5, 2] closed (x, z) polygons of the boxes' top faces, as the
    JAX ``plot_bev`` draws them."""
    top = box_ops.boxes_to_corners(
        np.asarray(boxes_3d).reshape(-1, 7))[:, :4][:, :, [0, 2]]
    return np.concatenate([top, top[:, :1]], axis=1)


def draw_2d_boxes(image: np.ndarray, label_list: List[Dict]) -> np.ndarray:
    """KITTI 2D boxes with their class names, colored by occlusion
    (DontCare apart)."""
    image = image.copy()
    for label in label_list:
        if label["name"] == "DontCare":
            color = DONTCARE_COLOR
        else:
            color = OCCLUSION_COLORS[
                int(np.clip(label.get("occlusion", 0), 0, 3))
            ]
        p1 = (int(label["xmin"]), int(label["ymin"]))
        p2 = (int(label["xmax"]), int(label["ymax"]))
        draw_rectangle(image, p1, p2, color, 2)
        draw_text(image, label["name"], p1, color, scale=2)
    return image


def draw_3d_boxes(
    image: np.ndarray,
    boxes_3d: np.ndarray,
    calib: Dict,
    color=GREEN,
    scores: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Project 7-DoF boxes and draw their 12-edge wireframes (and each
    score at its first corner)."""
    image = image.copy()
    xy = project_box_corners(boxes_3d, calib)
    for i in range(len(xy)):
        for a, b in BOX_EDGES:
            draw_line(image, xy[i, a], xy[i, b], color, 2)
        if scores is not None:
            draw_text(image, "%.2f" % scores[i], xy[i, 0], color)
    return image


def _bev_canvas(xz: np.ndarray, size: int = BEV_SIZE, margin: int = 20):
    """A white canvas and the map of (x, z) metres to (column, row):
    one scale for both axes, z up, ``xz`` inside the margin."""
    if len(xz) == 0:
        xz = np.zeros((1, 2))
    lo, hi = xz.min(axis=0), xz.max(axis=0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    scale = (size - 1 - 2 * margin) / span
    mid = (lo + hi) / 2.0

    def to_px(p):
        p = np.asarray(p, np.float64).reshape(-1, 2)
        col = (size - 1) / 2.0 + (p[:, 0] - mid[0]) * scale
        row = (size - 1) / 2.0 - (p[:, 1] - mid[1]) * scale
        return np.stack([col, row], axis=1)

    return np.full((size, size, 3), 255, np.uint8), to_px


def _draw_points(canvas, px, color):
    px = np.trunc(px).astype(np.int64)
    _stamp(canvas, px[:, 0], px[:, 1], color, 1)


def plot_bev(
    points_xyz: np.ndarray,
    boxes_3d: Optional[np.ndarray] = None,
    gt_boxes_3d: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    max_points: int = 50000,
):
    """Bird's-eye view (camera x right, z forward) of the points with
    the top faces of the detections (green) and the ground truth (red).
    Writes a PNG to ``path`` and returns it when given, else returns the
    BGR canvas."""
    pts = np.asarray(points_xyz)
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]
    polys = [(bev_polygons(b), c) for b, c in ((boxes_3d, GREEN),
                                                (gt_boxes_3d, RED))
             if b is not None and len(b)]
    extent = np.concatenate([pts[:, [0, 2]].reshape(-1, 2)]
                            + [p.reshape(-1, 2) for p, _ in polys])
    canvas, to_px = _bev_canvas(extent)
    _draw_points(canvas, to_px(pts[:, [0, 2]]), POINT_COLOR)
    for poly, color in polys:
        for p in poly:
            q = to_px(p)
            for a in range(4):
                draw_line(canvas, q[a], q[a + 1], color, 1)
    if path is not None:
        write_png(path, canvas)
        return path
    return canvas


def plot_graph_bev(
    vertex_xyz: np.ndarray,
    edges: np.ndarray,
    center_xyz: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    max_edges: int = 20000,
):
    """Bird's-eye view of a proximity graph: vertices as dots, edges as
    segments from the source points to their (possibly distinct) center
    set.  Writes a PNG to ``path`` and returns it when given, else
    returns the BGR canvas."""
    vertex_xyz = np.asarray(vertex_xyz)
    center_xyz = vertex_xyz if center_xyz is None else np.asarray(center_xyz)
    edges = np.asarray(edges).reshape(-1, 2)
    if len(edges) > max_edges:
        edges = edges[:: len(edges) // max_edges + 1]
    extent = np.concatenate([vertex_xyz[:, [0, 2]], center_xyz[:, [0, 2]]])
    canvas, to_px = _bev_canvas(extent)
    a = to_px(vertex_xyz[edges[:, 0]][:, [0, 2]])
    b = to_px(center_xyz[edges[:, 1]][:, [0, 2]])
    for p, q in zip(a, b):
        draw_line(canvas, p, q, EDGE_COLOR, 1)
    _draw_points(canvas, to_px(vertex_xyz[:, [0, 2]]), VERTEX_COLOR)
    if path is not None:
        write_png(path, canvas)
        return path
    return canvas


def save_detection_image(
    image: np.ndarray,
    pred_labels: List[tuple],
    calib: Dict,
    path: str,
) -> str:
    """Overlay ``run_dataset``-format detections (name, truncation,
    occlusion, alpha, bbox, h, w, l, x, y, z, yaw, score) on the image:
    each 2D box with its class initial and score, and each 3D box's
    wireframe; writes a PNG."""
    image = image.copy()
    boxes = []
    for p in pred_labels:
        name = p[0]
        xmin, ymin, xmax, ymax = p[4:8]
        h, w, l, x, y, z, yaw, score = p[8:16]
        boxes.append([x, y, z, l, h, w, yaw])
        draw_rectangle(image, (int(xmin), int(ymin)),
                       (int(xmax), int(ymax)), GREEN, 2)
        draw_text(image, "%s | %.3f" % (name[0], score),
                  (int(xmin), int(ymin)), GREEN)
    if boxes:
        image = draw_3d_boxes(image, np.asarray(boxes), calib)
    write_png(path, image)
    return path
