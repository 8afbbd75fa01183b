"""Build and load the port's native host library: merge-NMS
(``csrc/host/nms.cpp``), PNG row unfiltering (``csrc/host/png.cpp``) and
the radius search of the host-built graph (``csrc/host/radius_grid.cpp``,
threaded with ``std::thread``); :func:`build_target` also builds the
KITTI AP evaluator
(``postprocess/kitti_eval.py``).

At first use the host C++ compiler (``$CXX``, else ``c++``) compiles the
sources into one shared library under ``build/torch_kernels/``, named by
a hash of the sources, the flags and the instruction set that
``-march=native`` selects on this machine (the compiler's predefined
macros), so a change to any of them rebuilds it.  The library is loaded
with ``ctypes``.  There is no fallback: a failed build or load raises
with the compiler's output.

Flags: the JAX package's (``cpp/Makefile``), ``-O3 -march=native
-std=c++17``, plus ``-fPIC -shared -pthread``, and no ``-ffast-math``.
The Makefile builds ``radius_grid.cpp`` with ``-fopenmp``; the port's
copy threads its center loop itself, since the GPU machine's compiler
has no OpenMP runtime to link (``libgomp.spec`` missing).  In C++
GCC contracts ``a * b + c`` into one FMA by default
(``-ffp-contract=fast``; ISO mode turns that off only for C), wherever
the target has FMA.  ``-march=native`` is kept so that the port's NMS
loop contracts where the JAX package's library does and equals it bit
for bit: without it, on x86-64 the baseline target has no FMA and the
rescored scores differ in the last bits.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HOST_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
SOURCES = (HOST_DIR / "nms.cpp", HOST_DIR / "png.cpp",
           HOST_DIR / "radius_grid.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread"]

_lock = threading.Lock()
# the radius search keeps its grid between its two passes in one
# process-wide slot: one caller at a time
_radius_lock = threading.Lock()
_lib = None


def _run(cmd):
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as exc:
        raise RuntimeError("native build: cannot run %r: %s"
                           % (cmd[0], exc)) from exc
    if res.returncode != 0:
        raise RuntimeError("native build failed (%s):\n%s%s"
                           % (" ".join(cmd), res.stdout, res.stderr))
    return res.stdout


def target_path(cxx, sources, flags, stem, suffix, build_dir=BUILD_DIR):
    """Where ``cxx`` builds ``sources`` with ``flags``: ``<stem>_<hash>
    <suffix>`` under ``build_dir``, the hash over the sources, the flags
    and the target that ``-march=native`` means to ``cxx`` here."""
    target = _run([cxx, "-march=native", "-E", "-dM", "-x", "c++",
                   os.devnull])
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    h.update("".join(sorted(target.splitlines())).encode())
    return Path(build_dir) / ("%s_%s%s" % (stem, h.hexdigest()[:16], suffix))


def build_target(cxx, sources, flags, stem, suffix, build_dir=BUILD_DIR):
    """Compile ``sources`` into :func:`target_path` unless it exists;
    returns the path.  Raises ``RuntimeError`` with the compiler's output
    when the build fails or the compiler cannot be run."""
    cxx = cxx or os.environ.get("CXX") or "c++"
    path = target_path(cxx, sources, flags, stem, suffix, build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    # concurrent builders (test workers) each write their own file and
    # rename it into place
    tmp = path.with_name(path.name + ".tmp%d" % os.getpid())
    _run([cxx, *flags, "-o", str(tmp), *map(str, sources)])
    os.replace(tmp, path)
    return path


def lib_path(cxx, build_dir=BUILD_DIR):
    """The host library's path (:func:`target_path` of ``SOURCES``)."""
    return target_path(cxx, SOURCES, CXX_FLAGS, "host", ".so", build_dir)


def build_library(cxx=None, build_dir=BUILD_DIR):
    """Compile ``csrc/host/nms.cpp``, ``png.cpp`` and ``radius_grid.cpp``
    into one shared library unless it exists; returns its path."""
    return build_target(cxx, SOURCES, CXX_FLAGS, "host", ".so", build_dir)


def get_lib():
    """The loaded library (built at first use, once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.pgnn_nms.restype = None
            lib.pgnn_nms.argtypes = [
                f64p, f64p, ctypes.POINTER(ctypes.c_int64), f64p,
                ctypes.c_int64, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                f64p, ctypes.POINTER(ctypes.c_uint8),
            ]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.pgnn_png_unfilter.restype = ctypes.c_int64
            lib.pgnn_png_unfilter.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
            ]
            i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.pgnn_radius_neighbors.restype = ctypes.c_int
            lib.pgnn_radius_neighbors.argtypes = [
                f32p, i64, f32p, i64, ctypes.c_float, ctypes.c_int32,
                ctypes.c_uint64, i64p, i64p, i64p, i64p,
            ]
            _lib = lib
    return _lib


def greedy_nms(boxes, corners, classes, scores, threshold, merge, rescore):
    """The native greedy loop: ``boxes`` [n, 7] sorted by decreasing
    score, ``corners`` [n, 8, 3] of the original (possibly quantized)
    boxes, ``classes`` [n], ``scores`` [n].  Returns ``(keep, scores,
    boxes)`` as ``postprocess.nms._greedy_nms`` does."""
    n = len(scores)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    corners = np.ascontiguousarray(corners, dtype=np.float64)
    classes = np.ascontiguousarray(classes, dtype=np.int64)
    if boxes.shape != (n, 7) or corners.shape != (n, 8, 3) \
            or classes.shape != (n,):
        raise ValueError("greedy_nms: shapes %s %s %s for %d scores"
                         % (boxes.shape, corners.shape, classes.shape, n))
    out_scores = np.array(scores, dtype=np.float64, copy=True)
    out_boxes = np.empty_like(boxes)
    keep = np.empty((n,), dtype=np.uint8)

    def dptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    get_lib().pgnn_nms(
        dptr(boxes), dptr(corners),
        classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dptr(out_scores), n, float(threshold), int(merge), int(rescore),
        dptr(out_boxes), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool), out_scores, out_boxes


def png_unfilter(rows, bpp):
    """Undo PNG row filters: ``rows`` [H, 1 + stride] uint8 (each row's
    filter byte, then its filtered bytes) -> the image bytes [H, stride].
    Raises ``ValueError`` on an unknown filter type."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = get_lib().pgnn_png_unfilter(
        rows.ctypes.data_as(u8p), height, stride, bpp,
        out.ctypes.data_as(u8p))
    if bad >= 0:
        raise ValueError("PNG row %d has unknown filter type %d"
                         % (bad, rows[bad, 0]))
    return out


def radius_neighbors(points_xyz, centers_xyz, radius, num_neighbors, seed):
    """[E, 2] int64 (point, center) pairs with ``|p - c| <= radius``,
    grouped by center in ascending order; ``num_neighbors > 0`` keeps a
    uniform random subset of that many per center (reservoir sampling
    seeded by ``seed`` and the center).  Two passes: count, then fill."""
    pts = np.ascontiguousarray(points_xyz, dtype=np.float32)
    ctr = np.ascontiguousarray(centers_xyz, dtype=np.float32)
    n, m = len(pts), len(ctr)
    if n == 0 or m == 0:
        return np.zeros((0, 2), dtype=np.int64)
    lib = get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def iptr(a):
        return a.ctypes.data_as(i64p)

    counts = np.zeros((m,), dtype=np.int64)
    offsets = np.zeros((m + 1,), dtype=np.int64)
    args = (pts.ctypes.data_as(f32p), n, ctr.ctypes.data_as(f32p), m,
            float(radius), int(num_neighbors), int(seed))
    with _radius_lock:
        rc = lib.pgnn_radius_neighbors(*args, iptr(counts), i64p(), i64p(),
                                       i64p())
        if rc != 0:
            raise RuntimeError("pgnn_radius_neighbors count pass: %d" % rc)
        np.cumsum(counts, out=offsets[1:])
        src = np.empty((int(offsets[-1]),), dtype=np.int64)
        dst = np.empty_like(src)
        rc = lib.pgnn_radius_neighbors(*args, iptr(counts), iptr(offsets),
                                       iptr(src), iptr(dst))
    if rc != 0:
        raise RuntimeError("pgnn_radius_neighbors fill pass: %d" % rc)
    return np.stack([src, dst], axis=1)
