"""Build and load the port's hand-written CUDA kernels.

Every kernel is one source under ``pointgnn_tpu_torch/csrc/`` with a
plain C entry point.  At first use ``nvcc`` compiles it for ``sm_90a``
into a shared library under ``build/torch_kernels/``, named by a hash of
the source, every local header it includes (``#include "..."``, followed
recursively) and the compiler flags, so a change to any of them rebuilds
it.  The library is loaded with ``ctypes``; the calling module sets the
entry point's argument types.

:func:`build_kernels` starts one ``nvcc`` per missing library, all at
once, and waits for them together.
"""

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from pointgnn_tpu_torch.nn.mlp import round_to

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# kernel name -> its source under csrc/
SOURCES = {
    "slab_edge_max": "slab_edge_max.cu",          # K1
    "slab_edge_max_bwd": "slab_edge_max_bwd.cu",  # K2
    "edge_tail_max": "edge_tail_max.cu",          # K3
    "fused_edge_max": "fused_edge_max.cu",        # K4
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
MAX_LAYERS = 8  # slab::kMaxLayers in csrc/slab_chain.cuh
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_loaded = {}  # library path -> ctypes library (one load per process)
_entries = {}  # (kernel name, symbol) -> loaded C entry point
_tallies = threading.local()  # count_launch's tally of a graph capture


def local_headers(source):
    """The headers under ``csrc/`` that ``source`` includes, directly or
    through another header, in first-seen order."""
    seen, todo = [], [source]
    while todo:
        text = (CSRC_DIR / todo.pop()).read_text()
        for name in _INCLUDE.findall(text):
            if name not in seen:
                seen.append(name)
                todo.append(name)
    return seen


def source_hash(name):
    """Hash of the kernel's source, its local headers and the flags."""
    source = SOURCES[name]
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in local_headers(source):
        h.update((CSRC_DIR / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name):
    return BUILD_DIR / ("%s_%s.so" % (name, source_hash(name)))


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build_kernels(names=None):
    """Compile the kernels' sources (all of :data:`SOURCES` by default)
    for sm_90a, one ``nvcc`` per missing library, all started together.
    Returns ``{name: (path, seconds, compiler output)}``; a library that
    exists already reports 0 s and no output.  Raises if any build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    result, running = {}, {}
    for name in names:
        path = lib_path(name)
        if path.exists():
            result[name] = (path, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".so.tmp%d" % os.getpid())
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in running.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed building %s:\n%s"
                          % (SOURCES[name], log))
            continue
        os.replace(tmp, path)
        result[name] = (path, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def kernel_entry(name, symbol, argtypes):
    """The C entry point ``symbol`` of kernel ``name``, returning an
    ``int`` CUDA error code.  The first use in a process builds every
    missing kernel library at once; later calls reuse the loaded entry
    point (no source hashing per launch)."""
    key = (name, symbol)
    if key not in _entries:
        path = lib_path(name)
        if path not in _loaded:
            build_kernels()
            _loaded[path] = ctypes.CDLL(str(path))
        fn = getattr(_loaded[path], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return _entries[key]


def count_launch(fn):
    """Count one launch of the kernel wrapper ``fn`` in ``fn.launches``;
    inside :func:`capture_tally` in this thread, in the tally instead (a
    captured launch runs when, and as often as, its CUDA graph
    replays)."""
    tally = getattr(_tallies, "counts", None)
    if tally is None:
        fn.launches += 1
    else:
        tally[fn] = tally.get(fn, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Yields ``{wrapper: launches}`` of the kernel launches that this
    thread makes inside the block, which leave ``.launches`` as it is:
    the launches of a captured CUDA graph, added at each replay."""
    outer = getattr(_tallies, "counts", None)
    _tallies.counts = tally = {}
    try:
        yield tally
    finally:
        _tallies.counts = outer


def flat_chain(weights, compute_dtype, device, transpose=False):
    """A dense+ReLU chain as the kernels take it (``slab::Chain`` in
    ``csrc/slab_chain.cuh``): one flat float32 buffer ``[w_0, b_0, w_1,
    ...]`` rounded to ``compute_dtype`` (each ``w`` as ``[dout, din]``
    when ``transpose``), its host layer table of (weight offset, bias
    offset, din, dout) and its length."""
    flat, meta, off = [], [], 0
    for w, b in weights:
        wr = round_to(w.to(torch.float32), compute_dtype)
        wr = (wr.T if transpose else wr).contiguous().reshape(-1)
        br = round_to(b.to(torch.float32), compute_dtype).reshape(-1)
        meta += [off, off + wr.numel(), w.shape[0], w.shape[1]]
        flat += [wr, br]
        off += wr.numel() + br.numel()
    flat_w = torch.cat(flat) if flat else torch.zeros(1, device=device)
    return flat_w, (ctypes.c_int * max(len(meta), 1))(*meta), off
