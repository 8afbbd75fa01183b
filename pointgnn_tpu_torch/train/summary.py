"""Scalar summary logging, TensorBoard when available and JSONL always
(copy of :mod:`pointgnn_tpu.train.summary`).

One writer per directory, with the reference's
``write_summary_scale(key, value, step, dir)`` API.  Scalars
are always appended to ``<dir>/scalars.jsonl`` so runs are inspectable
without TensorBoard; a ``torch.utils.tensorboard`` event file is written
too when the package is importable.
"""

import json
import os
import time
from typing import Dict

_WRITERS: Dict[str, object] = {}
_FILES: Dict[str, object] = {}


def _tb_writer(directory: str):
    if directory in _WRITERS:
        return _WRITERS[directory]
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(log_dir=directory)
    except Exception:
        writer = None
    _WRITERS[directory] = writer
    return writer


def _jsonl(directory: str):
    if directory not in _FILES:
        os.makedirs(directory, exist_ok=True)
        _FILES[directory] = open(
            os.path.join(directory, "scalars.jsonl"), "a"
        )
    return _FILES[directory]


def write_summary_scale(key: str, value, step: int, directory: str):
    """Append one scalar to ``<directory>/scalars.jsonl`` (and the
    directory's TensorBoard event file when there is one)."""
    writer = _tb_writer(directory)
    if writer is not None:
        writer.add_scalar(key, float(value), int(step))
    f = _jsonl(directory)
    f.write(
        json.dumps(
            {
                "key": key,
                "value": float(value),
                "step": int(step),
                "time": time.time(),
            }
        )
        + "\n"
    )
    f.flush()


def flush(directory: str = None):
    for d, w in _WRITERS.items():
        if w is not None and (directory is None or d == directory):
            w.flush()
    for d, f in _FILES.items():
        if directory is None or d == directory:
            f.flush()


def close(directory: str):
    """Close the directory's writers (the next scalar reopens them)."""
    writer = _WRITERS.pop(directory, None)
    if writer is not None:
        writer.close()
    f = _FILES.pop(directory, None)
    if f is not None:
        f.close()
