"""Checkpoints in the port's own format, with the JAX package's
directory contract (:mod:`pointgnn_tpu.train.checkpoint`):
``<dir>/config`` and ``<dir>/train_config`` hold the frozen configs and
``<dir>/model-<step>/`` one saved state.

A step directory holds one ``params.npz``: every array leaf of the state
under its ``/``-joined tree path, and under ``__tree__`` a JSON record of
the tree (dicts with their key types, lists, tuples, ``None`` and plain
Python scalars).  It is numpy without pickle, so it loads on any machine
with numpy.  A ``torch.optim.Optimizer`` in the state is saved as its
``state_dict()`` and restored as that dict (give it to the optimizer's
``load_state_dict``).  A JAX (orbax) step directory has no
``params.npz``; ``convert_jax_checkpoint.py`` converts it.
"""

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.utils import config_io
from pointgnn_tpu_torch.utils.device import resolve_device

STATE_FILE = "params.npz"
TREE_KEY = "__tree__"
_STEP_RE = re.compile(r"^model-(\d+)$")


def _encode(node, path, arrays):
    """JSON record of ``node``; its array leaves go into ``arrays``."""
    if isinstance(node, torch.optim.Optimizer):
        return {"optimizer": _encode(node.state_dict(), path, arrays)}
    if isinstance(node, dict):
        items = []
        for key, val in node.items():
            if isinstance(key, bool) or not isinstance(key, (str, int)):
                raise TypeError("checkpoint keys are str or int, got %r"
                                % (key,))
            if "/" in str(key):
                raise ValueError("checkpoint key %r holds a '/'" % (key,))
            items.append([key, _encode(val, path + [str(key)], arrays)])
        return {"dict": items}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, path + [str(i)], arrays)
                       for i, v in enumerate(node)]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    name = "/".join(path)
    if name in arrays or name == TREE_KEY:
        raise ValueError("checkpoint path %r is not unique" % name)
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
            arrays[name] = t.view(torch.int16).numpy()
            return {"array": name, "dtype": "bfloat16"}
        arrays[name] = t.numpy()
        return {"array": name}
    arr = np.asarray(node)
    if arr.dtype == object:
        raise TypeError("cannot checkpoint %s at %r" % (type(node), name))
    arrays[name] = arr
    return {"array": name}


def _decode(rec, arrays, device):
    if "optimizer" in rec:
        return _decode(rec["optimizer"], arrays, device)
    if "dict" in rec:
        return {key: _decode(val, arrays, device) for key, val in rec["dict"]}
    if "list" in rec:
        return [_decode(v, arrays, device) for v in rec["list"]]
    if "tuple" in rec:
        return tuple(_decode(v, arrays, device) for v in rec["tuple"])
    if "value" in rec:
        return rec["value"]
    t = torch.from_numpy(np.array(arrays[rec["array"]]))
    if rec.get("dtype") == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def save_checkpoint(
    train_dir: str,
    step: int,
    state: Dict[str, Any],
    config: Optional[dict] = None,
    train_config: Optional[dict] = None,
) -> str:
    """Save the tree ``state`` (parameters, and the optimizer state if
    it holds one) as ``<train_dir>/model-<step>/params.npz`` and freeze
    the configs next to it.  Returns the step directory."""
    if not isinstance(state, dict):
        raise TypeError("the checkpoint state is a dict, got %s"
                        % type(state))
    train_dir = os.path.abspath(train_dir)
    path = os.path.join(train_dir, "model-%d" % step)
    os.makedirs(path, exist_ok=True)
    save_tree(os.path.join(path, STATE_FILE), state)
    if config is not None:
        config_io.save_config(os.path.join(train_dir, "config"), config)
    if train_config is not None:
        config_io.save_train_config(
            os.path.join(train_dir, "train_config"), train_config
        )
    return path


def list_checkpoint_steps(train_dir: str):
    if not os.path.isdir(train_dir):
        return []
    steps = []
    for name in os.listdir(train_dir):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(train_dir, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(train_dir: str) -> Optional[str]:
    """Path of the newest ``model-<step>`` dir, or None."""
    steps = list_checkpoint_steps(train_dir)
    if not steps:
        return None
    return os.path.join(train_dir, "model-%d" % steps[-1])


def restore_checkpoint(
    train_dir: str,
    step: Optional[int] = None,
    device=None,
) -> Tuple[Optional[Dict[str, Any]], int]:
    """``(state, step)`` from the latest (or the given) step, every array
    leaf a tensor on ``device`` (cuda by default).  ``(None, 0)`` when
    the directory holds no step; raises on a step directory that is not
    in the port's format."""
    device = resolve_device(device)
    if step is None:
        steps = list_checkpoint_steps(train_dir)
        if not steps:
            return None, 0
        step = steps[-1]
    path = os.path.join(os.path.abspath(train_dir), "model-%d" % step)
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        raise ValueError(
            "%s holds no %s: it is not a checkpoint of the PyTorch port "
            "(a JAX/orbax checkpoint?); convert it with "
            "convert_jax_checkpoint.py" % (path, STATE_FILE))
    return load_tree(file, device), step


def save_tree(file: str, tree) -> None:
    """Write a tree (dicts, lists, tuples, arrays, tensors, optimizers,
    plain scalars) to one ``.npz`` file in the checkpoint format."""
    arrays = {}
    record = _encode(tree, [], arrays)
    arrays[TREE_KEY] = np.array(json.dumps(record))
    tmp = file + ".tmp%d" % os.getpid()
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, file)


def load_tree(file: str, device="cpu"):
    """The tree :func:`save_tree` wrote, every array a tensor on
    ``device``."""
    with np.load(file, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    record = json.loads(arrays.pop(TREE_KEY).item())
    return _decode(record, arrays, torch.device(device))
