"""Parameter bridge from the JAX package's parameter tree.

The JAX model keeps its parameters as a nested dict/list tree
(``params[scope]["edge_mlp"][i]["w"]``); the port uses the same keys
with torch tensors.  The JAX side hands its tree over as numpy arrays
(``jax.device_get``), so nothing here imports JAX.
"""

import numpy as np
import torch

from pointgnn_tpu_torch.utils.device import resolve_device


def params_from_jax(tree, device=None):
    """Convert a nested dict/list/tuple tree of array-likes into the same
    tree of torch tensors on ``device`` (cuda by default); ``None``
    leaves (absent normalization state) stay ``None``."""
    device = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(device)

    return conv(tree)


def params_to_numpy(tree):
    """The inverse: torch tensors -> numpy arrays, same tree shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
