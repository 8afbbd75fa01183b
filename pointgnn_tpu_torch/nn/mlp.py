"""MLP building blocks (counterpart of :mod:`pointgnn_tpu.nn.mlp`).

Only the ``NONE`` normalization that every shipped config uses is
ported.  The weight regularizers (``l1``, ``l2``, ``l1_l2``) and
:func:`regularization_loss` enter the training loss.  :func:`dense` rounds its inputs to the compute dtype and
accumulates in float32, like ``jnp.dot(..., preferred_element_type=
float32)``: the bf16-rounded operands are multiplied as float32 tensors,
so the f32 accumulator is never rounded back to bf16.
"""

from typing import List, Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "ReLU": torch.relu,
    "ReLU6": lambda x: torch.clamp(x, 0.0, 6.0),
    "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "ELU": F.elu,
    "NONE": None,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
}


def as_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """``None``/"float32" -> None (plain f32); "bfloat16" -> bf16."""
    if compute_dtype is None:
        return None
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    return None if compute_dtype == torch.float32 else compute_dtype


def round_to(x, compute_dtype):
    """Round ``x`` through the compute dtype, keeping it float32."""
    cd = as_compute_dtype(compute_dtype)
    return x if cd is None else x.to(cd).to(torch.float32)


def dense(params, x, compute_dtype=None):
    """``x @ w + b`` with low-precision inputs and f32 accumulation."""
    w, b = params["w"], params["b"]
    y = round_to(x, compute_dtype) @ round_to(w, compute_dtype)
    return y + b.to(y.dtype)


def check_norm(normalization_type):
    if normalization_type != "NONE":
        raise NotImplementedError(
            "only NONE normalization is ported, got %r (BN and instance "
            "norm: ROADMAP.md Queue 1 item 6)" % normalization_type
        )


def apply_mlp(
    params: List[dict],
    x,
    is_logits: bool = False,
    normalization_type: str = "NONE",
    activation_type: str = "ReLU",
    compute_dtype=None,
):
    """``multi_layer_neural_network_fn`` parity; ``is_logits=True``
    leaves the final layer linear."""
    check_norm(normalization_type)
    act = ACTIVATIONS[activation_type]
    n = len(params)
    for i, layer in enumerate(params):
        x = dense(layer, x, compute_dtype)
        if not (is_logits and i == n - 1) and act is not None:
            x = act(x)
    return x


def apply_fc(
    params, x, is_logits=True, normalization_type="NONE",
    activation_type="ReLU", compute_dtype=None,
):
    """``multi_layer_fc_fn`` parity: hidden layers act; the output
    layer is linear iff ``is_logits``."""
    return apply_mlp(
        params, x, is_logits=is_logits,
        normalization_type=normalization_type,
        activation_type=activation_type, compute_dtype=compute_dtype,
    )


def l1_regularizer(scale):
    return lambda w: scale * torch.sum(torch.abs(w))


def l2_regularizer(scale):
    return lambda w: scale * 0.5 * torch.sum(torch.square(w))


def l1_l2_regularizer(scale_l1=1.0, scale_l2=1.0):
    return lambda w: (scale_l1 * torch.sum(torch.abs(w))
                      + scale_l2 * 0.5 * torch.sum(torch.square(w)))


REGULARIZERS = {
    "l1": l1_regularizer,
    "l2": l2_regularizer,
    "l1_l2": l1_l2_regularizer,
}


def named_leaves(tree, key=None):
    """``(dict key, tensor)`` for every tensor of a parameter tree, in
    order; a list's items carry the key of the list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from named_leaves(v, key)
    elif tree is not None:
        yield key, tree


def regularization_loss(params_tree, reg_fn):
    """Sum ``reg_fn`` over every dense kernel ``w`` of the tree (weights
    are regularized, biases are not)."""
    total = 0.0
    for key, leaf in named_leaves(params_tree):
        if key == "w":
            total = total + reg_fn(leaf)
    return total
