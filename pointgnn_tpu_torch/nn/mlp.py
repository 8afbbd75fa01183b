"""MLP building blocks (counterpart of :mod:`pointgnn_tpu.nn.mlp`).

The normalizations are the reference's registry: ``NONE``, ``IN``
(instance norm, no affine) and the batch norms ``fused_BN_center``,
``BN_center`` (both with a learned center ``beta``) and ``BN`` (none),
epsilon 1e-3 as slim's.  Every normalization takes a row validity mask,
so padded rows never enter the statistics.  A batch norm normalizes with
the masked batch statistics in training and with the moving averages
``ema_mean`` / ``ema_var`` stored beside ``beta`` in the parameters
otherwise (slim's ``is_training``); training records each site's
sufficient statistics ``(sum, sum_sq, count)`` and the train step folds
them into the averages with :func:`update_bn_ema`.  The averages take no
gradient (:data:`EMA_KEYS`).  The weight regularizers (``l1``, ``l2``,
``l1_l2``) and :func:`regularization_loss` enter the training loss.
:func:`dense` rounds its inputs to the compute dtype and accumulates in
float32, like ``jnp.dot(..., preferred_element_type=float32)``: the
bf16-rounded operands are multiplied as float32 tensors, so the f32
accumulator is never rounded back to bf16.
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


NORMALIZATIONS = ("fused_BN_center", "BN", "BN_center", "IN", "NONE")
BN_TYPES = ("fused_BN_center", "BN_center", "BN")
# the moving averages of a batch norm: parameters without a gradient
EMA_KEYS = ("ema_mean", "ema_var")


def _masked_moments(x, mask):
    """Mean and variance over axis 0 of the rows where ``mask`` is 1."""
    if mask is None:
        mean = torch.mean(x, dim=0, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=0, keepdim=True)
        return mean, var
    m = mask.reshape(-1, 1).to(x.dtype)
    count = torch.clamp(torch.sum(m), min=1.0)
    mean = torch.sum(x * m, dim=0, keepdim=True) / count
    var = torch.sum(torch.square(x - mean) * m, dim=0, keepdim=True) / count
    return mean, var


def instance_norm(x, mask=None, eps=1e-12):
    """Zero mean, unit variance per channel over the rows, no affine."""
    mean, var = _masked_moments(x, mask)
    return (x - mean) * torch.rsqrt(var + eps)


def batch_norm(x, norm_params, mask=None, center=True, eps=1e-3,
               use_stored=False, collect=None, collect_key=None):
    """Batch norm over the rows: with the masked batch statistics, or
    with the stored moving averages when ``use_stored``; plus ``beta``
    when ``center``.  With ``collect`` (a dict, training) the masked
    rows' ``(sum, sum_sq, count)``, detached, go under
    ``collect_key``."""
    if use_stored:
        mean = norm_params["ema_mean"][None, :]
        var = norm_params["ema_var"][None, :]
    else:
        mean, var = _masked_moments(x, mask)
        if collect is not None:
            with torch.no_grad():
                if mask is None:
                    s1 = torch.sum(x, dim=0)
                    s2 = torch.sum(torch.square(x), dim=0)
                    n = torch.tensor(float(x.shape[0]), dtype=x.dtype,
                                     device=x.device)
                else:
                    m = mask.reshape(-1, 1).to(x.dtype)
                    s1 = torch.sum(x * m, dim=0)
                    s2 = torch.sum(torch.square(x) * m, dim=0)
                    n = torch.sum(m)
            collect[collect_key] = (s1, s2, n)
    y = (x - mean) * torch.rsqrt(var + eps)
    if center and norm_params is not None:
        y = y + norm_params["beta"]
    return y


def init_norm(norm_type: str, dim: int, device=None):
    """A layer's normalization state: a batch norm's moving averages
    (0 and 1, as slim's) and, centered, its ``beta``; None otherwise."""
    def const(v):
        return torch.full((dim,), v, dtype=torch.float32, device=device)

    if norm_type not in BN_TYPES:
        return None
    state = {} if norm_type == "BN" else {"beta": const(0.0)}
    state.update(ema_mean=const(0.0), ema_var=const(1.0))
    return state


def apply_norm(norm_type, norm_params, x, mask=None, use_stored=False,
               collect=None, collect_key=None):
    if norm_type == "NONE":
        return x
    if norm_type == "IN":
        return instance_norm(x, mask)
    if norm_type in BN_TYPES:
        return batch_norm(x, norm_params, mask, center=norm_type != "BN",
                          use_stored=use_stored, collect=collect,
                          collect_key=collect_key)
    raise ValueError("unknown normalization: %s" % norm_type)


def apply_mlp(
    params: List[dict],
    x,
    is_logits: bool = False,
    normalization_type: str = "NONE",
    activation_type: str = "ReLU",
    mask=None,
    compute_dtype=None,
    bn_use_stored: bool = False,
    bn_collect=None,
    bn_prefix=(),
):
    """``multi_layer_neural_network_fn`` parity; ``is_logits=True``
    leaves the final layer linear (no normalization, no activation).
    ``mask`` marks the rows the normalizations count; a batch norm's
    statistics are collected under ``bn_prefix + (layer_index,)``."""
    act = ACTIVATIONS[activation_type]
    n = len(params)
    for i, layer in enumerate(params):
        x = dense(layer, x, compute_dtype)
        if not (is_logits and i == n - 1):
            x = apply_norm(normalization_type, layer.get("norm"), x, mask,
                           use_stored=bn_use_stored, collect=bn_collect,
                           collect_key=bn_prefix + (i,))
            if act is not None:
                x = act(x)
    return x


def apply_fc(
    params, x, is_logits=True, normalization_type="NONE",
    activation_type="ReLU", mask=None, compute_dtype=None,
    bn_use_stored=False, bn_collect=None, bn_prefix=(),
):
    """``multi_layer_fc_fn`` parity: hidden layers normalize and act;
    the output layer is linear iff ``is_logits``."""
    return apply_mlp(
        params, x, is_logits=is_logits,
        normalization_type=normalization_type,
        activation_type=activation_type, mask=mask,
        compute_dtype=compute_dtype, bn_use_stored=bn_use_stored,
        bn_collect=bn_collect, bn_prefix=bn_prefix,
    )


@torch.no_grad()
def update_bn_ema(params, stats, decay=0.999):
    """Fold collected statistics into the moving averages, in place:
    ``stats`` maps a path into ``params`` (down to a dense layer's dict)
    to that site's ``(sum, sum_sq, count)``; slim's
    ``assign_moving_average`` without zero debiasing."""
    for path, (s1, s2, n) in stats.items():
        layer = params
        for key in path:
            layer = layer[key]
        cnt = torch.clamp(n, min=1.0)
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - torch.square(mean), min=0.0)
        norm = layer["norm"]
        norm["ema_mean"].copy_(decay * norm["ema_mean"]
                               + (1.0 - decay) * mean)
        norm["ema_var"].copy_(decay * norm["ema_var"] + (1.0 - decay) * var)


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
