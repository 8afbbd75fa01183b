"""Classification and localization losses, mask-aware (counterpart of
:mod:`pointgnn_tpu.model.losses`).

Every reduction over "all endpoints" is taken over the valid endpoints
given by an explicit ``endpoint_mask``; padded rows carry zero loss.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def sparse_softmax_cross_entropy(labels, logits):
    """labels [N] int, logits [N, C] -> [N]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None].to(torch.int64))[:, 0]


def sigmoid_cross_entropy(labels_onehot, logits):
    """Elementwise binary cross entropy with logits."""
    return (
        torch.clamp(logits, min=0.0)
        - logits * labels_onehot
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def focal_loss_sigmoid(labels, logits, alpha=0.5, gamma=2.0):
    """labels [N] int, logits [N, C] -> [N, C]."""
    num_classes = logits.shape[1]
    prob = torch.sigmoid(logits)
    onehot = F.one_hot(labels.to(torch.int64), num_classes).to(logits.dtype)
    ce = sigmoid_cross_entropy(onehot, logits)
    prob_t = onehot * prob + (1.0 - onehot) * (1.0 - prob)
    modulating = torch.pow(1.0 - prob_t, gamma)
    alpha_weight = onehot * alpha + (1.0 - onehot) * (1.0 - alpha)
    return modulating * alpha_weight * ce


def focal_loss_softmax(labels, logits, gamma=2.0):
    """labels [N] int, logits [N, C] -> [N]."""
    probs = torch.softmax(logits, dim=-1)
    ce = sparse_softmax_cross_entropy(labels, logits)
    p_t = torch.gather(probs, 1, labels[:, None].to(torch.int64))[:, 0]
    return torch.pow(1.0 - p_t, gamma) * ce


def huber(x, delta=1.0):
    """Elementwise Huber loss: quadratic below ``delta``."""
    absx = torch.abs(x)
    quad = torch.clamp(absx, max=delta)
    lin = absx - quad
    return 0.5 * quad * quad + delta * lin


def masked_mean(values, mask):
    """Mean over entries where mask == 1 (0 if there are none)."""
    m = mask.to(values.dtype)
    while m.ndim < values.ndim:
        m = m[..., None]
    denom = torch.sum(m) * (values.numel() / mask.numel())
    s = torch.sum(values * m)
    return torch.where(denom > 0, s / torch.clamp(denom, min=1.0),
                       torch.zeros((), dtype=s.dtype, device=s.device))


def classification_loss(
    cls_loss_type: str,
    labels,            # [N] int32
    logits,            # [N, C]
    endpoint_mask,     # [N] 1 = valid
    cls_loss_kwargs: Optional[dict] = None,
):
    """Returns (scalar mean loss over valid endpoints, per-point loss)."""
    cls_loss_kwargs = dict(cls_loss_kwargs or {})
    if cls_loss_type in ("softmax", "top_k_softmax"):
        point_loss = sparse_softmax_cross_entropy(labels, logits)
    elif cls_loss_type == "focal_sigmoid":
        point_loss = focal_loss_sigmoid(
            labels, logits,
            alpha=cls_loss_kwargs.pop("alpha", 0.5),
            gamma=cls_loss_kwargs.pop("gamma", 2.0),
        )
    elif cls_loss_type == "focal_softmax":
        point_loss = focal_loss_softmax(
            labels, logits, gamma=cls_loss_kwargs.pop("gamma", 2.0)
        )
    else:
        raise ValueError("unknown cls_loss_type: %s" % cls_loss_type)

    mask = endpoint_mask.to(logits.dtype)
    if point_loss.ndim == 2:
        point_loss = point_loss * mask[:, None]
    else:
        point_loss = point_loss * mask

    if cls_loss_type == "top_k_softmax":
        k = int(cls_loss_kwargs["k"])
        mean = torch.mean(torch.topk(point_loss, k).values)
    else:
        mean = masked_mean(point_loss, mask)
    return mean, point_loss


def localization_loss(
    loc_loss_type: str,
    pred_box,          # [N, 7]: the predicted encoding of the gt class
    gt_box,            # [N, 7]
    valid_box,         # [N] 1 = vertex belongs to a real object
    labels,            # [N] int32 (classwise breakdown)
    num_classes: int,
    loc_loss_weight: float = 1.0,
    loc_loss_kwargs: Optional[dict] = None,
    delta: float = 1.0,
    apply_classwise_weight: bool = True,
):
    """Returns (loc_loss scalar, classwise [num_classes, 7], num_valid):
    Huber per box dimension weighted by validity, optional per-class
    weights, and the top-k variant over the hardest vertices."""
    loc_loss_kwargs = dict(loc_loss_kwargs or {})
    labels = labels.to(torch.int64)
    valid = valid_box.to(pred_box.dtype)
    all_loc = (loc_loss_weight * huber(gt_box - pred_box, delta)
               * valid[:, None])
    if ("classwise_loc_loss_weight" in loc_loss_kwargs
            and apply_classwise_weight):
        w = torch.as_tensor(loc_loss_kwargs["classwise_loc_loss_weight"],
                            dtype=pred_box.dtype, device=pred_box.device)
        all_loc = all_loc * w[labels][:, None]

    per_vertex = torch.mean(all_loc, dim=1)  # [N]
    zero = torch.zeros((), dtype=pred_box.dtype, device=pred_box.device)

    if loc_loss_type == "huber_loss":
        num_valid = torch.sum(valid)
        loc = torch.where(
            num_valid > 0,
            torch.sum(per_vertex) / torch.clamp(num_valid, min=1.0), zero,
        )
        sel_loc, sel_labels = all_loc, labels
    elif loc_loss_type == "top_k_huber_loss":
        k = int(loc_loss_kwargs["k"])
        top_vals, top_idx = torch.topk(per_vertex, k)
        num_valid = torch.sum(valid[top_idx])
        loc = torch.where(
            num_valid > 0,
            torch.sum(top_vals) / torch.clamp(num_valid, min=1.0), zero,
        )
        sel_loc, sel_labels = all_loc[top_idx], labels[top_idx]
    else:
        raise ValueError("unknown loc_loss_type: %s" % loc_loss_type)

    onehot = F.one_hot(sel_labels, num_classes).to(sel_loc.dtype)
    classwise = onehot.T @ sel_loc  # [num_classes, 7]
    return loc, classwise, num_valid


def loss_config(config: Dict) -> Dict:
    """Map a model config's "loss" block onto ``PointGNN.loss`` kwargs."""
    loss = dict(config.get("loss", {}))
    return {
        key: loss[key] for key in (
            "cls_loss_type", "cls_loss_kwargs", "loc_loss_type",
            "loc_loss_kwargs", "loc_loss_weight", "cls_loss_weight",
        ) if key in loss
    }
