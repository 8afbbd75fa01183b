"""Streaming training metrics (counterpart of
:mod:`pointgnn_tpu.train.metrics`).

The per-step update runs on the device inside the train step
(:func:`device_updates`: [C, 3] confusion counts and [C, B] class
probability histograms over the same 200 thresholds); accumulation and
the PR-AUC interpolation (:class:`StreamingMetrics`) run on the host.
"""

from typing import Dict

import numpy as np
import torch

NUM_THRESHOLDS = 200
_KEPSILON = 1e-7


def thresholds(num: int = NUM_THRESHOLDS) -> np.ndarray:
    """Threshold grid: interior points plus +/-epsilon sentinels."""
    inner = [(i + 1) * 1.0 / (num - 1) for i in range(num - 2)]
    return np.array([0.0 - _KEPSILON] + inner + [1.0 + _KEPSILON])


def device_updates(logits, labels, mask, num_classes: int):
    """Per-step metric counts.

    Args: logits [K, C]; labels [K] int; mask [K] 1.0 = real vertex.
    Returns a dict of ``confusion`` [C, 3] (TP, predicted positive,
    labeled positive) and ``pr_pos_hist`` / ``pr_neg_hist`` [C, B - 1]:
    histograms of each class's probability over the threshold bins
    (bin b counts p in (edges[b], edges[b + 1]]) for positive / negative
    vertices."""
    probs = torch.softmax(logits, dim=-1)
    preds = torch.argmax(probs, dim=-1)
    mask = mask.to(torch.float32)
    edges = torch.as_tensor(thresholds(), dtype=torch.float32,
                            device=logits.device)
    nbins = edges.shape[0] - 1
    confusion, pos_hists, neg_hists = [], [], []
    for c in range(num_classes):
        is_label = (labels == c).to(torch.float32) * mask
        is_pred = (preds == c).to(torch.float32) * mask
        tp = torch.sum(is_label * is_pred)
        confusion.append(torch.stack([tp, torch.sum(is_pred),
                                      torch.sum(is_label)]))
        bin_idx = torch.clamp(
            torch.searchsorted(edges, probs[:, c].contiguous()) - 1,
            0, nbins - 1,
        )
        pos = torch.zeros(nbins, device=logits.device)
        neg = torch.zeros(nbins, device=logits.device)
        pos_hists.append(pos.index_add_(0, bin_idx, is_label))
        neg_hists.append(neg.index_add_(0, bin_idx, (1.0 - is_label) * mask))
    return {
        "confusion": torch.stack(confusion),
        "pr_pos_hist": torch.stack(pos_hists),
        "pr_neg_hist": torch.stack(neg_hists),
    }


def interpolated_pr_auc(tp, fp, fn) -> float:
    """Careful-interpolation PR-AUC from cumulative counts at each
    threshold."""
    tp, fp, fn = (np.asarray(a, np.float64) for a in (tp, fp, fn))
    dtp = tp[:-1] - tp[1:]
    p = tp + fp
    dp = p[:-1] - p[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        prec_slope = np.where(np.maximum(dp, 0) > 0,
                              dtp / np.maximum(dp, 1e-12), 0.0)
        intercept = tp[1:] - prec_slope * p[1:]
        safe_p_ratio = np.where(
            (p[:-1] > 0) & (p[1:] > 0), p[:-1] / np.maximum(p[1:], 1e-12),
            1.0,
        )
        denom = np.maximum(tp[1:] + fn[1:], 0)
        increment = np.where(
            denom > 0,
            prec_slope * (dtp + intercept * np.log(safe_p_ratio))
            / np.maximum(denom, 1e-12),
            0.0,
        )
    return float(np.sum(increment))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


class StreamingMetrics:
    """Host-side accumulator, reset per epoch."""

    def __init__(self, num_classes: int, encoding_len: int = 7):
        self.num_classes = num_classes
        self.encoding_len = encoding_len
        self.reset()

    def reset(self):
        self._scalar_sums: Dict[str, float] = {}
        self._steps = 0
        self._confusion = np.zeros((self.num_classes, 3))
        self._pos_hist = np.zeros((self.num_classes, NUM_THRESHOLDS - 1))
        self._neg_hist = np.zeros((self.num_classes, NUM_THRESHOLDS - 1))
        self._classwise_loc = np.zeros((self.num_classes, self.encoding_len))

    def update(self, aux: Dict):
        """Consume one step's aux dict (tensors or numpy)."""
        self._steps += 1
        for key in ("cls_loss", "loc_loss", "reg_loss", "total_loss"):
            if key in aux:
                self._scalar_sums[key] = (self._scalar_sums.get(key, 0.0)
                                          + float(_host(aux[key])))
        if "confusion" in aux:
            for name, dst in (("confusion", self._confusion),
                              ("pr_pos_hist", self._pos_hist),
                              ("pr_neg_hist", self._neg_hist)):
                val = _host(aux[name])
                dst += val.sum(0) if val.ndim == 3 else val
        if "classwise_loc_loss" in aux:
            cw = _host(aux["classwise_loc_loss"])
            self._classwise_loc += cw.sum(0) if cw.ndim == 3 else cw

    def results(self) -> Dict[str, float]:
        """Snapshot with the reference's metric names."""
        steps = max(self._steps, 1)
        out = {k: v / steps for k, v in self._scalar_sums.items()}
        for c in range(self.num_classes):
            tp, pred_pos, label_pos = self._confusion[c]
            out["recall_%d" % c] = tp / label_pos if label_pos > 0 else 0.0
            out["precision_%d" % c] = tp / pred_pos if pred_pos > 0 else 0.0
            pos_above = np.concatenate(
                [np.cumsum(self._pos_hist[c][::-1])[::-1], [0.0]]
            )
            neg_above = np.concatenate(
                [np.cumsum(self._neg_hist[c][::-1])[::-1], [0.0]]
            )
            total_pos = self._pos_hist[c].sum()
            out["mAP_%d" % c] = interpolated_pr_auc(
                tp=pos_above, fp=neg_above, fn=total_pos - pos_above
            )
            out["loc_loss_cls_%d" % c] = self._classwise_loc[c].sum() / steps
            for bi in range(self.encoding_len):
                out["loc_loss_cls_%d_box_%d" % (c, bi)] = (
                    self._classwise_loc[c, bi] / steps
                )
        return out

    def print_epoch(self, step: int, epoch: int, lr: float, seconds: float):
        r = self.results()
        print(
            "STEP: %d, epoch_idx: %d, lr: %f, time cost: %f"
            % (step, epoch, lr, seconds)
        )
        print(
            "cls:%f, loc:%f, reg:%f, loss: %f"
            % (
                r.get("cls_loss", 0.0),
                r.get("loc_loss", 0.0),
                r.get("reg_loss", 0.0),
                r.get("total_loss", 0.0),
            )
        )
        for c in range(self.num_classes):
            print(
                "Class_%d: recall=%f, prec=%f, mAP=%f, loc=%f"
                % (
                    c,
                    r["recall_%d" % c],
                    r["precision_%d" % c],
                    r["mAP_%d" % c],
                    r["loc_loss_cls_%d" % c],
                )
            )
        return r
