"""The single-device training step and the one-frame loss (counterpart
of the single-device branches of :mod:`pointgnn_tpu.parallel.step`).

With a ``graph_builder`` (the on-device pipeline) the step takes a stack
of ``frames_per_device`` DeviceFrames, builds each frame's graph on its
own grid, runs the model and the loss frame by frame, and combines them
with the graph-union endpoint weighting of the reference's batching:

    cls = sum_f cls_f * n_ep_f / sum_f n_ep_f     (loc: n_val_f)

Without one (host-built graphs) it takes the padded union of the step's
frames (``graph.pad.batch_and_pad``, on the device) and runs the model
and the loss once over it, as the JAX step does.

The parameters are updated in place (one set of tensors, the leaves of
``state.params``); the returned state carries the next step count.  A
model with batch norms also returns each site's statistics from its
forward (summed over the step's frames), and after the optimizer update
the step folds them into the moving averages stored in the parameters
(``mlp.update_bn_ema``, decay ``bn_decay``).

With a ``mesh`` (:mod:`pointgnn_tpu_torch.parallel.mesh`) the step is
the JAX step's SPMD body, run by every rank on its own share of the
frames.  Each collective stands for one of the JAX step's:

- ``unify_copies``: the endpoint counts are summed over the ranks, so
  each rank's loss terms weigh its endpoints against the whole batch's
  (host graphs: ``w = n_dev * n_ep / tot_ep``; device graphs: the
  union sums over ``tot_ep``), as if one device saw every frame;
- each rank's backward runs on its loss over ``n_dev`` (or on its share
  of the global union loss), and the gradients are summed over the
  ranks: the mean gradient, as JAX's transposed ``psum`` gives it;
- the batch norms' statistics and the streaming-metric counts are
  summed, the scalar losses are the global ones (``pmean`` where JAX
  takes it), and ``classwise_loc_loss``, ``num_endpoint`` and
  ``num_valid_endpoint`` carry a leading device axis.

Every rank ends the step with the same parameters, bit for bit.
"""

from typing import Any, NamedTuple, Optional

import torch

from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.nn import mlp
from pointgnn_tpu_torch.parallel import mesh as mesh_lib
from pointgnn_tpu_torch.train import metrics as metrics_lib
from pointgnn_tpu_torch.train.optimizers import param_leaves


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


_SCALAR_KEYS = ("cls_loss", "loc_loss", "reg_loss", "total_loss")
_PER_DEVICE_KEYS = (
    "classwise_loc_loss", "num_endpoint", "num_valid_endpoint",
)
_METRIC_KEYS = ("confusion", "pr_pos_hist", "pr_neg_hist")


def _forward(model, params, graph):
    """``(logits, boxes, bn_stats)``; the statistics are None unless the
    model trains batch norms."""
    if model._has_bn and model.mode == "train":
        return model.apply(params, graph, collect_stats=True)
    return model.apply(params, graph) + (None,)


def make_loss_fn(model, loss_cfg, with_logits: bool = False):
    """The total loss over one labeled graph.

    Returns ``loss_fn(params, graph) -> (total, d)``: ``d`` holds the
    model's loss terms (``cls_loss``, ``loc_loss``, ``reg_loss``,
    ``classwise_loc_loss``, ``num_endpoint``, ``num_valid_endpoint``),
    ``total_loss``, ``with_logits`` the detached ``logits`` and, for a
    train-mode model with batch norms, ``bn_stats``.  ``unify_weights``
    ``(w, vw)`` (the data-parallel step's endpoint reweighting) scales
    ``cls_loss`` by ``w`` and ``loc_loss`` by ``vw``."""

    def loss_fn(params, graph, unify_weights=None):
        logits, boxes, bn_stats = _forward(model, params, graph)
        d = model.loss(
            logits, graph.cls_labels, boxes, graph.encoded_boxes,
            graph.valid_boxes, graph.vertex_mask[model.output_graph_level],
            **loss_cfg,
        )
        if unify_weights is not None:
            w, vw = unify_weights
            d["cls_loss"] = d["cls_loss"] * w
            d["loc_loss"] = d["loc_loss"] * vw
        d["reg_loss"] = model.reg_loss(params)
        total = d["cls_loss"] + d["loc_loss"] + d["reg_loss"]
        d["total_loss"] = total
        if with_logits:
            d["logits"] = logits.detach()
        if bn_stats is not None:
            d["bn_stats"] = bn_stats
        return total, d

    return loss_fn


def _frame(batch, f):
    """Frame ``f`` of a stacked DeviceFrame (every leaf indexed)."""
    return type(batch)(*[
        type(x)(*[y[f] for y in x]) if isinstance(x, tuple) else x[f]
        for x in batch
    ])


def make_union_sums_fn(model, loss_cfg, graph_builder,
                       frames_per_device: int, with_metrics: bool = False):
    """Loss SUMS over ``frames_per_device`` stacked frames.

    Returns ``sums_fn(params, frames_batch, rnds=None) -> (acc,
    reg_loss)``: ``acc`` holds ``cls_w`` (sum of cls_f * n_ep_f),
    ``loc_w``, ``n_ep``, ``n_val``, the summed ``classwise`` breakdown
    and, with metrics, the summed metric counts; for a train-mode model
    with batch norms, ``bn_stats``, each site's statistics summed over
    the frames.  ``rnds`` holds one frame's graph randomization (``(shift,
    perm)`` draws) per frame."""

    def frame_terms(params, frame, rnd):
        graph = graph_builder(frame, rnd)
        logits, boxes, bn_stats = _forward(model, params, graph)
        d = model.loss(
            logits, graph.cls_labels, boxes, graph.encoded_boxes,
            graph.valid_boxes, graph.vertex_mask[model.output_graph_level],
            **loss_cfg,
        )
        n_ep = d["num_endpoint"].to(torch.float32)
        n_val = d["num_valid_endpoint"].to(torch.float32)
        out = {
            "cls_w": d["cls_loss"] * n_ep,
            "loc_w": d["loc_loss"] * n_val,
            "n_ep": n_ep,
            "n_val": n_val,
            "classwise": d["classwise_loc_loss"],
        }
        if bn_stats is not None:
            out["bn_stats"] = bn_stats
        if with_metrics:
            out.update(metrics_lib.device_updates(
                logits.detach(), graph.cls_labels,
                graph.vertex_mask[model.output_graph_level],
                model.num_classes,
            ))
        return out

    def sums_fn(params, frames_batch, rnds=None):
        acc = None
        for f in range(frames_per_device):
            rnd = None if rnds is None else rnds[f]
            terms = frame_terms(params, _frame(frames_batch, f), rnd)
            acc = terms if acc is None else {
                k: _add(acc[k], v) for k, v in terms.items()
            }
        return acc, model.reg_loss(params)

    return sums_fn


def _add(a, b):
    """``a + b`` over tensors and the ``bn_stats`` dicts of tuples."""
    if isinstance(a, dict):
        return {k: tuple(x + y for x, y in zip(a[k], b[k])) for k in a}
    return a + b


def graph_generator(seed: int, step: int, frame: int, device,
                    rank: Optional[int] = None):
    """The generator of one frame's graph randomization in one step
    (``device_builder.draw_randomization``): seeded from (seed, step,
    frame), so a resumed run sees the graphs the uninterrupted run would
    have seen.  A data-parallel step folds in the rank (``rank`` given,
    JAX's ``fold_in(key, axis_index)``), so that the ranks draw apart."""
    mixed = ((seed * 1000003 + step) * 1000003 + frame) % (2 ** 63)
    if rank is not None:
        mixed = (mixed * 1000003 + rank + 1) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def make_train_step(
    model,
    optimizer,
    loss_cfg: dict,
    graph_builder=None,
    frames_per_device: int = 1,
    with_metrics: bool = False,
    graph_rng_seed: Optional[int] = None,
    bn_decay: float = 0.999,
    mesh: Optional[mesh_lib.Mesh] = None,
    unify_copies: bool = True,
):
    """``step(state, batch) -> (state, aux)`` on one device.

    With ``graph_builder``, ``batch`` is a stack of ``frames_per_device``
    DeviceFrames on the device, ``graph_builder`` builds each frame's
    graph and ``graph_rng_seed`` randomizes each frame's graph per step.
    Without it, ``batch`` is a padded union graph on the device
    (``frames_per_device`` must be 1: the frames are unioned before the
    step).  ``bn_decay`` is the batch norms' moving-average decay.

    With ``mesh``, every rank of the group calls the step on its own
    share of the batch (``frames_per_device`` frames, or their padded
    union) and the step is data-parallel, as the module docstring says;
    ``unify_copies`` reweighs the loss terms by the endpoint counts
    summed over the ranks.  ``mesh=None`` is the single-device step."""
    # f32 training: the dense layers outside the kernels must not drop
    # to TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if graph_builder is None:
        if frames_per_device != 1:
            raise ValueError(
                "frames_per_device > 1 needs a graph_builder (host-built "
                "graphs union the frames in pad.batch_and_pad)"
            )
        return _make_graph_step(model, optimizer, loss_cfg, with_metrics,
                                bn_decay, mesh, unify_copies)
    sums_fn = make_union_sums_fn(model, loss_cfg, graph_builder,
                                 frames_per_device, with_metrics)
    rank = None if mesh is None else mesh.rank

    def _rnds(step_no, batch):
        if graph_rng_seed is None:
            return None
        points = batch.packed_points
        return [db.draw_randomization(points.shape[-2], graph_generator(
            graph_rng_seed, step_no, f, points.device, rank))
            for f in range(frames_per_device)]

    def step(state: TrainState, batch):
        for t in param_leaves(state.params):
            t.grad = None
        acc, reg = sums_fn(state.params, batch, _rnds(state.step, batch))
        if mesh is None:
            cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
            loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
            total = cls + loc + reg
            total.backward()
        elif unify_copies:
            # this rank's share of the global union loss: the summed
            # gradient is the one-big-batch gradient
            tot_ep, tot_val = mesh_lib.sum_across(
                mesh, [acc["n_ep"], acc["n_val"]])
            cls = acc["cls_w"] / torch.clamp(tot_ep, min=1.0)
            loc = acc["loc_w"] / torch.clamp(tot_val, min=1.0)
            (cls + loc + reg / mesh.size).backward()
        else:
            cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
            loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
            ((cls + loc + reg) / mesh.size).backward()
        aux = {
            "classwise_loc_loss": acc["classwise"] / frames_per_device,
            "num_endpoint": acc["n_ep"],
            "num_valid_endpoint": acc["n_val"],
        }
        summed = {"cls_loss": cls, "loc_loss": loc}
        if with_metrics:
            summed.update({k: acc[k] for k in _METRIC_KEYS})
        if "bn_stats" in acc:
            summed["bn_stats"] = acc["bn_stats"]
        if mesh is not None:
            summed, gathered = _sync_ranks(mesh, state.params, summed, aux)
            aux.update(gathered)
            if not unify_copies:  # pmean
                for k in ("cls_loss", "loc_loss"):
                    summed[k] = summed[k] / mesh.size
            total = summed["cls_loss"] + summed["loc_loss"] + reg
        bn_stats = summed.pop("bn_stats", None)
        aux.update(summed, reg_loss=reg, total_loss=total)
        _update(optimizer, state, bn_stats, bn_decay)
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        return TrainState(state.step + 1, state.params,
                          state.opt_state), aux

    return step


def _sync_ranks(mesh, params, summed, gathered):
    """The data-parallel step's collectives after its backward: every
    trainable leaf's gradient and each entry of ``summed`` (tensors, or
    ``bn_stats`` dicts of statistics) summed over the ranks, one bucket
    per dtype; the summed gradients replace ``.grad``.  Each entry of
    ``gathered`` is stacked over a leading device axis.  Returns the
    summed and the gathered dicts."""
    leaves = [t for t in param_leaves(params) if t.requires_grad]
    flat = [t.grad if t.grad is not None else torch.zeros_like(t)
            for t in leaves]
    spots = []
    for key, val in summed.items():
        if isinstance(val, dict):  # a site path -> (sum, sum_sq, count)
            for path, stats in val.items():
                spots.append((key, path, len(stats)))
                flat.extend(stats)
        else:
            spots.append((key, None, 1))
            flat.append(val)
    reduced = mesh_lib.sum_across(mesh, flat)
    for t, g in zip(leaves, reduced):
        t.grad = g
    out, pos = {}, len(leaves)
    for key, path, n in spots:
        if path is None:
            out[key] = reduced[pos]
        else:
            out.setdefault(key, {})[path] = tuple(reduced[pos:pos + n])
        pos += n
    return out, {k: mesh_lib.gather_stack(mesh, v)
                 for k, v in gathered.items()}


def _update(optimizer, state, bn_stats, bn_decay):
    """The optimizer update, then the batch norms' moving averages from
    the statistics of the step's forward (leaves without a gradient,
    which the optimizer skips)."""
    optimizer.apply(state.opt_state, state.params)
    if bn_stats is not None:
        mlp.update_bn_ema(state.params, bn_stats, bn_decay)


def _endpoint_counts(model, graph):
    """``(n_ep, n_val)``: the graph's real output vertices and valid
    boxes, which do not depend on the parameters."""
    return (torch.sum(graph.vertex_mask[model.output_graph_level]),
            torch.sum(graph.valid_boxes))


def _make_graph_step(model, optimizer, loss_cfg, with_metrics, bn_decay,
                     mesh=None, unify_copies=True):
    """The step over one padded graph: the loss dict of
    :func:`make_loss_fn`, its backward and the optimizer update; with a
    mesh, the JAX step's ``_spmd_grads``."""
    loss_fn = make_loss_fn(model, loss_cfg, with_logits=with_metrics)

    def step(state: TrainState, graph):
        for t in param_leaves(state.params):
            t.grad = None
        weights = None
        if mesh is not None and unify_copies:
            n_ep, n_val = _endpoint_counts(model, graph)
            tot_ep, tot_val = mesh_lib.sum_across(mesh, [n_ep, n_val])
            zero = torch.zeros((), device=n_ep.device)
            weights = tuple(
                torch.where(tot > 0, mesh.size * n / torch.clamp(
                    tot, min=1.0), zero)
                for n, tot in ((n_ep, tot_ep), (n_val, tot_val)))
        total, aux = loss_fn(state.params, graph, weights)
        if mesh is None:
            total.backward()
        else:
            (total / mesh.size).backward()
        if with_metrics:
            aux.update(metrics_lib.device_updates(
                aux.pop("logits"), graph.cls_labels,
                graph.vertex_mask[model.output_graph_level],
                model.num_classes,
            ))
        if mesh is not None:
            summed = {k: aux.pop(k) for k in _SCALAR_KEYS}
            if with_metrics:
                summed.update({k: aux.pop(k) for k in _METRIC_KEYS})
            if "bn_stats" in aux:
                summed["bn_stats"] = aux.pop("bn_stats")
            summed, gathered = _sync_ranks(
                mesh, state.params, summed,
                {k: aux.pop(k) for k in _PER_DEVICE_KEYS})
            for k in _SCALAR_KEYS:  # pmean
                summed[k] = summed[k] / mesh.size
            aux.update(summed, **gathered)
        _update(optimizer, state, aux.pop("bn_stats", None), bn_decay)
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        return TrainState(state.step + 1, state.params,
                          state.opt_state), aux

    return step
