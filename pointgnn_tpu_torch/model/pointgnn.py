"""Config-driven Point-GNN model (counterpart of
:class:`pointgnn_tpu.model.pointgnn.PointGNN`): serving (``mode="test"``)
on slab graphs, on device-built edge lists (``pallas_tail``) or on any
edge list through the generic segment path (host-built graphs with
``edge_sentinel="dst"``, streamed in ``edge_chunks`` blocks), training
(``mode="train"``: the slab layers become differentiable through
``slab_edge_max_train``, and :meth:`PointGNN.loss` gives the loss dict)
and evaluation (``mode="eval"``: the serving forward, with the loss
settings of the eval mode and no class-wise localization weights).

Batch norms (``nn/mlp.py``) normalize with the batch's statistics in
training, where ``apply(..., collect_stats=True)`` also returns each
site's sufficient statistics for the train step's moving averages, and
with the stored averages in the eval and test modes.  A model with a
batch norm anywhere (the predictor's normalization defaults to
``fused_BN_center``, as in the JAX model) runs its edges unchunked, since
chunks would take the statistics per chunk.

The parameter tree has the JAX package's keys
(``params[scope]["edge_mlp"][i]["w"]`` ...), so :func:`~pointgnn_tpu_torch.
params.params_from_jax` makes both packages compute the same function.
"""

from typing import Dict, Optional

import numpy as np
import torch

from pointgnn_tpu_torch.graph.pad import PaddedGraph
from pointgnn_tpu_torch.model import losses as L
from pointgnn_tpu_torch.nn import mlp
from pointgnn_tpu_torch.nn.layers import (
    ClassAwarePredictor,
    GraphNetAutoCenter,
    PointSetPooling,
    predictor_widths,
)
from pointgnn_tpu_torch.utils.device import resolve_device

_POOLING_TYPES = {"scatter_max_point_set_pooling": "max"}
_GNN_TYPES = {"scatter_max_graph_auto_center_net": "max"}


def _glorot_layer(rng, din, dout, norm, device):
    """TF-slim fully_connected default init (xavier uniform), zero bias,
    and the normalization's state."""
    limit = np.sqrt(6.0 / (din + dout))
    w = rng.uniform(-limit, limit, (din, dout)).astype(np.float32)
    return {
        "w": torch.from_numpy(w).to(device),
        "b": torch.zeros(dout, dtype=torch.float32, device=device),
        "norm": mlp.init_norm(norm, dout, device),
    }


def _init_mlp(rng, din, widths, device, norm="NONE"):
    dims = [din] + list(widths)
    return [
        _glorot_layer(rng, dims[i], dims[i + 1], norm, device)
        for i in range(len(widths))
    ]


def _predictor_norm(pred_cfg) -> str:
    """The predictor's normalization; the JAX model's default is
    ``fused_BN_center``."""
    return pred_cfg["kwargs"].get("normalization_type", "fused_BN_center")


def has_bn(layer_configs) -> bool:
    """Whether any MLP of the layer configs has a batch norm."""
    return any(
        key.endswith("normalization_type") and val in mlp.BN_TYPES
        for cfg in layer_configs
        for key, val in cfg.get("kwargs", {}).items()
    ) or _predictor_norm(layer_configs[-1]) in mlp.BN_TYPES


class PointGNN:
    """Multi-layer local graph model over a two-level graph (slab
    metadata or blocked edge lists per level)."""

    def __init__(
        self,
        num_classes: int,
        box_encoding_len: int,
        layer_configs,
        mode: str = "test",
        compute_dtype=None,
        slab_level1: Optional[dict] = None,
        slab_level0: Optional[dict] = None,
        regularizer_type: Optional[str] = None,
        regularizer_kwargs: Optional[dict] = None,
        edge_sentinel: str = "dst",
        pallas_tail: bool = False,
        edge_chunks: Optional[int] = None,
    ):
        if mode not in ("train", "eval", "test"):
            raise ValueError("unknown mode %r" % (mode,))
        if regularizer_type is None:
            if regularizer_kwargs:
                raise ValueError("regularizer kwargs without a regularizer")
            self._reg_fn = None
        else:
            self._reg_fn = mlp.REGULARIZERS[regularizer_type](
                **(regularizer_kwargs or {})
            )
        # train mode: the slab layers call the differentiable kernel (no
        # remat: its backward recomputes the walk from the layer inputs)
        if mode == "train":
            if slab_level1 is not None:
                slab_level1 = dict(slab_level1, train=True)
            if slab_level0 is not None:
                slab_level0 = dict(slab_level0, train=True)
        self.num_classes = num_classes
        self.box_encoding_len = box_encoding_len
        self.layer_configs = list(layer_configs)
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.slab_level1 = slab_level1
        self.slab_level0 = slab_level0
        # padding convention of the edge lists: "src" for device-built
        # graphs, "dst" for host-built ones; the edge-list tail
        # (inference only) needs "src"
        self.edge_sentinel = edge_sentinel
        # the segment path streams the edge MLP and the reduction in
        # this many checkpointed blocks: training holds E / edge_chunks
        # edge rows at a time, forward and backward
        if edge_chunks is None:
            edge_chunks = 16 if mode == "train" else 1
        self.pallas_tail = pallas_tail and mode != "train"
        # batch norms: batch statistics in training, the stored moving
        # averages otherwise; the statistics are over the whole edge
        # list, so edges run in one block
        self._has_bn = has_bn(self.layer_configs)
        self.edge_chunks = 1 if self._has_bn else edge_chunks
        pred_cfg = self.layer_configs[-1]
        widths = predictor_widths(pred_cfg["type"])
        if widths is None:
            raise ValueError("unknown predictor type %r" % pred_cfg["type"])
        self._predictor = ClassAwarePredictor(**widths)
        self._layers = []
        for cfg in self.layer_configs[:-1]:
            if cfg["type"] in _POOLING_TYPES:
                self._layers.append(PointSetPooling(_POOLING_TYPES[cfg["type"]]))
            elif cfg["type"] in _GNN_TYPES:
                self._layers.append(GraphNetAutoCenter(_GNN_TYPES[cfg["type"]]))
            else:
                raise ValueError("unknown layer type: %s" % cfg["type"])

    @property
    def output_graph_level(self) -> int:
        """Vertex level carrying the predictor outputs."""
        return self.layer_configs[-1]["graph_level"] + 1

    def init(self, seed: int = 0, input_dim: int = 1, device=None) -> Dict:
        """Random parameters from a numpy ``RandomState(seed)`` (glorot
        uniform weights, zero biases), on ``device`` (cuda by default)."""
        device = resolve_device(device)
        rng = np.random.RandomState(seed)
        params = {}
        dim = input_dim

        def norm(kw, name):
            return kw.get(name + "_normalization_type", "NONE")

        for cfg in self.layer_configs[:-1]:
            kw = cfg["kwargs"]
            if cfg["type"] in _POOLING_TYPES:
                params[cfg["scope"]] = {
                    "point_mlp": _init_mlp(
                        rng, dim + 3, kw["point_MLP_depth_list"], device,
                        norm(kw, "point_MLP"),
                    ),
                    "output_mlp": _init_mlp(
                        rng, kw["point_MLP_depth_list"][-1],
                        kw["output_MLP_depth_list"], device,
                        norm(kw, "output_MLP"),
                    ),
                }
                dim = kw["output_MLP_depth_list"][-1]
            else:
                p = {
                    "edge_mlp": _init_mlp(
                        rng, dim + 3, kw["edge_MLP_depth_list"], device,
                        norm(kw, "edge_MLP"),
                    ),
                    "update_mlp": _init_mlp(
                        rng, kw["edge_MLP_depth_list"][-1],
                        kw["update_MLP_depth_list"], device,
                        norm(kw, "update_MLP"),
                    ),
                }
                if kw.get("auto_offset"):
                    p["auto_offset_mlp"] = _init_mlp(
                        rng, dim, kw["auto_offset_MLP_depth_list"], device,
                        norm(kw, "auto_offset_MLP"),
                    )
                params[cfg["scope"]] = p
                dim = kw["update_MLP_depth_list"][-1]
        pred = self._predictor
        pred_norm = _predictor_norm(self.layer_configs[-1])
        loc_in = pred.loc_in_dim(dim, self.num_classes)
        params[self.layer_configs[-1]["scope"]] = {
            "cls": _init_mlp(
                rng, dim, list(pred.cls_Ks) + [self.num_classes], device,
                pred_norm,
            ),
            "loc": [
                _init_mlp(
                    rng, loc_in, list(pred.loc_Ks) + [self.box_encoding_len],
                    device, pred_norm,
                )
                for _ in range(self.num_classes)
            ],
        }
        return params

    def apply(self, params, graph: PaddedGraph, collect_stats: bool = False):
        """``(logits [K, num_classes], box_encodings [K, num_classes, L])``
        on the output vertex level.  With ``collect_stats`` (a train-mode
        model with a batch norm) also the statistics of every batch-norm
        site, ``{path into params: (sum, sum_sq, count)}``, for
        :func:`~pointgnn_tpu_torch.nn.mlp.update_bn_ema`."""
        stats = {} if (collect_stats and self._has_bn) else None
        bn = dict(bn_use_stored=self._has_bn and self.mode != "train",
                  bn_collect=stats)
        features = graph.features
        for cfg, layer in zip(self.layer_configs[:-1], self._layers):
            g = cfg["graph_level"]
            kw = dict(cfg["kwargs"], compute_dtype=self.compute_dtype,
                      edges_src=graph.edges_src[g],
                      edges_dst=graph.edges_dst[g],
                      edge_sentinel=self.edge_sentinel,
                      pallas_tail=self.pallas_tail,
                      edge_chunks=self.edge_chunks,
                      bn_prefix=(cfg["scope"],), **bn)
            p = params[cfg["scope"]]
            # slab kwargs only where the graph carries that level's slab
            # metadata; a slab level's edge list is a 1-element dummy,
            # which no other path may reduce
            slab_graph = (graph.slab0_offsets if g == 0
                          else graph.slab_offsets) is not None
            wiring = self.slab_level0 if g == 0 else self.slab_level1
            if slab_graph and wiring is None:
                raise ValueError(
                    "level %d of the graph is a slab (its edge list is a "
                    "dummy): the segment path cannot reduce it; build the "
                    "model with that level's slab wiring" % g
                )
            if isinstance(layer, PointSetPooling):
                if (self.slab_level0 is not None and g == 0
                        and graph.slab0_offsets is not None):
                    kw["slab"] = dict(
                        self.slab_level0,
                        offsets=graph.slab0_offsets,
                        center_cell=graph.slab0_center_cell,
                    )
                features = layer.apply(
                    p, features, graph.vertex_xyz[g], graph.vertex_xyz[g + 1],
                    center_mask=graph.vertex_mask[g + 1],
                    point_mask=graph.vertex_mask[g], **kw,
                )
            else:
                if (self.slab_level1 is not None and g == 1
                        and graph.slab_offsets is not None):
                    kw["slab"] = dict(
                        self.slab_level1,
                        offsets=graph.slab_offsets,
                        center_cell=graph.slab_center_cell,
                    )
                features = layer.apply(
                    p, features, graph.vertex_xyz[g],
                    vertex_mask=graph.vertex_mask[g], **kw,
                )
        pred_cfg = self.layer_configs[-1]
        out = self._predictor.apply(
            params[pred_cfg["scope"]], features, self.num_classes,
            **dict(pred_cfg["kwargs"],
                   normalization_type=_predictor_norm(pred_cfg)),
            vertex_mask=graph.vertex_mask[self.output_graph_level],
            compute_dtype=self.compute_dtype,
            bn_prefix=(pred_cfg["scope"],), **bn,
        )
        if collect_stats:
            return out + (stats or {},)
        return out

    def postprocess(self, logits):
        return torch.softmax(logits, dim=-1)

    def reg_loss(self, params):
        """The weight regularization of the config (0 without one)."""
        if self._reg_fn is None:
            _, leaf = next(mlp.named_leaves(params))
            return torch.zeros((), device=leaf.device)
        return mlp.regularization_loss(params, self._reg_fn)

    def loss(
        self,
        logits,            # [K, C]
        labels,            # [K] int32
        pred_box,          # [K, C, L]
        gt_box,            # [K, L]
        valid_box,         # [K]
        endpoint_mask,     # [K]
        cls_loss_type="focal_sigmoid",
        cls_loss_kwargs=None,
        loc_loss_type="huber_loss",
        loc_loss_kwargs=None,
        loc_loss_weight=1.0,
        cls_loss_weight=1.0,
    ):
        """One frame's terms of the JAX model's loss dict: ``cls_loss``,
        ``loc_loss``, ``classwise_loc_loss``, ``num_endpoint``,
        ``num_valid_endpoint``.  ``reg_loss`` depends on the parameters
        only, so the step takes it once from :meth:`reg_loss`.  Per-mode
        settings (dicts keyed by mode) are resolved for this model's
        mode."""
        mode = self.mode

        def _select(v):
            return v[mode] if isinstance(v, dict) else v

        loc_loss_weight = _select(loc_loss_weight)
        cls_loss_weight = _select(cls_loss_weight)
        if isinstance(cls_loss_type, dict):
            cls_loss_kwargs = (cls_loss_kwargs or {})[mode]
            cls_loss_type = cls_loss_type[mode]
        if isinstance(loc_loss_type, dict):
            loc_loss_kwargs = (loc_loss_kwargs or {})[mode]
            loc_loss_type = loc_loss_type[mode]

        cls_mean, _ = L.classification_loss(
            cls_loss_type, labels, logits, endpoint_mask, cls_loss_kwargs
        )
        # the predicted encoding of each vertex's labeled class
        idx = labels.to(torch.int64)[:, None, None].expand(
            -1, 1, pred_box.shape[2]
        )
        pred_sel = torch.gather(pred_box, 1, idx)[:, 0, :]
        loc_loss, classwise, num_valid = L.localization_loss(
            loc_loss_type, pred_sel, gt_box, valid_box, labels,
            self.num_classes, loc_loss_weight=loc_loss_weight,
            loc_loss_kwargs=loc_loss_kwargs,
            apply_classwise_weight=(mode == "train"),
        )
        return {
            "cls_loss": cls_loss_weight * cls_mean,
            "loc_loss": loc_loss,
            "classwise_loc_loss": classwise,
            "num_endpoint": torch.sum(endpoint_mask),
            "num_valid_endpoint": num_valid,
        }


def get_model(model_name: str):
    models = {"multi_layer_fast_local_graph_model_v2": PointGNN}
    return models[model_name]
