"""Config-driven Point-GNN model in test mode (counterpart of
:class:`pointgnn_tpu.model.pointgnn.PointGNN`).

The parameter tree has the JAX package's keys
(``params[scope]["edge_mlp"][i]["w"]`` ...), so :func:`~pointgnn_tpu_torch.
params.params_from_jax` makes both packages compute the same function.
"""

from typing import Dict, Optional

import numpy as np
import torch

from pointgnn_tpu_torch.graph.pad import PaddedGraph
from pointgnn_tpu_torch.nn.layers import (
    ClassAwarePredictor,
    GraphNetAutoCenter,
    PointSetPooling,
    predictor_widths,
)
from pointgnn_tpu_torch.utils.device import resolve_device

_POOLING_TYPES = {"scatter_max_point_set_pooling": "max"}
_GNN_TYPES = {"scatter_max_graph_auto_center_net": "max"}


def _glorot_layer(rng, din, dout, device):
    """TF-slim fully_connected default init (xavier uniform), zero bias."""
    limit = np.sqrt(6.0 / (din + dout))
    w = rng.uniform(-limit, limit, (din, dout)).astype(np.float32)
    return {
        "w": torch.from_numpy(w).to(device),
        "b": torch.zeros(dout, dtype=torch.float32, device=device),
        "norm": None,
    }


def _init_mlp(rng, din, widths, device):
    dims = [din] + list(widths)
    return [
        _glorot_layer(rng, dims[i], dims[i + 1], device)
        for i in range(len(widths))
    ]


class PointGNN:
    """Multi-layer local graph model over a two-level slab graph."""

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
    ):
        # the regularizer only enters the training loss (not ported)
        del regularizer_type, regularizer_kwargs
        if mode != "test":
            raise NotImplementedError("only test mode (serving) is ported")
        self.num_classes = num_classes
        self.box_encoding_len = box_encoding_len
        self.layer_configs = list(layer_configs)
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.slab_level1 = slab_level1
        self.slab_level0 = slab_level0
        pred_cfg = self.layer_configs[-1]
        widths = predictor_widths(pred_cfg["type"])
        if widths is None:
            raise NotImplementedError(
                "predictor type %r is not ported" % pred_cfg["type"]
            )
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
        for cfg in self.layer_configs[:-1]:
            kw = cfg["kwargs"]
            if cfg["type"] in _POOLING_TYPES:
                params[cfg["scope"]] = {
                    "point_mlp": _init_mlp(
                        rng, dim + 3, kw["point_MLP_depth_list"], device
                    ),
                    "output_mlp": _init_mlp(
                        rng, kw["point_MLP_depth_list"][-1],
                        kw["output_MLP_depth_list"], device,
                    ),
                }
                dim = kw["output_MLP_depth_list"][-1]
            else:
                p = {
                    "edge_mlp": _init_mlp(
                        rng, dim + 3, kw["edge_MLP_depth_list"], device
                    ),
                    "update_mlp": _init_mlp(
                        rng, kw["edge_MLP_depth_list"][-1],
                        kw["update_MLP_depth_list"], device,
                    ),
                }
                if kw.get("auto_offset"):
                    p["auto_offset_mlp"] = _init_mlp(
                        rng, dim, kw["auto_offset_MLP_depth_list"], device
                    )
                params[cfg["scope"]] = p
                dim = kw["update_MLP_depth_list"][-1]
        pred = self._predictor
        params[self.layer_configs[-1]["scope"]] = {
            "cls": _init_mlp(
                rng, dim, list(pred.cls_Ks) + [self.num_classes], device
            ),
            "loc": [
                _init_mlp(
                    rng, dim, list(pred.loc_Ks) + [self.box_encoding_len],
                    device,
                )
                for _ in range(self.num_classes)
            ],
        }
        return params

    def apply(self, params, graph: PaddedGraph):
        """``(logits [K, num_classes], box_encodings [K, num_classes, L])``
        on the output vertex level."""
        features = graph.features
        for cfg, layer in zip(self.layer_configs[:-1], self._layers):
            g = cfg["graph_level"]
            kw = dict(cfg["kwargs"], compute_dtype=self.compute_dtype)
            p = params[cfg["scope"]]
            if isinstance(layer, PointSetPooling):
                if self.slab_level0 is not None and g == 0:
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
                if self.slab_level1 is not None and g == 1:
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
        return self._predictor.apply(
            params[pred_cfg["scope"]], features, self.num_classes,
            compute_dtype=self.compute_dtype, **pred_cfg["kwargs"],
        )

    def postprocess(self, logits):
        return torch.softmax(logits, dim=-1)


def get_model(model_name: str):
    models = {"multi_layer_fast_local_graph_model_v2": PointGNN}
    return models[model_name]
