"""Tests of the port that need the card: the CUDA slab_edge_max kernel
against its plain PyTorch version, and the launch count of the serving
path.  They import no JAX, so on a machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

and here, without a card, they skip.
"""

import numpy as np
import pytest
import torch

from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.infer import InferencePipeline
from pointgnn_tpu_torch.nn import slab
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

pytestmark = pytest.mark.cuda

NUM_POINTS, NUM_KEYPOINTS = 4096, 2048

# f32: the kernel's sums run in another order than cuBLAS's, a few f32
# ulps.  bf16: such a difference can flip one bf16 rounding of a hidden
# activation (2^-8 relative) that later layers carry on.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _graph(device):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )._replace(slab_level0=True, slab_level1=True)
    pts, _ = synthetic_lidar_frame(seed=0, n_beams=32, points_per_beam=160)
    packed = torch.from_numpy(
        db.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    ).to(device)
    return spec, db.build_padded_graph(*db.unpack_points(packed), spec)


def _call(graph, spec, level, widths, device):
    gen = torch.Generator(device=device).manual_seed(level)
    if level == 0:
        src, smask = graph.vertex_xyz[0], graph.vertex_mask[0]
        offsets, cells, lvl = graph.slab0_offsets, graph.slab0_center_cell, \
            spec.level0
    else:
        src, smask = graph.vertex_xyz[1], graph.vertex_mask[1]
        offsets, cells, lvl = graph.slab_offsets, graph.slab_center_cell, \
            spec.level1
    ctr, cmask = graph.vertex_xyz[1], graph.vertex_mask[1]

    def xyz4(xyz, mask, sentinel):
        x4 = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], 1)
        return torch.where(mask[:, None] > 0, x4,
                           torch.full((), sentinel, device=device))

    tail = [
        (torch.randn(i, o, generator=gen, device=device) / i ** 0.5,
         0.1 * torch.randn(o, generator=gen, device=device))
        for i, o in zip(widths[:-1], widths[1:])
    ]
    return dict(
        table_a=torch.randn(src.shape[0], widths[0], generator=gen,
                            device=device),
        src_xyz=xyz4(src, smask, 1e6).contiguous(),
        table_b=torch.randn(ctr.shape[0], widths[0], generator=gen,
                            device=device),
        ctr_xyz=xyz4(ctr, cmask, -1e6).contiguous(),
        offsets=offsets, center_cell=cells, weights=tail,
        **db.slab_kernel_wiring(lvl),
    )


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level,widths", [
    (0, [32, 64, 128, 300]), (1, [300, 300]), (1, [36, 20]),
])
def test_kernel_matches_plain_version(cuda, level, widths, compute_dtype):
    spec, graph = _graph(cuda)
    kw = dict(_call(graph, spec, level, widths, cuda),
              compute_dtype=compute_dtype)
    before = slab.slab_edge_max.launches
    out = slab.slab_edge_max(**kw)
    torch.cuda.synchronize()
    assert slab.slab_edge_max.launches == before + 1
    ref = slab.slab_edge_max_reference(**kw)
    assert out.shape == ref.shape
    rel = ((out - ref).abs() / (1 + ref.abs())).max().item()
    assert rel <= TOL[compute_dtype], rel
    assert (out.abs().sum(1) > 0).sum() > 0


def test_kernel_rejects_cpu_mixed_inputs(cuda):
    spec, graph = _graph(cuda)
    kw = _call(graph, spec, 1, [32, 32], cuda)
    kw["table_b"] = kw["table_b"].cpu()
    with pytest.raises(ValueError, match="on cuda"):
        slab.slab_edge_max(**kw)


def test_serving_launches_once_per_slab_layer(cuda):
    cfg = configs.model_config("Car", T=2)
    spec = db.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS)
    pipe = InferencePipeline(cfg, device_spec=spec, device=cuda)
    pts, _ = synthetic_lidar_frame(seed=1, n_beams=32, points_per_beam=160)
    before = slab.slab_edge_max.launches
    cls, boxes, scores, _ = pipe.run_frame(pts)
    assert slab.slab_edge_max.launches == before + 3  # 1 x L0 + T x L1
    assert np.isfinite(boxes).all() and boxes.shape[1:] == (7,)
