"""The port's edge-list serving against the JAX pipeline, end to end.

Both pipelines serve the same frames with the same parameters: JAX's
``InferencePipeline(on_device_graph=True, pallas_tail=True, slab=False)``
and ``slab="l1"`` (its ``edge_tail_max`` and slab kernels in interpret
mode on the CPU) and the port's ``InferencePipeline(device="cpu",
slab=False)`` and ``slab="l1"`` (the plain versions).  The per-center
caps are small, so the capped edge lists truncate some neighborhoods on
both sides alike.
"""

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import infer as jax_infer
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import infer
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.params import params_from_jax

from test_torch_serving import TOL, _hypotheses, _small_config

NUM_POINTS, NUM_KEYPOINTS = 1024, 256
CAPS = dict(per_center_caps=(8, 16), cell_caps=(16, 32))


def _spec_kw():
    return dict(num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS, **CAPS)


@pytest.fixture(scope="module", params=[False, "l1"], ids=["edges", "l1"])
def pipelines(request):
    slab = request.param
    cfg = _small_config()
    jpipe = jax_infer.InferencePipeline(
        cfg, on_device_graph=True, slab=slab, pallas_tail=True,
        compute_dtype=None, device_spec=jdb.spec_from_config(cfg,
                                                             **_spec_kw()),
        seed=3,
    )
    params = jax.device_get(jpipe.params)
    # spread the class logits so hypotheses are not near-ties at the
    # 1/num_classes threshold or in the NMS score order
    head = params["output"]["cls"][-1]
    head["w"] = head["w"] * 8.0
    jpipe.params = params
    tpipe = infer.InferencePipeline(
        cfg, params=params_from_jax(params, device="cpu"),
        on_device_graph=True,
        device_spec=tdb.spec_from_config(cfg, **_spec_kw()),
        compute_dtype="float32", device="cpu", slab=slab,
    )
    assert tpipe.slab == jpipe.slab == slab
    assert tpipe.pallas_tail and jpipe.pallas_tail
    for flag in ("slab_level0", "slab_level1"):
        assert (getattr(tpipe.device_spec, flag)
                == getattr(jpipe.device_spec, flag))
    assert (tpipe.model.slab_level0 is None) == (
        jpipe.model.slab_level0 is None)
    assert (tpipe.model.slab_level1 is None) == (
        jpipe.model.slab_level1 is None)
    return jpipe, tpipe


def _frame(seed):
    pts, _ = synthetic_lidar_frame(seed=seed, n_beams=16, points_per_beam=64)
    return pts


@pytest.mark.parametrize("seed", [0, 1])
def test_device_hypotheses_match_jax(pipelines, seed):
    jpipe, tpipe = pipelines
    pts = _frame(seed)
    packed = jdb.pack_points(
        pts.xyz, infer.select_input_features(pts.attr, "i"), NUM_POINTS
    )
    jout = jax.device_get(jpipe._device_fn(jpipe.params, packed))
    tout = [t.numpy() for t in tpipe.device_fn(
        tpipe.params, torch.from_numpy(packed)
    )]
    hj, ht = _hypotheses(*jout), _hypotheses(*tout)
    assert len(ht) > 10
    assert hj.keys() == ht.keys()
    for key, (s, b) in hj.items():
        np.testing.assert_allclose(ht[key][0], s, **TOL)
        np.testing.assert_allclose(ht[key][1], b, **TOL)


def test_run_frame_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    pts = _frame(2)
    jcls, jboxes, jscores, jaux = jpipe.run_frame(pts)
    tcls, tboxes, tscores, taux = tpipe.run_frame(pts)
    assert len(tcls) > 0
    np.testing.assert_array_equal(tcls, jcls)
    np.testing.assert_allclose(tboxes, jboxes, **TOL)
    np.testing.assert_allclose(tscores, jscores, **TOL)
    assert len(taux["hyp_xyz"]) == len(jaux["hyp_xyz"])
    assert set(tpipe.time_dict) == {"gen graph", "gnn inference", "nms"}


def test_preset_slab_flags_cleared_when_slab_off():
    """A slab-flagged spec passed to a pipeline where slab resolves off
    has its flags cleared (the graph would otherwise carry dummy 1-edge
    lists), and it serves exactly as a never-flagged spec."""
    cfg = _small_config()
    spec = tdb.spec_from_config(cfg, **_spec_kw())
    flagged = spec._replace(slab_level1=True, slab_level0=True)
    pipe = infer.InferencePipeline(cfg, on_device_graph=True,
                                   device_spec=flagged, seed=4,
                                   device="cpu", compute_dtype="float32",
                                   slab=False)
    assert pipe.slab is False
    assert pipe.device_spec.slab_level1 is False
    assert pipe.device_spec.slab_level0 is False
    assert pipe.model.slab_level1 is None and pipe.model.slab_level0 is None
    ref = infer.InferencePipeline(cfg, on_device_graph=True,
                                  device_spec=spec, seed=4,
                                  device="cpu", compute_dtype="float32",
                                  slab=False)
    pts = _frame(0)
    packed = torch.from_numpy(jdb.pack_points(
        pts.xyz, infer.select_input_features(pts.attr, "i"), NUM_POINTS))
    for a, b in zip(pipe.device_fn(pipe.params, packed),
                    ref.device_fn(ref.params, packed)):
        assert torch.equal(a, b)
    # and "l1" sets level 1 only, on an unflagged spec
    l1 = infer.InferencePipeline(cfg, on_device_graph=True,
                                 device_spec=spec, seed=4,
                                 device="cpu", slab="l1")
    assert l1.device_spec.slab_level1 and not l1.device_spec.slab_level0
    assert l1.model.slab_level1 is not None and l1.model.slab_level0 is None


def test_option_resolution():
    cfg = _small_config()
    spec = tdb.spec_from_config(cfg, **_spec_kw())
    auto = infer.InferencePipeline(cfg, on_device_graph=True,
                                   device_spec=spec, device="cpu")
    assert auto.slab is True and auto.pallas_tail is True
    assert auto.device_spec.slab_level0 and auto.device_spec.slab_level1
    # slab on both levels needs no edge-list tail
    slab_only = infer.InferencePipeline(cfg, on_device_graph=True,
                                        device_spec=spec,
                                        device="cpu", slab=True,
                                        pallas_tail=False)
    assert slab_only.model.pallas_tail is False
    # without the tail, the edge-list levels take the generic segment
    # path (8 edge chunks on device-built graphs, as in JAX)
    for slab in (False, "l1"):
        seg = infer.InferencePipeline(cfg, on_device_graph=True,
                                      device_spec=spec, device="cpu",
                                      slab=slab, pallas_tail=False)
        assert seg.model.pallas_tail is False
        assert seg.model.edge_chunks == 8
        assert seg.model.edge_sentinel == "src"
        assert seg.device_spec.slab_level0 is False
