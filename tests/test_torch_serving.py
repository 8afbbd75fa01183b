"""The port's slab serving pipeline against the JAX one, end to end.

Both pipelines serve the same frames with the same parameters: JAX's
``InferencePipeline(on_device_graph=True, slab=True, pallas_tail=False)``
(its slab kernel in interpret mode on the CPU) and the port's
``InferencePipeline(device="cpu")`` (the plain slab_edge_max).
"""

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import infer as jax_infer
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import configs, infer
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.utils.device import resolve_device

NUM_POINTS, NUM_KEYPOINTS = 1024, 256

# f32 on both sides: model outputs agree to ~1e-6 (other summation
# orders); the decode adds exp() of two libm versions.  Scores and boxes
# are compared at 1e-4.  After NMS the median merge and the rescoring
# sum reuse those values, so the same 1e-4 holds there.
TOL = dict(rtol=1e-4, atol=1e-4)


def _small_config():
    cfg = configs.model_config("Car", T=2)
    for lc in cfg["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    return cfg


@pytest.fixture(scope="module")
def pipelines():
    cfg = _small_config()
    kw = dict(num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS)
    jpipe = jax_infer.InferencePipeline(
        cfg, on_device_graph=True, slab=True, pallas_tail=False,
        compute_dtype=None, device_spec=jdb.spec_from_config(cfg, **kw),
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
        device_spec=tdb.spec_from_config(cfg, **kw),
        compute_dtype="float32", device="cpu",
    )
    return jpipe, tpipe


def _frame(seed):
    pts, _ = synthetic_lidar_frame(seed=seed, n_beams=16, points_per_beam=64)
    return pts


def _hypotheses(scores, cls, boxes, xyz):
    keep = scores > 0
    return {
        (tuple(np.round(x, 5)), int(c)): (s, b)
        for s, c, b, x in zip(scores[keep], cls[keep], boxes[keep],
                              xyz[keep])
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_device_hypotheses_match_jax(pipelines, seed):
    """Hypotheses with score > 0 (top_k orders the -1 ties
    differently): same (keypoint, class) set, same scores and boxes."""
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


@pytest.mark.parametrize("seed", [0, 1])
def test_run_frame_matches_jax(pipelines, seed):
    """Detections after the class fold and merge-NMS."""
    jpipe, tpipe = pipelines
    pts = _frame(seed)
    jcls, jboxes, jscores, jaux = jpipe.run_frame(pts)
    tcls, tboxes, tscores, taux = tpipe.run_frame(pts)
    assert len(tcls) > 0
    np.testing.assert_array_equal(tcls, jcls)
    np.testing.assert_allclose(tboxes, jboxes, **TOL)
    np.testing.assert_allclose(tscores, jscores, **TOL)
    assert len(taux["hyp_xyz"]) == len(jaux["hyp_xyz"])
    assert set(tpipe.time_dict) == {"gen graph", "gnn inference", "nms"}
    assert set(tpipe.time_dict) <= set(jpipe.time_dict)
    # KITTI text from the same detections
    calib = {"cam_to_image": np.array(
        [[700.0, 0, 621, 0], [0, 700.0, 187, 0], [0, 0, 1, 0]]
    )}
    labels = infer.detections_to_kitti_labels(
        "Car", jcls, jboxes, jscores, calib, jaux
    )
    assert infer.format_kitti_lines(labels) == jax_infer.format_kitti_lines(
        jax_infer.detections_to_kitti_labels(
            "Car", jcls, jboxes, jscores, calib, jaux
        )
    )


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.InferencePipeline(_small_config())
    assert resolve_device("cpu") == torch.device("cpu")
