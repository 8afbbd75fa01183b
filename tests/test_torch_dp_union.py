"""The port's data-parallel union step (device-built graphs, two frames
per device) against the JAX package's, on the CPU.

JAX's ``test_multi_frame_dp_matches_single_device_union`` setup: the Car
T=1 model on capped edge lists (the graph JAX freezes on the CPU) at
2048 points and 512 keypoints, four synthetic frames dealt two per
device, through ``make_train_step(mesh=make_mesh(2), graph_builder=...,
frames_per_device=2, unify_copies=True)``; the port replays the case
in two spawned gloo ranks from the same parameters and packed frames.
``test_torch_dp_union_plain.py`` runs the same case with
``unify_copies`` off, at 1024 points and 256 keypoints, through
:func:`union_runs` and :func:`check_union`.  Tolerances as in
``test_torch_dp_step.py``.
"""

import concurrent.futures
import os

import numpy as np
import pytest

import jax

from pointgnn_tpu.data.labels import LABEL_METHODS
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.infer import select_input_features
from pointgnn_tpu.parallel import mesh as pmesh
from pointgnn_tpu.parallel import step as pstep
from pointgnn_tpu.train import device_pipeline as jdpipe
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch.parallel import dryrun, mesh
from pointgnn_tpu_torch.train import checkpoint as ckpt
from test_parallel import _device_setup
from test_torch_dp_step import SGD, _check_update


def _frames(spec, cfg):
    """Four frames, each with one more car box placed on its own points
    (so that every device holds localization targets), two per
    device."""
    label_map, num_classes = LABEL_METHODS[cfg["label_method"]]
    frames = []
    for seed in range(4):
        points, labels = synthetic_lidar_frame(seed=seed, n_beams=16,
                                               points_per_beam=64)
        c = points.xyz[len(points.xyz) // 3]
        labels = list(labels) + [{
            "name": "Car", "x3d": float(c[0]), "y3d": float(c[1]) + 0.5,
            "z3d": float(c[2]), "length": 6.0, "width": 3.0, "height": 2.5,
            "yaw": 0.3 + seed, "truncation": 0.0, "occlusion": 0,
            "alpha": 0, "xmin": 0, "ymin": 0, "xmax": 100, "ymax": 100,
        }]
        packed = jdb.pack_points(
            points.xyz,
            select_input_features(points.attr, cfg["input_features"]),
            spec.num_points)
        frames.append(jdpipe.DeviceFrame(packed, jdpipe.dl.pack_frame_labels(
            labels, label_map, num_classes)))
    return [jdpipe.stack_frames(frames[:2]), jdpipe.stack_frames(frames[2:])]


def union_runs(root, unify_copies, num_points=None, num_keypoints=None):
    """The 2-frame union step through JAX's 2-device mesh and through
    the port's two gloo ranks: ``((initial params, JAX's updated params,
    JAX's aux), [each rank's replay])``.  ``num_points`` and
    ``num_keypoints``, when given, replace the setup's graph spec (its
    caps kept)."""
    cfg, spec, jmodel, builder, params, opt = _device_setup()
    if num_points is not None:
        spec = jdb.spec_from_config(
            cfg, num_points=num_points, num_keypoints=num_keypoints,
            runtime=False, cell_caps=(16, 32), per_center_caps=(16, 64))
        builder = jdpipe.make_graph_builder(spec, jmodel.output_graph_level,
                                            cfg)
    per_dev = _frames(spec, cfg)
    params = jax.device_get(params)
    case = dict(
        model=dict(num_classes=cfg["num_classes"], box_encoding_len=7,
                   mode="train", **cfg["model_kwargs"]),
        loss=jax_loss_config(cfg), steps=1, params=params, optimizer=SGD,
        step=dict(frames_per_device=2, unify_copies=unify_copies),
        graph_builder=dict(config=cfg, spec=tuple(spec), slab=False),
        inputs=[(f.packed_points, tuple(f.labels)) for f in per_dev])
    path = os.path.join(root, "union.npz")
    ckpt.save_tree(path, case)
    jmesh = pmesh.make_mesh(2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(mesh.launch, dryrun.run_cases, 2, [path],
                           devices="cpu", timeout=60, join_timeout=60)
        dp = pstep.make_train_step(
            jmodel, opt, jax_loss_config(cfg), mesh=jmesh,
            graph_builder=builder, frames_per_device=2,
            unify_copies=unify_copies)
        state, aux = dp(pstep.init_train_state(params, opt),
                        pmesh.shard_batch(jmesh,
                                          pmesh.stack_graphs(per_dev)))
        want = (params, jax.device_get(state.params), jax.device_get(aux))
        ranks = port.result()
    return want, [r[0] for r in ranks]


def check_union(runs):
    """The union's global losses (``cls_g``, ``loc_g``), each device's
    endpoint counts and classwise losses, and the updated parameters
    against JAX; both ranks equal bit for bit."""
    (p0, jparams, jaux), ranks = runs
    assert dryrun.same_params(ranks)
    assert (np.asarray(jaux["num_valid_endpoint"]) > 0).all()
    for rank in ranks:
        aux = rank["aux"][0]
        for key in ("cls_loss", "loc_loss", "reg_loss", "total_loss"):
            np.testing.assert_allclose(aux[key], jaux[key], rtol=1e-5,
                                       err_msg=key)
        for key in ("num_endpoint", "num_valid_endpoint"):
            np.testing.assert_array_equal(aux[key], jaux[key], err_msg=key)
        np.testing.assert_allclose(aux["classwise_loc_loss"],
                                   jaux["classwise_loc_loss"], rtol=1e-4,
                                   atol=1e-6)
        _check_update(p0, jparams, rank["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return union_runs(str(tmp_path_factory.mktemp("dp_union")),
                      unify_copies=True)


def test_multi_frame_dp_matches_jax_mesh(runs):
    """``unify_copies`` on: each rank's share of the global union loss
    (``reg / n_dev``), the psum-ed ``cls_g`` / ``loc_g``."""
    check_union(runs)
