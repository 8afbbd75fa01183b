"""The port's device-graph training pieces against the JAX package.

The same numpy inputs (synthetic frames, packed labels, and the graph
randomization that ``jax.random`` draws, injected into the port) go
through both packages: the randomized graph build, label assignment and
box encoding, the optimizers against optax, and the streaming-metric
counts.  The train step itself is held against JAX in
``test_torch_train_step.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.graph import device_labels as jdl
from pointgnn_tpu.train import metrics as jmetrics
from pointgnn_tpu.train import optimizers as jopt
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch.data.labels import LABEL_MAP_CAR
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.graph import device_labels as tdl
from pointgnn_tpu_torch.model import encodings
from pointgnn_tpu_torch.train import metrics as tmetrics
from pointgnn_tpu_torch.train import optimizers as topt

NUM_POINTS, NUM_KEYPOINTS = 1024, 256


def small_config(T=2):
    """car_auto config with MLP widths narrowed to 16-32 (CPU-sized)."""
    cfg = jax_configs.model_config("Car", T=T)
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


def _frame(seed):
    """A small synthetic frame, its labels plus one car box placed on
    its own points (so some keypoints carry a localization target)."""
    pts, labels = synthetic_lidar_frame(seed=seed, n_beams=16,
                                        points_per_beam=64)
    xyz = pts.xyz[:NUM_POINTS]
    c = xyz[len(xyz) // 3]
    labels = list(labels) + [{
        "name": "Car", "x3d": float(c[0]), "y3d": float(c[1]) + 0.5,
        "z3d": float(c[2]), "length": 6.0, "width": 3.0, "height": 2.5,
        "yaw": 0.3 + seed, "truncation": 0.0, "occlusion": 0, "alpha": 0,
        "xmin": 0, "ymin": 0, "xmax": 100, "ymax": 100,
    }]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        packed = jdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    return packed, labels


def _spec(cfg):
    return jdb.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS,
        runtime=False,
    )._replace(slab_level0=True, slab_level1=True)


def _jax_draws(key, num_points):
    """The draws jax's voxel_select makes from ``key``."""
    kshift, kperm = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kshift, (3,))),
            np.asarray(jax.random.permutation(kperm, num_points)))


def _torch_draws(draws):
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


def test_randomized_graph_matches_jax():
    cfg = small_config()
    spec = _spec(cfg)
    packed, _ = _frame(0)
    key = jax.random.PRNGKey(7)
    jg = jax.device_get(jax.jit(
        lambda x, k: jdb.build_padded_graph(*jdb.unpack_points(x), spec,
                                            rnd_key=k)
    )(jnp.asarray(packed), key))
    draws = _jax_draws(key, NUM_POINTS)
    tg = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)),
        tdb.DeviceGraphSpec(*spec), rnd=_torch_draws(draws),
    )
    for name in ("slab_offsets", "slab_center_cell", "slab0_offsets",
                 "slab0_center_cell"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    for lvl in range(3):
        np.testing.assert_array_equal(tg.vertex_xyz[lvl].numpy(),
                                      np.asarray(jg.vertex_xyz[lvl]))
        np.testing.assert_array_equal(tg.vertex_mask[lvl].numpy(),
                                      np.asarray(jg.vertex_mask[lvl]))
    np.testing.assert_array_equal(tg.keypoint_indices[0].numpy(),
                                  np.asarray(jg.keypoint_indices[0]))
    # the randomization moved the keypoints off the serving selection
    plain = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)),
        tdb.DeviceGraphSpec(*spec),
    )
    assert not torch.equal(plain.vertex_xyz[1], tg.vertex_xyz[1])
    # draws from a torch generator give the same kind of randomization
    gen = torch.Generator().manual_seed(0)
    tg2 = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)),
        tdb.DeviceGraphSpec(*spec),
        rnd=tdb.draw_randomization(NUM_POINTS, gen),
    )
    assert tg2.vertex_mask[1].sum() > 0


def test_labels_and_encode_match_jax():
    cfg = small_config()
    spec = _spec(cfg)
    packed, labels = _frame(1)
    jpacked = jdl.pack_frame_labels(labels, LABEL_MAP_CAR, 4)
    tpacked = tdl.pack_frame_labels(labels, LABEL_MAP_CAR, 4)
    for a, b in zip(jpacked, tpacked):
        np.testing.assert_array_equal(a, b)
    graph = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)),
        tdb.DeviceGraphSpec(*spec),
    )
    kp_xyz, kp_mask = graph.vertex_xyz[1], graph.vertex_mask[1]
    jcls, jtarget, jvalid = jax.device_get(jdl.assign_labels_jax(
        jnp.asarray(kp_xyz.numpy()), jnp.asarray(kp_mask.numpy()), jpacked
    ))
    dev_labels = tdl.PackedLabels(*map(torch.from_numpy, tpacked))
    cls, target, valid = tdl.assign_labels(kp_xyz, kp_mask, dev_labels)
    np.testing.assert_array_equal(cls.numpy(), jcls)
    np.testing.assert_array_equal(target.numpy(), jtarget)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert valid.sum() > 0 and (cls.numpy() == 3).sum() >= 0
    jenc = np.asarray(jdl.get_encode_jax(
        "classaware_all_class_box_encoding", LABEL_MAP_CAR
    )(jnp.asarray(jcls), jnp.asarray(kp_xyz.numpy()), jnp.asarray(jtarget)))
    enc = tdl.get_encode("classaware_all_class_box_encoding",
                         LABEL_MAP_CAR)(cls, kp_xyz, target)
    # log() of two libm implementations: a few f32 ulps
    np.testing.assert_allclose(enc.numpy(), jenc, rtol=1e-6, atol=1e-6)
    # encode is the inverse of the ported decode on the labeled rows
    rows = valid > 0
    dec = encodings.get_decode("classaware_all_class_box_encoding",
                               LABEL_MAP_CAR)(cls, kp_xyz, enc)
    np.testing.assert_allclose(dec[rows].numpy(), target[rows].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,every_k", [
    ("sgd", 1), ("momentum", 1), ("rmsprop", 1), ("adam", 1), ("sgd", 2),
    ("adam", 2),
])
def test_optimizers_match_optax(name, every_k):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    # a decay every update exercises the count the schedule reads
    jlr = jopt.exponential_decay_lr(0.125, 1, 0.5)
    jo = jopt.build_optimizer(name, jlr)
    tlr = topt.exponential_decay_lr(0.125, 1, 0.5)
    to = topt.Optimizer(name, tlr)
    if every_k > 1:
        jo = optax.MultiSteps(jo, every_k_schedule=every_k)
        to = topt.MultiSteps(to, every_k)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jo.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in init.items()}
    tstate = to.init(tparams)
    for g in grads:
        upd, jstate = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, v in g.items():
            tparams[k].grad = torch.from_numpy(v)
        to.apply(tstate, tparams)
        for k in shapes:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-5, atol=1e-6, err_msg="%s %s" % (name, k),
            )


def test_device_updates_match_jax():
    rng = np.random.default_rng(0)
    k, c = 300, 4
    logits = (rng.normal(size=(k, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, k).astype(np.int32)
    mask = (rng.uniform(size=k) > 0.2).astype(np.float32)
    ju = jax.device_get(jmetrics.device_updates(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), c))
    tu = tmetrics.device_updates(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask), c)
    for key in ("confusion", "pr_pos_hist", "pr_neg_hist"):
        np.testing.assert_array_equal(tu[key].numpy(), np.asarray(ju[key]),
                                      key)
    jm, tm = jmetrics.StreamingMetrics(c), tmetrics.StreamingMetrics(c)
    aux = {"cls_loss": 0.5, "classwise_loc_loss": np.ones((c, 7))}
    jm.update(dict(aux, **{k: np.asarray(v) for k, v in ju.items()}))
    tm.update(dict(aux, **tu))
    jr, tr = jm.results(), tm.results()
    assert jr.keys() == tr.keys()
    for key in jr:
        np.testing.assert_allclose(tr[key], jr[key], rtol=1e-12,
                                   err_msg=key)
