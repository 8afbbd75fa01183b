"""The port's train step against the JAX package.

One two-frame union step on the same frames, packed labels, parameters
(handed over through ``params_from_jax``) and graph randomization (the
``jax.random`` draws injected into the port): the loss dict and every
parameter gradient against ``jax.value_and_grad`` with the JAX slab
kernels in interpret mode; and the port's ``make_train_step`` on the
CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.graph import device_labels as jdl
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.parallel import step as jstep
from pointgnn_tpu.train import device_pipeline as jdpipe
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.data.labels import LABEL_MAP_CAR
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.graph import device_labels as tdl
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import device_pipeline as tdpipe
from pointgnn_tpu_torch.train import metrics as tmetrics
from pointgnn_tpu_torch.train import optimizers as topt
from test_torch_train import (
    NUM_POINTS, _frame, _jax_draws, _spec, _torch_draws, small_config,
)


def _grads_tree(tree):
    if isinstance(tree, dict):
        return {k: _grads_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grads_tree(v) for v in tree]
    if tree is None:
        return None
    return tree.grad.numpy() if tree.grad is not None else np.zeros(
        tuple(tree.shape), np.float32)


def test_union_step_loss_and_grads_match_jax():
    """One two-frame union step: the loss dict and every parameter
    gradient, f32, on the same randomized graphs (T=1: both slab
    levels, one layer each)."""
    cfg = small_config(T=1)
    spec = _spec(cfg)
    frames = [_frame(s) for s in (2, 3)]
    label_map = LABEL_MAP_CAR
    jframes = [jdpipe.DeviceFrame(p, jdl.pack_frame_labels(lb, label_map, 4))
               for p, lb in frames]
    jbatch = jax.tree_util.tree_map(jnp.asarray,
                                    jdpipe.stack_frames(jframes))
    dspec_j, extra_j = jdpipe.resolve_device_setup(cfg, spec=spec, slab=True)
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="train",
                         **extra_j, **cfg["model_kwargs"])
    jbuild = jdpipe.make_graph_builder(dspec_j, jmodel.output_graph_level,
                                       cfg)
    jsums = jstep.make_union_sums_fn(jmodel, jax_loss_config(cfg), jbuild, 2)
    key = jax.random.PRNGKey(3)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1), 1))

    def lossf(p):
        acc, reg = jsums(p, jbatch, key)
        cls = acc["cls_w"] / jnp.maximum(acc["n_ep"], 1.0)
        loc = acc["loc_w"] / jnp.maximum(acc["n_val"], 1.0)
        return cls + loc + reg, (cls, loc, reg, acc["n_val"])

    (jtotal, (jcls, jloc, jreg, jnval)), jgrads = jax.value_and_grad(
        lossf, has_aux=True)(jparams)
    draws = [_torch_draws(_jax_draws(jax.random.fold_in(key, f),
                                     NUM_POINTS)) for f in range(2)]

    tcfg = configs.get_config("car_auto_T1_train")
    tcfg["model_kwargs"] = cfg["model_kwargs"]
    dspec, extra = tdpipe.resolve_device_setup(tcfg,
                                               tdb.DeviceGraphSpec(*spec))
    tmodel = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                      **extra, **tcfg["model_kwargs"])
    tbuild = tdpipe.make_graph_builder(dspec, tmodel.output_graph_level,
                                       tcfg)
    tsums = tstep.make_union_sums_fn(tmodel, loss_config(tcfg), tbuild, 2)
    params = params_from_jax(jparams, device="cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    tframes = [tdpipe.DeviceFrame(p, tdl.pack_frame_labels(lb, label_map, 4))
               for p, lb in frames]
    tbatch = tdpipe.frames_to_device(tdpipe.stack_frames(tframes), "cpu")
    acc, reg = tsums(params, tbatch, draws)
    cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
    loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
    total = cls + loc + reg
    total.backward()

    assert float(jnval) > 0 and float(acc["n_val"]) == float(jnval)
    for name, t, j in (("total", total, jtotal), ("cls", cls, jcls),
                       ("loc", loc, jloc), ("reg", reg, jreg)):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-5,
                                   err_msg=name)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tleaves = jax.tree_util.tree_leaves(_grads_tree(params))
    assert len(jleaves) == len(tleaves) > 0
    for (path, jg), tg in zip(jleaves, tleaves):
        jg = np.asarray(jg)
        assert tg.shape == jg.shape, path
        # f32 sums in other orders through the chain rule: 1e-4 of the
        # leaf's own scale
        tol = 1e-4 * (1.0 + np.abs(jg).max())
        err = np.abs(tg - jg).max()
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


@pytest.mark.parametrize("frames_per_device", [1, 2])
def test_train_step_updates_parameters(frames_per_device):
    """make_train_step on the CPU: finite losses, metric counts, and
    parameters that moved by -lr * grad (sgd)."""
    cfg = configs.get_config("car_auto_T1_train")
    cfg["model_kwargs"] = small_config(T=1)["model_kwargs"]
    spec = tdb.DeviceGraphSpec(*_spec(cfg))
    dspec, extra = tdpipe.resolve_device_setup(cfg, spec)
    model = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                     **extra, **cfg["model_kwargs"])
    params = model.init(seed=0, input_dim=1, device="cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    before = [t.detach().clone() for t in topt.param_leaves(params)]
    opt, lr = topt.build_from_train_config(
        configs.get_train_config("car_auto_T1_train"))
    state = tstep.init_train_state(params, opt)
    step = tstep.make_train_step(
        model, opt, loss_config(cfg), with_metrics=True,
        graph_builder=tdpipe.make_graph_builder(
            dspec, model.output_graph_level, cfg),
        graph_rng_seed=0, frames_per_device=frames_per_device,
    )
    frames = [tdpipe.DeviceFrame(p, tdl.pack_frame_labels(lb, LABEL_MAP_CAR,
                                                           4))
              for p, lb in (_frame(4), _frame(5))[:frames_per_device]]
    batch = tdpipe.frames_to_device(tdpipe.stack_frames(frames), "cpu")
    state, aux = step(state, batch)
    assert state.step == 1
    assert all(np.isfinite(float(aux[k])) for k in
               ("cls_loss", "loc_loss", "reg_loss", "total_loss"))
    assert float(aux["confusion"][:, 2].sum()) == float(aux["num_endpoint"])
    for t, b in zip(topt.param_leaves(params), before):
        np.testing.assert_allclose(t.detach().numpy(),
                                   (b - lr(0) * t.grad).numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(t.detach(), b) for t, b in
               zip(topt.param_leaves(params), before))
    m = tmetrics.StreamingMetrics(4)
    m.update(aux)
    assert np.isfinite(m.results()["total_loss"])
