"""The port's sgd training trajectory against the JAX train step: the
same fetched KITTI frames (a synthetic tree), parameters and learning
rate, several steps in a row, into the divergence that a too-large
learning rate causes in both."""

import numpy as np

import jax
import jax.numpy as jnp

from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.parallel import step as jstep
from pointgnn_tpu.train import device_pipeline as jdpipe
from pointgnn_tpu.train import optimizers as jopt
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import device_pipeline as tdpipe
from pointgnn_tpu_torch.train import optimizers as topt
from test_torch_configs import narrow_config, port_spec
from test_torch_trainer import _fetch_specs, _train_config, tree  # noqa: F401


def test_sgd_trajectory_matches_jax_into_divergence(tree):
    """Three sgd steps of the JAX train step and the port's on the same
    fetched frames and parameters (no graph randomization), at a learning
    rate where both diverge: the port follows JAX's loss step for step,
    to 1e-4 relative (f32 sums in other orders, amplified by the
    divergence), as the loss grows by orders of magnitude."""
    root, lib = tree
    name = "car_auto_T1_train"
    cfg = narrow_config(name)
    tc = _train_config(name, root, lib, initial_lr=1.5)
    _, jspec = _fetch_specs(root, name, cfg, tc)
    fetch = jdpipe.build_device_fetch(jspec)
    batches = [[fetch(i, i) for i in pair] for pair in ((0, 1), (2, 3))]
    spec = jspec.device_spec._replace(slab_level0=True, slab_level1=True)
    jd, jextra = jdpipe.resolve_device_setup(cfg, spec=spec, slab=True)
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="train",
                         **jextra, **cfg["model_kwargs"])
    jo, _ = jopt.build_from_train_config(tc)
    jstep_fn = jstep.make_train_step(
        jmodel, jo, jax_loss_config(cfg), frames_per_device=2,
        graph_builder=jdpipe.make_graph_builder(
            jd, jmodel.output_graph_level, cfg))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1), 1))
    jstate = jstep.init_train_state(jparams, jo)
    dspec, extra = tdpipe.resolve_device_setup(cfg, port_spec(spec))
    model = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                     **extra, **cfg["model_kwargs"])
    opt, _ = topt.build_from_train_config(tc)
    params = params_from_jax(jparams, "cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    state = tstep.init_train_state(params, opt)
    step_fn = tstep.make_train_step(
        model, opt, loss_config(cfg),
        tdpipe.make_graph_builder(dspec, model.output_graph_level, cfg),
        frames_per_device=2)
    losses = []
    for s in range(3):
        frames = batches[s % 2]
        jstate, jaux = jstep_fn(jstate, jax.tree_util.tree_map(
            jnp.asarray, jdpipe.stack_frames(frames)))
        state, aux = step_fn(state, tdpipe.frames_to_device(
            tdpipe.stack_frames([tdpipe.DeviceFrame(*f) for f in frames]),
            "cpu"))
        jl, tl = float(jaux["total_loss"]), float(aux["total_loss"])
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=str(s))
        losses.append(tl)
    assert losses[-1] > 1e6 * losses[0]
