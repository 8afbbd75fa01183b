"""The port's data-parallel train step against the JAX package's, on the
CPU.

JAX runs ``make_train_step(mesh=make_mesh(2))`` on two devices of its
8-device virtual CPU mesh; the port runs the same case in two spawned
gloo ranks (``parallel.mesh.launch``, once for the whole file), each on
its own share of the batch, from the same parameters (the JAX tree,
numpy) and inputs, written to ``.npz`` files.  The cases: one host-built
graph per device with ``unify_copies`` on and off (with the streaming
metrics), and a batch-norm model whose moving averages take the
statistics summed over the devices (``test_torch_dp_union.py`` holds
the device-graph union step).

Tolerances, as in the single-device parity tests: losses at rtol 1e-5;
each leaf's parameter update within 1e-4 of (lr + its largest update),
the gradient tolerance of ``test_torch_train_step.py`` times the
learning rate; moving averages at rtol 1e-4, atol 1e-6.  The ranks end
every case with the same parameters, bit for bit.
"""

import concurrent.futures
import os

import numpy as np
import pytest

import jax

from pointgnn_tpu import configs as jconfigs
from pointgnn_tpu.graph import pad as jpad
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.parallel import mesh as pmesh
from pointgnn_tpu.parallel import step as pstep
from pointgnn_tpu.train import optimizers as joptimizers
from pointgnn_tpu_torch.parallel import dryrun, mesh
from pointgnn_tpu_torch.train import checkpoint as ckpt
from test_bn import bn_layer_configs
from test_parallel import CAP, LOSS_CFG, _frame

LR = 0.1
SGD = {"initial_lr": LR, "decay_step": 1000, "decay_factor": 0.1,
       "optimizer": "sgd"}
REG = {"regularizer_type": "l1", "regularizer_kwargs": {"scale": 5e-7}}


def _host_case(layer_configs, reg, step, seed):
    """Two host-built graphs (one per device), as JAX's DP tests make
    them, and the JAX model's parameters."""
    rng = np.random.RandomState(seed)
    model = dict(num_classes=4, box_encoding_len=7,
                 layer_configs=layer_configs, mode="train", **reg)
    params = jax.device_get(JaxPointGNN(**model).init(
        jax.random.PRNGKey(0), 1))
    graphs = [jpad.pad_frame(_frame(rng), CAP) for _ in range(2)]
    return dict(model=model, loss=LOSS_CFG, optimizer=SGD, steps=1,
                params=params, step=step,
                inputs=[tuple(g) for g in graphs])


def _jax_step(case):
    """The case's step through ``make_train_step(mesh=make_mesh(2))``:
    ``(initial params, updated params, aux)``."""
    jmesh = pmesh.make_mesh(2)
    opt, _ = joptimizers.build_from_train_config(case["optimizer"])
    step_fn = pstep.make_train_step(JaxPointGNN(**case["model"]), opt,
                                    case["loss"], mesh=jmesh, **case["step"])
    graphs = [jpad.PaddedGraph(*g) for g in case["inputs"]]
    state, aux = step_fn(
        pstep.init_train_state(case["params"], opt),
        pmesh.shard_batch(jmesh, pmesh.stack_graphs(graphs)))
    return case["params"], jax.device_get(state.params), jax.device_get(aux)


CASES = {
    "host_unify": lambda: _host_case(
        jconfigs.layer_configs(T=1), REG,
        dict(unify_copies=True, with_metrics=True), seed=1),
    "host_plain": lambda: _host_case(
        jconfigs.layer_configs(T=1), REG,
        dict(unify_copies=False, with_metrics=True), seed=2),
    "bn": lambda: _host_case(bn_layer_configs(), {},
                             dict(bn_decay=0.5), seed=3),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through two gloo ranks of the port, spawned once,
    while JAX runs them here."""
    root = tmp_path_factory.mktemp("dp_cases")
    cases = {name: make() for name, make in CASES.items()}
    paths = [os.path.join(str(root), name + ".npz") for name in cases]
    for path, case in zip(paths, cases.values()):
        ckpt.save_tree(path, case)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(mesh.launch, dryrun.run_cases, 2, paths,
                           devices="cpu", timeout=60, join_timeout=60)
        jax_runs = {name: _jax_step(case) for name, case in cases.items()}
        ranks = port.result()
    return {name: (jax_runs[name], [r[i] for r in ranks])
            for i, name in enumerate(cases)}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _check_update(p0, jp1, tp1, lr=LR):
    """Each leaf's update within 1e-4 of (lr + its largest update)."""
    leaves = list(zip(_leaves(p0), _leaves(jp1), _leaves(tp1)))
    assert leaves
    for a, j, t in leaves:
        assert j.shape == t.shape and j.dtype == t.dtype
        uj, ut = j - a, t - a
        tol = 1e-4 * (lr + np.abs(uj).max())
        assert np.abs(ut - uj).max() <= tol, (np.abs(ut - uj).max(), tol)


@pytest.mark.parametrize("name", ["host_unify", "host_plain", "bn"])
def test_dp_step_matches_jax_mesh(runs, name):
    """Losses, per-device counts and the updated parameters of each
    case against the JAX 2-device step; both ranks equal bit for bit."""
    (p0, jparams, jaux), ranks = runs[name]
    assert dryrun.same_params(ranks)
    for rank in ranks:
        aux = rank["aux"][0]
        for key in ("cls_loss", "loc_loss", "reg_loss", "total_loss"):
            np.testing.assert_allclose(aux[key], jaux[key], rtol=1e-5,
                                       err_msg=key)
        for key in ("num_endpoint", "num_valid_endpoint"):
            np.testing.assert_array_equal(
                aux[key].astype(np.float64),
                np.asarray(jaux[key]).astype(np.float64), err_msg=key)
        assert aux["classwise_loc_loss"].shape == np.shape(
            jaux["classwise_loc_loss"])
        np.testing.assert_allclose(aux["classwise_loc_loss"],
                                   jaux["classwise_loc_loss"], rtol=1e-4,
                                   atol=1e-6)
        _check_update(p0, jparams, rank["params"])
    assert float(np.sum(jaux["num_valid_endpoint"])) > 0
    if "confusion" in jaux:
        # the labeled positives and the histograms' totals do not
        # depend on a probability's side of a bin edge
        aux = ranks[0]["aux"][0]
        np.testing.assert_array_equal(aux["confusion"][:, 2],
                                      np.asarray(jaux["confusion"])[:, 2])
        for key in ("pr_pos_hist", "pr_neg_hist"):
            assert aux[key].sum() == np.asarray(jaux[key]).sum(), key


def test_bn_dp_step_sums_statistics(runs):
    """The moving averages take the statistics summed over the ranks
    (JAX's ``psum``), so they equal the JAX mesh step's, and the step
    moved them from their initial values."""
    (p0, jparams, _), ranks = runs["bn"]
    moved = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        key = path[-1].key if hasattr(path[-1], "key") else None
        if key not in ("ema_mean", "ema_var"):
            continue
        got = ranks[0]["params"]
        for p in path:
            got = got[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_allclose(np.asarray(got), np.asarray(leaf),
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
        moved += not np.allclose(np.asarray(leaf),
                                 0.0 if key == "ema_mean" else 1.0)
    assert moved
