"""The port's checkpoint evaluation against the JAX package.

On a 2-frame synthetic KITTI tree, car at T=1 with widths 16-32, a
2048-point / 256-keypoint training spec, and random parameters saved as
a JAX checkpoint (``convert_jax_checkpoint.py`` carries them across):

- one eval step (the model in ``"eval"`` mode, ``make_loss_fn`` with the
  logits, ``device_updates``) per frame against the JAX ``Evaluator``'s
  jitted ``_eval_step`` on the slab graph (``device_graph_slab=True``:
  ``slab_edge_max`` in interpret mode);
- ``eval_once`` of both evaluators over the tree, each from its own
  checkpoint, whose frozen train_config holds the JAX spec;
- ``eval_repeat``'s polling, the routing of ``device_graph``, the eval
  mode's wiring against the JAX model's, and ``eval_torch.py --device
  cpu``.

Tolerance: loss terms and every result at rtol 1e-5 / atol 1e-6 (f32,
sums in other orders).  Metric counts must be equal; a count may differ
only where a softmax probability lies within 1e-6 of a histogram edge
or of another class's probability (a flip the two packages' f32
rounding can cause), which ``_assert_counts`` checks before it accepts
a difference.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.train import checkpoint as jax_ckpt
from pointgnn_tpu.train import pipeline as jpipe
from pointgnn_tpu.train import summary as jax_summary
from pointgnn_tpu.train.evaluator import Evaluator as JaxEvaluator
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_to_numpy
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.train import device_pipeline as tdpipe
from pointgnn_tpu_torch.train import metrics as tmetrics
from pointgnn_tpu_torch.train import pipeline as tpipe
from pointgnn_tpu_torch.train import summary as tsummary
from pointgnn_tpu_torch.train.evaluator import Evaluator
from pointgnn_tpu_torch.utils import config_io, synthetic_kitti
from test_torch_configs import narrow_config

import convert_jax_checkpoint
import eval_torch

RTOL, ATOL = 1e-5, 1e-6
FLIP = 1e-6
NUM_FRAMES = 2
NUM_POINTS, NUM_KEYPOINTS = 2048, 256
STEP = 5
COUNT_KEYS = ("confusion", "pr_pos_hist", "pr_neg_hist")


@pytest.fixture(autouse=True)
def _jsonl_summaries_only(monkeypatch):
    """Scalars go to the JSONL files only: both packages' summary writers
    would also import TensorBoard (and with it TensorFlow, ~16 s here),
    which these tests do not read."""
    for module in (tsummary, jax_summary):
        monkeypatch.setattr(module, "_tb_writer", lambda directory: None)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, the config, a JAX checkpoint with a frozen device-graph
    train_config (the JAX spec) and its conversion."""
    root = tmp_path_factory.mktemp("eval")
    tree = str(root / "kitti")
    synthetic_kitti.main(tree, NUM_FRAMES, n_ground=600)
    cfg = narrow_config("car_auto_T1_train")
    jspec = jdb.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS,
        runtime=False)._replace(slab_level0=True, slab_level1=True)
    # glorot weights from a numpy seed, in the JAX package's tree
    params = params_to_numpy(PointGNN(4, 7, **cfg["model_kwargs"]).init(
        7, 1, "cpu"))
    train_config = {"device_graph": True, "device_graph_slab": True,
                    "device_graph_spec": jspec}
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_ckpt.save_checkpoint(jax_dir, STEP, {"params": params}, config=cfg,
                             train_config=train_config)
    convert_jax_checkpoint.convert(jax_dir, port_dir)
    frozen = config_io.load_train_config(os.path.join(port_dir,
                                                      "train_config"))
    assert isinstance(frozen["device_graph_spec"], list)  # JSON
    return dict(root=root, tree=tree, cfg=cfg, jspec=jspec,
                jax_dir=jax_dir, port_dir=port_dir, frozen=frozen)


def _eval_config(setup, **kw):
    return dict(configs.eval_config("Car"), train_dir=setup["port_dir"],
                eval_dataset="val.txt", **kw)


def _port_evaluator(setup, eval_config=None, train_config=None):
    cfg = setup["cfg"]
    ec = eval_config or _eval_config(setup)
    spec = tpipe.DatasetSpec.from_kitti_root(
        setup["tree"], os.path.join(setup["tree"], "3DOP_splits/val.txt"),
        cfg["num_classes"])
    return Evaluator(cfg, ec, tpipe.FetchSpec(spec, cfg, ec, is_eval=True),
                     num_frames=NUM_FRAMES,
                     train_config=(setup["frozen"] if train_config is None
                                   else train_config),
                     device="cpu")


@pytest.fixture(scope="module")
def jax_evaluator(setup):
    cfg = setup["cfg"]
    ec = dict(configs.eval_config("Car"), device_graph=True,
              device_graph_slab=True)
    spec = jpipe.DatasetSpec.from_kitti_root(
        setup["tree"], os.path.join(setup["tree"], "3DOP_splits/val.txt"),
        cfg["num_classes"])
    ev = JaxEvaluator(cfg, ec, jpipe.FetchSpec(spec, cfg, ec, is_eval=True),
                      num_frames=NUM_FRAMES,
                      train_config=config_io.load_train_config(
                          os.path.join(setup["jax_dir"], "train_config")))
    yield ev
    ev.close()


def _probs(model, params, graph):
    logits, _ = model.apply(params, graph)
    return torch.softmax(logits, -1).numpy()


def _assert_counts(got, want, probs, mask):
    """Metric counts equal, or every differing class explained by a
    probability within ``FLIP`` of a histogram edge (a histogram count)
    or of another class's probability (a confusion count)."""
    live = probs[mask > 0]
    edges = tmetrics.thresholds()
    for key in COUNT_KEYS:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape, key
        for c in np.flatnonzero((a != b).any(axis=-1)):
            if key == "confusion":
                top2 = np.sort(live, axis=1)[:, -2:]
                near = int(np.sum(top2[:, 1] - top2[:, 0] < FLIP))
            else:
                near = int(np.sum(np.min(np.abs(
                    live[:, c, None] - edges[None]), axis=1) < FLIP))
            moved = int(np.abs(a[c] - b[c]).sum())
            assert 0 < moved <= 2 * near, (
                "%s class %d differs by %d with %d probabilities within "
                "%g" % (key, c, moved, near, FLIP))


def test_eval_step_matches_jax(setup, jax_evaluator):
    """One eval step per frame: every loss term and the metric counts."""
    ev = _port_evaluator(setup)
    try:
        tparams = ckpt.restore_checkpoint(setup["port_dir"],
                                          device="cpu")[0]["params"]
        jparams = jax_ckpt.restore_checkpoint(setup["jax_dir"])[0]["params"]
        assert ev.device_spec == tdpipe.coerce_device_spec(setup["jspec"])
        tfetch = tdpipe.build_device_fetch(tpipe.FetchSpec(
            tpipe.DatasetSpec.from_kitti_root(setup["tree"], "", 4),
            setup["cfg"], {}, is_eval=True, device_spec=ev.device_spec))
        jfetch = jax_evaluator.provider._fetch
        build = tdpipe.make_graph_builder(ev.device_spec, 2, setup["cfg"])
        endpoints = 0
        for frame_idx in range(NUM_FRAMES):
            jframe = jfetch(frame_idx, 0)
            tframe = tdpipe.frames_to_device(tfetch(frame_idx, 0), "cpu")
            np.testing.assert_array_equal(tframe.packed_points.numpy(),
                                          jframe.packed_points)
            want = jax.device_get(jax_evaluator._eval_step(
                jparams, jax.device_put(jframe)))
            got = ev._eval_step(tparams, tframe)
            assert set(got) == set(want)
            for key in set(want) - set(COUNT_KEYS):
                np.testing.assert_allclose(
                    np.asarray(got[key]), np.asarray(want[key]), rtol=RTOL,
                    atol=ATOL, err_msg=key)
            graph = build(tframe)
            with torch.inference_mode():
                probs = _probs(ev.model, tparams, graph)
            _assert_counts(got, want, probs, graph.vertex_mask[2].numpy())
            endpoints += int(got["num_endpoint"])
        assert endpoints > 0
    finally:
        ev.close()


def test_eval_once_matches_jax(setup, jax_evaluator, tmp_path):
    """``eval_once`` over the tree from a JAX checkpoint and its
    conversion: the same result keys and values."""
    want = jax_evaluator.eval_once(setup["jax_dir"], str(tmp_path / "j"),
                                   STEP)
    ev = _port_evaluator(setup)
    try:
        got = ev.eval_once(setup["port_dir"], str(tmp_path / "t"), STEP)
        assert ev.frames_per_second > 0
    finally:
        ev.close()
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_allclose(got[key], float(val), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert np.isfinite(got["total_loss"]) and got["total_loss"] > 0
    with open(tmp_path / "t" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert {r["key"] for r in rows} == set(got)
    assert {r["step"] for r in rows} == {STEP}


def test_eval_repeat_polls(setup, tmp_path, capsys):
    """Skips evaluated steps, stops at ``max_step``, then picks up only
    the new checkpoints."""
    train_dir = tmp_path / "train"
    state, _ = ckpt.restore_checkpoint(setup["port_dir"], device="cpu")
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(train_dir), step, state)
    ev = _port_evaluator(setup)
    try:
        eval_dir = str(tmp_path / "eval")
        ev.eval_repeat(str(train_dir), eval_dir, eval_every_second=0,
                       max_step=2)
        assert ev._evaluated_steps == {1, 2}
        ckpt.save_checkpoint(str(train_dir), 4, state)
        ev.eval_repeat(str(train_dir), eval_dir, eval_every_second=0,
                       max_polls=1)
        assert ev._evaluated_steps == {1, 2, 3, 4}
        ev.eval_repeat(str(train_dir), eval_dir, eval_every_second=0,
                       max_polls=2)  # nothing new: two empty polls
    finally:
        ev.close()
    printed = capsys.readouterr().out
    assert [int(line.split()[-1]) for line in printed.splitlines()
            if line.startswith("Evaluating checkpoint")] == [1, 2, 3, 4]


def test_routing_and_eval_mode(setup):
    """``"auto"`` follows the frozen train_config; otherwise the
    evaluation runs on host-built graphs (4x the family's edge buckets
    for a checkpoint trained on device graphs); the eval mode keeps
    ``pallas_tail`` and the forward slab wiring, as the JAX model does;
    the loss's ``unify_weights`` (data parallelism) scale its terms."""
    ev = _port_evaluator(setup)
    try:
        assert ev.model.mode == "eval"
        assert ev.model.slab_level1 is not None
        assert "train" not in ev.model.slab_level1
    finally:
        ev.close()
    frame_cap = configs.tpu_settings("Car")["frame_capacity"]
    for ec, tc, factor in ((_eval_config(setup), {}, 1),
                           (_eval_config(setup, device_graph=False),
                            setup["frozen"], 4)):
        host = _port_evaluator(setup, ec, tc)
        host.close()
        assert not host.device_graph and host.device_spec is None
        assert host.model.slab_level1 is None
        assert host.capacity.vertices == frame_cap.vertices
        assert host.capacity.edges == tuple(factor * e
                                            for e in frame_cap.edges)
    # an eval_config spec wins over the frozen one
    other = setup["jspec"]._replace(num_keypoints=128)
    ev = _port_evaluator(setup, _eval_config(
        setup, device_graph_spec=json.loads(json.dumps(other))))
    try:
        assert ev.device_spec.num_keypoints == 128
    finally:
        ev.close()
    cfg = setup["cfg"]
    wiring = tdb.slab_kernel_wiring(tdpipe.coerce_device_spec(
        setup["jspec"]).level1)
    for mode in ("train", "eval", "test"):
        port = PointGNN(4, 7, mode=mode, pallas_tail=True,
                        slab_level1=wiring, **cfg["model_kwargs"])
        ref = JaxPointGNN(num_classes=4, box_encoding_len=7, mode=mode,
                          pallas_tail=True, slab_level1=wiring,
                          **cfg["model_kwargs"])
        assert port.pallas_tail == ref.pallas_tail, mode
        assert port.slab_level1 == ref.slab_level1, mode
    with pytest.raises(ValueError, match="mode"):
        PointGNN(4, 7, mode="serve", **cfg["model_kwargs"])
    # unify_weights (w, vw) scale cls_loss by w and loc_loss by vw, as
    # the JAX make_loss_fn does; the unscaled loss is the w = vw = 1 case
    ev = _port_evaluator(setup)
    try:
        fetch = tdpipe.build_device_fetch(tpipe.FetchSpec(
            tpipe.DatasetSpec.from_kitti_root(setup["tree"], "", 4),
            cfg, {}, is_eval=True, device_spec=ev.device_spec))
        graph = tdpipe.make_graph_builder(ev.device_spec, 2, cfg)(
            tdpipe.frames_to_device(fetch(0, 0), "cpu"))
        params = ckpt.restore_checkpoint(setup["port_dir"],
                                         device="cpu")[0]["params"]
        loss_fn = tstep.make_loss_fn(ev.model, loss_config(cfg))
        with torch.no_grad():
            _, base = loss_fn(params, graph)
            w, vw = torch.tensor(0.75), torch.tensor(2.5)
            total, got = loss_fn(params, graph, unify_weights=(w, vw))
    finally:
        ev.close()
    assert float(base["loc_loss"]) > 0 and float(base["cls_loss"]) > 0
    assert torch.equal(got["cls_loss"], base["cls_loss"] * w)
    assert torch.equal(got["loc_loss"], base["loc_loss"] * vw)
    assert torch.equal(got["reg_loss"], base["reg_loss"])
    assert torch.equal(total, got["cls_loss"] + got["loc_loss"]
                       + got["reg_loss"])
    assert torch.equal(got["total_loss"], total)


def test_eval_cli(setup, tmp_path, capsys):
    """``eval_torch.py --device cpu`` over a train_dir with a frozen
    narrow config: every checkpoint evaluated, the summaries written, the
    launches line last."""
    train_dir = tmp_path / "train"
    state, _ = ckpt.restore_checkpoint(setup["port_dir"], device="cpu")
    for step in (3, 6):
        ckpt.save_checkpoint(str(train_dir), step, state,
                             config=setup["cfg"],
                             train_config=setup["frozen"])
    eval_dir = tmp_path / "eval"
    ec_path = tmp_path / "eval_config"
    config_io.save_train_config(str(ec_path), dict(
        configs.eval_config("Car"), train_dir=str(train_dir),
        eval_dir=str(eval_dir), eval_dataset="val.txt", max_step=6))
    rc = eval_torch.main([str(ec_path), "--dataset_root_dir", setup["tree"],
                          "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "Evaluating on %d frames" % NUM_FRAMES in lines
    assert sum(line.startswith("eval throughput") for line in lines) == 2
    # the plain versions ran: no kernel was launched
    assert json.loads(lines[-1]) == {"launches": {
        "slab_edge_max": 0, "slab_edge_max_backward": 0}}
    with open(eval_dir / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert {r["step"] for r in rows} == {3, 6}
    assert all(np.isfinite(r["value"]) for r in rows)
    assert {r["key"] for r in rows} >= {"total_loss", "mAP_1", "recall_1"}
