"""The port's training surface against the JAX package, on the CPU.

On a small synthetic KITTI tree with Car, Pedestrian and Cyclist
objects: the device fetch (KITTI read, crop-paste, the shipped
augmentation, packing) and the prefetching ``DataProvider`` give the
JAX package's frames bitwise for the same seeds, in the same order, with
and without worker processes.  The ``Trainer`` at a small graph spec and
narrow widths: its first step is ``make_train_step`` by hand (which
``test_torch_train_step.py`` holds against ``jax.value_and_grad``), its
batch order is the JAX Trainer's permutation, it checkpoints, resumes,
prints epochs and writes summaries, and it raises on what is not ported.
``train_torch.py --device cpu`` trains two steps and ``run_torch.py``
serves the checkpoint.  Tolerance: none, everything is compared exactly.
"""

import json
import os
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.train import device_pipeline as jdpipe
from pointgnn_tpu.train import pipeline as jpipe
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.data import crop_aug as tcrop
from pointgnn_tpu_torch.data import kitti as tkitti
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.train import device_pipeline as tdpipe
from pointgnn_tpu_torch.train import optimizers as topt
from pointgnn_tpu_torch.train import pipeline as tpipe
from pointgnn_tpu_torch.train import summary as tsummary
from pointgnn_tpu_torch.train.trainer import Trainer
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.utils import config_io, synthetic_kitti
from pointgnn_tpu_torch.utils import thread_warnings
from test_torch_augment import CLASSES, dataset
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from test_torch_configs import narrow_config

import run_torch
import train_torch

NUM_FRAMES = 4
NUM_POINTS, NUM_KEYPOINTS = 2048, 256


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 4-frame tree (Car, Pedestrian, Cyclist in every frame) and a
    crop-aug library written from it."""
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic_kitti.main(root, NUM_FRAMES, classes=CLASSES, n_ground=600)
    lib = os.path.join(root, "crop_lib.json")
    tcrop.save_cropped_boxes(dataset(root, tkitti), lib)
    return root, lib


def _train_config(name, root, lib=None, **kw):
    tc = configs.get_train_config(name)
    tc.update(batch_size=2, num_load_dataset_workers=0, **kw)
    if lib is not None:
        tc["crop_aug"] = {
            "crop_filename": lib,
            "sample_rate": {"Car": 1, "Pedestrian": 1, "Cyclist": 1},
            "parser_kwargs": {"max_overlap_rate": 0.5, "max_trails": 2},
        }
    return tc


def _specs(cfg, packages=(tdb,)):
    return [m.spec_from_config(cfg, num_points=NUM_POINTS,
                               num_keypoints=NUM_KEYPOINTS, runtime=False)
            for m in packages]


def _fetch_specs(root, name, cfg, tc):
    split = os.path.join(root, "3DOP_splits/train.txt")
    tspec, jspec = _specs(cfg, (tdb, jdb))
    t = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        root, split, cfg["num_classes"]), cfg, tc, device_spec=tspec)
    j = jpipe.FetchSpec(jpipe.DatasetSpec.from_kitti_root(
        root, split, cfg["num_classes"]), cfg, tc, device_spec=jspec)
    return t, j


def _same_frame(a, b):
    assert type(a).__name__ == type(b).__name__ == "DeviceFrame"
    assert a.packed_points.dtype == b.packed_points.dtype
    np.testing.assert_array_equal(a.packed_points, b.packed_points)
    assert a.labels._fields == b.labels._fields
    for x, y in zip(a.labels, b.labels):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["car_auto_T3_train",
                                  "ped_cyl_auto_T3_trainval"])
def test_device_fetch_matches_jax(tree, name):
    """The fetch (crop-paste, the shipped augmentation, packing) of every
    frame at several seeds, for the Car and the Ped+Cyc label maps."""
    root, lib = tree
    cfg = configs.get_config(name)
    tc = _train_config(name, root, lib)
    tspec, jspec = _fetch_specs(root, name, cfg, tc)
    tfetch, jfetch = tdpipe.build_device_fetch(tspec), \
        jdpipe.build_device_fetch(jspec)
    active = 0
    for frame in range(NUM_FRAMES):
        for seed in (0, 5, 99):
            a, b = tfetch(frame, seed), jfetch(frame, seed)
            _same_frame(a, b)
            active += int(a.labels.has_target.sum())
    assert active > 0  # some boxes carry localization targets
    # eval skips crop-paste and augmentation
    tev = tdpipe.build_device_fetch(tspec._replace(is_eval=True))
    jev = jdpipe.build_device_fetch(jspec._replace(is_eval=True))
    _same_frame(tev(1, 3), jev(1, 3))


class _SyncPool:
    """Stands in for the JAX provider's worker pool: runs each request
    at once, in submission order, with the request's own seed."""

    def apply_async(self, fn, args):
        out = fn(*args)
        return types.SimpleNamespace(get=lambda: out)

    def terminate(self):
        pass

    def join(self):
        pass


BATCHES = ([0, 1], [2, 0], [3, 1], [0, 1], [2, 2], [3, 0])


@pytest.mark.parametrize("num_workers,every_n,capacity",
                         [(0, 2, 2), (0, 0, 1), (2, 2, 2)])
def test_data_provider_matches_jax(tree, monkeypatch, num_workers, every_n,
                                   capacity):
    """provide_batch over several calls: JAX's frames, seeds drawn in
    JAX's order (the generators end in the same state), with the slotted
    cache (every_n >= 1) or the shipped direct loads (every_n 0)."""
    root, lib = tree
    name = "car_auto_T1_train"
    cfg = configs.get_config(name)
    tc = _train_config(name, root, lib)
    tspec, jspec = _fetch_specs(root, name, cfg, tc)
    kw = dict(load_dataset_every_N_time=every_n, capacity=capacity,
              num_frames=NUM_FRAMES, seed=3)
    preload = list(range(NUM_FRAMES)) if num_workers else ()
    jprov = jpipe.DataProvider(jspec, num_workers=0, **kw)
    if num_workers:
        monkeypatch.setattr(jpipe, "_WORKER_FETCH", jprov._fetch)
        jprov._pool = _SyncPool()
        jprov.preload(preload)
    tprov = tpipe.DataProvider(tspec, num_workers=num_workers,
                               preload_list=preload, **kw)
    try:
        for batch in BATCHES:
            for a, b in zip(tprov.provide_batch(batch),
                            jprov.provide_batch(batch)):
                _same_frame(a, b)
            assert (tprov._rng.bit_generator.state
                    == jprov._rng.bit_generator.state)
            assert sorted(tprov._results) == sorted(jprov._results)
    finally:
        tprov.close()
    assert tprov._pool is None


def test_host_graph_paths_raise(tree):
    """(Named when the host-graph fetch and edge-list training raised.)
    The host-graph fetch is ported (a FetchSpec without device_spec
    builds it; ``tests/test_torch_train_host.py`` holds it against JAX);
    ``slab=False`` resolves to device-built edge lists (both slab flags
    cleared, the SRC sentinel, no slab wiring), "auto" to the slab
    graph."""
    root, _ = tree
    cfg = configs.get_config("car_auto_T1_train")
    tspec, _ = _fetch_specs(root, "car_auto_T1_train", cfg, {})
    frame = tpipe.build_fetch(tspec._replace(device_spec=None))(0, 1)
    assert type(frame).__name__ == "FrameData"
    assert len(frame.edges_list) == 2
    edges, extra = tdpipe.resolve_device_setup(cfg, slab=False)
    assert not (edges.slab_level0 or edges.slab_level1)
    assert extra == {"edge_sentinel": "src"}
    dspec, _ = tdpipe.resolve_device_setup(cfg, slab=True)
    assert dspec.slab_level0 and dspec.slab_level1
    assert tdpipe.resolve_device_setup(cfg)[0] == dspec
    # a spec frozen with the slab flags set trains on edge lists when the
    # frozen routing says so
    assert tdpipe.resolve_device_setup(cfg, spec=dspec, slab=False)[0] == \
        edges


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _trainer_setup(root, train_dir, name="car_auto_T1_train", **tc_kw):
    cfg = narrow_config(name)
    tc = _train_config(name, root, train_dir=str(train_dir),
                       device_graph_spec=_specs(cfg)[0], **tc_kw)
    split = os.path.join(root, "3DOP_splits/train.txt")
    fspec = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        root, split, cfg["num_classes"]), cfg, tc)
    return cfg, tc, fspec


def _trainer(root, train_dir, **tc_kw):
    cfg, tc, fspec = _trainer_setup(root, train_dir, **tc_kw)
    return Trainer(cfg, tc, fspec, num_frames=NUM_FRAMES, device="cpu")


def _leaves(params):
    return [t.detach().clone() for t in topt.param_leaves(params)]


def test_trainer_first_step_is_make_train_step(tree, tmp_path):
    """Two steps through Trainer.train; the first equals make_train_step
    by hand on the frames a fresh provider gives for the JAX Trainer's
    first batch, with the Trainer's graph randomization (seed 0)."""
    root, _ = tree
    trainer = _trainer(root, tmp_path / "run")
    requested, snaps = [], []
    provide, step = trainer.provider.provide_batch, trainer.step_fn

    def spy_provide(idx):
        requested.append([int(i) for i in idx])
        return provide(idx)

    def spy_step(state, batch):
        state, aux = step(state, batch)
        snaps.append((_leaves(state.params), aux))
        return state, aux

    trainer.provider.provide_batch = spy_provide
    trainer.step_fn = spy_step
    try:
        trainer.train(max_steps=2)
    finally:
        trainer.close()
    assert trainer.global_step == 2 and len(snaps) == 2
    # the JAX Trainer's order: one permutation of the frames per epoch
    order = np.random.default_rng(0).permutation(NUM_FRAMES)
    assert requested == [list(order[0:2]), list(order[2:4])]

    cfg, tc, fspec = _trainer_setup(root, tmp_path / "hand")
    dspec, extra = tdpipe.resolve_device_setup(
        cfg, tc["device_graph_spec"])
    model = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                     **extra, **cfg["model_kwargs"])
    params = model.init(0, 1, "cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    opt, _ = topt.build_from_train_config(tc)
    state = tstep.init_train_state(params, opt)
    step_fn = tstep.make_train_step(
        model, opt, loss_config(cfg),
        tdpipe.make_graph_builder(dspec, model.output_graph_level, cfg),
        frames_per_device=2, with_metrics=True, graph_rng_seed=0)
    provider = tpipe.DataProvider(
        fspec._replace(device_spec=dspec), num_workers=0,
        load_dataset_every_N_time=0, num_frames=NUM_FRAMES, seed=0)
    batch = tdpipe.frames_to_device(tdpipe.stack_frames(
        provider.provide_batch(order[:2])), "cpu")
    state, aux = step_fn(state, batch)
    got_params, got_aux = snaps[0]
    assert np.isfinite(float(aux["total_loss"]))
    assert float(aux["num_valid_endpoint"]) > 0
    for key in ("total_loss", "cls_loss", "loc_loss", "confusion"):
        assert torch.equal(got_aux[key], aux[key]), key
    for a, b in zip(got_params, _leaves(state.params)):
        assert torch.equal(a, b)


def test_trainer_checkpoint_resume_and_epochs(tree, tmp_path, capsys,
                                             monkeypatch):
    """max_steps saves at the step; a new Trainer restores step,
    parameters and optimizer state (momentum buffers) and trains on from
    the epoch of the restored step; an epoch end prints the metrics and
    writes the JSONL summaries.  (The TensorBoard writer is left out:
    importing it imports TensorFlow here, which takes longer than this
    whole file.)"""
    monkeypatch.setattr(tsummary, "_tb_writer", lambda directory: None)
    root, _ = tree
    train_dir = tmp_path / "run"
    first = _trainer(root, train_dir, optimizer="momentum")
    try:
        first.train(max_steps=1)
    finally:
        first.close()
    assert ckpt.list_checkpoint_steps(str(train_dir)) == [1]

    frozen = config_io.load_train_config(str(train_dir / "train_config"))
    assert frozen["device_graph"] is True
    assert frozen["device_graph_slab"] is True
    assert isinstance(frozen["device_graph_spec"], list)  # JSON
    assert tdpipe.coerce_device_spec(
        frozen["device_graph_spec"]) == first.device_spec
    with pytest.raises(TypeError):
        tdpipe.coerce_device_spec({"num_points": 1})

    cfg, _, fspec = _trainer_setup(root, train_dir)
    second = Trainer(cfg, frozen, fspec, num_frames=NUM_FRAMES,
                     device="cpu")
    try:
        assert second.device_spec == first.device_spec
        assert second.restore() == 1 and second.global_step == 1
        for a, b in zip(_leaves(second.state.params),
                        _leaves(first.state.params)):
            assert torch.equal(a, b)
        mine = second.state.opt_state["torch"].state_dict()
        theirs = first.state.opt_state["torch"].state_dict()
        assert second.state.opt_state["count"] == 1
        assert mine["state"].keys() == theirs["state"].keys()
        for k, v in theirs["state"].items():
            assert torch.equal(mine["state"][k]["momentum_buffer"],
                               v["momentum_buffer"])
        capsys.readouterr()
        # step 1 of 2-step epochs lies in epoch 0: the resumed run
        # trains epochs 0 and 1 whole, as the JAX Trainer does
        second.train(max_epoch=2)
    finally:
        second.close()
    out = capsys.readouterr().out
    assert "STEP: 3, epoch_idx: 0" in out and "STEP: 5, epoch_idx: 1" in out
    assert "Class_3: recall=" in out
    assert ckpt.list_checkpoint_steps(str(train_dir)) == [1, 5]
    rows = [json.loads(line) for line in open(train_dir / "scalars.jsonl")]
    keys = {r["key"] for r in rows}
    assert {"total_loss", "mAP_1", "learning rate"} <= keys
    assert {r["step"] for r in rows} == {3, 5}
    assert len(second.step_log["step_ms"]) == 4


def test_trainer_refuses_what_is_not_ported(tree, tmp_path):
    """(Named when edge-list training, normalized MLPs and data
    parallelism raised here, naming ROADMAP items 6 and 7; the name
    predates item 7.)  ``device_graph_slab: false`` builds an edge-list
    trainer and freezes that routing; a BN config routes to host graphs
    when ``device_graph`` is unset and trains on them; more than one
    device outside a launched group raises a ``ValueError`` naming
    ``parallel.mesh.launch``."""
    root, _ = tree
    cfg, tc, fspec = _trainer_setup(root, tmp_path)
    bn = json.loads(json.dumps(cfg))
    bn["model_kwargs"]["layer_configs"][1]["kwargs"][
        "edge_MLP_normalization_type"] = "fused_BN_center"
    edges = Trainer(cfg, dict(tc, device_graph_slab=False), fspec,
                    NUM_FRAMES, device="cpu")
    edges.close()
    assert edges.device_graph and edges.model.edge_sentinel == "src"
    assert edges.model.slab_level0 is None and edges.model.edge_chunks == 16
    assert edges.train_config["device_graph_slab"] is False
    host_tc = {k: v for k, v in tc.items() if k != "device_graph"}
    bn_trainer = Trainer(bn, host_tc, fspec, NUM_FRAMES, device="cpu")
    bn_trainer.close()
    assert not bn_trainer.device_graph and bn_trainer.model.edge_chunks == 1
    # more than one device needs a launched group of ranks
    with pytest.raises(ValueError, match="parallel.mesh.launch"):
        Trainer(cfg, tc, fspec, NUM_FRAMES, n_devices=2, device="cpu")
    # NUM_GPU 2 on a machine without a second card trains on one
    assert tc["NUM_GPU"] == 2
    one = Trainer(cfg, tc, fspec, NUM_FRAMES, device="cpu")
    one.close()
    assert one.n_devices == 1 and one.frames_per_device == 2


def test_pack_overflow_warning_is_deferred_on_a_thread():
    xyz = np.zeros((8, 3), np.float32)
    attr = np.zeros((8, 1), np.float32)
    held = []

    def worker():
        with thread_warnings.deferred() as entries:
            tdb.pack_points(xyz, attr, 4)
        held.extend(entries)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not caught and len(held) == 1
        thread_warnings.emit(held)
    assert len(caught) == 1 and "point overflow" in str(caught[0].message)


def test_train_cli_then_serve(tree, tmp_path, capsys):
    """train_torch.py --device cpu trains 2 steps from files (the
    narrowed config, a train_config with a small spec, crop-paste and
    the shipped augmentation), traces the second step with
    torch.profiler and writes a checkpoint that run_torch.py --fast
    serves."""
    root, lib = tree
    cfg, tc, _ = _trainer_setup(root, tmp_path / "run", max_steps=2,
                                data_aug_configs=configs.get_train_config(
                                    "car_auto_T1_train")["data_aug_configs"])
    tc["crop_aug"] = _train_config("car_auto_T1_train", root, lib)["crop_aug"]
    # a torch.profiler trace of the second step
    tc.update(profile_dir=str(tmp_path / "prof"), profile_start_step=1,
              profile_steps=1)
    cfg_path, tc_path = str(tmp_path / "config"), str(tmp_path / "tc")
    config_io.save_config(cfg_path, cfg)
    config_io.save_train_config(tc_path, tc)
    split = os.path.join(root, "3DOP_splits/train.txt")
    rc = train_torch.main([tc_path, cfg_path, "--dataset_root_dir", root,
                           "--dataset_split_file", split, "--device", "cpu"])
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 2 and len(last["wait_ms"]) == 2
    assert len(last["total_loss"]) == 2
    assert all(np.isfinite(v) for v in last["total_loss"])
    # the CPU runs the plain versions: no kernel launches
    assert last["launches"] == {"slab_edge_max": 0,
                                "slab_edge_max_backward": 0}
    assert ckpt.list_checkpoint_steps(str(tmp_path / "run")) == [2]
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    out_dir = str(tmp_path / "out")
    rc = run_torch.main([str(tmp_path / "run"), "--fast", "--device", "cpu",
                         "--dataset_root_dir", root, "--output_dir",
                         out_dir, "--dataset_split_file", split])
    assert rc == 0
    assert "Restored step 2" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out_dir, "data"))) == [
        "%06d.txt" % i for i in range(NUM_FRAMES)]


@pytest.mark.parametrize("device,cards,ranks", [
    ("cuda", 2, 2), ("cuda", 8, 2), ("cuda", 1, 1), ("cuda:0", 2, 1),
    ("cuda:1", 2, 1), ("cpu", 2, 1)])
def test_train_cli_rank_count(tree, tmp_path, monkeypatch, capsys, device,
                              cards, ranks):
    """train_torch.py and the Trainer take their rank count from one
    function: on ``cuda``, min(NUM_GPU x COPY_PER_GPU, cards visible)
    ranks started through ``parallel.mesh.launch``; a named card or the
    CPU trains in this process on that device.  The training itself is
    replaced by a recorder."""
    from pointgnn_tpu_torch.parallel import mesh as tmesh
    from pointgnn_tpu_torch.train import trainer as ttrainer
    root, _ = tree
    cfg, tc, _ = _trainer_setup(root, tmp_path / "run")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tc["NUM_GPU"] * tc.get("COPY_PER_GPU", 1) == 2
    assert ttrainer.num_ranks(tc, device) == ranks
    calls = []

    def run_training(mesh, *args, device=None):
        calls.append(("run", mesh, device))
        return {"launches": {}}

    def launch(fn, n, *args):
        assert fn is run_training
        calls.append(("launch", n))
        return [{"launches": {}}] * n

    monkeypatch.setattr(ttrainer, "run_training", run_training)
    monkeypatch.setattr(tmesh, "launch", launch)
    cfg_path, tc_path = str(tmp_path / "config"), str(tmp_path / "tc")
    config_io.save_config(cfg_path, cfg)
    config_io.save_train_config(tc_path, tc)
    rc = train_torch.main([tc_path, cfg_path, "--dataset_root_dir", root,
                           "--dataset_split_file",
                           os.path.join(root, "3DOP_splits/train.txt"),
                           "--device", device])
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ranks"] == ranks
    if ranks > 1:
        assert calls == [("launch", ranks)]
    else:
        assert calls == [("run", None, device)]
