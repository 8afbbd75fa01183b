"""The port's ``Trainer`` over two spawned gloo ranks on the CPU.

One launch of two ranks (``parallel.mesh.launch``) runs the jobs of
``parallel.dryrun.train_jobs`` on a synthetic KITTI tree (Car,
Pedestrian and Cyclist), car_auto_T1 at narrow widths on slab graphs at
2048 points and 256 keypoints, ``batch_size`` 4 and ``NUM_GPU`` 2 (two
frames per rank), without augmentation so that the frames are the same
whichever process fetches them:

- four steps on explicit batches with per-step graph randomization;
- the same steps as two, a checkpoint (written by rank 0 alone), and two
  more in fresh trainers that restore it: bitwise the uninterrupted run
  (JAX's ``test_trainer_device_graph_mesh_resume_determinism``);
- one step without graph randomization, held against one process
  training the union of the same four frames at the union tolerance
  (losses rtol 1e-5; each leaf's update within 1e-4 of (lr + its
  largest update));
- ``train_torch.py``'s run on each rank (``run_training``: restore,
  ``Trainer.train`` to ``max_steps`` 1, one checkpoint).

Every rank ends every job with the same parameters, bit for bit.
"""

import copy
import os

import numpy as np
import pytest
import torch

from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.parallel import dryrun, mesh
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.params import params_to_numpy
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.train import pipeline as tpipe
from pointgnn_tpu_torch.train.trainer import Trainer
from pointgnn_tpu_torch.utils import synthetic_kitti
from test_torch_augment import CLASSES
from test_torch_configs import narrow_config
from test_torch_dp_step import _check_update

NUM_FRAMES = 4
BATCHES = [[0, 1, 2, 3], [2, 3, 0, 1], [1, 3, 0, 2], [3, 0, 2, 1]]


def _job(root, train_dir, batches, **kw):
    cfg = narrow_config("car_auto_T1_train")
    tc = configs.get_train_config("car_auto_T1_train")
    job_kw = {k: kw.pop(k) for k in ("restore", "save", "run") if k in kw}
    tc.update(batch_size=4, NUM_GPU=2, num_load_dataset_workers=0,
              data_aug_configs=[], train_dir=str(train_dir),
              device_graph_spec=tdb.spec_from_config(
                  cfg, num_points=2048, num_keypoints=256, runtime=False),
              **kw)
    split = os.path.join(root, "3DOP_splits/train.txt")
    fspec = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        root, split, cfg["num_classes"]), cfg, tc)
    return dict(config=cfg, train_config=tc, fetch_spec=fspec,
                num_frames=NUM_FRAMES, batches=batches, **job_kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    tree = str(root / "kitti")
    synthetic_kitti.main(tree, NUM_FRAMES, classes=CLASSES, n_ground=600)
    jobs = {
        "whole": _job(tree, root / "whole", BATCHES),
        "first": _job(tree, root / "resumed", BATCHES[:2], save=True),
        "resumed": _job(tree, root / "resumed", BATCHES[2:], restore=True),
        "union": _job(tree, root / "union", BATCHES[:1],
                      device_graph_rnd3d=False),
        "train": _job(tree, root / "train", [], run=True, max_steps=1),
    }
    ranks = mesh.launch(dryrun.train_jobs, 2, list(jobs.values()),
                        devices="cpu", timeout=60, join_timeout=60)
    out = {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}
    return root, jobs, out


def test_ranks_train_in_step(runs):
    """Two ranks of two frames each: finite losses, valid endpoints, and
    the same parameters on both ranks after every job."""
    _, _, out = runs
    for name, ranks in out.items():
        assert ranks[0]["total_loss"] == ranks[1]["total_loss"], name
        if name != "train":  # run_training returns no parameters
            assert dryrun.same_params(ranks), name
    whole = out["whole"][0]
    assert whole["step"] == 4 and len(whole["total_loss"]) == 4
    assert all(np.isfinite(whole["total_loss"]))
    assert all(v > 0 for v in whole["valid"])
    # per-step graph randomization: the graphs change every step
    assert len(set(whole["valid"])) > 1


def test_checkpoint_written_once_and_resume_is_exact(runs):
    """Rank 0 alone writes the checkpoint; both ranks restore it and
    continue exactly as the uninterrupted run."""
    root, _, out = runs
    first, resumed, whole = out["first"], out["resumed"], out["whole"]
    assert first[0]["saved"].endswith("model-2") and first[1]["saved"] is None
    assert ckpt.list_checkpoint_steps(str(root / "resumed")) == [2]
    assert sorted(os.listdir(first[0]["saved"])) == [ckpt.STATE_FILE]
    for r in range(2):
        assert resumed[r]["step"] == 4
        assert (first[r]["total_loss"] + resumed[r]["total_loss"]
                == whole[r]["total_loss"])
        assert first[r]["valid"] + resumed[r]["valid"] == whole[r]["valid"]
    assert dryrun.same_params([whole[0], resumed[0]])
    train_dir = str(root / "train")
    assert ckpt.list_checkpoint_steps(train_dir) == [1]
    for run in out["train"]:
        assert run["steps"] == 1 and len(run["total_loss"]) == 1
        assert np.isfinite(run["total_loss"][0])
        assert set(run["launches"]) == {"slab_edge_max",
                                        "slab_edge_max_backward"}


def test_two_ranks_match_one_process_union(runs):
    """One step of two ranks against one process training the union of
    the same four frames (no graph randomization: both see the same
    graphs)."""
    _, jobs, out = runs
    job = jobs["union"]
    tc = dict(job["train_config"], NUM_GPU=1)
    one = Trainer(job["config"], tc, job["fetch_spec"]._replace(
        train_config=tc), num_frames=NUM_FRAMES, device="cpu")
    try:
        assert one.n_devices == 1 and one.frames_per_device == 4
        p0 = copy.deepcopy(params_to_numpy(one.state.params))
        aux = one.train_batch(BATCHES[0])
        p1 = params_to_numpy(one.state.params)
    finally:
        one.close()
    for rank in out["union"]:
        np.testing.assert_allclose(rank["total_loss"][0],
                                   float(aux["total_loss"]), rtol=1e-5)
        assert rank["valid"][0] == float(aux["num_valid_endpoint"])
        _check_update(p0, p1, rank["params"], lr=tc["initial_lr"])


def test_graph_draws_fold_in_the_rank_only_with_a_mesh():
    """Without a mesh the graph randomization is seeded from (seed,
    step, frame) alone, as before data parallelism; each rank of a mesh
    draws its own."""
    def seed(*args, **kw):
        return tstep.graph_generator(*args, **kw).initial_seed()

    assert seed(5, 3, 1, "cpu") == (5 * 1000003 + 3) * 1000003 + 1
    ranked = {seed(5, 3, 1, "cpu", rank=r) for r in range(2)}
    assert len(ranked) == 2 and seed(5, 3, 1, "cpu") not in ranked
