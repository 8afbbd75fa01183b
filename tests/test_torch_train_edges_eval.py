"""A JAX edge-list checkpoint trained, converted and evaluated by the
port.

A JAX ``Trainer`` on the CPU under ``"auto"`` trains on device-built edge
lists (``resolve_device_setup`` picks the slab graph only on a TPU) and
freezes ``device_graph_slab: false`` into its train_config.  Two steps on
a 2-frame synthetic KITTI tree (car T=1, widths 16-32), then
``convert_jax_checkpoint.py``, then ``eval_once`` of the port's
``Evaluator`` (routed by the frozen train_config) against the JAX
``Evaluator``'s on the same checkpoint: every result at rtol 1e-5.
"""

import os

import numpy as np
import pytest

import jax

from pointgnn_tpu.train import pipeline as jpipe
from pointgnn_tpu.train import summary as jax_summary
from pointgnn_tpu.train.evaluator import Evaluator as JaxEvaluator
from pointgnn_tpu.train.trainer import Trainer as JaxTrainer
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.train import pipeline as tpipe
from pointgnn_tpu_torch.train import summary as tsummary
from pointgnn_tpu_torch.train.evaluator import Evaluator
from pointgnn_tpu_torch.utils import config_io, synthetic_kitti
from test_torch_configs import narrow_config
from test_torch_train import _spec

import convert_jax_checkpoint

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _jsonl_summaries_only(monkeypatch):
    """Scalars go to the JSONL files only (a TensorBoard writer would
    import TensorFlow, ~16 s here)."""
    for module in (tsummary, jax_summary):
        monkeypatch.setattr(module, "_tb_writer", lambda directory: None)


def test_jax_auto_checkpoint_evaluates_in_the_port(tmp_path):
    """A JAX ``Trainer`` on the CPU under ``"auto"`` trains on edge lists
    (2 steps) and freezes ``device_graph_slab: false``; the conversion,
    evaluated by the port's ``Evaluator``, gives JAX ``Evaluator``'s
    results."""
    root = str(tmp_path / "kitti")
    synthetic_kitti.main(root, 2, n_ground=600)
    cfg = narrow_config("car_auto_T1_train")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    tc = dict(configs.get_train_config("car_auto_T1_train"), batch_size=1,
              NUM_GPU=1, num_load_dataset_workers=0, train_dir=jax_dir,
              max_steps=2, initial_lr=0.01,
              device_graph_spec=_spec(cfg)._replace(
                  slab_level0=False, slab_level1=False))
    split = os.path.join(root, "3DOP_splits/train.txt")
    jtrainer = JaxTrainer(cfg, tc, jpipe.FetchSpec(
        jpipe.DatasetSpec.from_kitti_root(root, split, 4), cfg, tc),
        num_frames=2)
    try:
        assert jtrainer.device_graph
        jtrainer.train()
    finally:
        jtrainer.close()
    frozen = config_io.load_train_config(os.path.join(jax_dir,
                                                      "train_config"))
    assert frozen["device_graph_slab"] is False
    convert_jax_checkpoint.convert(jax_dir, port_dir)
    ec = dict(configs.eval_config("Car"), eval_dataset="val.txt")
    val = os.path.join(root, "3DOP_splits/val.txt")
    jev = JaxEvaluator(cfg, ec, jpipe.FetchSpec(
        jpipe.DatasetSpec.from_kitti_root(root, val, 4), cfg, ec,
        is_eval=True), num_frames=2, train_config=frozen)
    try:
        with jax.default_matmul_precision("highest"):
            want = jev.eval_once(jax_dir, str(tmp_path / "jeval"), 2)
    finally:
        jev.close()
    tev = Evaluator(cfg, ec, tpipe.FetchSpec(
        tpipe.DatasetSpec.from_kitti_root(root, val, 4), cfg, ec,
        is_eval=True), num_frames=2,
        train_config=config_io.load_train_config(
            os.path.join(port_dir, "train_config")), device="cpu")
    try:
        assert tev.device_graph and tev.model.slab_level1 is None
        got = tev.eval_once(port_dir, str(tmp_path / "teval"), 2)
    finally:
        tev.close()
    assert set(got) == set(want)
    assert np.isfinite(got["total_loss"]) and got["total_loss"] > 0
    for key, val in want.items():
        np.testing.assert_allclose(got[key], float(val), rtol=RTOL,
                                   atol=1e-6, err_msg=key)
