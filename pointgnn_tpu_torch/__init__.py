"""PyTorch/CUDA port of Point-GNN serving and training.

The counterpart of :mod:`pointgnn_tpu` for an NVIDIA Hopper GPU.  It
imports ``torch`` and never ``jax``, and nothing of ``pointgnn_tpu``:
every host helper it needs is its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain PyTorch version.

Implemented so far: serving (``infer.InferencePipeline``: the
two-level on-device graph on the slab and edge-list paths, or the
host-built graph on the generic segment path; ``stream`` and
``run_dataset`` over a KITTI tree, driven by ``run_torch.py``),
single-device training and evaluation on slab graphs, device-built
edge lists or host-built graphs (``Trainer``, ``Evaluator``,
``train_torch.py``, ``eval_torch.py``), every normalization, box codec
and predictor of the reference's configs, carried by the
hand-written CUDA kernels under ``csrc/`` and the native host code under
``csrc/host/`` (merge-NMS, PNG row filters, the radius search, the KITTI
AP evaluator).
"""

__version__ = "0.1.0"
