"""PyTorch/CUDA port of Point-GNN serving and training.

The counterpart of :mod:`pointgnn_tpu` for an NVIDIA Hopper GPU.  It
imports ``torch`` and never ``jax``, and nothing of ``pointgnn_tpu``:
every host helper it needs is its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain PyTorch version.

Implemented so far: serving of the two-level on-device graph
(``infer.InferencePipeline``: slab and edge-list paths, ``stream`` and
``run_dataset`` over a KITTI tree, driven by ``run_torch.py``) and
single-device training on it (``parallel.step.make_train_step``),
carried by the hand-written CUDA kernels under ``csrc/`` and the native
host merge-NMS (``csrc/host/nms.cpp``).
"""

__version__ = "0.1.0"
