"""PyTorch/CUDA port of Point-GNN serving and training.

The counterpart of :mod:`pointgnn_tpu` for an NVIDIA Hopper GPU.  It
imports ``torch`` and never ``jax``, and nothing of ``pointgnn_tpu``:
every host helper it needs is its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain PyTorch version.

Implemented so far: slab serving of the two-level on-device graph
(``infer.InferencePipeline``) and single-device training on it
(``parallel.step.make_train_step``), carried by the hand-written
``slab_edge_max`` kernel and its backward (``csrc/slab_edge_max.cu``,
``csrc/slab_edge_max_bwd.cu``).
"""

__version__ = "0.1.0"
