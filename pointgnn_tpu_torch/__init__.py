"""PyTorch/CUDA port of Point-GNN serving.

The counterpart of :mod:`pointgnn_tpu` for an NVIDIA Hopper GPU.  It
imports ``torch`` and never ``jax``, and nothing of ``pointgnn_tpu``:
every host helper it needs is its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain PyTorch version.

Implemented so far: slab serving of the two-level on-device graph
(``infer.InferencePipeline``), carried by the hand-written
``slab_edge_max`` kernel (``csrc/slab_edge_max.cu``).
"""

__version__ = "0.1.0"
