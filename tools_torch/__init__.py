"""Command-line tools of the PyTorch/CUDA port, one per tool of ``tools/``
(same file names and flags); each imports only ``pointgnn_tpu_torch``."""
