"""Device resolution shared by the port's entry points."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None):
    """``cuda`` unless the caller asks for another device.

    Raises when CUDA is requested (explicitly or by default) and no GPU
    is visible: the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pointgnn_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    return dev
