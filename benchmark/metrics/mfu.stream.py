"""Useful forward FLOPs of the device programs that ran in the traced
window (frozen ``pointgnn_forward_flops`` on the reference graph's
in-radius pairs), over the window and the bf16 peak, in %."""

from benchmark.core import layers


def read(ctx):
    return layers.mfu(ctx, "stream")
