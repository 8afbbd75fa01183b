"""K1 (``slab_edge_max``): the least time of its calls in the traced
window (frozen bound on the reference graph's pair counts) over the
device time of its own kernels, found by name in the trace, in %."""

from benchmark.core import layers


def read(ctx):
    return layers.k1_roofline(ctx, "stream")
