"""Share of the traced window in which no operation ran on the device,
in %."""

from benchmark.core import layers


def read(ctx):
    return layers.device_idle(ctx, "stream")
