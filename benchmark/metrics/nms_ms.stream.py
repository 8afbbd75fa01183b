"""Host merge-NMS milliseconds per frame served in the window: the
window's growth of the program's ``time_dict["nms"]`` over the frames."""

from benchmark.core import layers


def read(ctx):
    return layers.nms_ms(ctx, "stream")
