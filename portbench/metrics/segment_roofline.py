"""segment.cu against its byte roofline in the traced window, %."""

from portbench import layers


def read(ctx):
    return layers.segment_roofline(ctx)
