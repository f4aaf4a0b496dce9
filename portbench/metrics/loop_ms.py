"""The segment loop, the summed ``secs`` of a call's segment records, ms a call."""

from portbench import layers


def read(ctx):
    return layers.loop_ms(ctx)
