"""Share of the traced window with nothing on the card, %."""

from portbench import layers


def read(ctx):
    return layers.device_idle(ctx)
