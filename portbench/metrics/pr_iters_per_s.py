"""PageRank iterations completed by the window's calls, a second of the window."""

from portbench import layers


def read(ctx):
    return layers.rate(ctx, "iterations")
