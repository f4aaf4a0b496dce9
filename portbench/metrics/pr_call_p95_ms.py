"""95th percentile of the window's api.pagerank call latencies, ms."""

from portbench import layers


def read(ctx):
    return layers.p95_ms(ctx)
