"""95th percentile of the window's run_ppr_batch call latencies, ms."""

from portbench import layers


def read(ctx):
    return layers.p95_ms(ctx)
