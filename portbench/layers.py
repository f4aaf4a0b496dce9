"""The arithmetic the metric readers share, over one run's ``Context``.

The end-to-end numbers come from the host clock around each call of the
window; the per-layer ones from the program's own metrics records of each
call (its ``put_graph`` record's ``preprocess_secs``, its segments'
``secs``) and from the traced window (``devtrace``).  Each returns None
where the run gives it nothing to read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from portbench import roofline


class Call(NamedTuple):
    latency_s: float
    iterations: int
    queries: int
    records: list  # the program's metrics records of this call


class Context(NamedTuple):
    calls: list  # Call, each call the window completed
    window_s: float  # host clock, first call's start to last call's end
    setup_s: float
    nodes: int
    edges: int
    config: dict
    trace: object  # devtrace.Summary of the traced run, else None


def rate(ctx: Context, unit: str) -> float | None:
    """``unit`` (``iterations`` or ``queries``) completed a second of the
    window."""
    if not ctx.calls or ctx.window_s <= 0:
        return None
    return sum(getattr(c, unit) for c in ctx.calls) / ctx.window_s


def p95_ms(ctx: Context) -> float | None:
    """The 95th percentile (nearest rank) of every call's latency, ms."""
    if not ctx.calls:
        return None
    lat = sorted(c.latency_s for c in ctx.calls)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]


def put_graph_ms(ctx: Context) -> float | None:
    """Mean over the calls of the program's ``put_graph`` record, ms."""
    secs = [r["preprocess_secs"] for c in ctx.calls for r in c.records
            if r.get("event") == "put_graph"]
    return 1e3 * sum(secs) / len(secs) if secs else None


def loop_ms(ctx: Context) -> float | None:
    """Mean over the calls of the summed ``secs`` of a call's segment
    records, ms."""
    loops = [sum(r["secs"] for r in c.records if "secs" in r and "iter" in r)
             for c in ctx.calls]
    return 1e3 * sum(loops) / len(loops) if loops else None


def segment_roofline(ctx: Context) -> float | None:
    """The program's segmented-sum kernel against its byte roofline, %:
    the bytes of each launch in the traced window over the peak bandwidth,
    divided by the launches' device time.  Only where every launch is the
    cell's main-path sum over the graph's edges (the ``segment`` impl, in
    float32), so the bytes a launch needs follow from the cell's shape."""
    pr = ctx.config.get("pagerank", {})
    if ctx.trace is None or pr.get("spmv_impl") != "segment" or pr.get("dtype") != "float32":
        return None
    launches, secs = 0, 0.0
    for name, (count, s) in ctx.trace.device_ops.items():
        if "segment_tiles" in name:
            launches += count
            secs += s
    if not launches:
        return None
    return roofline.share_pct(launches * roofline.segment_gather_bytes(ctx.nodes, ctx.edges),
                              secs)


def device_idle(ctx: Context) -> float | None:
    """Share of the traced window with nothing running on the card, %."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
