"""The put's host-to-device copies, the ``put_graph`` record's ``h2d_secs`` (the
program's ``device.h2d`` spans inside the put), ms a call; None where the
record has no such field."""


def read(ctx):
    secs = [r["h2d_secs"] for c in ctx.calls for r in c.records
            if r.get("event") == "put_graph" and "h2d_secs" in r]
    return 1e3 * sum(secs) / len(secs) if secs else None
