"""The put's kernel plan builds, the ``put_graph`` record's ``plan_secs`` (the
program's ``ops.segment_plan`` and ``ops.spmv_plan`` spans), ms a call; None
where the record has no such field."""


def read(ctx):
    secs = [r["plan_secs"] for c in ctx.calls for r in c.records
            if r.get("event") == "put_graph" and "plan_secs" in r]
    return 1e3 * sum(secs) / len(secs) if secs else None
