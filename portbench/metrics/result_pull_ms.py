"""The pull of the result to the host, the ``result_pull`` record's ``secs`` (the
program's ``<p>.result_pull`` span), ms a call; None where the program writes
no such record."""


def read(ctx):
    secs = [r["secs"] for c in ctx.calls for r in c.records
            if r.get("event") == "result_pull"]
    return 1e3 * sum(secs) / len(secs) if secs else None
