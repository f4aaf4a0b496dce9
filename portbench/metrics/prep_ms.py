"""The entry's host preparation outside the put, the summed ``prep_secs`` of a
call's records (the program's ``<p>.prep`` spans), ms a call; None where no
record carries ``prep_secs``."""


def read(ctx):
    preps = [[r["prep_secs"] for r in c.records if "prep_secs" in r] for c in ctx.calls]
    if not any(preps):
        return None
    return 1e3 * sum(sum(p) for p in preps) / len(preps)
