"""What a put holds on the device, the ``put_graph`` record's
``device_bytes`` (the bytes of the tensors of the graph it returns), GB a
call; None where no record has the field (a program that does not count
it)."""


def read(ctx):
    held = [r["device_bytes"] for c in ctx.calls for r in c.records
            if r.get("event") == "put_graph" and "device_bytes" in r]
    return sum(held) / len(held) / 1e9 if held else None
