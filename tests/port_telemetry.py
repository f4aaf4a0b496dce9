"""What the port's PageRank-family telemetry carries beyond the JAX package's.

The port spans every phase of a call: the call itself (``<p>.call``), its
host preparation (``<p>.prep``), the put (``<p>.put_graph``), each
host-to-device copy (``device.h2d``) and each kernel plan build
(``ops.segment_plan``, ``ops.spmv_plan``); its ``put_graph`` record adds
the put's copy and plan seconds, the bytes copied, where its derived
fields were built (``derived_on``), the bytes it holds on the device
(``device_bytes``) and the prep's seconds,
``ppr_batch`` the prep's seconds, and a ``result_pull`` record times the
pull.  The parity tests hold the port's records and spans, with exactly
these taken away, to the reference's.
"""

PORT_ONLY_SPANS = (
    "pagerank.call", "pagerank.prep", "pagerank.put_graph",
    "ppr.call", "ppr.prep", "ppr.put_graph",
    "hits.prep", "hits.put_graph", "cc.prep", "cc.put_graph",
    "device.h2d", "ops.segment_plan", "ops.spmv_plan",
)
PORT_ONLY_FIELDS = {
    "put_graph": ("h2d_secs", "h2d_bytes", "plan_secs", "derived_on", "prep_secs",
                  "device_bytes"),
    "ppr_batch": ("prep_secs",),
}
PORT_ONLY_EVENTS = ("result_pull",)


def reference_view(records: list) -> list:
    """``records`` without the port-only events and fields, in order."""
    out = []
    for r in records:
        if r.get("event") in PORT_ONLY_EVENTS:
            continue
        drop = PORT_ONLY_FIELDS.get(r.get("event"), ())
        out.append({k: v for k, v in r.items() if k not in drop})
    return out
