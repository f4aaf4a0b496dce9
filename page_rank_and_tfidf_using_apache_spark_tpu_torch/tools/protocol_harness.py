"""Wire-protocol conformance harness: replay the DECLARED message space
at a live replica and through the router (tier 6's derived dynamic
proof).

Counterpart of the JAX package's ``tools/protocol_harness.py``, over the
port's fleet: the fixture replica (a real ``serving/fabric._Replica`` on
``--device``, ``cuda`` unless told otherwise) is served over HTTP by the
real ``obs/export.MetricsExporter`` route table, and the real
``ServingFabric`` router is driven at it.  Its probes come from the port's
``analysis.protocol.enumerate_message_space`` over the port's
``analysis/registry.py WIRE_SCHEMAS``.  The assertions are the fabric's
audit invariants:

- **typed rejection, never a hang** — every probe answers within its
  timeout with a status code the contract declares for that endpoint
  (the dispatcher's 404/500 catch-alls are always admissible); a socket
  timeout is a failure, not a retry.
- **never a second execution** — a duplicate request id replays
  byte-identical cached bytes and leaves the replica's ``executions``
  counter where the first request left it; the router audit ends with
  ``double_served == 0``.
- **floor refusal is retryable, then terminal** — with the committed
  floor ratcheted past the replica's generation the replica 503s with
  the floor attached, and the router surfaces a typed
  ``FabricExhausted`` within its bounded retry budget.

Because expected codes come from the contract, a seeded contract
mutation (e.g. deleting the query row's 503) fails the harness — the
observed refusal is no longer in the declared set — as the static
``endpoint-contract-drift`` check fails on the code side.  The report
adds what a run on the card prints: ``handshake_s`` (the fixture
replica's start until it is ready), ``duplicate_executions`` (the
replica's executions counter across the duplicate request: 0),
``double_served`` and ``router_refusal``.

Usage (from the repository root)::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.protocol_harness \
        [--device cpu] [--json] [--timeout-s 5.0]

Exit codes: 0 = every probe conformed, 1 = violations (printed),
2 = could not bring the fixture fleet up.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import protocol
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.export import MetricsExporter
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import MetricsHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    TfidfConfig,
)

REPO = Path(__file__).resolve().parents[2]

# Knobs that would leak ambient chaos or trace capture into the probe
# replies; cleared for the run and restored after it.
_AMBIENT_KNOBS = ("GRAFT_CHAOS", "GRAFT_TRACE_DIR")

_SCFG = TfidfConfig(vocab_bits=10)
_DOCS = [
    "node edge graph rank walk",
    "graph node directed edge weight",
    "rank walk teleport damping node",
    "edge list sparse matrix graph",
]

# Template values for building a VALID request body from declared keys.
# (The harness bodies carry the UNION of every row's droppable keys, so
# every declared key needs a value the strictest handler parses: the
# /cache/fill coercions want numeric lists and an int generation, and
# /peers wants a str→int map — {} keeps the fixture topology peer-free.)
_REQUEST_VALUES = {"terms": ["node"], "ranker": "tfidf",
                   "scores": [1.0], "docs": [0], "generation": 1,
                   "peers": {}, "slots": 64}

# Dispatcher catch-alls: admissible on every endpoint without declaring
# them per row (unrouted path/method -> 404, handler crash -> 500).
_CATCH_ALLS = {404, 500}


@contextlib.contextmanager
def _quiet_environment():
    saved = {k: os.environ.pop(k) for k in _AMBIENT_KNOBS if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def _seal(d: str, docs, device: str, base: int = 0) -> int:
    out = run_tfidf(docs, _SCFG, device=device)
    ref = sgm.seal_segment(d, out, _SCFG, doc_base=base,
                           ranks=np.ones(out.n_docs, np.float32),
                           bm25=Bm25Config())
    return sgm.commit_append(d, ref, _SCFG.config_hash())


def _http(method: str, url: str, body: "bytes | None",
          timeout_s: float) -> tuple[int, bytes]:
    """One bounded HTTP exchange.  Raises TimeoutError on a hang — the
    harness's cardinal failure."""
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


class _Violations:
    def __init__(self) -> None:
        self.rows: list[dict] = []

    def add(self, probe: dict, detail: str) -> None:
        self.rows.append({
            "endpoint": probe.get("endpoint"),
            "kind": probe.get("kind"),
            "detail": detail,
        })


def _valid_body(row_keys, rid: str) -> dict:
    doc = {}
    for k in row_keys:
        doc[k] = rid if k == "rid" else _REQUEST_VALUES.get(k, "x")
    return doc


def _declared_codes(probes: list, endpoint: "str | None") -> set:
    for p in probes:
        if p.get("kind") == "declared-codes" and p.get("endpoint") == endpoint:
            return set(p.get("codes", ()))
    return set()


def _replica_counters(port: int, timeout_s: float) -> dict:
    code, body = _http("GET", f"http://127.0.0.1:{port}/status", None,
                       timeout_s)
    if code != 200:
        raise RuntimeError(f"/status answered {code}")
    return json.loads(body.decode("utf-8"))


def _probe_body(probe: dict, request_keys: set, rid: str) -> "bytes | None":
    kind = probe["kind"]
    if kind in ("malformed-syntax", "malformed-shape"):
        return probe["body"].encode("utf-8")
    if "drop_key" in probe:
        doc = _valid_body(request_keys, rid)
        doc.pop(probe["drop_key"], None)
        return json.dumps(doc).encode("utf-8")
    if "extra_key" in probe:
        doc = _valid_body(request_keys, rid)
        doc[probe["extra_key"]] = 1
        return json.dumps(doc).encode("utf-8")
    if probe["method"] == "POST":
        return json.dumps(_valid_body(request_keys, rid)).encode("utf-8")
    return None


def run_harness(timeout_s: float = 5.0, device: "str | None" = None) -> dict:
    """Replay the declared message space at a fixture replica on
    ``device`` (``cuda`` unless told otherwise) and drive the router at it;
    the report's ``ok`` is False on any violation, and ``fatal`` says why
    the fixture never came up."""
    with _quiet_environment():
        return _run(timeout_s, device)


def _run(timeout_s: float, device: "str | None") -> dict:
    probes = protocol.enumerate_message_space(REPO)
    if not probes:
        return {"ok": False, "fatal": "no WIRE_SCHEMAS contract parsed"}

    viol = _Violations()
    rid_seq = [0]

    def fresh_rid() -> str:
        rid_seq[0] += 1
        return f"ph-{os.getpid()}-{rid_seq[0]}"

    # the declared request keys travel on the probes via drop_key; every
    # replayed route also takes the rid
    declared_req = {p["drop_key"] for p in probes if "drop_key" in p}
    request_keys = (declared_req | {"rid"}) if declared_req \
        else {"rid", "terms", "ranker"}

    tmp = tempfile.mkdtemp(prefix="protocol-harness-")
    stats = {"probes": 0, "replica_checks": 0, "router_checks": 0}
    extra: dict = {"device": None, "handshake_s": None,
                   "duplicate_executions": None, "double_served": None,
                   "router_refusal": None}
    t_start = time.monotonic()
    rep = exporter = None
    try:
        gen = _seal(tmp, _DOCS, device)
        t_hand = time.monotonic()
        rep = fabric._Replica(tmp, replica_id=0, top_k=4, max_batch=None,
                              scoring="coo", poll_s=0.1, device=device)
        extra["device"] = str(rep.device)
        rep.start()
        exporter = MetricsExporter(MetricsHub(), port=0, routes={
            ("POST", "/query"): rep.handle_query,
            ("GET", "/status"): rep.handle_status,
            ("POST", "/cache/peek"): rep.handle_cache_peek,
            ("POST", "/cache/fill"): rep.handle_cache_fill,
            ("POST", "/peers"): rep.handle_peers,
        }).start()
        port = exporter.port

        deadline = time.monotonic() + 60.0
        while not rep.ready() and time.monotonic() < deadline:
            time.sleep(0.05)
        if not rep.ready():
            return {"ok": False,
                    "fatal": "fixture replica never became ready"}
        extra["handshake_s"] = time.monotonic() - t_hand

        # ---- phase 1: the enumerated probe matrix at the live replica.
        # stale-floor last: the floor only ratchets up, so it poisons
        # every probe after it.
        ordered = (
            [p for p in probes if p["kind"] not in
             ("stale-floor", "declared-codes")]
            + [p for p in probes if p["kind"] == "stale-floor"]
        )
        for probe in ordered:
            kind = probe["kind"]
            endpoint = probe.get("endpoint")
            allowed = _declared_codes(probes, endpoint) | _CATCH_ALLS
            url = f"http://127.0.0.1:{port}{probe['path']}"
            body = _probe_body(probe, request_keys, fresh_rid())

            if kind == "duplicate-rid":
                before = _replica_counters(port, timeout_s)
                code1, bytes1 = _http(probe["method"], url, body, timeout_s)
                mid = _replica_counters(port, timeout_s)
                code2, bytes2 = _http(probe["method"], url, body, timeout_s)
                after = _replica_counters(port, timeout_s)
                stats["replica_checks"] += 1
                moved = after["executions"] - mid["executions"]
                extra["duplicate_executions"] = moved
                if (code1, bytes1) != (code2, bytes2):
                    viol.add(probe, "replayed rid did not return "
                                    "byte-identical response")
                if moved != 0 or after["executions"] - before["executions"] > 1:
                    viol.add(probe, "duplicate rid executed twice "
                                    f"(executions {before['executions']} "
                                    f"-> {mid['executions']} -> "
                                    f"{after['executions']})")
                if after["replays"] - before["replays"] < 1:
                    viol.add(probe, "duplicate rid was not counted as a "
                                    "replay")
                codes_seen = {code1, code2}
            elif kind == "stale-floor":
                fabric.commit_floor(tmp, gen + 1)  # strand the replica
                floor_deadline = time.monotonic() + 10.0
                while rep.ready() and time.monotonic() < floor_deadline:
                    time.sleep(0.05)
                if rep.ready():
                    viol.add(probe, "replica stayed ready past a floor "
                                    "above its generation")
                code, raw = _http(probe["method"], url, body, timeout_s)
                stats["replica_checks"] += 1
                codes_seen = {code}
                try:
                    reply = json.loads(raw.decode("utf-8"))
                except ValueError:
                    reply = {}
                if "floor" not in reply:
                    viol.add(probe, "floor refusal did not attach the "
                                    "committed floor")
            else:
                try:
                    code, _raw = _http(probe["method"], url, body, timeout_s)
                except (TimeoutError, OSError) as exc:
                    viol.add(probe, f"no bounded answer: "
                                    f"{type(exc).__name__}: {exc}")
                    continue
                codes_seen = {code}

            stats["probes"] += 1
            expect = set(probe.get("expect", ()))
            for code in sorted(codes_seen):
                if expect and code not in expect:
                    viol.add(probe, f"answered {code}, probe expects "
                                    f"one of {sorted(expect)}")
                if endpoint is not None and code not in allowed:
                    viol.add(probe, f"answered {code}, which the "
                                    "WIRE_SCHEMAS row does not declare "
                                    "— contract drift caught on the wire")

        # ---- phase 2: the real router at the (now stranded) replica:
        # typed exhaustion within the bounded retry budget, no hang.
        cfg = fabric.FabricConfig(replicas=1, retry_limit=3,
                                  retry_pause_s=0.05,
                                  request_timeout_s=timeout_s,
                                  device=extra["device"])
        fab = fabric.ServingFabric(tmp, cfg)
        fab._ports = {0: port}  # routed without start(): no child processes
        t0 = time.monotonic()
        try:
            fab.query(["node"], timeout=timeout_s)
            viol.add({"endpoint": "query", "kind": "router-stale-floor"},
                     "router served from a replica below the committed "
                     "floor")
        except fabric.FabricExhausted as exc:
            extra["router_refusal"] = type(exc).__name__
        except Exception as exc:
            viol.add({"endpoint": "query", "kind": "router-stale-floor"},
                     f"untyped router failure {type(exc).__name__}: {exc}")
        stats["router_checks"] += 1
        elapsed = time.monotonic() - t0
        budget = timeout_s + cfg.retry_limit * (cfg.request_timeout_s
                                                + cfg.retry_pause_s) + 5.0
        if elapsed > budget:
            viol.add({"endpoint": "query", "kind": "router-stale-floor"},
                     f"router took {elapsed:.1f}s — unbounded retry")
        audit = fab.audit()
        extra["double_served"] = audit["double_served"]
        if audit["double_served"] != 0:
            viol.add({"endpoint": "query", "kind": "router-audit"},
                     f"double_served == {audit['double_served']}")
    finally:
        if exporter is not None:
            exporter.stop()
        if rep is not None:
            rep.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    return {
        "ok": not viol.rows,
        "fingerprint": protocol.wire_fingerprint(REPO),
        "probes": stats["probes"],
        "replica_checks": stats["replica_checks"],
        "router_checks": stats["router_checks"],
        "elapsed_s": time.monotonic() - t_start,
        **extra,
        "violations": viol.rows,
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="protocol_harness",
        description="replay the declared wire message space at a live "
                    "replica and router; assert typed rejection, no "
                    "hangs, no double execution",
    )
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--timeout-s", type=float, default=5.0,
                    help="per-exchange HTTP timeout (a hit = a hang = "
                         "failure; default 5.0)")
    ap.add_argument("--device", default=None,
                    help="the fixture replica's torch device (default cuda)")
    args = ap.parse_args(argv)

    try:
        report = run_harness(timeout_s=args.timeout_s, device=args.device)
    except RuntimeError as exc:  # e.g. no CUDA for the default device
        report = {"ok": False, "fatal": f"{type(exc).__name__}: {exc}"}
    if "fatal" in report:
        print(f"protocol_harness: {report['fatal']}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(f"protocol_harness: {report['probes']} probe(s), "
              f"{report['replica_checks']} replica check(s), "
              f"{report['router_checks']} router check(s) against "
              f"contract {report['fingerprint']} on {report['device']} in "
              f"{report['elapsed_s']:.2f}s (handshake "
              f"{report['handshake_s']:.2f}s)")
        for v in report["violations"]:
            print(f"  VIOLATION [{v['endpoint']}/{v['kind']}] {v['detail']}")
        if report["ok"]:
            print("protocol_harness: conformant — typed rejection "
                  "everywhere, zero hangs, zero double executions")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
