"""The chaos gate's scenarios, on the port: each scenario of the JAX
package's ``tools/chaos.sh`` after its test-suite run, as one function
taking ``device``.

=================  ==========================================================
``device_lost``    a 2-slot mesh loses slot 1 (``*:device_lost@dev:1``):
                   PageRank sharded, TF-IDF sharded and ``owned`` each
                   within 1e-6 of the unbroken run; the trace report shows
                   exactly three ``mesh_shrinks`` 2 -> 1 and no
                   ``exhausted`` (``tools/chaos.sh:36-106``)
``fixpoint``       a tolerance fixpoint on the 2-slot mesh under the same
                   loss, and batched PPR losing device 0 at its delta sync
                   salvaged on the CPU (``:117-176``)
``ingest_h2d``     ``device_lost`` at ``ingest_h2d_put``: the single-device
                   stream rolls back and replays on the CPU, the sharded
                   one shrinks 2 -> 1 (``:187-249``)
``segment_swap``   a segmented server hot-swapping delta segments and a
                   background merge under ``serve_dispatch:fail@%5`` and
                   ``segment_merge:fail@1``; every request served once
                   (``:259-351``)
``crash_append``   the crash harness's SIGKILLs at every write boundary of
                   ``commit_append`` (``:362-387``); its workers touch no
                   device, so it runs on the CPU whatever ``device`` says
``malformed``      the protocol harness, then malformed bodies at a live
                   2-replica fleet under ``fabric_route:net_partition@2``
                   and ``replica_query:proc_kill@3``, and the
                   ``replica_swap:proc_kill@1`` kill seam (``:398-492``)
``fed_scrape``     every scrape partitioned, then hung, mid-traffic: the
                   board labels both replicas stale, never drops them, and
                   recovers (``:502-596``)
``cache_peer``     a non-owner replica under ``cache_peek`` partition and
                   hang and ``cache_fill`` partition: correct bytes, bounded
                   blocking, the breaker trips and recloses (``:609-729``)
=================  ==========================================================

Each scenario keeps the reference's bars, and a fleet scenario its audit:
``dropped`` 0, ``double_served`` 0, ``roll_retries`` 0.  Where the
reference forces 2 CPU devices, the port builds a mesh of 2 slots: on the
CPU ``parallel.mesh.mesh_for(2, axis, device="cpu")``, on a card
``make_mesh(devices=[card] * 2)``.  The mesh rungs shrink only on a loss
that names its slot, which ``device_lost@dev:1`` does.  Faults are
installed with ``resilience.chaos.inject``, so a plan counts its own calls
whatever the process ran before; the env knobs the reference sets for its
process (retry, scrape and cache-breaker settings, which the replicas
inherit) are set for the scenario's span only, and the caller's
``GRAFT_CHAOS`` is set aside for it (:func:`own_plans`).

Each function returns a report: ``line`` (the reference's ``OK`` line),
``seconds`` and the records the tests hold to the reference's run.  The
CLI runs them, from the repository root::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.chaos_scenarios \\
        [--device cpu|cuda] [names...]

on ``cuda`` unless given ``--device cpu``, and prints one ``OK`` line a
scenario; it exits 0 when every named scenario (all by default) held, 1
otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"

# the reference scenarios' fixtures
MESH_SLOTS = 2
PR_KW = dict(dangling="redistribute", init="uniform", dtype="float32")
FLEET_DOCS = ["node edge graph rank walk", "graph node directed edge weight",
              "rank walk teleport damping node", "edge list sparse matrix graph"]
MALFORMED = [b"{not json", b"[]", b"null", b'{"terms": ["node"]}']
CACHE_SPEC = ("cache_peek:net_partition@1;cache_peek:net_hang@2:2000;"
              "cache_fill:net_partition@1+")


def check(ok: bool, detail=None) -> None:
    """A bar of the gate: raise ``AssertionError`` (with ``detail``) unless
    ``ok``.  A call, not an ``assert`` statement, so ``python -O`` keeps it."""
    if not ok:
        raise AssertionError("check failed" if detail is None else detail)


def trace_report():
    """The repository's stdlib trace reader, ``tools/trace_report.py``."""
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def env(**values: str):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def own_plans(fn):
    """Run ``fn(device)`` under its own fault plans alone, as the reference
    runs each scenario and smoke in a process of its own: the caller's
    ``GRAFT_CHAOS``, which an in-process run and every replica it spawns
    would read, is set aside for the call.  An env plan counts calls per
    process, so it would fault calls the reference's run never faults
    (a routed retry landing on the non-owner replica drives the peer
    cache's breaker, a fleet scrape is one attempt)."""
    @functools.wraps(fn)
    def run(device="cuda") -> dict:
        with env(GRAFT_CHAOS=""):
            return fn(device)
    return run


@contextlib.contextmanager
def fresh_health():
    """The device-health registry empty before and after the block: a
    scenario's acknowledged losses must not outlive it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import elastic

    elastic.reset_health()
    try:
        yield elastic
    finally:
        elastic.reset_health()


def slot_mesh(n: int, axis: str, device):
    """``n`` slots of ``device``: CPU slots through ``mesh_for``, or one
    card repeated."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
        make_mesh,
        mesh_for,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return make_mesh(axis=axis, devices=[dev] * n)
    return mesh_for(n, axis, device=dev)


def shrink_pairs(rep: dict) -> list:
    """A trace report's mesh shrinks as (site, slots before, slots after)."""
    return [(s["site"], s["devices_old"], s["devices_new"]) for s in rep["mesh_shrinks"]]


def corpus_chunks() -> list:
    """The reference scenarios' corpus: 12 chunks of 2 documents."""
    return [[f"tok{i} tok{i % 5} shared word extra{i % 3}"
             for i in range(j * 2, (j + 1) * 2)] for j in range(12)]


def _traced(name: str, body):
    """Run ``body()`` inside a traced run in a fresh directory; returns
    ``(body's value, the trace report)``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs

    d = tempfile.mkdtemp(prefix=f"{name}-")
    try:
        with obs.run(name, trace_dir=d):
            value = body()
        rep = trace_report().report(glob.glob(os.path.join(d, f"{name}.*.trace.jsonl"))[0])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return value, rep


def _close(a, b, what: str) -> float:
    err = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max(initial=0.0))
    check(err <= 1e-6, f"{what}: max abs {err} > 1e-6")
    return err


# ------------------------------------------------------------------ mesh

@own_plans
def device_lost(device="cuda") -> dict:
    """``tools/chaos.sh:36-106``: slot 1 of a 2-slot mesh dies; both sharded
    runners and ``owned`` finish through the mesh shrink."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        DATA_AXIS,
        NODES_AXIS,
        run_pagerank_sharded,
        run_tfidf_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        PageRankConfig,
        TfidfConfig,
    )

    t0 = time.perf_counter()
    g = synthetic_powerlaw(800, 3200, seed=5)
    chunks = corpus_chunks()
    cfg = PageRankConfig(iterations=10, **PR_KW)
    with fresh_health() as elastic:
        base_pr = run_pagerank(g, cfg, device=device)
        base_tf = run_tfidf_sharded(iter(chunks), TfidfConfig(vocab_bits=10),
                                    mesh=slot_mesh(MESH_SLOTS, DATA_AXIS, device))

        def body():
            errs = {}
            with chaos.inject("*:device_lost@dev:1"):
                res = run_pagerank_sharded(g, cfg, mesh=slot_mesh(MESH_SLOTS, NODES_AXIS, device))
                errs["pagerank"] = _close(res.ranks, base_pr.ranks, "sharded pagerank")
                elastic.reset_health()  # a fresh loss for the second runner
                tf = run_tfidf_sharded(iter(chunks), TfidfConfig(vocab_bits=10),
                                       mesh=slot_mesh(MESH_SLOTS, DATA_AXIS, device))
                errs["tfidf"] = _close(tf.to_dense(), base_tf.to_dense(), "sharded tfidf")
                # the owned strategy: the shrink re-owns the rank slices and
                # rebuilds the boundary sets for the surviving mesh
                elastic.reset_health()
                res_o = run_pagerank_sharded(g, cfg, strategy="owned",
                                             mesh=slot_mesh(MESH_SLOTS, NODES_AXIS, device))
                errs["owned"] = _close(res_o.ranks, base_pr.ranks, "owned pagerank")
            return errs

        errs, rep = _traced("chaos_device_lost", body)
    shrinks = shrink_pairs(rep)
    check(len(shrinks) == 3, shrinks)  # one a runner: pagerank, tfidf, owned
    check(all(s[1:] == (MESH_SLOTS, 1) for s in shrinks), shrinks)
    check(not rep["exhausted"], rep["exhausted"])
    return {"line": "device_lost scenario: OK — all three sharded runners survived via "
                    f"mesh-shrink ({[s[0] for s in shrinks]})",
            "seconds": time.perf_counter() - t0, "mesh_shrinks": shrinks,
            "exhausted": dict(rep["exhausted"]), "degraded": dict(rep["degraded"]),
            "max_abs_err": errs}


@own_plans
def fixpoint(device="cuda") -> dict:
    """``tools/chaos.sh:117-176``: the tolerance fixpoint (the while-loop
    branch of ``dataflow.fixpoint.iterate``) on the 2-slot mesh loses slot
    1; batched PPR loses device 0 at its delta sync and the salvage rung
    reruns it on the CPU."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        NODES_AXIS,
        run_pagerank_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    t0 = time.perf_counter()
    g = synthetic_powerlaw(800, 3200, seed=9)
    cfg = PageRankConfig(iterations=200, tol=1e-8, **PR_KW)
    ppr_cfg = PageRankConfig(iterations=30, **PR_KW)
    queries = [[int(g.node_ids[0])], [int(g.node_ids[10])]]
    with fresh_health() as elastic:
        base = run_pagerank_sharded(g, cfg, mesh=slot_mesh(MESH_SLOTS, NODES_AXIS, device))
        base_ppr = run_ppr_batch(g, ppr_cfg, queries, device=device)

        def body():
            errs = {}
            with chaos.inject("*:device_lost@dev:1"):
                res = run_pagerank_sharded(g, cfg, mesh=slot_mesh(MESH_SLOTS, NODES_AXIS, device))
            errs["pagerank"] = _close(res.ranks, base.ranks, "tolerance fixpoint")
            elastic.reset_health()
            with chaos.inject("ppr_delta_sync:device_lost@dev:0"):
                ppr = run_ppr_batch(g, ppr_cfg, queries, device=device)
            errs["ppr"] = _close(ppr.ranks, base_ppr.ranks, "batched ppr")
            return errs

        errs, rep = _traced("chaos_dataflow_fixpoint", body)
    shrinks = shrink_pairs(rep)
    check(len(shrinks) == 1 and shrinks[0][1:] == (MESH_SLOTS, 1), shrinks)
    # the inner guarded delta fetch exhausts by design (the outer segment
    # ladder owns recovery); anything else exhausting means the salvage failed
    check(set(rep["exhausted"]) <= {"ppr_delta_sync"}, rep["exhausted"])
    check(any(d == "ppr_step" for d in rep["degraded"]), rep["degraded"])
    return {"line": "dataflow fixpoint scenario: OK — sharded tol-fixpoint shrank 2->1 "
                    "and the batched-PPR fixpoint salvaged through the shared ladder",
            "seconds": time.perf_counter() - t0, "mesh_shrinks": shrinks,
            "exhausted": dict(rep["exhausted"]), "degraded": dict(rep["degraded"]),
            "max_abs_err": errs}


@own_plans
def ingest_h2d(device="cuda") -> dict:
    """``tools/chaos.sh:187-249``: a loss at the staged H2D put, on both
    ingest paths."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        run_tfidf_streaming,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        DATA_AXIS,
        run_tfidf_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig

    t0 = time.perf_counter()
    chunks = corpus_chunks()
    cfg = TfidfConfig(vocab_bits=10, prefetch=2, pipeline_depth=2)
    with fresh_health() as elastic:
        base_stream = run_tfidf_streaming(iter(chunks), cfg, device=device)
        base_shard = run_tfidf_sharded(iter(chunks), TfidfConfig(vocab_bits=10),
                                       mesh=slot_mesh(MESH_SLOTS, DATA_AXIS, device))

        def body():
            # single device: device 0 dies at the H2D put -> the cpu rung
            # rolls back and replays the retained chunks
            with chaos.inject("ingest_h2d_put:device_lost@dev:0"):
                res = run_tfidf_streaming(iter(chunks), cfg, device=device)
            check(res.to_dense().tobytes() == base_stream.to_dense().tobytes(),
                  "the replayed stream differs from the unbroken one")
            # 2 slots: slot 1 dies at the sharded put -> shrink 2->1, the
            # in-flight staged groups re-sliced from the retained corpora
            elastic.reset_health()
            with chaos.inject("ingest_h2d_put:device_lost@dev:1"):
                tf = run_tfidf_sharded(iter(chunks), TfidfConfig(vocab_bits=10),
                                       mesh=slot_mesh(MESH_SLOTS, DATA_AXIS, device))
            return _close(tf.to_dense(), base_shard.to_dense(), "sharded ingest")

        err, rep = _traced("chaos_ingest_h2d", body)
    shrinks = shrink_pairs(rep)
    check(len(shrinks) == 1 and shrinks[0][1:] == (MESH_SLOTS, 1), shrinks)
    check(shrinks[0][0] == "ingest_h2d_put", shrinks)
    check(rep["degraded"].get("ingest_h2d_put", 0) >= 2, rep["degraded"])
    check(not rep["exhausted"], rep["exhausted"])
    check(rep["ingest"] and all("h2d_overlap_frac" in r for r in rep["ingest"]), rep["ingest"])
    return {"line": "staged-ingest scenario: OK — single-chip rolled back+replayed on "
                    "the cpu rung, sharded shrank 2->1 re-slicing staged groups "
                    f"(ingest runs traced: {len(rep['ingest'])})",
            "seconds": time.perf_counter() - t0, "mesh_shrinks": shrinks,
            "exhausted": dict(rep["exhausted"]), "degraded": dict(rep["degraded"]),
            "ingest_runs": len(rep["ingest"]), "max_abs_err": {"sharded": err}}


# -------------------------------------------------------------- serving

@own_plans
def segment_swap(device="cuda") -> dict:
    """``tools/chaos.sh:259-351``: live traffic against a segmented server
    while delta segments commit and the merge compacts, under dispatch
    chaos and one merge fault; the abandoned-future audit finds every
    request served exactly once."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chaos-seg-")
    d = os.path.join(tmp, "idx")
    scfg = TfidfConfig(vocab_bits=10)
    docs = [f"doc{i} shared word tok{i % 7}" for i in range(12)]
    srv = None
    records: list = []
    try:
        with env(GRAFT_RETRY_MAX="4", GRAFT_BACKOFF_BASE_S="0.01"):
            out = run_tfidf(docs, scfg, device=device)
            ref = sgm.seal_segment(d, out, scfg, doc_base=0)
            sgm.commit_append(d, ref, scfg.config_hash())
            srv = serving.TfidfServer(
                sgm.load_segment_set(d),
                serving.ServeConfig(top_k=3, max_batch=4, scoring="impacted"),
                device=device,
            ).start()
            stop = threading.Event()

            def client(idx):
                rng = np.random.default_rng(idx)
                while not stop.is_set():
                    rec = {"ok": False, "abandoned": []}
                    records.append(rec)
                    for _ in range(50):
                        fut = None
                        try:
                            fut = srv.submit([f"tok{int(rng.integers(0, 7))}", "shared"])
                            fut.result(5.0)
                            rec["ok"] = True
                            break
                        except Exception:  # noqa: BLE001 — audited below
                            if fut is not None and not fut.done:
                                rec["abandoned"].append(fut)
                            time.sleep(0.01)
                    time.sleep(0.005)

            with chaos.inject("serve_dispatch:fail@%5;segment_merge:fail@1") as plan:
                threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                            name=f"chaos-client-{i}") for i in range(2)]
                for t in threads:
                    t.start()
                base = out.n_docs
                for i in range(3):
                    o = run_tfidf([f"swap{i} fresh shared"], scfg, device=device)
                    r = sgm.seal_segment(d, o, scfg, doc_base=base)
                    sgm.commit_append(d, r, scfg.config_hash())
                    base += o.n_docs
                    srv.refresh_segments(sgm.load_segment_set(d))
                    time.sleep(0.1)
                s, i2 = srv.query(["swap2"])
                check(float(s[0]) > 0 and int(i2[0]) == base - 1, (s, i2))
                merger = sgm.SegmentMerger(d, scfg, max_segments=1, device=device)
                while merger.merge_once():
                    pass
                srv.refresh_segments(sgm.load_segment_set(d))
                s, i3 = srv.query(["swap2"])
                check(int(i3[0]) == int(i2[0]), (i2, i3))
                stop.set()
                for t in threads:
                    t.join(timeout=10.0)
                merges = plan.call_count("segment_merge")
                check(merges >= 2, merges)  # the injected fault and its retry
            time.sleep(0.2)
            segments = len(sgm.latest_manifest(d).segments)
    finally:
        if srv is not None:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    finished = [r for r in records if r["ok"] or len(r["abandoned"]) >= 1]
    dropped = double = 0
    for r in finished:
        served = int(r["ok"]) + sum(1 for f in r["abandoned"] if f.done and f.error is None)
        dropped += served == 0
        double += max(served - 1, 0)
    check(dropped == 0 and double == 0, (dropped, double))
    check(segments == 1, segments)
    return {"line": "segment hot-swap scenario: OK — "
                    f"{len(finished)} requests audited across 4 hot swaps + merge, "
                    "dropped=0 double_served=0, merge fault retried",
            "seconds": time.perf_counter() - t0, "requests": len(finished),
            "audit": {"dropped": dropped, "double_served": double},
            "merge_calls": merges, "segments": segments}


@own_plans
def crash_append(device="cuda") -> dict:
    """``tools/chaos.sh:362-387``: SIGKILL a committing child at every write
    boundary of seal + ``commit_append``; each kill reloads to the pre-kill
    or the committed generation, never a torn set, with no orphan after
    the recovery GC.  The harness is a filesystem protocol whose workers
    touch no device, so ``device`` is not used."""
    del device
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tools.crash_harness", "--scenarios", "append",
         "--json"], cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"crash harness failed: {proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout)["append"]
    check(rep["boundaries"] >= 4, rep)  # seal (2 renames) + commit (2 renames)
    check(len(rep["kills"]) == rep["boundaries"], rep)
    # every pre-flip kill serves the pre-kill generation byte-identically
    check(rep["served_pre"] >= 1
          and rep["served_pre"] + rep["served_post"] == rep["boundaries"], rep)
    return {"line": "crash-recovery scenario: OK — "
                    f"{rep['boundaries']} SIGKILL point(s) through commit_append, "
                    f"{rep['served_pre']} served the pre-kill generation / "
                    f"{rep['served_post']} the committed one, 0 torn, 0 orphans "
                    "after recovery GC",
            "seconds": time.perf_counter() - t0,
            **{k: rep[k] for k in ("boundaries", "served_pre", "served_post")},
            "kills": len(rep["kills"])}


def fleet_index(prefix: str, device) -> str:
    """The fleet scenarios' index: the four documents sealed as one
    segment with unit ranks and BM25, committed; the caller removes it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        Bm25Config,
        TfidfConfig,
    )

    scfg = TfidfConfig(vocab_bits=10)
    tmp = tempfile.mkdtemp(prefix=prefix)
    out = run_tfidf(FLEET_DOCS, scfg, device=device)
    ref = sgm.seal_segment(tmp, out, scfg, doc_base=0,
                           ranks=np.ones(out.n_docs, np.float32), bm25=Bm25Config())
    sgm.commit_append(tmp, ref, scfg.config_hash())
    return tmp


def fleet_device(device) -> str:
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device

    return str(resolve_device(device))


def check_audit(audit: dict) -> dict:
    """The fleet scenarios' audit bar; returns the audited keys."""
    for key in ("dropped", "double_served", "roll_retries"):
        check(audit[key] == 0, audit)
    return {k: audit[k] for k in ("requests", "delivered", "dropped", "double_served",
                                  "roll_retries", "failed")}


def post_raw(port: int, body: bytes):
    """A raw POST /query; ``None`` where the port is dead (a SIGKILLed
    replica mid-respawn: that is the chaos, not a protocol violation).  A
    live port answers a typed status within the timeout."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/query", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5.0) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code
    except urllib.error.URLError:
        return None


@own_plans
def malformed(device="cuda") -> dict:
    """``tools/chaos.sh:398-492``: the protocol harness's matrix, then
    malformed bodies at a live 2-replica fleet whose router link is
    partitioned every 2nd hop and whose replica 1 SIGKILLs itself at its
    third query: typed 400s, never a 500 or a hang; then the
    ``replica_swap:proc_kill@1`` kill seam."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import protocol_harness

    t0 = time.perf_counter()
    dev = fleet_device(device)
    harness = protocol_harness.run_harness(timeout_s=5.0, device=dev)
    check("fatal" not in harness and harness["ok"], harness.get("fatal") or harness["violations"])
    tmp = fleet_index("chaos-proto-", device)
    typed = 0
    try:
        fab = fabric.ServingFabric(tmp, fabric.FabricConfig(
            replicas=2, poll_s=0.1, health_period_s=0.2, retry_limit=100,
            retry_pause_s=0.1, request_timeout_s=10.0, grace_s=10.0, device=dev,
            replica_chaos=((1, "replica_query:proc_kill@3"),),
        ))
        with fab:
            with chaos.inject("fabric_route:net_partition@2"):
                for i in range(10):
                    scores, _ = fab.query(["node"])
                    check(len(scores) > 0)
                    port = fab._ports[i % len(fab._ports)]
                    code = post_raw(port, MALFORMED[i % len(MALFORMED)])
                    check(code in (400, None), f"malformed message answered {code}, want 400")
                    typed += code == 400
            check(typed >= 4, typed)
            audit = check_audit(fab.audit())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the hot-swap kill seam: the process dies at its first swap call
    probe = subprocess.run(
        [sys.executable, "-c",
         f"from {PKG}.resilience import chaos\n"
         "ctx = chaos.inject('replica_swap:proc_kill@1'); ctx.__enter__()\n"
         "chaos.on_call('replica_swap')\n"],
        cwd=REPO, timeout=60)
    check(probe.returncode == -9, probe.returncode)
    return {"line": "malformed-message fabric scenario: OK — typed 400s under "
                    "fabric_route:net_partition@2 + replica_query:proc_kill@3, "
                    "replica_swap:proc_kill@1 kill seam verified, "
                    "dropped=0 double_served=0",
            "seconds": time.perf_counter() - t0, "typed_rejections": typed,
            "harness_probes": harness["probes"], "audit": audit,
            "kill_seam_rc": probe.returncode}


@own_plans
def fed_scrape(device="cuda") -> dict:
    """``tools/chaos.sh:502-596``: the fleet board degrades to staleness,
    never to routing impact, while every scrape is severed and then hung."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

    t0 = time.perf_counter()
    tmp = fleet_index("chaos-scrape-", device)
    try:
        # stale after 3 missed scrapes: 0.6 s
        with env(GRAFT_FED_SCRAPE_S="0.2"):
            fab = fabric.ServingFabric(tmp, fabric.FabricConfig(
                replicas=2, poll_s=0.1, health_period_s=0.2, retry_limit=100,
                retry_pause_s=0.1, grace_s=10.0, device=fleet_device(device),
            ))
            with fab:
                for _ in range(6):
                    scores, _ = fab.query(["node"])
                    check(len(scores) > 0)
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    snap = fab.fleet.snapshot()
                    if (snap["counters"].get("serve.requests", {}).get("total", 0) >= 1
                            and not snap["fleet"]["stale"]):
                        break
                    time.sleep(0.2)
                check(len(snap["fleet"]["replicas"]) == 2, snap["fleet"])
                check(not snap["fleet"]["stale"], snap["fleet"])
                base_total = snap["counters"]["serve.requests"]["total"]
                check(base_total >= 1, snap["counters"])
                # every scrape severed: routing must not notice; the board
                # labels (never drops) the replicas and keeps their last state
                with chaos.inject("fed_scrape:net_partition@1+"):
                    for _ in range(10):
                        scores, _ = fab.query(["graph"])
                        check(len(scores) > 0)
                    time.sleep(1.0)  # > stale_after_s (0.6): three missed scrapes
                    snap2 = fab.fleet.snapshot()
                    check(snap2["fleet"]["replicas"] == snap["fleet"]["replicas"], snap2["fleet"])
                    check(len(snap2["fleet"]["stale"]) == 2, snap2["fleet"])
                    check(snap2["fleet"]["per_replica"]["0"]["stale"], snap2["fleet"])
                    kept = snap2["counters"]["serve.requests"]["total"]
                    check(kept >= base_total, (kept, base_total))
                check(snap2["fleet"]["scrape_errors"] >= 2, snap2["fleet"])
                # the partition lifted: the scraper recovers the board
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    if not fab.fleet.snapshot()["fleet"]["stale"]:
                        break
                    time.sleep(0.2)
                check(not fab.fleet.snapshot()["fleet"]["stale"])
                # hung scrapes stall the scraper thread, not the query path
                with chaos.inject("fed_scrape:net_hang@1+:400"):
                    for _ in range(10):
                        scores, _ = fab.query(["rank"])
                        check(len(scores) > 0)
                audit = fab.audit()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    audited = check_audit(audit)
    check(audit["requests"] == 26 and audit["delivered"] == 26, audit)
    return {"line": "scrape-chaos scenario: OK — 26/26 delivered under "
                    "fed_scrape:net_partition@1+ + net_hang@1+:400, both replicas "
                    "labeled stale (never dropped), aggregate kept last-known state, "
                    "fleet recovered to fresh, dropped=0 double_served=0",
            "seconds": time.perf_counter() - t0, "audit": audited,
            "stale": list(snap2["fleet"]["stale"]),
            "scrape_errors": snap2["fleet"]["scrape_errors"]}


def _post_json(port: int, path: str, doc: dict, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(doc).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _status(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=5.0) as resp:
        return json.loads(resp.read())


@own_plans
def cache_peer(device="cuda") -> dict:
    """``tools/chaos.sh:609-729``: the sharded result cache degrades to
    local compute, never to blocking or wrong bytes.  Replica 1 boots with
    ``cache_peek`` partition and hang and ``cache_fill`` partition in its
    own environment; its breaker trips at 2 consecutive failures, the
    half-open probe eats the 2 s hang within the 0.4 s peek deadline, and
    the next probe recloses it with a real peer hit."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

    t0 = time.perf_counter()
    tmp = fleet_index("chaos-cache-", device)
    # single-word keys the cache ring routes to replica 0 (the owner):
    # driving them at replica 1 exercises the non-owner peek
    ring = fabric._Ring([0, 1], 64)
    owned = [[w] for w in (f"k{i}" for i in range(200))
             if ring.route(fabric.affinity_key([w], "tfidf"))[0] == 0]
    check(len(owned) >= 4, len(owned))
    k_hot, k_open, k_hang, k_heal = owned[:4]
    secs = {}
    try:
        with env(GRAFT_CACHE_BREAKER_TRIP="2", GRAFT_CACHE_BREAKER_PROBE_S="1.0",
                 GRAFT_CACHE_PEEK_DEADLINE_S="0.4"):
            fab = fabric.ServingFabric(tmp, fabric.FabricConfig(
                replicas=2, poll_s=0.1, health_period_s=0.2, retry_limit=100,
                retry_pause_s=0.1, grace_s=10.0, federation=False,
                device=fleet_device(device), replica_chaos=((1, CACHE_SPEC),),
            ))
            with fab:
                p1 = fab._ports[1]
                ref_scores, _ = fab.query(k_hot)  # affinity warms the owner
                # peek 1 partitions; the consecutive fill failure trips the breaker
                t1 = time.perf_counter()
                r1 = _post_json(p1, "/query", {"rid": "cc-1", "terms": k_hot,
                                               "ranker": "tfidf"})
                secs["partitioned_peek"] = time.perf_counter() - t1
                check(secs["partitioned_peek"] < 2.0, secs)  # the deadline + compute
                check(r1["scores"] == [float(s) for s in ref_scores], r1)
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline and _status(p1)["breaker_open"] == 0:
                    time.sleep(0.05)  # the tripping fill is asynchronous
                st = _status(p1)
                check(st["breaker_open"] == 1 and st["peek_timeouts"] >= 1, st)
                # breaker open: no peer I/O, fast local compute; the routed
                # path keeps serving correct bytes mid-partition
                t1 = time.perf_counter()
                _post_json(p1, "/query", {"rid": "cc-2", "terms": k_open, "ranker": "tfidf"})
                secs["open_breaker"] = time.perf_counter() - t1
                check(secs["open_breaker"] < 1.0, secs)
                for _ in range(5):
                    scores, _ = fab.query(k_hot)
                    check([float(s) for s in scores] == [float(s) for s in ref_scores])
                # half-open probe 1 eats the 2 s hang but blocks only for the
                # 0.4 s peek deadline before local compute (re-opens)
                time.sleep(1.2)
                t1 = time.perf_counter()
                _post_json(p1, "/query", {"rid": "cc-3", "terms": k_hang, "ranker": "tfidf"})
                secs["hung_probe"] = time.perf_counter() - t1
                check(secs["hung_probe"] < 1.5, secs)  # not the 2 s hang
                st = _status(p1)
                check(st["breaker_open"] == 1 and st["peek_timeouts"] >= 2, st)
                # half-open probe 2 is clean: warms through the owner, recloses
                time.sleep(1.2)
                fab.query(k_heal)
                _post_json(p1, "/query", {"rid": "cc-4", "terms": k_heal, "ranker": "tfidf"})
                st = _status(p1)
                check(st["breaker_open"] == 0 and st["peer_hits"] >= 1, st)
                audit = fab.audit()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    audited = check_audit(audit)
    check(audit["failed"] == 0, audit)
    return {"line": "cache-partition scenario: OK — non-owner served correct bytes "
                    "under cache_peek:net_partition/net_hang + cache_fill:net_partition, "
                    "blocking bounded by the 0.4s peek deadline (2s hang absorbed), "
                    "breaker tripped at 2 consecutive failures, half-open probe "
                    "reclosed it with a real peer hit, dropped=0 double_served=0",
            "seconds": time.perf_counter() - t0, "audit": audited,
            "blocking_s": {k: round(v, 4) for k, v in secs.items()},
            "peek_timeouts": st["peek_timeouts"], "peer_hits": st["peer_hits"]}


SCENARIOS = {
    "device_lost": device_lost,
    "fixpoint": fixpoint,
    "ingest_h2d": ingest_h2d,
    "segment_swap": segment_swap,
    "crash_append": crash_append,
    "malformed": malformed,
    "fed_scrape": fed_scrape,
    "cache_peer": cache_peer,
}


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="chaos_scenarios",
        description="run the chaos gate's scenarios on the port; one OK line each")
    ap.add_argument("names", nargs="*",
                    help=f"scenarios to run, of {', '.join(SCENARIOS)} (default: all, "
                         "in order)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="the torch device of the runs and the replicas (default cuda; "
                         "cpu runs them on the host)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(SCENARIOS))
    if unknown:
        ap.error(f"unknown scenarios {unknown}")
    failed = []
    for name in args.names or list(SCENARIOS):
        try:
            rep = SCENARIOS[name](args.device)
        except Exception as exc:  # noqa: BLE001 — reported, then the exit code
            failed.append(name)
            print(f"FAIL {name}: {type(exc).__name__}: {exc}", flush=True)
            continue
        print(f"OK {name} ({rep['seconds']:.1f} s): {rep['line']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
