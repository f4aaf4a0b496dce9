"""The CI gate's smokes, on the port: the smokes of the JAX package's
``tools/ci.sh`` that the port's ``tools/lint.sh`` does not already run,
each as one function taking ``device`` and held to the reference's budget
knob.

==============  ==================================================  =========================
smoke           what it holds                                       budget knob (default)
==============  ==================================================  =========================
``autotune``    ``tools/autotune.py --dry-run --json`` prunes       ``GRAFT_TUNE_BUDGET_S``
                >= 30% of the grid statically, every group keeps    (60 s)
                a survivor; the committed ``tuned_profile_gpu.json``
                loads and round-trips (``tools/ci.sh:48-97``)
``crash``       the crash harness's SIGKILL at 3 ``commit_append``  none
                boundaries (``:167-173``)
``drain``       a 1-replica fleet rolled by socket handoff with     ``GRAFT_DRAIN_BUDGET_S``
                SIGKILL pre-drain, mid-drain and post-roll: one     (40 s)
                listener each time, nothing dropped (``:228-412``)
``traced``      a traced streaming run of ``cli.tfidf`` read by     none
                ``tools/trace_report.py`` (``:448-487``)
``soak``        ``serving.soak.run_soak`` under ``*:fail@%5``       ``GRAFT_SOAK_DURATION_S``
                with one device loss: an SLO record, a recovery     (20 s), ``GRAFT_SOAK_QPS``
                time, nothing dropped (``:489-520``)                (15)
``fabric``      an N-replica fleet, one replica SIGKILLed and       ``GRAFT_FABRIC_BUDGET_S``
                respawned, the trace's fabric section               (25 s); N from
                (``:522-603``)                                      ``GRAFT_FABRIC_REPLICAS``
``federation``  one scrape, the router's merged board, one forced   ``GRAFT_FED_BUDGET_S``
                scale-up, the autoscale timeline (``:605-696``)     (25 s)
``segment``     seal, serve, a post-start commit hot-swapped, the   ``GRAFT_SEG_BUDGET_S``
                merge, under ``*:fail@%5`` (``:698-761``)           (15 s)
``owned``       the owned strategy on 4 slots, float64 within 1e-9  ``GRAFT_OWNED_BUDGET_S``
                of one device under ``*:fail@%5`` (``:763-811``)    (30 s)
==============  ==================================================  =========================

``bench.py`` has no port yet, so the soak calls ``run_soak`` directly
with the reference's knobs (its ``bench.py --soak`` child does the same in
the JAX package).  Left out: the trace-diff gate (``tools/ci.sh:414-446``),
which diffs the committed TPU ``BENCH_r*.json`` rounds; it belongs with
the port's benchmark (ROADMAP Queue 1, item 14's note).  The lint tiers,
their smokes and the protocol harness are ``tools/lint.sh``.

Each smoke runs under the reference's plan alone (``own_plans``): the
soak, segment and owned smokes under ``*:fail@%5``, the others under none,
whatever ``GRAFT_CHAOS`` the caller holds.  Each function returns a report
with ``line`` (the reference's ``OK`` line), ``seconds`` and ``budget_s``,
and raises when a bar or its budget does not hold.  The CLI runs them, from the repository root::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.ci_smokes \\
        [--device cpu|cuda] [names...]

and prints one ``OK`` line a smoke; it exits 0 when every named smoke (all
by default) held, 1 otherwise.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.chaos_scenarios import (
    FLEET_DOCS,
    PKG,
    REPO,
    check,
    env,
    fleet_device,
    own_plans,
    slot_mesh,
    trace_report,
)

SMOKE_DOCS = [f"alpha beta doc{i} shared word graph node" for i in range(8)]
TRACED_CORPUS = ("alpha beta gamma\nbeta gamma delta\nepsilon zeta alpha\n"
                 "gamma gamma beta\nalpha delta epsilon\nzeta zeta beta\n")


def within(name: str, t0: float, knob: str | None, default: float | None) -> tuple:
    """``(seconds since t0, the budget)``: the budget is ``knob``'s value in
    the environment, else ``default`` (``None``: no budget); raises past it."""
    secs = time.perf_counter() - t0
    limit = float(os.environ.get(knob) or default) if knob else None
    if limit is not None and secs > limit:
        raise AssertionError(f"{name} smoke exceeded its {limit:g}s budget ({secs:.1f}s)")
    return secs, limit


def root_tool(name: str):
    """A stdlib-only root tool (``tools/<name>.py``) as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_index(d: str, device, docs=SMOKE_DOCS, vocab_bits: int = 9) -> None:
    """``docs`` sealed as one segment with unit ranks and BM25, committed."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        Bm25Config,
        TfidfConfig,
    )

    scfg = TfidfConfig(vocab_bits=vocab_bits)
    out = run_tfidf(docs, scfg, device=device)
    ref = sgm.seal_segment(d, out, scfg, doc_base=0, ranks=np.ones(out.n_docs, np.float32),
                           bm25=Bm25Config())
    sgm.commit_append(d, ref, scfg.config_hash())


@own_plans
def autotune(device="cpu") -> dict:
    """``tools/ci.sh:48-97``: the cost model that prunes the tuner's grid
    discards at least 30% of it before anything is measured, no group is
    pruned to zero, and the committed gpu profile parses and round-trips
    through the loader the runners resolve knobs from.  The dry run
    measures nothing, so ``device`` is not used."""
    del device
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.tools.autotune", "--dry-run", "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"autotune --dry-run: {proc.stderr[-2000:]}")
    plan = json.loads(proc.stdout)["plan"]
    frac = plan["prune_frac"]
    check(frac >= 0.30, f"static pruning discarded only {frac:.1%} of the raw grid")
    check(plan["raw_points"] == plan["pruned_points"] + plan["survivor_points"], plan)
    for g, gp in plan["groups"].items():
        check(gp["survivors"], f"group {g!r} pruned to zero survivors")
    prof = config.load_tuned_profile(backend="gpu")
    check(prof is not None, "committed tuned_profile_gpu.json did not load")
    check(prof.backend == "gpu" and prof.source == "committed", (prof.backend, prof.source))
    check(set(prof.knobs) == set(config.TUNABLE_DEFAULTS),
          sorted(set(config.TUNABLE_DEFAULTS) ^ set(prof.knobs)))
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "tuned_profile_gpu.json")
        config.write_tuned_profile(p, "gpu", prof.knobs, measured={"smoke": True})
        back = config.load_tuned_profile(backend="gpu", path=p)
        check(back.knobs == prof.knobs, "loader round-trip changed the knobs")
    secs, limit = within("autotune", t0, "GRAFT_TUNE_BUDGET_S", 60)
    return {"line": f"autotune smoke: OK ({plan['pruned_points']}/{plan['raw_points']} "
                    f"points pruned statically = {frac:.1%}, committed gpu profile "
                    f"round-trips {len(prof.knobs)} knobs)",
            "seconds": secs, "budget_s": limit, "prune_frac": frac,
            "raw_points": plan["raw_points"], "knobs": len(prof.knobs)}


@own_plans
def crash(device="cpu") -> dict:
    """``tools/ci.sh:167-173``: SIGKILL at 3 of ``commit_append``'s write
    boundaries; each reloads a consistent generation with no orphan.  The
    harness's workers touch no device."""
    del device
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.tools.crash_harness", "--scenarios",
                           "append", "--max-kills", "3", "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"crash harness: {proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout)["append"]
    check(len(rep["kills"]) == 3, rep)
    secs, limit = within("crash", t0, None, None)
    return {"line": f"crash-harness smoke: OK ({len(rep['kills'])} of {rep['boundaries']} "
                    "commit_append boundaries killed, every reload consistent)",
            "seconds": secs, "budget_s": limit, "kills": len(rep["kills"]),
            "boundaries": rep["boundaries"]}


@own_plans
def drain(device="cpu") -> dict:
    """``tools/ci.sh:228-412``: a 1-replica fleet rolls by socket handoff
    while SIGKILL lands on the predecessor before its drain, on it right
    after the swap, and on the healthy successor; after each exactly one
    process serves the pinned port and the closed-loop audit stays
    clean."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.export import (
        reuse_port_supported,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

    t0 = time.perf_counter()
    if not reuse_port_supported():
        secs, limit = within("drain", t0, "GRAFT_DRAIN_BUDGET_S", 40)
        return {"line": "drain kill-matrix: SKIP (platform lacks SO_REUSEPORT)",
                "seconds": secs, "budget_s": limit, "skipped": True}
    tmp = tempfile.mkdtemp(prefix="drain-matrix-")
    try:
        smoke_index(tmp, device, docs=FLEET_DOCS, vocab_bits=10)
        fab = fabric.ServingFabric(tmp, fabric.FabricConfig(
            replicas=1, poll_s=0.1, health_period_s=0.2, retry_limit=200,
            retry_pause_s=0.1, grace_s=10.0, federation=False, device=fleet_device(device),
        ))

        def kill(pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass  # already exited: the point degenerates upward

        def status():
            with urllib.request.urlopen(f"http://127.0.0.1:{fab._ports[0]}/status",
                                        timeout=2.0) as resp:
                return json.loads(resp.read())

        def settle(not_pid=None, timeout=30.0):
            """The pid of the one live, ready serving process."""
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                h = fab._handles.get(0)
                if h is not None and h.alive() and (not_pid is None or h.pid != not_pid):
                    try:
                        if status()["ready"]:
                            return h.pid
                    except OSError:
                        pass
                time.sleep(0.1)
            raise AssertionError("no healthy replica settled in time")

        def poll_pids(n=15):
            pids = set()
            for _ in range(n):
                pids.add(status()["pid"])
                time.sleep(0.02)
            return pids

        def roll_with_kill(trigger):
            """Roll on a thread; ``trigger(old_pid)`` decides when to SIGKILL."""
            old_pid = fab._handles[0].pid
            errs = []

            def run():
                try:
                    fab.rolling_restart(timeout=60.0)
                except Exception as exc:  # noqa: BLE001 — surfaced below
                    errs.append(exc)

            t = threading.Thread(target=run, name="ci-roll")
            t.start()
            trigger(old_pid)
            t.join(90.0)
            check(not t.is_alive(), "roll wedged")
            check(not errs, errs)
            return old_pid

        def mid_drain(pid):
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                h = fab._handles.get(0)
                if h is not None and h.pid != pid:
                    break
                time.sleep(0.01)
            kill(pid)

        with fab:
            stop = threading.Event()
            failures = []

            def load():
                while not stop.is_set():
                    try:
                        fab.query(["node", "graph"])
                    except Exception as exc:  # noqa: BLE001 — audited below
                        failures.append(exc)

            loader = threading.Thread(target=load, daemon=True, name="ci-load")
            loader.start()
            try:
                # (a) pre-drain: the predecessor dies while its successor spawns
                old = roll_with_kill(kill)
                pid = settle(not_pid=old)
                check(poll_pids() == {pid}, "more than one listener serving")
                # (b) mid-drain: SIGKILL the predecessor right after the swap
                old = roll_with_kill(mid_drain)
                pid = settle(not_pid=old)
                check(poll_pids() == {pid}, "more than one listener serving")
                # (c) the freshly rolled replica dies: the supervisor's path
                old = roll_with_kill(lambda _pid: None)
                pid = settle(not_pid=old)
                kill(pid)
                pid2 = settle(not_pid=pid)
                check(poll_pids() == {pid2}, "more than one listener serving")
            finally:
                stop.set()
                loader.join(10.0)
            audit = fab.audit()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not failures, failures[:3])
    check(audit["dropped"] == 0 and audit["double_served"] == 0, audit)
    check(audit["rolled"] == 3, audit)
    secs, limit = within("drain", t0, "GRAFT_DRAIN_BUDGET_S", 40)
    return {"line": "drain kill-matrix: OK — SIGKILL pre-drain / mid-drain / "
                    "post-successor left exactly one listener each time "
                    f"({audit['requests']} closed-loop requests, dropped=0 double_served=0)",
            "seconds": secs, "budget_s": limit,
            "audit": {k: audit[k] for k in ("requests", "dropped", "double_served", "rolled",
                                            "roll_retries")}}


@own_plans
def traced(device="cpu") -> dict:
    """``tools/ci.sh:448-487``: a traced 6-document streaming run of the
    port's ``cli.tfidf`` in 3 chunks leaves a trace and a manifest that
    ``tools/trace_report.py`` turns into a per-phase breakdown, a complete
    chunk timeline and the ingest accounting.  ``GRAFT_TUNED_PROFILE=off``:
    the committed profile's packing would merge the 3 chunks."""
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="ci-traced-")
    try:
        corpus = os.path.join(d, "corpus.txt")
        with open(corpus, "w") as f:
            f.write(TRACED_CORPUS)
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli.tfidf", corpus, "--lines", "--streaming",
             "--chunk-docs", "2", "--vocab-bits", "8", "--prefetch", "0",
             "--device", fleet_device(device)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "GRAFT_TRACE_DIR": d, "GRAFT_TUNED_PROFILE": "off"})
        check(proc.returncode == 0, f"traced tfidf CLI run: {proc.stderr[-3000:]}")
        trace = [f for f in os.listdir(d) if f.startswith("tfidf.") and
                 f.endswith(".trace.jsonl")]
        check(len(trace) == 1, trace)
        rep = trace_report().report(os.path.join(d, trace[0]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(rep["complete"], f"traced run did not finish: {rep}")
    check("tfidf.stream" in rep["breakdown"], rep["breakdown"])
    check(len(rep["chunks"]) == 3 and all(c["complete"] for c in rep["chunks"]), rep["chunks"])
    check(rep["manifest"] and rep["manifest"]["status"] == "ok", rep["manifest"])
    check(rep.get("ingest") and all("h2d_overlap_frac" in r for r in rep["ingest"]),
          rep.get("ingest"))
    secs, limit = within("traced", t0, None, None)
    return {"line": f"traced-run smoke: OK ({rep['events']} events, {len(rep['chunks'])} "
                    f"chunks, wall {rep['wall_secs']:.3f}s, "
                    f"h2d_overlap {rep['ingest'][-1]['h2d_overlap_frac']})",
            "seconds": secs, "budget_s": limit, "chunks": len(rep["chunks"]),
            "backend": rep["manifest"].get("backend")}


@own_plans
def soak(device="cpu") -> dict:
    """``tools/ci.sh:489-520``: a bounded soak (streaming ingest, index
    rebuilds and hot swaps, mixed closed-loop traffic, one injected device
    loss) under ``*:fail@%5``: an SLO record with a served p99 and a time
    to recover, nothing dropped or served twice, ingest ran."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.soak import (
        SoakConfig,
        run_soak,
    )

    t0 = time.perf_counter()
    with env(GRAFT_CHAOS="*:fail@%5",
             GRAFT_SOAK_DURATION_S=os.environ.get("GRAFT_SOAK_DURATION_S") or "20",
             GRAFT_SOAK_QPS=os.environ.get("GRAFT_SOAK_QPS") or "15"):
        with obs.run("soak"):
            rec = run_soak(SoakConfig.from_env(device=fleet_device(device)))
    check(rec.get("served_p99_ms") is not None, f"null p99: {rec}")
    recov = rec.get("recovery") or {}
    check(recov.get("losses_injected", 0) >= 1, f"no loss injected: {recov}")
    check(recov.get("time_to_recover_s") is not None, f"no recovery time: {recov}")
    check(rec.get("dropped") == 0, f"dropped requests: {rec['dropped']}")
    check(rec.get("double_served") == 0, f"double-served: {rec['double_served']}")
    check((rec.get("ingest") or {}).get("chunks", 0) > 0, "no ingest ran")
    secs, limit = within("soak", t0, None, None)
    return {"line": f"soak smoke: OK ({rec['requests']} req at {rec['qps']} qps, "
                    f"p99 {rec['served_p99_ms']}ms, recovered in "
                    f"{recov['time_to_recover_s']}s, {rec['ingest']['rebuilds']} rebuild(s))",
            "seconds": secs, "budget_s": limit, "keys": sorted(rec),
            "dropped": rec["dropped"], "double_served": rec["double_served"],
            "time_to_recover_s": recov["time_to_recover_s"]}


@own_plans
def fabric_smoke(device="cpu") -> dict:
    """``tools/ci.sh:522-603``: an N-replica fleet mmap-loads one sealed
    segment, replica 0 is SIGKILLed mid-traffic, the router's sibling
    retry and the supervisor's respawn deliver every request once, and the
    trace parses into ``tools/trace_report.py``'s fabric section."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

    t0 = time.perf_counter()
    n = int(os.environ.get("GRAFT_FABRIC_REPLICAS") or 2)
    tmp = tempfile.mkdtemp(prefix="ci-fabric-")
    try:
        d = os.path.join(tmp, "fabidx")
        smoke_index(d, device)
        with obs.run("fabric_smoke", trace_dir=os.path.join(tmp, "fabtrace")) as r:
            cfg = fabric.FabricConfig(replicas=n, poll_s=0.1, health_period_s=0.2,
                                      retry_limit=100, retry_pause_s=0.1, grace_s=10.0,
                                      device=fleet_device(device))
            with fabric.ServingFabric(d, cfg) as fab:
                for _ in range(5):
                    fab.query(["alpha", "beta"])
                fab.kill_replica(0)  # hard SIGKILL mid-traffic
                for _ in range(10):
                    fab.query(["shared", "word"])
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    if (fab.audit()["respawns"] >= 1
                            and all(s is not None and s.get("ready") for s in fab.statuses())):
                        break
                    time.sleep(0.2)
                audit = fab.audit()
        fb = trace_report().report(r.trace_path)["fabric"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(audit["respawns"] >= 1, audit)
    check(audit["dropped"] == 0 and audit["double_served"] == 0, audit)
    check(fb is not None and fb["replicas"] == n, fb)
    check(fb["kills"] >= 1 and len(fb["respawns"]) >= 1, fb)
    check(fb["totals"]["dropped"] == 0 and fb["totals"]["double_served"] == 0, fb)
    secs, limit = within("fabric", t0, "GRAFT_FABRIC_BUDGET_S", 25)
    return {"line": f"fabric smoke: OK — N={n} fleet survived a SIGKILL "
                    f"({audit['requests']} req, {audit['retries']} sibling retries, "
                    f"{len(fb['respawns'])} respawn(s), dropped=0, double_served=0)",
            "seconds": secs, "budget_s": limit,
            "audit": {k: audit[k] for k in ("requests", "dropped", "double_served",
                                            "respawns", "roll_retries")}}


@own_plans
def federation(device="cpu") -> dict:
    """``tools/ci.sh:605-696``: a 1-replica fleet with the router's
    ``FleetHub``: one scrape, the router's own ``/snapshot.json`` merges
    the counters exactly, one forced scale-up through the autoscaler's
    spawn path, and the trace renders the autoscale timeline."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ci-fed-")
    try:
        d = os.path.join(tmp, "fedidx")
        smoke_index(d, device)
        with obs.run("fed_smoke", trace_dir=os.path.join(tmp, "fedtrace")) as r:
            cfg = fabric.FabricConfig(replicas=1, poll_s=0.1, health_period_s=0.2,
                                      retry_limit=100, retry_pause_s=0.1, grace_s=10.0,
                                      latency_slo_s=0.5, availability_target=0.999,
                                      device=fleet_device(device))
            with fabric.ServingFabric(d, cfg) as fab:
                for _ in range(8):
                    fab.query(["alpha", "beta"])
                fab.fleet.scrape_once()
                with urllib.request.urlopen(fab.fleet_url + "/snapshot.json",
                                            timeout=5) as resp:
                    snap = json.loads(resp.read())
                check(snap["fleet"]["replicas"], snap["fleet"])
                total = snap["counters"]["serve.requests"]["total"]
                check(total >= 8, snap["counters"])
                scaler = fabric.Autoscaler(fab, fabric.AutoscaleConfig(
                    min_replicas=1, max_replicas=2, cooldown_s=0.0))
                action = scaler.tick({"budgets": {"availability": {"burn_rate": 10.0}}})
                check(action == "up", action)
                check(len(fab.replica_ids()) == 2, fab.replica_ids())
                for _ in range(4):
                    fab.query(["shared", "word"])
                audit = fab.audit()
        a = trace_report().report(r.trace_path)["autoscale"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(audit["dropped"] == 0 and audit["double_served"] == 0, audit)
    check(audit["scale_ups"] >= 1, audit)
    check(a is not None and a["ups"] >= 1 and a["actions"] >= 1, a)
    board = root_tool("slo_watch").render_fleet(snap)
    check("fleet:" in board, board)
    secs, limit = within("federation", t0, "GRAFT_FED_BUDGET_S", 25)
    return {"line": f"federation smoke: OK — scraped {len(snap['fleet']['replicas'])} "
                    f"replica(s), merged {int(total)} requests exactly, forced scale-up to "
                    f"{audit['scale_ups'] + 1} replicas, autoscale timeline rendered "
                    f"({a['actions']} action(s))",
            "seconds": secs, "budget_s": limit, "merged_requests": int(total),
            "audit": {k: audit[k] for k in ("requests", "dropped", "double_served",
                                            "scale_ups")}}


@own_plans
def segment(device="cpu") -> dict:
    """``tools/ci.sh:698-761``: seal a streamed segment, serve it by
    impacted scoring, commit a second one after the server started and
    hot-swap it, merge the set to one segment, all under ``*:fail@%5``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        run_tfidf_streaming,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ci-seg-")
    srv = None
    try:
        with env(GRAFT_RETRY_MAX="4", GRAFT_BACKOFF_BASE_S="0.01"), chaos.inject("*:fail@%5"):
            d = os.path.join(tmp, "segidx")
            scfg = TfidfConfig(vocab_bits=8, prefetch=0, pipeline_depth=0)
            chunks = [[f"tok{i} tok{i % 5} shared word" for i in range(j * 3, j * 3 + 3)]
                      for j in range(4)]
            out = run_tfidf_streaming(iter(chunks), scfg, device=device)
            ref = sgm.seal_segment(d, out, scfg, doc_base=0)
            sgm.commit_append(d, ref, scfg.config_hash())
            srv = serving.TfidfServer(sgm.load_segment_set(d),
                                      serving.ServeConfig(top_k=3, scoring="impacted"),
                                      device=device).start()
            s, _ = srv.query(["tok3"])
            check(float(s[0]) > 0, s)
            # a segment committed after the server started, swapped in live
            out2 = run_tfidf_streaming(iter([["freshterm post start doc"]]), scfg,
                                       device=device)
            ref2 = sgm.seal_segment(d, out2, scfg, doc_base=out.n_docs)
            sgm.commit_append(d, ref2, scfg.config_hash())
            srv.refresh_segments(sgm.load_segment_set(d))
            s2, i2 = srv.query(["freshterm"])
            check(float(s2[0]) > 0 and int(i2[0]) == out.n_docs, (s2, i2))
            # compaction to one segment, still serving the same doc
            merger = sgm.SegmentMerger(d, scfg, max_segments=1, device=device)
            while merger.merge_once():
                pass
            check(len(sgm.latest_manifest(d).segments) == 1)
            srv.refresh_segments(sgm.load_segment_set(d))
            s3, i3 = srv.query(["freshterm"])
            check(int(i3[0]) == int(i2[0]), (i2, i3))
    finally:
        if srv is not None:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    secs, limit = within("segment", t0, "GRAFT_SEG_BUDGET_S", 15)
    return {"line": "segment smoke: OK — post-start commit served from segment "
                    f"{ref2.name} (global doc {int(i2[0])}), merged to 1 segment",
            "seconds": secs, "budget_s": limit, "doc": int(i2[0])}


@own_plans
def owned(device="cpu") -> dict:
    """``tools/ci.sh:763-811``: a seeded Zipf graph through the owned
    strategy on 4 slots for a fixed 40 iterations under ``*:fail@%5``,
    float64 within 1e-9 (L1) of one device, with a nonzero comm
    footprint a step."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_zipf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        NODES_AXIS,
        run_pagerank_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    t0 = time.perf_counter()
    g = synthetic_zipf(3000, 24000, seed=5)
    cfg = PageRankConfig(iterations=40, dangling="redistribute", init="uniform",
                         dtype="float64")
    m = MetricsRecorder()
    with env(GRAFT_RETRY_MAX="4", GRAFT_BACKOFF_BASE_S="0.01"), chaos.inject("*:fail@%5"):
        base = run_pagerank(g, cfg, device=device)
        res = run_pagerank_sharded(g, cfg, mesh=slot_mesh(4, NODES_AXIS, device),
                                   strategy="owned", metrics=m)
    l1 = float(np.abs(res.ranks - base.ranks).sum())
    check(l1 <= 1e-9, l1)
    check(res.iterations == 40, res.iterations)
    part = next(r for r in m.records if r.get("event") == "partition")
    check(part["comm_bytes_per_step"] > 0, part)
    secs, limit = within("owned", t0, "GRAFT_OWNED_BUDGET_S", 30)
    return {"line": "owned smoke: OK — 40-iteration fixpoint matched single-chip at "
                    f"1e-9 under chaos, {part['comm_bytes_per_step']} comm B/step on 4 "
                    "devices",
            "seconds": secs, "budget_s": limit, "l1": l1,
            "comm_bytes_per_step": part["comm_bytes_per_step"]}


SMOKES = {
    "autotune": autotune,
    "crash": crash,
    "drain": drain,
    "traced": traced,
    "soak": soak,
    "fabric": fabric_smoke,
    "federation": federation,
    "segment": segment,
    "owned": owned,
}


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ci_smokes", description="run the CI gate's smokes on the port; one OK line each")
    ap.add_argument("names", nargs="*",
                    help=f"smokes to run, of {', '.join(SMOKES)} (default: all, in order)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the torch device of the runs and the replicas (default cpu)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(SMOKES))
    if unknown:
        ap.error(f"unknown smokes {unknown}")
    failed = []
    for name in args.names or list(SMOKES):
        try:
            rep = SMOKES[name](args.device)
        except Exception as exc:  # noqa: BLE001 — reported, then the exit code
            failed.append(name)
            print(f"FAIL {name}: {type(exc).__name__}: {exc}", flush=True)
            continue
        limit = f" of {rep['budget_s']:g} s" if rep["budget_s"] is not None else ""
        print(f"OK {name} ({rep['seconds']:.1f} s{limit}): {rep['line']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
