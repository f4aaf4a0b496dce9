"""The port's serving fleet (``serving/fabric.py``, ``resilience/process.py``,
``tools/crash_harness.py``) against the JAX package's, on the CPU.

``resilience/process.py`` is a copy: its code, docstrings aside, is the
reference's.  The fabric is held by behaviour: the hash ring and the
affinity key route 10,000 seeded keys like the reference's; a floor written
by either package reads the same in the other; an in-process port replica
and a JAX replica behind their own exporters answer the same requests with
the same status codes, ids and scores; the same ``GRAFT_CHAOS`` plan on the
router→replica hop publishes the same ``(event, site)`` records; the
autoscaler takes the same decisions on the same snapshots; the port's
crash harness counts the reference's write boundaries (its end-to-end run
is slow-marked).  A real port
replica process (``--device cpu``) shakes hands, answers, is watched by the
root ``tools/slo_watch.py`` and exits 0 on SIGTERM; so does a one-replica
fleet behind the router.  The end-to-end kill/respawn/roll and the fleet
soak are slow-marked, as in the reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.obs.export import MetricsExporter as JExporter
from page_rank_and_tfidf_using_apache_spark_tpu.obs.metrics import MetricsHub as JHub
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.serving import fabric as jfabric
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.export import MetricsExporter
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import MetricsHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import process as procs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import crash_harness
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from tests.test_torch_obs import PORT, REF, _code

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "tiny.txt"
SCFG = tcfg.TfidfConfig(vocab_bits=10)
MODULE = "page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.fabric"
SCORE_ATOL = 2e-6  # tests/test_torch_serving.py's bar against the JAX server


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_fabric_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _docs() -> list[str]:
    return FIXTURE.read_text().splitlines()


def _seal(d, docs, base=0) -> tuple[int, int]:
    out = run_tfidf(docs, SCFG, device="cpu")
    ref = sgm.seal_segment(str(d), out, SCFG, doc_base=base,
                           ranks=np.ones(out.n_docs, np.float32), bm25=tcfg.Bm25Config())
    return sgm.commit_append(str(d), ref, SCFG.config_hash()), out.n_docs


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    """Each test installs its own plan (an empty one by default) in both
    packages, and replica processes get a clean environment."""
    monkeypatch.setenv("GRAFT_CHAOS", "")
    with chaos.inject(""), jchaos.inject(""):
        yield


# ------------------------------------------------------------------ the copy

def test_process_copy_matches_reference():
    assert (_code(PORT / "resilience" / "process.py")
            == _code(REF / "resilience" / "process.py"))


def test_surface_matches_reference():
    """The guarded sites, the floor file, the config fields (the port adds
    ``device``) and the fleet knobs are the reference's."""
    for name in ("ROUTE_SITE", "SWAP_SITE", "QUERY_SITE", "DRAIN_SITE", "PEEK_SITE",
                 "FILL_SITE", "FLOOR_FILE"):
        assert getattr(fabric, name) == getattr(jfabric, name), name
    import dataclasses

    for cls in ("FabricConfig", "AutoscaleConfig"):
        port = {f.name: f.default for f in dataclasses.fields(getattr(fabric, cls))}
        ref = {f.name: f.default for f in dataclasses.fields(getattr(jfabric, cls))}
        extra = {"device": "cuda"} if cls == "FabricConfig" else {}
        assert port == {**ref, **extra}, cls
    from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg

    knobs = {"GRAFT_SOAK_DURATION_S", "GRAFT_SOAK_QPS", "GRAFT_SOAK_SLO_P99_MS",
             "GRAFT_SOAK_SLO_AVAILABILITY", "GRAFT_FABRIC_REPLICAS", "GRAFT_FED_SCRAPE_S",
             "GRAFT_AUTOSCALE_MIN", "GRAFT_AUTOSCALE_MAX", "GRAFT_AUTOSCALE_COOLDOWN_S",
             "GRAFT_CACHE_PEEK_DEADLINE_S", "GRAFT_CACHE_BREAKER_TRIP",
             "GRAFT_CACHE_BREAKER_PROBE_S"}
    assert knobs <= tcfg.GRAFT_ENV_KNOBS and knobs <= jcfg.GRAFT_ENV_KNOBS
    assert "respawn" in tcfg.DEGRADE_LADDER


def test_respawn_publishes_degraded_on_the_respawn_rung():
    """``respawn`` publishes ``degraded`` on the ``respawn`` rung before the
    replacement comes up, then spawns the same argv (here a one-line
    child that prints its handshake)."""
    child = [sys.executable, "-c",
             "import json, time; print(json.dumps({'ready': True})); time.sleep(30)"]
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    try:
        first = procs.ProcessHandle(child, ready_timeout_s=30.0).spawn()
        first.kill()
        fresh = procs.respawn(first, site=fabric.ROUTE_SITE, replica=3)
        try:
            assert fresh.alive() and fresh.pid != first.pid
            assert fresh.ready == {"ready": True}
        finally:
            fresh.kill()
    finally:
        obs.bus().detach(sink)
    deg = sink.of_kind("degraded")
    assert [(e["site"], e["ladder"], e["replica"], e["pid"]) for e in deg] == [
        (fabric.ROUTE_SITE, "respawn", 3, first.pid)]
    assert deg[0]["returncode"] == -signal.SIGKILL


# ------------------------------------------------------------------ ring

def _seeded_terms(n: int, seed: int = 5) -> list[list[str]]:
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(500)]
    return [[words[j] for j in rng.integers(0, len(words), size=int(rng.integers(1, 5)))]
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_and_affinity_match_reference(n):
    """10,000 seeded keys: the same affinity keys, the same preference
    order (owner first) on a ring of N replicas, after one member leaves,
    and after one joins, as the reference's ring."""
    rng = np.random.default_rng(n)
    terms = _seeded_terms(10_000, seed=n)
    rankers = ["tfidf", "bm25", "prior"]
    keys = []
    for i, t in enumerate(terms):
        r = rankers[i % 3]
        k = fabric.affinity_key(t, r)
        assert k == jfabric.affinity_key(t, r)
        keys.append(k)
    ids = list(range(n))
    gone = ids[int(rng.integers(n))]
    members = [ids, [i for i in ids if i != gone] or [n], ids + [n]]
    for m in members:
        port, ref = fabric._Ring(m, 64), jfabric._Ring(m, 64)
        assert [port.route(k) for k in keys] == [ref.route(k) for k in keys]
        excl = {m[0]}
        assert ([port.route(k, exclude=excl) for k in keys[:500]]
                == [ref.route(k, exclude=excl) for k in keys[:500]])


# ----------------------------------------------------------------- floor

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_floor_read_across_packages(tmp_path, writer):
    """A floor committed by either package reads the same in both, and the
    file is byte-compatible (one JSON object with ``floor``)."""
    w = fabric if writer == "port" else jfabric
    d = str(tmp_path)
    assert fabric.read_floor(d) == jfabric.read_floor(d) == 0
    w.commit_floor(d, 3)
    assert fabric.read_floor(d) == jfabric.read_floor(d) == 3
    w.commit_floor(d, 7)
    assert fabric.read_floor(d) == jfabric.read_floor(d) == 7
    doc = json.loads((tmp_path / fabric.FLOOR_FILE).read_text())
    assert doc["floor"] == 7 and set(doc) == {"floor", "committed_wall"}
    assert not [p for p in os.listdir(d) if p.endswith(".tmp")]


@pytest.mark.parametrize("body, reads, raises", [
    ("{not json", 0, None),  # torn: reads as never committed
    ("", 0, None),
    ('{"floor": "high"}', None, ValueError),  # parseable but corrupt
    ('[3]', None, AttributeError),
])
def test_corrupt_floor_reads_alike(tmp_path, body, reads, raises):
    """A torn floor file reads as 0 in both packages; a parseable but
    corrupt one raises the same error in both."""
    (tmp_path / fabric.FLOOR_FILE).write_text(body)
    for pkg in (fabric, jfabric):
        if raises is None:
            assert pkg.read_floor(str(tmp_path)) == reads
        else:
            with pytest.raises(raises):
                pkg.read_floor(str(tmp_path))


# ------------------------------------------------ in-process replica parity

def _post(port: int, path: str, body: bytes, timeout: float = 30.0) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _routes(rep) -> dict:
    return {("POST", "/query"): rep.handle_query,
            ("GET", "/status"): rep.handle_status,
            ("POST", "/cache/peek"): rep.handle_cache_peek,
            ("POST", "/cache/fill"): rep.handle_cache_fill,
            ("POST", "/peers"): rep.handle_peers}


@contextlib.contextmanager
def _replica_pair(d):
    """A port replica (on the CPU) and a JAX replica over the same sealed
    segments, each behind its own package's exporter."""
    port_rep = fabric._Replica(str(d), replica_id=0, top_k=5, max_batch=None,
                               scoring="coo", poll_s=0.05, device="cpu").start()
    jax_rep = jfabric._Replica(str(d), replica_id=0, top_k=5, max_batch=None,
                               scoring="coo", poll_s=0.05).start()
    exporters = [MetricsExporter(MetricsHub(), port=0, routes=_routes(port_rep),
                                 ready=port_rep.ready).start(),
                 JExporter(JHub(), port=0, routes=_routes(jax_rep),
                           ready=jax_rep.ready).start()]
    try:
        deadline = time.monotonic() + 60.0
        while not (port_rep.ready() and jax_rep.ready()) and time.monotonic() < deadline:
            time.sleep(0.02)
        yield (port_rep, jax_rep), [e.port for e in exporters]
    finally:
        for e in exporters:
            e.stop()
        port_rep.stop()
        jax_rep.stop()


def _same_answer(a: dict, b: dict) -> None:
    assert a["docs"] == b["docs"]
    assert np.allclose(a["scores"], b["scores"], rtol=0.0, atol=SCORE_ATOL)


def test_replica_answers_like_the_reference(tmp_path):
    """The same requests to both replicas: the same status codes, ids
    equal and scores within 2e-6 — a query, a duplicate rid (replayed,
    byte-identical, not executed), a malformed body, a missing key, the
    cache peek (miss, hit, malformed), the cache fill (stored, replayed,
    stale, missing key), the peers push, the status keys, and a
    generation below a freshly committed floor (503 with the floor)."""
    gen, _ = _seal(tmp_path, _docs())
    with _replica_pair(tmp_path) as ((port_rep, jax_rep), ports):
        def both(path, doc_or_body):
            body = (doc_or_body if isinstance(doc_or_body, bytes)
                    else json.dumps(doc_or_body).encode())
            return [_post(p, path, body) for p in ports]

        (pc, pa), (jc, ja) = both("/cache/peek", {"terms": ["node"], "ranker": "tfidf"})
        assert pc == jc == 200 and pa["hit"] is ja["hit"] is False
        for terms, ranker in ((["node"], "tfidf"), (["directed", "graph"], "bm25"),
                              (["graph", "node", "edge"], "tfidf")):
            q = {"rid": f"q-{ranker}-{len(terms)}", "terms": terms, "ranker": ranker}
            (pc, pa), (jc, ja) = both("/query", q)
            assert pc == jc == 200
            assert pa["rid"] == ja["rid"] and pa["generation"] == ja["generation"] == gen
            _same_answer(pa, ja)
            # a duplicate rid replays the same bytes
            (pc2, pa2), (jc2, ja2) = both("/query", q)
            assert (pc2, pa2) == (pc, pa) and (jc2, ja2) == (jc, ja)
        assert port_rep._executions == jax_rep._executions == 3
        assert port_rep._replays == jax_rep._replays == 3
        (pc, pa), (jc, ja) = both("/cache/peek", {"terms": ["node"]})
        assert pc == jc == 200 and pa["hit"] is ja["hit"] is True
        _same_answer(pa, ja)
        for bad in (b"{not json", b"[]", b'"x"', b"null"):
            assert [c for c, _ in both("/query", bad)] == [400, 400]
            assert [c for c, _ in both("/cache/peek", bad)] == [400, 400]
            assert [c for c, _ in both("/cache/fill", bad)] == [400, 400]
            assert [c for c, _ in both("/peers", bad)] == [400, 400]
        assert [c for c, _ in both("/query", {"terms": ["node"]})] == [400, 400]
        assert [c for c, _ in both("/query", {"rid": "m-1"})] == [400, 400]
        fill = {"rid": "fl-1", "terms": ["walk"], "ranker": "tfidf",
                "scores": [0.5, 0.25], "docs": [1, 0], "generation": gen}
        (pc, pa), (jc, ja) = both("/cache/fill", fill)
        assert pc == jc == 200 and pa == ja and pa["stored"] is True
        assert both("/cache/fill", fill) == [(pc, pa), (jc, ja)]  # replayed
        (pc, pa), (jc, ja) = both("/cache/peek", {"terms": ["walk"]})
        assert pa == ja and pa["scores"] == [0.5, 0.25] and pa["docs"] == [1, 0]
        stale = dict(fill, rid="fl-2", generation=gen + 7)
        (pc, pa), (jc, ja) = both("/cache/fill", stale)
        assert pc == jc == 200 and pa["stored"] is ja["stored"] is False
        assert [c for c, _ in both("/cache/fill", {"rid": "fl-3", "terms": ["x"]})] == [400, 400]
        (pc, pa), (jc, ja) = both("/peers", {"peers": {"0": 1111, "1": 2222}})
        assert pc == jc == 200 and pa == ja
        assert port_rep._peers == jax_rep._peers == {1: 2222}
        assert (port_rep._cache_owner(["node"], "tfidf")
                == jax_rep._cache_owner(["node"], "tfidf"))
        assert both("/peers", {"peers": {"0": 1111}})[0][0] == 200
        assert port_rep.srv.stats()["peer_stores"] == jax_rep.srv.stats()["peer_stores"] == 1
        s_port = json.loads(port_rep.handle_status(b"")[2])
        s_jax = json.loads(jax_rep.handle_status(b"")[2])
        assert set(s_port) == set(s_jax)
        for key in ("replica", "ready", "generation", "floor", "executions", "replays",
                    "peer_stores"):
            assert s_port[key] == s_jax[key], key
        # the floor moves past the loaded generation: both refuse, typed
        fabric.commit_floor(str(tmp_path), gen + 1)
        deadline = time.monotonic() + 10.0
        while (port_rep.ready() or jax_rep.ready()) and time.monotonic() < deadline:
            time.sleep(0.02)
        for path, doc in (("/query", {"rid": "f-1", "terms": ["node"]}),
                          ("/cache/fill", dict(fill, rid="f-2"))):
            (pc, pa), (jc, ja) = both(path, doc)
            assert pc == jc == 503 and pa == ja
            assert pa["floor"] == gen + 1 and pa["generation"] == gen
        codes = []
        for p in ports:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{p}/healthz", timeout=10)
                codes.append(200)
            except urllib.error.HTTPError as exc:
                codes.append(exc.code)
        assert codes == [503, 503]


def test_replica_refuses_pre_floor_artifact_then_catches_up(tmp_path):
    """tests/test_fabric.py's floor scenario on the port's replica: below
    the floor it comes up unready and 503s; once the fleet's generation
    lands its poll loop catches up and it serves generation 2."""
    docs = _docs()
    v1, n1 = _seal(tmp_path, docs[:5])
    assert v1 == 1
    fabric.commit_floor(str(tmp_path), 2)
    rep = fabric._Replica(str(tmp_path), replica_id=0, top_k=5, max_batch=None,
                          scoring="coo", poll_s=0.05, device="cpu").start()
    try:
        assert not rep.ready()
        code, _, body = rep.handle_query(json.dumps(
            {"rid": "r1", "terms": ["node"], "ranker": "tfidf"}).encode())
        assert code == 503 and json.loads(body)["floor"] == 2
        _seal(tmp_path, docs[5:], base=n1)
        deadline = time.monotonic() + 10.0
        while not rep.ready() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rep.ready()
        code, _, body = rep.handle_query(json.dumps(
            {"rid": "r2", "terms": ["node"], "ranker": "tfidf"}).encode())
        assert code == 200 and json.loads(body)["generation"] == 2
    finally:
        rep.stop()


def test_replica_resolves_its_own_devices_profile(tmp_path, monkeypatch):
    """A ``--device cpu`` replica resolves the ``cpu`` backend's tuned
    profile even where the process's default backend would be ``gpu``;
    a ``cuda`` replica without CUDA raises before it serves."""
    import torch

    _seal(tmp_path, _docs())
    root = tmp_path / "profiles"
    root.mkdir()
    tcfg.write_tuned_profile(root / "tuned_profile_gpu.json", "gpu", {"max_batch": 16})
    tcfg.write_tuned_profile(root / "tuned_profile_cpu.json", "cpu", {"max_batch": 2})
    monkeypatch.setattr(tcfg, "_PACKAGE_DIR", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcfg.default_backend() == "gpu"
    rep = fabric._Replica(str(tmp_path), replica_id=0, top_k=5, max_batch=None,
                          scoring="coo", poll_s=5.0, device="cpu")
    assert rep._serve_config().max_batch == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fabric._Replica(str(tmp_path), replica_id=0, top_k=5, max_batch=None,
                        scoring="coo", poll_s=5.0)


# ------------------------------------------------------------ router chaos

def _ok_handler(replica_id, seen):
    def handle(body: bytes):
        req = json.loads(body.decode())
        seen.append(req["rid"])
        return (200, "application/json", json.dumps({
            "rid": req["rid"], "replica": replica_id, "generation": 1,
            "scores": [1.0], "docs": [0]}))
    return handle


@pytest.mark.parametrize("plan", ["fabric_route:net_partition@1",
                                  "fabric_route:net_hang@1:50"])
def test_router_chaos_records_match_reference(tmp_path, plan):
    """The same plan on the router→replica hop of two stub replicas: the
    same ordered ``(event, site)`` records from both packages' routers,
    one delivery each, the same audit."""
    got = {}
    for name, (fab_mod, chaos_mod, obs_mod, exp_cls, hub_cls) in {
            "port": (fabric, chaos, obs, MetricsExporter, MetricsHub),
            "jax": (jfabric, jchaos, jobs, JExporter, JHub)}.items():
        seen: list[str] = []
        exporters = [exp_cls(hub_cls(), port=0,
                             routes={("POST", "/query"): _ok_handler(i, seen)}).start()
                     for i in range(2)]
        sink = obs_mod.MemorySink()
        obs_mod.bus().attach(sink)
        try:
            fab = fab_mod.ServingFabric(str(tmp_path), fab_mod.FabricConfig(
                replicas=2, retry_pause_s=0.01, request_timeout_s=5.0, retry_limit=8))
            fab._ports = {i: e.port for i, e in enumerate(exporters)}
            with chaos_mod.inject(plan):
                scores, docs = fab.query(["gamma", "delta"])
            assert scores.dtype == np.float32 and docs.dtype == np.int32
        finally:
            obs_mod.bus().detach(sink)
            for e in exporters:
                e.stop()
        records = [(e["kind"], e.get("site")) for e in sink.events
                   if e["kind"] not in ("span_start", "span_end")]
        got[name] = (records, fab.audit(), len(seen), sorted(fab._suspect))
    assert got["port"] == got["jax"]
    records, audit, executed, _ = got["port"]
    assert ("chaos", fabric.ROUTE_SITE) in records
    assert audit["delivered"] == 1 and audit["dropped"] == 0 and executed == 1


# ------------------------------------------------------------ autoscaler

class _StubFleet:
    """The replica_ids/scale_up/scale_down surface the autoscaler drives,
    over a counter: no process is spawned."""

    def __init__(self, n: int):
        self.fleet = object()  # federation present; tick() is given snaps
        self._n = n

    def replica_ids(self):
        return list(range(self._n))

    def scale_up(self, k: int = 1):
        self._n += k
        return [self._n - 1]

    def scale_down(self, k: int = 1):
        self._n -= k
        return [self._n]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_autoscaler_decisions_match_reference(seed):
    """The same seeded script of fleet snapshots (budget burn, queue-wait
    p99, offered rate) and clock steps: the same action, the same
    ``autoscale`` event and the same tallies from both packages'
    autoscalers."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(300):
        snap = {"budgets": {"availability": {"burn_rate": float(rng.choice([0.0, 0.3, 3.0]))},
                            "latency": {"burn_rate": float(rng.choice([0.0, 1.0, 2.5]))}},
                "queue_wait_s": {"p99": rng.choice([None, 0.01, 0.9])},
                "counters": {"serve.requests": {"rate_per_s": float(rng.choice([0.0, 0.2, 9.0]))}}}
        script.append((float(rng.exponential(1.5)), snap))
    got = {}
    for name, (fab_mod, obs_mod) in {"port": (fabric, obs), "jax": (jfabric, jobs)}.items():
        clock = [100.0]
        sc = fab_mod.Autoscaler(_StubFleet(2), fab_mod.AutoscaleConfig(
            min_replicas=1, max_replicas=4, cooldown_s=3.0, idle_hold_s=2.0),
            clock=lambda: clock[0])
        sink = obs_mod.MemorySink()
        obs_mod.bus().attach(sink)
        try:
            actions = []
            for dt, snap in script:
                clock[0] += dt
                actions.append(sc.tick(snap))
        finally:
            obs_mod.bus().detach(sink)
        events = [{k: v for k, v in e.items() if k not in ("t", "seq", "wall")}
                  for e in sink.of_kind("autoscale")]
        got[name] = (actions, events, sc.stats())
    assert got["port"] == got["jax"]
    assert {"up", "down", "hold"} <= set(got["port"][0])


# ------------------------------------------------------------- crash harness

REF_HARNESS = _tool("crash_harness")


@pytest.mark.parametrize("scenario", ["append", "replace", "merge", "floor"])
def test_crash_harness_counts_the_reference_boundaries(tmp_path, monkeypatch, capsys,
                                                       scenario):
    """Each scenario's probe (setup, then the op with no kill) counts the
    same write boundaries in the port's harness as in the reference's, and
    leaves the same files."""
    for mod, name in ((os, "replace"), (os, "unlink"), (shutil, "rmtree")):
        monkeypatch.setattr(mod, name, getattr(mod, name))  # restored after
    got = {}
    for label, harness in (("port", crash_harness), ("jax", REF_HARNESS)):
        base = tmp_path / label
        base.mkdir()
        assert harness.worker_setup(str(base), scenario) == 0
        capsys.readouterr()
        originals = (os.replace, os.unlink, shutil.rmtree)
        try:
            assert harness.worker_op(str(base), scenario, -1) == 0
        finally:
            os.replace, os.unlink, shutil.rmtree = originals
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        files = sorted(p.relative_to(base).as_posix()
                       for p in (base / "idx").rglob("*") if p.is_file())
        got[label] = (printed, files)
    assert got["port"] == got["jax"]
    assert got["port"][0]["boundaries"] >= REF_HARNESS._MIN_BOUNDARIES.get(scenario, 2)
    assert crash_harness._SCENARIOS == REF_HARNESS._SCENARIOS
    assert crash_harness._MIN_BOUNDARIES == REF_HARNESS._MIN_BOUNDARIES


@pytest.mark.slow
def test_crash_harness_floor_scenario_end_to_end(tmp_path):
    """The port's harness as a user runs it: the floor scenario, every
    kill point, a consistent generation after each and no orphan (six
    worker processes, each importing torch: about 20 s on the CPU)."""
    out = subprocess.run(
        [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.tools."
         "crash_harness", "--scenarios", "floor", "--json", "--dir", str(tmp_path / "w")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout)
    assert rep["floor"]["boundaries"] == 1
    assert rep["floor"]["served_pre"] == 1 and rep["floor"]["served_post"] == 0


# ------------------------------------------------------- a real replica process

def _slo_watch(url: str, *extra: str) -> str:
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "slo_watch.py"),
                          "--url", url, "--once", *extra],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_replica_process_handshake_query_and_sigterm(tmp_path):
    """One REAL port replica process on the CPU: the ready handshake on
    stdout, a /query round-trip equal to the in-process server's, the
    /healthz the router checks, the root slo_watch against its endpoint,
    and a graceful SIGTERM exit (rc 0)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving

    _seal(tmp_path, _docs())
    handle = procs.ProcessHandle([
        sys.executable, "-m", MODULE, "--replica", str(tmp_path), "--replica-id", "0",
        "--port", "0", "--top-k", "3", "--device", "cpu",
    ], ready_timeout_s=120.0).spawn()
    try:
        assert handle.ready["ready"] is True and handle.ready["generation"] == 1
        port = int(handle.ready["port"])
        code, resp = _post(port, "/query", json.dumps(
            {"rid": "t-1", "terms": ["node"], "ranker": "tfidf"}).encode())
        assert code == 200 and resp["rid"] == "t-1" and resp["generation"] == 1
        with serving.TfidfServer(sgm.load_segment_set(str(tmp_path)),
                                 serving.ServeConfig(top_k=3), device="cpu") as srv:
            scores, docs = srv.query(["node"])
        assert resp["docs"] == docs.tolist()
        assert resp["scores"] == [float(s) for s in scores]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.status == 200
        board = _slo_watch(f"http://127.0.0.1:{port}")
        assert "p99" in board
        assert handle.terminate(grace_s=20.0) == 0
    finally:
        handle.kill()


def test_fleet_of_one_behind_the_router(tmp_path, monkeypatch):
    """``ServingFabric`` with one CPU replica: routed answers, the rid
    audit, the router's own fleet endpoint rendered by the root
    ``slo_watch --fleet``, a clean stop."""
    monkeypatch.setenv("GRAFT_FED_SCRAPE_S", "0.2")
    _seal(tmp_path, _docs())
    fab = fabric.ServingFabric(str(tmp_path), fabric.FabricConfig(
        replicas=1, device="cpu", poll_s=0.1, health_period_s=0.2, grace_s=10.0))
    with fab:
        for _ in range(3):
            scores, docs = fab.query(["directed", "graph"])
            assert scores.dtype == np.float32 and len(docs) > 0
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            snap = fab.fleet.snapshot()
            if snap["fleet"]["scrapes"] >= 1:
                break
            time.sleep(0.1)
        board = _slo_watch(fab.fleet_url, "--fleet")
        assert "fleet: 1 replica(s)" in board
        audit = fab.audit()
        assert audit["delivered"] == 3 and audit["dropped"] == 0
        assert audit["double_served"] == 0


# --------------------------------------------------------- the whole fleet

@pytest.mark.slow
def test_fabric_end_to_end_kill_respawn_and_rolling_restart(tmp_path):
    """tests/test_fabric.py's end-to-end scenario on the port (CPU
    replicas): per-replica chaos kills replica 1 mid-query, a SIGKILL on
    replica 0 recovers through sibling retry and respawn with 0 dropped
    and 0 served twice, a rolling restart under a committed floor leaves
    the fleet at generation 2, and the root trace_report reads the trace."""
    docs = _docs()
    v1, n1 = _seal(tmp_path, docs[:5])
    with obs.run("fabrictest", trace_dir=str(tmp_path / "trace")) as r:
        fab = fabric.ServingFabric(str(tmp_path), fabric.FabricConfig(
            replicas=2, poll_s=0.1, health_period_s=0.2, retry_limit=100,
            retry_pause_s=0.1, request_timeout_s=10.0, grace_s=10.0, device="cpu",
            replica_chaos=((1, "replica_query:proc_kill@3"),)))
        with fab:
            for _ in range(8):
                scores, _ = fab.query(["node"])
                assert len(scores) > 0
            fab.kill_replica(0)
            for _ in range(20):
                fab.query(["directed", "graph"])
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if (fab.audit()["respawns"] >= 1
                        and all(s is not None and s.get("ready") for s in fab.statuses())):
                    break
                time.sleep(0.2)
            audit = fab.audit()
            assert audit["respawns"] >= 1
            assert audit["dropped"] == 0 and audit["double_served"] == 0
            _seal(tmp_path, docs[5:], base=n1)
            assert fab.await_fleet_generation(2, timeout=60.0)
            fab.rolling_restart(timeout=60.0)
            assert fabric.read_floor(str(tmp_path)) == 2
            statuses = fab.statuses()
            assert all(s is not None and s.get("ready") and s.get("generation") >= 2
                       and s.get("floor") == 2 for s in statuses)
            fab.query(["node"])
            audit = fab.audit()
            assert audit["rolled"] == 2
            assert audit["dropped"] == 0 and audit["double_served"] == 0
    fb = _tool("trace_report").report(r.trace_path)["fabric"]
    assert fb["replicas"] == 2 and fb["kills"] >= 1 and len(fb["respawns"]) >= 1
    assert fb["rolls"] == 2 and fb["floor_timeline"][-1]["floor"] == 2
    assert fb["totals"]["dropped"] == 0 and fb["totals"]["double_served"] == 0


@pytest.mark.slow
def test_fleet_soak_scenario(tmp_path):
    """tests/test_fabric.py's fleet soak on the port (CPU replicas): one
    SIGKILL and one rolling restart under load, the reference's record."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.soak import (
        FleetSoakConfig,
        run_fleet_soak,
    )

    with obs.run("fleettest", trace_dir=str(tmp_path / "trace")) as r:
        rec = run_fleet_soak(FleetSoakConfig(
            duration_s=18.0, qps=6.0, clients=2, replicas=2, rebuild_every_s=6.0,
            kill_at_s=5.0, roll_at_s=11.0, device="cpu"))
    assert rec["requests"] > 10 and rec["backend"] == "cpu"
    assert rec["dropped"] == 0 and rec["double_served"] == 0
    assert rec["recovery"]["losses_injected"] == 1
    assert rec["recovery"]["time_to_recover_s"] is not None
    assert rec["fleet"]["respawns"] >= 1
    assert rec["fleet"]["rolled"] == 2 and rec["fleet"]["roll"]["ok"]
    assert rec["fleet"]["floor"] >= 1
    assert rec["served_p99_ms"] is not None
    rep = _tool("trace_report").report(r.trace_path)
    assert rep["slo"]["dropped"] == 0 and rep["slo"]["fleet"]["rolled"] == 2
