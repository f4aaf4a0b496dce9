"""The port's drain handoff and sharded peer cache (``serving/fabric.py``)
against the JAX package's, on the CPU.

The circuit breaker gives the reference's trip / half-open / close
sequence under the same seeded call script.  The peer-cache tests of
``tests/test_drain_cache.py`` run on the port's replicas (in-process, on
the CPU): the peek and fill handlers, the peers push, a non-owner's miss
served by the owner byte for byte, a partitioned peek that trips the
breaker and recloses it, a hung peek bounded by the deadline, a
partitioned fill that costs nothing.  The reuse-port exporter drains
in-flight requests, and its listener leaves the group on its serving
thread.  Then the handoff on real replica processes: a successor spawn
that fails leaves the predecessor serving, a roll under closed-loop load
needs zero roll-attributed retries and TERMs each predecessor with no
query in flight to it, and the retry-carried roll still rolls.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.serving import fabric as jfabric
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.export import (
    MetricsExporter,
    reuse_port_supported,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import MetricsHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    TfidfConfig,
)

FIXTURE = Path(__file__).parent / "fixtures" / "tiny.txt"
SCFG = TfidfConfig(vocab_bits=10)


@pytest.fixture(autouse=True)
def _hermetic_chaos(monkeypatch):
    """These tests pin exact peer/breaker/roll ledgers, so they run under
    their own (empty) plan, and replica processes get a clean one; tests
    that want chaos nest their own ``chaos.inject(...)``."""
    monkeypatch.setenv("GRAFT_CHAOS", "")
    with chaos.inject(""):
        yield


def _seal(d, docs, base=0):
    out = run_tfidf(docs, SCFG, device="cpu")
    ref = sgm.seal_segment(str(d), out, SCFG, doc_base=base,
                           ranks=np.ones(out.n_docs, np.float32), bm25=Bm25Config())
    return sgm.commit_append(str(d), ref, SCFG.config_hash())


def _docs():
    return FIXTURE.read_text().splitlines()


def _mk_replica(d, rid, **kw):
    rep = fabric._Replica(str(d), replica_id=rid, top_k=5, max_batch=None,
                          scoring="coo", poll_s=5.0, device="cpu", **kw)
    rep.start()
    deadline = time.monotonic() + 15.0
    while not rep.ready() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert rep.ready()
    return rep


def _query_body(rid, terms, ranker="tfidf"):
    return json.dumps({"rid": rid, "terms": terms, "ranker": ranker}).encode()


def _owned_terms(owner_id, ids, slots=64, ranker="tfidf"):
    """A single-word query routed to ``owner_id`` by the cache ring."""
    ring = fabric._Ring(sorted(ids), slots)
    for w in _docs()[0].split() + ["alpha", "beta", "gamma", "delta"]:
        if ring.route(fabric.affinity_key([w], ranker))[0] == owner_id:
            return [w]
    raise AssertionError("no fixture word routed to the wanted owner")


# ------------------------------------------------------------- breaker

@pytest.mark.parametrize("seed, trip, probe_s", [(1, 3, 2.0), (2, 1, 0.5), (3, 2, 1.0),
                                                 (4, 5, 0.1)])
def test_breaker_sequence_matches_reference(seed, trip, probe_s):
    """The same seeded call script — a caller asks ``allow`` at seeded
    times and, when allowed, reports a seeded success or failure (60%
    failures) — gives the same answers, states, failure counts and open
    times, call by call, as the reference's breaker."""
    rng = np.random.default_rng(seed)
    port, ref = fabric._Breaker(trip, probe_s), jfabric._Breaker(trip, probe_s)
    now, seen = 0.0, []
    for _ in range(600):
        now += float(rng.exponential(probe_s / 4))
        allowed = port.allow(now)
        assert allowed == ref.allow(now)
        assert port.state == ref.state
        seen.append(port.state)
        if allowed:
            if rng.random() < 0.6:
                port.record_failure(now)
                ref.record_failure(now)
            else:
                port.record_success()
                ref.record_success()
        assert (port.state, port.failures, port.opened_t) == (ref.state, ref.failures,
                                                              ref.opened_t)
        seen.append(port.state)
    assert set(seen) == {"closed", "open", "half_open"}


def test_breaker_trips_half_opens_and_recloses():
    br = fabric._Breaker(trip=3, probe_s=2.0)
    assert br.allow(now=0.0) and br.state == "closed"
    br.record_failure(now=0.0)
    br.record_failure(now=0.1)
    assert br.state == "closed"
    br.record_failure(now=0.2)
    assert br.state == "open"
    assert not br.allow(now=0.3) and not br.allow(now=2.1)
    assert br.allow(now=2.3) and br.state == "half_open"
    br.record_failure(now=2.4)
    assert br.state == "open"
    assert br.allow(now=4.5)
    br.record_success()
    assert br.state == "closed" and br.failures == 0


# ----------------------------------------------------- peek/fill handlers

def test_cache_peek_miss_hit_and_malformed(tmp_path):
    _seal(tmp_path, _docs())
    rep = _mk_replica(tmp_path, 0)
    try:
        code, _, body = rep.handle_cache_peek(json.dumps({"terms": ["node"]}).encode())
        assert code == 200 and json.loads(body)["hit"] is False
        _, _, qbody = rep.handle_query(_query_body("pk-1", ["node"]))
        served = json.loads(qbody)
        code, _, body = rep.handle_cache_peek(
            json.dumps({"terms": ["node"], "ranker": "tfidf"}).encode())
        peek = json.loads(body)
        assert code == 200 and peek["hit"] is True
        assert peek["generation"] == served["generation"]
        # the peeked values re-serialise to the served ones
        assert peek["scores"] == served["scores"] and peek["docs"] == served["docs"]
        assert rep.handle_cache_peek(b"{not json")[0] == 400
        assert rep.handle_cache_peek(b"[]")[0] == 400
    finally:
        rep.stop()


def test_cache_fill_is_idempotent_by_rid_and_generation_gated(tmp_path):
    gen = _seal(tmp_path, _docs())
    rep = _mk_replica(tmp_path, 0)
    try:
        doc = {"rid": "fl-1", "terms": ["node"], "ranker": "tfidf",
               "scores": [0.5, 0.25], "docs": [1, 0], "generation": gen}
        first = rep.handle_cache_fill(json.dumps(doc).encode())
        assert first[0] == 200 and json.loads(first[2])["stored"] is True
        assert rep.srv.stats()["peer_stores"] == 1
        assert rep.handle_cache_fill(json.dumps(doc).encode()) == first
        assert rep.srv.stats()["peer_stores"] == 1 and rep._replays == 1
        code, _, body = rep.handle_cache_peek(json.dumps({"terms": ["node"]}).encode())
        peek = json.loads(body)
        assert peek["hit"] is True and peek["scores"] == [0.5, 0.25]
        assert peek["docs"] == [1, 0]
        stale = dict(doc, rid="fl-2", generation=gen + 7)
        code, _, body = rep.handle_cache_fill(json.dumps(stale).encode())
        assert code == 200 and json.loads(body)["stored"] is False
        assert rep.handle_cache_fill(
            json.dumps({"rid": "fl-3", "terms": ["node"]}).encode())[0] == 400
    finally:
        rep.stop()


def test_cache_insert_is_served_byte_equal_and_invalidated_by_a_swap(tmp_path):
    """A filled entry comes back from the serve path itself, in the serve
    path's types, and a hot-swap (a new generation) drops it like a
    computed one."""
    gen = _seal(tmp_path, _docs())
    rep = _mk_replica(tmp_path, 0)
    try:
        _, _, body = rep.handle_query(_query_body("ci-1", ["graph"]))
        computed = json.loads(body)
        srv = rep.srv
        assert srv.cache_lookup(["graph"]) is not None
        srv.cache_insert(["walk"], computed["scores"], computed["docs"])
        scores, docs = srv.query(["walk"])
        assert scores.dtype == np.float32 and docs.dtype == np.int32
        assert [float(s) for s in scores] == computed["scores"]
        assert [int(d) for d in docs] == computed["docs"]
        assert srv.stats()["cache_hits"] >= 1
        srv.refresh_segments(sgm.load_segment_set(str(tmp_path)))
        assert srv.cache_lookup(["walk"]) is None
        assert gen == rep.generation
    finally:
        rep.stop()


def test_cache_fill_below_floor_is_typed_503_with_floor(tmp_path):
    gen = _seal(tmp_path, _docs())
    rep = fabric._Replica(str(tmp_path), replica_id=0, top_k=5, max_batch=None,
                          scoring="coo", poll_s=0.05, device="cpu").start()
    try:
        deadline = time.monotonic() + 15.0
        while not rep.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        fabric.commit_floor(str(tmp_path), gen + 1)
        deadline = time.monotonic() + 10.0
        while rep.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not rep.ready()
        doc = {"rid": "fl-floor", "terms": ["node"], "scores": [1.0], "docs": [0],
               "generation": gen}
        code, _, body = rep.handle_cache_fill(json.dumps(doc).encode())
        assert code == 503 and json.loads(body)["floor"] == gen + 1
    finally:
        rep.stop()


def test_peers_push_installs_ring_and_single_member_disables(tmp_path):
    _seal(tmp_path, _docs())
    rep = _mk_replica(tmp_path, 0)
    try:
        code, _, body = rep.handle_peers(
            json.dumps({"peers": {"0": 1111, "1": 2222}}).encode())
        assert code == 200 and json.loads(body)["ok"] is True
        assert rep._peers == {1: 2222} and rep._peer_ring is not None
        ring = fabric._Ring([0, 1], 64)
        assert (rep._cache_owner(["node"], "tfidf")
                == ring.route(fabric.affinity_key(["node"], "tfidf"))[0])
        assert rep.handle_peers(json.dumps({"peers": {"0": 1111}}).encode())[0] == 200
        assert rep._cache_owner(["node"], "tfidf") is None
        assert rep.handle_peers(json.dumps({"peers": "x"}).encode())[0] == 400
    finally:
        rep.stop()


# ------------------------------------------------- two-replica peer fleet

class _PeerPair:
    """Two in-process port replicas behind real exporters with the full
    route table, wired as each other's peers — the peer cache minus the
    processes."""

    def __init__(self, d, cache_size=None):
        self.reps = [_mk_replica(d, i, cache_size=cache_size) for i in (0, 1)]
        self.exporters = [
            MetricsExporter(MetricsHub(), port=0, routes={
                ("POST", "/query"): r.handle_query,
                ("GET", "/status"): r.handle_status,
                ("POST", "/cache/peek"): r.handle_cache_peek,
                ("POST", "/cache/fill"): r.handle_cache_fill,
                ("POST", "/peers"): r.handle_peers,
            }, ready=r.ready).start()
            for r in self.reps
        ]
        peers = {i: e.port for i, e in enumerate(self.exporters)}
        for r in self.reps:
            r.configure_peers(peers)

    def ports(self):
        return [e.port for e in self.exporters]

    def stop(self):
        for e in self.exporters:
            e.stop()
        for r in self.reps:
            r.stop()


def _drain_fills(rep, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not rep._fill_q.empty() and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.05)  # let the in-flight fill POST land


def test_peer_hit_serves_byte_equal_and_fill_warms_owner(tmp_path):
    _seal(tmp_path, _docs())
    pair = _PeerPair(tmp_path)
    a, b = pair.reps
    try:
        terms = _owned_terms(0, [0, 1])
        _, _, abody = a.handle_query(_query_body("ph-1", terms))
        _, _, bbody = b.handle_query(_query_body("ph-2", terms))
        served_a, served_b = json.loads(abody), json.loads(bbody)
        assert served_b["scores"] == served_a["scores"]
        assert served_b["docs"] == served_a["docs"]
        assert b._peer_stats["peer_hits"] == 1
        assert b._executions == 1 and a._executions == 1
        ring = fabric._Ring([0, 1], 64)
        terms2 = next([w] for w in ("graph", "edge", "walk", "rank", "sparse", "matrix")
                      if [w] != terms
                      and ring.route(fabric.affinity_key([w], "tfidf"))[0] == 0)
        _, _, body2 = b.handle_query(_query_body("ph-3", terms2))
        _drain_fills(b)
        assert b._peer_stats["fills"] == 1
        assert a.srv.stats()["peer_stores"] == 1
        code, _, peek = a.handle_cache_peek(json.dumps({"terms": terms2}).encode())
        peeked = json.loads(peek)
        assert code == 200 and peeked["hit"] is True
        assert peeked["scores"] == json.loads(body2)["scores"]
    finally:
        pair.stop()


def test_cache_peek_partition_degrades_trips_and_recovers(tmp_path, monkeypatch):
    """A partitioned peek hop: every query still serves the right bytes
    (local compute), the owner's breaker opens within the trip count, and
    the half-open probe recloses it once the partition heals; the router
    on top keeps its audit at 0/0."""
    monkeypatch.setenv("GRAFT_CACHE_BREAKER_TRIP", "2")
    monkeypatch.setenv("GRAFT_CACHE_BREAKER_PROBE_S", "0.3")
    monkeypatch.setenv("GRAFT_CACHE_PEEK_DEADLINE_S", "0.5")
    _seal(tmp_path, _docs())
    pair = _PeerPair(tmp_path)
    a, b = pair.reps
    fab = fabric.ServingFabric(str(tmp_path), fabric.FabricConfig(
        replicas=2, retry_pause_s=0.01, request_timeout_s=5.0, device="cpu"))
    fab._ports = dict(enumerate(pair.ports()))
    try:
        terms = _owned_terms(0, [0, 1])
        ref = json.loads(a.handle_query(_query_body("pt-ref", terms))[2])
        ring = fabric._Ring([0, 1], 64)
        owned = [[w] for w in (f"w{i}" for i in range(200))
                 if ring.route(fabric.affinity_key([w], "tfidf"))[0] == 0]
        assert len(owned) >= 4
        with chaos.inject("cache_peek:net_partition@1+;cache_fill:net_partition@1+"):
            for n in range(4):
                scores, docs = fab.query(terms)
                assert list(map(float, scores)) == ref["scores"]
                assert list(map(int, docs)) == ref["docs"]
                assert b.handle_query(_query_body(f"pt-b{n}", owned[n]))[0] == 200
            _drain_fills(b)
        assert b._breakers[0].state == "open"
        assert b._peer_stats["peek_timeouts"] >= 1
        assert b._peer_stats["peeks_skipped_open"] >= 1
        assert b._peer_stats["breaker_trips"] >= 1
        time.sleep(0.35)
        bbody = b.handle_query(_query_body("pt-heal", terms))[2]
        assert json.loads(bbody)["scores"] == ref["scores"]
        assert b._breakers[0].state == "closed"
        assert b._peer_stats["peer_hits"] >= 1
        audit = fab.audit()
        assert audit["dropped"] == 0 and audit["double_served"] == 0
        assert audit["failed"] == 0
    finally:
        pair.stop()


def test_cache_peek_hang_is_bounded_by_deadline(tmp_path, monkeypatch):
    """A hung owner costs a request at most the peek deadline plus one
    local compute, never the hang."""
    monkeypatch.setenv("GRAFT_CACHE_PEEK_DEADLINE_S", "0.15")
    _seal(tmp_path, _docs())
    pair = _PeerPair(tmp_path)
    a, b = pair.reps
    try:
        terms = _owned_terms(0, [0, 1])
        ref = json.loads(a.handle_query(_query_body("hg-ref", terms))[2])
        t0 = time.perf_counter()
        with chaos.inject("cache_peek:net_hang@1:2000"):
            bbody = b.handle_query(_query_body("hg-1", terms))[2]
        elapsed = time.perf_counter() - t0
        assert json.loads(bbody)["scores"] == ref["scores"]
        assert elapsed < 1.5
        assert b._peer_stats["peek_timeouts"] == 1
    finally:
        pair.stop()


def test_cache_fill_partition_is_best_effort(tmp_path):
    _seal(tmp_path, _docs())
    pair = _PeerPair(tmp_path)
    a, b = pair.reps
    try:
        terms = _owned_terms(0, [0, 1])
        with chaos.inject("cache_fill:net_partition@1+"):
            code, _, body = b.handle_query(_query_body("fp-1", terms))
            assert code == 200
            _drain_fills(b)
        assert b._peer_stats["fill_errors"] == 1
        assert a.srv.stats()["peer_stores"] == 0
        abody = a.handle_query(_query_body("fp-2", terms))[2]
        assert json.loads(abody)["scores"] == json.loads(body)["scores"]
    finally:
        pair.stop()


# --------------------------------------------------- reuse-port exporter

@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_reuse_port_listener_group_and_drain_joins_inflight():
    """The handoff transport: two exporters share one port, and a draining
    exporter's stop() blocks until its in-flight handler has answered."""
    gate = threading.Event()

    def slow(body):
        gate.wait(5.0)
        return (200, "application/json", json.dumps({"ok": True}))

    first = MetricsExporter(MetricsHub(), port=0, reuse_port=True, drain=True,
                            routes={("POST", "/slow"): slow}).start()
    second = MetricsExporter(MetricsHub(), port=first.port, reuse_port=True,
                             routes={}).start()
    assert second.port == first.port
    second.stop()
    results = []

    def call():
        req = urllib.request.Request(f"http://127.0.0.1:{first.port}/slow",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=10.0) as r:
            results.append(r.status)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    time.sleep(0.2)
    stopper = threading.Thread(target=first.stop, daemon=True)
    stopper.start()
    time.sleep(0.2)
    assert stopper.is_alive()  # draining, not dropping
    gate.set()
    stopper.join(10.0)
    t.join(10.0)
    assert results == [200]


@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_draining_listener_leaves_the_group_on_its_serving_thread():
    """The port's one change to the copied exporter: the serving thread
    closes the listening socket right after its backlog sweep, before
    ``shutdown()`` returns, so no connection the kernel queues meanwhile
    is reset by a later ``server_close()``."""
    ex = MetricsExporter(MetricsHub(), port=0, reuse_port=True, drain=True).start()
    srv = ex._srv
    try:
        srv.shutdown()
        assert srv.socket.fileno() == -1
    finally:
        ex.stop()


# --------------------------------------------------------- drain handoff

def _fab(tmp_path, **overrides):
    overrides.setdefault("replicas", 2)
    cfg = fabric.FabricConfig(poll_s=0.1, health_period_s=0.2, grace_s=10.0,
                              retry_pause_s=0.05, federation=False, device="cpu",
                              **overrides)
    return fabric.ServingFabric(str(tmp_path), cfg)


@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_handoff_spawn_failure_leaves_predecessor_serving(tmp_path):
    """``drain_handoff:fail@1``: the roll aborts typed, the predecessor
    never stopped serving, one process per replica id remains."""
    _seal(tmp_path, _docs())
    fab = _fab(tmp_path, replicas=1)
    fab.start()
    try:
        pid_before = fab._handles[0].pid
        with chaos.inject("drain_handoff:fail@1"):
            with pytest.raises(chaos.ChaosError):
                fab.rolling_restart(timeout=30.0)
        assert fab._handles[0].pid == pid_before
        scores, _ = fab.query(["node"])
        assert len(scores) > 0
        audit = fab.audit()
        assert audit["dropped"] == 0 and audit["double_served"] == 0
        assert audit["rolled"] == 0
    finally:
        fab.stop()


@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_rolling_restart_handoff_zero_roll_retries_under_load(tmp_path):
    """A roll under closed-loop load needs ZERO roll-attributed retries:
    the socket handoff carries it.  Ports stay pinned across the roll,
    every replica ends on a fresh pid, and the floor sits at the fleet's
    generation."""
    gen = _seal(tmp_path, _docs())
    fab = _fab(tmp_path)
    fab.start()
    try:
        pids_before = {i: h.pid for i, h in fab._handles.items()}
        ports_before = dict(fab._ports)
        stop = threading.Event()
        failures: list = []
        served = [0]

        def closed_loop():
            while not stop.is_set():
                try:
                    fab.query(["node", "graph"])
                    served[0] += 1
                except Exception as exc:  # noqa: BLE001 — recorded
                    failures.append(exc)

        t = threading.Thread(target=closed_loop, daemon=True)
        t.start()
        try:
            fab.rolling_restart(timeout=60.0)
        finally:
            stop.set()
            t.join(10.0)
        assert not failures and served[0] > 0
        audit = fab.audit()
        assert audit["roll_retries"] == 0
        assert audit["dropped"] == 0 and audit["double_served"] == 0
        assert audit["rolled"] == 2
        assert dict(fab._ports) == ports_before
        pids_after = {i: h.pid for i, h in fab._handles.items()}
        assert all(pids_after[i] != pids_before[i] for i in pids_before)
        assert fabric.read_floor(str(tmp_path)) == gen
        with urllib.request.urlopen(f"http://127.0.0.1:{ports_before[0]}/status",
                                    timeout=10) as r:
            assert json.loads(r.read())["pid"] == pids_after[0]
    finally:
        fab.stop()


@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_handoff_terms_the_predecessor_with_no_hop_in_flight(tmp_path, monkeypatch):
    """The predecessor's listener closes with whatever the kernel queued
    there: so the router routes around the id from before the TERM until
    the predecessor has exited, and TERMs it only once no hop to the id is
    in flight.  The id is back in rotation after the roll."""
    _seal(tmp_path, _docs())
    fab = _fab(tmp_path)
    fab.start()
    seen = []
    terminate = fabric.procs.ProcessHandle.terminate

    def spy(handle, *args, **kwargs):
        ids = [i for i, p in olds.items() if p == handle.pid]
        if ids:
            with fab._lock:
                seen.append((ids[0], ids[0] in fab._restarting, fab._inflight[ids[0]]))
        return terminate(handle, *args, **kwargs)

    try:
        olds = {i: h.pid for i, h in fab._handles.items()}
        monkeypatch.setattr(fabric.procs.ProcessHandle, "terminate", spy)
        stop = threading.Event()

        def closed_loop():
            while not stop.is_set():
                fab.query(["node", "graph"])

        t = threading.Thread(target=closed_loop, daemon=True)
        t.start()
        try:
            fab.rolling_restart(timeout=60.0)
        finally:
            stop.set()
            t.join(10.0)
        assert sorted(seen) == [(0, True, 0), (1, True, 0)]
        assert not fab._restarting and fab.audit()["roll_retries"] == 0
    finally:
        fab.stop()


@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_handoff_of_the_only_replica_holds_queries_for_the_drain(tmp_path, monkeypatch):
    """A one-replica fleet has no sibling to route around to: while its id
    is routed around for the predecessor's drain, queries wait for the
    drain instead of keeping a hop in flight, so the predecessor is TERMed
    with none in flight at once, not after a hop's timeout (10 s), and
    nothing is retried."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs

    _seal(tmp_path, _docs())
    fab = _fab(tmp_path, replicas=1)
    fab.start()
    seen = []
    terminate = fabric.procs.ProcessHandle.terminate

    def spy(handle, *args, **kwargs):
        if handle.pid == old_pid:
            with fab._lock:
                seen.append((0 in fab._restarting, fab._inflight[0]))
        return terminate(handle, *args, **kwargs)

    sink = obs.MemorySink()
    obs.bus().attach(sink)
    try:
        old_pid = fab._handles[0].pid
        monkeypatch.setattr(fabric.procs.ProcessHandle, "terminate", spy)
        stop = threading.Event()
        served = [0]

        def closed_loop():
            while not stop.is_set():
                fab.query(["node", "graph"])
                served[0] += 1

        t = threading.Thread(target=closed_loop, daemon=True)
        t.start()
        try:
            fab.rolling_restart(timeout=60.0)
            n = served[0]
            deadline = time.monotonic() + 10.0
            while served[0] == n and time.monotonic() < deadline:
                time.sleep(0.01)  # the held queries are served after the roll
        finally:
            stop.set()
            t.join(10.0)
        phases = {e["phase"]: e["t"] for e in sink.of_kind("fabric_handoff")}
        assert seen == [(True, 0)]
        assert phases["drain"] - phases["successor_ready"] < fab.cfg.request_timeout_s / 2
        assert served[0] > n and not fab._restarting
        audit = fab.audit()
        assert audit["roll_retries"] == 0 and audit["rolled"] == 1
        assert audit["dropped"] == 0 and audit["double_served"] == 0
    finally:
        obs.bus().detach(sink)
        fab.stop()


@pytest.mark.slow
@pytest.mark.skipif(not reuse_port_supported(), reason="platform lacks SO_REUSEPORT")
def test_handoff_rolls_under_sixteen_clients_reset_nothing(tmp_path):
    """Five handoff rolls under 16 closed-loop clients (about 40 s on the
    CPU): no connection is reset, so no retry is roll-attributed.  With the
    reference's exporter, whose draining listener closes only after
    ``shutdown()`` has returned, the kernel queues connections into the
    closing listener and they are reset."""
    _seal(tmp_path, _docs())
    fab = _fab(tmp_path)
    fab.start()
    try:
        words = _docs()[0].split()
        resets = []
        for _ in range(5):
            stop = threading.Event()

            def closed_loop(c):
                k = c
                while not stop.is_set():
                    fab.query([words[k % len(words)], words[(k * 7) % len(words)]])
                    k += 16

            threads = [threading.Thread(target=closed_loop, args=(c,), daemon=True)
                       for c in range(16)]
            for t in threads:
                t.start()
            before = fab.audit()["roll_retries"]
            try:
                fab.rolling_restart(timeout=60.0)
            finally:
                stop.set()
                for t in threads:
                    t.join(30.0)
            resets.append(fab.audit()["roll_retries"] - before)
        audit = fab.audit()
        assert resets == [0] * 5, f"roll retries per roll {resets}"
        assert audit["dropped"] == 0 and audit["double_served"] == 0
    finally:
        fab.stop()


def test_rolling_restart_without_handoff_still_rolls(tmp_path):
    """``handoff=False`` keeps the retry-carried roll working."""
    _seal(tmp_path, _docs())
    fab = _fab(tmp_path, handoff=False, peer_cache=False)
    fab.start()
    try:
        fab.rolling_restart(timeout=60.0)
        audit = fab.audit()
        assert audit["rolled"] == 2
        assert audit["dropped"] == 0 and audit["double_served"] == 0
        scores, _ = fab.query(["node"])
        assert len(scores) > 0
    finally:
        fab.stop()
