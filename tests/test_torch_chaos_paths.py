"""The port's guarded sites under fault injection, against the JAX
package's, on the CPU.

Each path runs through the JAX function and its port counterpart under the
same ``chaos.inject`` plan: the results agree (float64 within 1e-12, TF-IDF
DF and counts exactly, weights within the streaming tests' bar), the port's
faulted run equals its unfaulted run bit for bit, the ordered ``(event,
site, attempt)`` records of the fault events are equal, and the port visits
the sites the reference visits.  Then the ported chaos tests of
``tests/test_ingest_pipeline.py``, ``tests/test_serving.py`` and
``tests/test_segments.py``, and exhaustion: a lost device at a guarded
site raises ``ResilienceExhausted`` with the newest checkpoint, emits no
``degraded`` event, and a resume from that checkpoint gives the unbroken
run's bits.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import hits as jhits
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import ppr as jppr
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.models.pagerank import run_pagerank as jrun
from page_rank_and_tfidf_using_apache_spark_tpu.obs.federation import FleetHub as JFleetHub
from page_rank_and_tfidf_using_apache_spark_tpu.obs.metrics import MetricsHub as JMetricsHub
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted, obs, serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import bm25 as tbm25
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import hits as thits
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ingest as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr as tppr
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank as trun
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.federation import FleetHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder
from tests.test_torch_obs import HUB_ARGS, _Clock
from tests.test_torch_segments import _docs, _seal
from tests.test_torch_serving import QUERIES, _one_shot, make_server, oracle_index  # noqa: F401
from tests.test_torch_tfidf import check_float, ill_rows, ill_terms, oracle

TOL = 1e-12
FAULT_EVENTS = ("chaos", "retry", "backoff", "watchdog", "degraded", "exhausted")
PR_BASE = dict(iterations=20, dangling="redistribute", init="uniform", dtype="float64",
               head_row_width=8)


@pytest.fixture(autouse=True)
def short_backoff(monkeypatch):
    """Both packages read the backoff from the env: keep the tests quick."""
    monkeypatch.setenv("GRAFT_BACKOFF_BASE_S", "0.001")
    for k in ("GRAFT_CHAOS", "GRAFT_SYNC_DEADLINE_S", "GRAFT_STEP_DEADLINE_S",
              "GRAFT_RETRY_MAX"):
        monkeypatch.delenv(k, raising=False)


@contextlib.contextmanager
def recording(bus_owner):
    s = bus_owner.MemorySink()
    bus_owner.bus().attach(s)
    try:
        yield s
    finally:
        bus_owner.bus().detach(s)


def fault_records(sink) -> list:
    """The ordered ``(event, site, attempt)`` records of the fault events
    (a chaos event's attempt is its call number)."""
    return [(e["kind"], e.get("site"), e.get("attempt", e.get("call")))
            for e in sink.events if e["kind"] in FAULT_EVENTS]


def under_plan(spec: str, port_fn, jax_fn):
    """Run both packages under ``spec``: (port result, jax result, port
    records, jax records, port plan, jax plan)."""
    with recording(obs) as ps, chaos.inject(spec) as pplan:
        p = port_fn()
    with recording(jobs) as js, jchaos.inject(spec) as jplan:
        j = jax_fn()
    return p, j, fault_records(ps), fault_records(js), pplan, jplan


def counts(plan) -> dict:
    return dict(plan._counts)


# ------------------------------------------------- paths against the reference

@pytest.mark.parametrize("impl", ["segment", "pallas", "hybrid"])
def test_pagerank_under_chaos_matches_reference(impl, tmp_path):
    spec = "pagerank_step:fail@2;pagerank_ckpt_pull:fail@1"
    kw = dict(PR_BASE, spmv_impl=impl, checkpoint_every=5)
    tgr, jgr = tg.synthetic_powerlaw(120, 600, seed=11), jg.synthetic_powerlaw(120, 600, seed=11)
    clean = trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "c")),
                 device="cpu")
    p, j, prec, jrec, pplan, jplan = under_plan(
        spec,
        lambda: trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                     device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j"))))
    assert p.ranks.tobytes() == clean.ranks.tobytes()
    assert np.abs(p.ranks - np.asarray(j.ranks)).max() <= TOL
    assert p.iterations == j.iterations == 20
    assert prec == jrec and len(prec) == 6  # 2 × (chaos, retry, backoff)
    assert counts(pplan) == counts(jplan) == {
        "pagerank_step": 5, "pagerank_delta_sync": 4, "pagerank_ckpt_pull": 4,
        "pagerank_result_pull": 1}
    retries = [r for r in p.metrics.records if r.get("event") == "retry"]
    # the checkpoint at 5 comes before the second segment
    assert [(r["site"], r["attempt"]) for r in retries] == [
        ("pagerank_ckpt_pull", 1), ("pagerank_step", 1)]


@pytest.mark.parametrize("workload", ["hits", "ppr"])
def test_workloads_under_chaos_match_reference(workload, tmp_path):
    """HITS and PPR reach ``{prefix}_step``, ``_delta_sync``, ``_ckpt_pull``
    and ``_result_pull`` through run_single_chip_fixpoint."""
    spec = (f"{workload}_step:fail@2;{workload}_delta_sync:fail@%3;"
            f"{workload}_ckpt_pull:fail@1;{workload}_result_pull:fail@1")
    tgr, jgr = tg.synthetic_powerlaw(150, 700, seed=11), jg.synthetic_powerlaw(150, 700, seed=11)
    ck = dict(checkpoint_every=4)

    def run(pkg_cfg, mod, g, d, **kw):
        if workload == "hits":
            res = mod.run_hits(g, pkg_cfg.HitsConfig(iterations=14, tol=0.0, dtype="float64",
                                                     checkpoint_dir=d, **ck), **kw)
            return np.stack([np.asarray(res.hubs), np.asarray(res.authorities)])
        cfg = pkg_cfg.PageRankConfig(iterations=14, dangling="redistribute", init="uniform",
                                     dtype="float64", spmv_impl="pallas", checkpoint_dir=d,
                                     **ck)
        ids = g.node_ids
        queries = [[int(ids[0])], [int(ids[3]), int(ids[9])]]
        return np.asarray(mod.run_ppr_batch(g, cfg, queries, **kw).ranks)

    tmod, jmod = (thits, jhits) if workload == "hits" else (tppr, jppr)
    clean = run(tcfg, tmod, tgr, str(tmp_path / "c"), device="cpu")
    p, j, prec, jrec, pplan, jplan = under_plan(
        spec, lambda: run(tcfg, tmod, tgr, str(tmp_path / "p"), device="cpu"),
        lambda: run(jcfg, jmod, jgr, str(tmp_path / "j")))
    assert p.tobytes() == clean.tobytes()
    assert np.abs(p - j).max() <= TOL
    assert prec == jrec and prec
    assert counts(pplan) == counts(jplan)
    assert set(counts(pplan)) == {f"{workload}_{s}" for s in
                                  ("step", "delta_sync", "ckpt_pull", "result_pull")}


def test_streaming_tfidf_under_chaos_matches_reference():
    spec = "tfidf_chunk_sync:fail@%3"
    docs = tt.synthetic_corpus_lines(48, 12, 3)
    chunks = [docs[i:i + 4] for i in range(0, len(docs), 4)]
    kw = dict(vocab_bits=9, chunk_tokens=128)
    clean = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), device="cpu")
    m = MetricsRecorder()
    p, j, prec, jrec, pplan, jplan = under_plan(
        spec,
        lambda: tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), metrics=m,
                                       device="cpu"),
        lambda: jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(**kw)))
    for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"):
        assert getattr(p, f).tobytes() == getattr(clean, f).tobytes(), f
    for f in ("doc", "term", "count", "df", "doc_lengths"):
        a, b = getattr(p, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    c = tt.tokenize_corpus(docs, vocab_bits=9)
    cfg = tcfg.TfidfConfig(**kw)
    o = oracle(c, cfg.tf_mode, cfg.idf_mode, cfg.l2_normalize)
    ill = ill_terms(o["df"], c.n_docs, cfg.idf_mode)
    order = np.lexsort((p.doc, p.term))
    check_float("weight", p.weight[order], np.asarray(j.weight)[order], o["weight"],
                ill_rows(o, ill, cfg.l2_normalize))
    # 12 drains take 17 calls: calls 3, 6, 9, 12 and 15 fail and retry
    assert prec == jrec and len(prec) == 3 * 5
    assert set(counts(pplan)) == set(counts(jplan)) == {
        "ingest_h2d_put", "ingest_h2d_wait", "tfidf_chunk_sync", "tfidf_df_commit",
        "tfidf_finalize_sync"}
    assert pplan.call_count("tfidf_chunk_sync") == jplan.call_count("tfidf_chunk_sync") == 17
    assert sum(r.get("event") == "retry" for r in m.records) == 5


@pytest.mark.parametrize("site", ["bm25_weights_pull", "tfidf_batch_sync",
                                  "tfidf_finalize_sync", "tfidf_df_commit", "ingest_h2d_wait",
                                  "ingest_h2d_put"])
def test_tfidf_sites_retry_invisibly(site):
    """A transient fault at each remaining TF-IDF site retries with the
    unfaulted bits."""
    docs = tt.synthetic_corpus_lines(30, 10, 5)
    chunks = [docs[i:i + 5] for i in range(0, len(docs), 5)]
    cfg = tcfg.TfidfConfig(vocab_bits=9)

    def run():
        if site == "tfidf_batch_sync":
            out = tm.run_tfidf(docs, cfg, device="cpu")
        else:
            out = tm.run_tfidf_streaming(iter(chunks), cfg, device="cpu")
        return out, tbm25.bm25_from_tfidf(out)

    clean, clean_bm25 = run()
    with chaos.inject(f"{site}:fail@1") as plan:
        out, bm25 = run()
    assert plan.call_count(site) >= 2
    for f in ("doc", "term", "count", "weight", "df", "idf"):
        assert getattr(out, f).tobytes() == getattr(clean, f).tobytes(), f
    assert bm25.tobytes() == clean_bm25.tobytes()


def test_federation_scrape_under_chaos_matches_reference():
    """A partition at ``fed_scrape`` is one failed scrape, in both packages:
    the replica goes stale for that sweep and the next sweep reads it."""
    clk = _Clock(100.0)
    hub = JMetricsHub(clock=clk, **HUB_ARGS)
    hub.observe_request(0.01, ok=True)

    def fetch(url):
        return json.loads(json.dumps(hub.snapshot()))

    got = []
    for cls, mod in ((FleetHub, chaos), (JFleetHub, jchaos)):
        fleet = cls(scrape_s=1.0, clock=clk, fetch=fetch, **HUB_ARGS)
        fleet.register("0", "http://stub/0")
        with mod.inject("fed_scrape:net_partition@1") as plan:
            got.append((fleet.scrape_once(), fleet.scrape_once(), plan.call_count("fed_scrape")))
    assert got[0] == got[1] == ({"0": False}, {"0": True}, 2)


# ---------------------------------------------- exhaustion is not degradation

@pytest.mark.parametrize("spec, at", [
    ("pagerank_step:lost@3", 10),
    ("pagerank_delta_sync:lost@3", 10),
    ("pagerank_ckpt_pull:lost@2", 5),
    ("pagerank_result_pull:lost@1", 15),
])
def test_lost_device_exhausts_with_the_newest_checkpoint(spec, at, tmp_path):
    g = tg.synthetic_powerlaw(120, 600, seed=11)
    cfg = tcfg.PageRankConfig(**PR_BASE, checkpoint_every=5, checkpoint_dir=str(tmp_path))
    full = trun(g, tcfg.PageRankConfig(**PR_BASE), device="cpu")
    with recording(obs) as sink, chaos.inject(spec):
        with pytest.raises(ResilienceExhausted) as ei:
            trun(g, cfg, device="cpu")
    err = ei.value
    assert err.last_checkpoint and err.last_checkpoint.endswith(f"ckpt_{at:08d}.npz")
    assert err.last_checkpoint in str(err)
    assert sink.of_kind("exhausted") and not sink.of_kind("degraded")
    assert not any(e["kind"] == "retry" for e in sink.events)  # a loss is not retried
    res = trun(g, cfg, resume=True, device="cpu")
    assert res.ranks.tobytes() == full.ranks.tobytes()


@pytest.mark.parametrize("spec", ["tfidf_chunk_sync:lost@5", "tfidf_df_commit:lost@2"])
def test_streaming_lost_device_exhausts_then_resumes(spec, tmp_path):
    docs = tt.synthetic_corpus_lines(40, 10, 2)
    chunks = [docs[i:i + 4] for i in range(0, len(docs), 4)]
    kw = dict(vocab_bits=9, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    full = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=9), device="cpu")
    with recording(obs) as sink, chaos.inject(spec):
        with pytest.raises(ResilienceExhausted) as ei:
            tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), device="cpu")
    assert ei.value.last_checkpoint == ckpt.latest_checkpoint(str(tmp_path)) is not None
    assert sink.of_kind("exhausted") and not sink.of_kind("degraded")
    res = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), resume=True,
                                 device="cpu")
    assert res.to_dense().tobytes() == full.to_dense().tobytes()


def test_hits_lost_at_result_pull_exhausts(tmp_path):
    g = tg.synthetic_powerlaw(150, 700, seed=11)
    cfg = tcfg.HitsConfig(iterations=12, tol=0.0, dtype="float64", checkpoint_every=4,
                          checkpoint_dir=str(tmp_path))
    with recording(obs) as sink, chaos.inject("hits_result_pull:lost@1"):
        with pytest.raises(ResilienceExhausted) as ei:
            thits.run_hits(g, cfg, device="cpu")
    assert ei.value.site == "hits_result_pull"
    assert ei.value.last_checkpoint.endswith("ckpt_00000008.npz")
    assert not sink.of_kind("degraded")


# ------------------------------------ ingest (tests/test_ingest_pipeline.py)

def _chunks(n: int, per: int = 3) -> list:
    docs = tt.synthetic_corpus_lines(n * per, 10, 7)
    return [docs[i:i + per] for i in range(0, len(docs), per)]


def test_h2d_put_transient_faults_invisible():
    """Transient faults at ingest_h2d_put retry on the transfer thread and
    stay invisible to the caller."""
    chunks = _chunks(9)
    base = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=10), device="cpu")
    m = MetricsRecorder()
    with chaos.inject("ingest_h2d_put:fail@%3"):
        res = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=10), metrics=m,
                                     device="cpu")
    retries = [r for r in m.records if r.get("event") == "retry"
               and r.get("site") == dflow.H2D_PUT_SITE]
    assert len(retries) >= 2
    assert res.to_dense().tobytes() == base.to_dense().tobytes()


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_wait_site_retries_injections_but_not_iterator_failures(pipeline_depth):
    """Injected faults at ingest_h2d_wait retry (the hook fires before the
    pull); a stage failure whose message carries a transient marker comes
    out of the stateful iterator and propagates, its item staged once."""
    drained: list = []
    staged: list = []

    def stage(item):
        staged.append(item)
        if item == 4:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return item

    m = MetricsRecorder()
    with chaos.inject("ingest_h2d_wait:fail@%2"):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            dflow.chunked_ingest(
                range(8), stage=stage, launch=lambda s: s,
                drain=drained.append, commit=lambda: None,
                depth=2, pipeline_depth=pipeline_depth, metrics=m,
            )
    assert drained == list(range(len(drained))) and len(drained) <= 4
    assert staged.count(4) == 1
    retries = [r for r in m.records if r.get("event") == "retry"]
    assert retries and {r["site"] for r in retries} == {dflow.H2D_WAIT_SITE}


def test_wait_site_watchdog_never_drops_consumed_items(monkeypatch):
    """With GRAFT_SYNC_DEADLINE_S armed and a staging stage slower than the
    deadline, the wait site runs without the watchdog: an abandoned attempt
    blocked inside next() would lose the item it consumed."""
    monkeypatch.setenv("GRAFT_SYNC_DEADLINE_S", "0.2")
    for depth in (0, 2):
        drained: list = []

        def stage(item):
            time.sleep(0.3)  # slower than the armed deadline
            return item

        dflow.chunked_ingest(
            range(6), stage=stage, launch=lambda s: s,
            drain=drained.append, commit=lambda: None,
            depth=2, pipeline_depth=depth,
        )
        assert drained == list(range(6)), (depth, drained)


def test_staging_ring_claims_a_slot_no_call_holds(monkeypatch):
    """A call that has claimed a slot (a retry beside the attempt its
    watchdog abandoned) is skipped; with every slot held the ring grows.
    (No pinned memory on the CPU: the slots' buffers are stand-ins.)"""
    monkeypatch.setattr(dflow.torch, "empty", lambda *a, **k: object())
    ring = dflow.StagingRing("cpu", 2)
    ring._bufs, ring._events, ring._shape = [object(), object()], [None, None], (1, 4)
    i, *_ = ring._claim((1, 4))
    j, *_ = ring._claim((1, 4))
    k, bufs, events, busy = ring._claim((1, 4))
    assert (i, j, k) == (0, 1, 2) and len(events) == 3 and busy == {0, 1, 2}


# ---------------------- serving and segments (tests/test_serving.py, test_segments.py)

def test_chaos_transient_faults_are_invisible(oracle_index):
    """fail@%5 at serve_dispatch and fail@7 at serve_pull: the executor
    retries; every request succeeds and matches the clean run."""
    queries = [["node", f"w{i}"] for i in range(16)] + [["directed"]] * 2
    with make_server(oracle_index, top_k=3, cache_size=0, max_batch=2) as srv:
        clean = [srv.query(q) for q in queries]
    m = MetricsRecorder()
    with chaos.inject("serve_dispatch:fail@%5;serve_pull:fail@7") as plan:
        with serving.TfidfServer(oracle_index, serving.ServeConfig(
                top_k=3, cache_size=0, max_batch=2), metrics=m, device="cpu") as srv:
            # sequential queries: each is its own micro-batch, so the
            # schedule hits the same dispatches whatever the drain timing
            results = [srv.query(q, timeout=60.0) for q in queries]
            stats = srv.stats()
        assert plan.call_count("serve_dispatch") >= len(queries)
    assert stats["batch_errors"] == 0
    for (s, i), (cs, ci) in zip(results, clean):
        assert s.tobytes() == cs.tobytes() and i.tobytes() == ci.tobytes()
    sites = [r["site"] for r in m.records if r.get("event") == "retry"]
    assert sites.count("serve_dispatch") >= 3 and sites.count("serve_pull") == 1


def test_chaos_hard_fault_degrades_per_request(oracle_index):
    """A lost device at the dispatch site fails exactly the batch that hit
    it, with ResilienceExhausted; the queue keeps draining."""
    with chaos.inject("serve_dispatch:lost@1"):
        with make_server(oracle_index, top_k=3, cache_size=0, max_batch=2,
                         flush_ms=50.0) as srv:
            first = srv.submit(["node"])
            second = srv.submit(["graph"])
            with pytest.raises(ResilienceExhausted):
                first.result(60.0)
            with pytest.raises(ResilienceExhausted):
                second.result(60.0)  # same micro-batch: same fault
            scores, idx = srv.query(["directed", "graph"], timeout=60.0)
            stats = srv.stats()
    assert stats["batch_errors"] == 1
    assert scores.shape == (3,)
    qt, qw = srv.make_query(["directed", "graph"])
    es, ei = _one_shot(oracle_index, qt, qw, 3)
    assert scores.tobytes() == es.tobytes()


def test_warmup_fault_retries_invisibly(oracle_index):
    with chaos.inject("serve_warmup:fail@1") as plan:
        with make_server(oracle_index, top_k=3, max_batch=4) as srv:
            got = srv.query(["node", "graph"])
    assert plan.call_count("serve_warmup") >= 2
    with make_server(oracle_index, top_k=3, max_batch=4) as srv:
        want = srv.query(["node", "graph"])
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()


def test_merge_preserves_scores_and_merger_chaos_retry(tmp_path):
    """Merging segments changes no served bit, and a transient fault at the
    ``segment_merge`` site retries invisibly."""
    scfg = tcfg.TfidfConfig(vocab_bits=10)
    docs = _docs()
    third = max(len(docs) // 3, 1)
    o1, _ = _seal(tmp_path, docs[:third], scfg, 0)
    o2, _ = _seal(tmp_path, docs[third:2 * third], scfg, o1.n_docs)
    _seal(tmp_path, docs[2 * third:], scfg, o1.n_docs + o2.n_docs)
    segset = sgm.load_segment_set(str(tmp_path))
    assert len(segset.segments) == 3
    with make_server(segset, top_k=5, scoring="impacted") as srv:
        before = {tuple(q): srv.query(q) for q in QUERIES}
        merger = sgm.SegmentMerger(str(tmp_path), scfg, max_segments=1, device="cpu")
        with chaos.inject("segment_merge:fail@1") as plan:
            assert merger.merge_once()  # the injected fault retried inside
        assert plan.call_count("segment_merge") >= 2
        while merger.merge_once():
            pass
        m = sgm.latest_manifest(str(tmp_path))
        assert len(m.segments) == 1 and merger.merges >= 2
        srv.refresh_segments(sgm.load_segment_set(str(tmp_path)))
        for q in QUERIES:
            s, i = srv.query(q)
            bs, bi = before[tuple(q)]
            assert s.tobytes() == bs.tobytes() and i.tobytes() == bi.tobytes(), q
    live = {s.name for s in m.segments}
    on_disk = {p.name for p in (tmp_path / "segments").iterdir() if p.is_dir()}
    assert live <= on_disk
