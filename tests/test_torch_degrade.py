"""A lost device hands the run to the CPU: the port's single-device
degradation ladder against the JAX package's, on the CPU.

Each reference test of the ladder (``tests/test_resilience.py``,
``tests/test_dataflow.py``, ``tests/test_ingest_pipeline.py``) runs through
both packages under the same ``chaos.inject`` plan, the JAX package on its
CPU backend and the port with ``device="cpu"``, each package's
device-health registry reset around every case.  They must agree on the
ordered ``(event, site, ladder, salvage_iter | salvage_chunk,
rerun_iters | rerun_chunks)`` records of the ``degraded`` and ``exhausted``
events, on float64 results within 1e-12, and on streaming COO, counts and
DF exactly with weights within 2e-6.  A salvaged run of the port equals its
own ``device="cpu"``, ``resume=True`` run from the snapshot the salvage
took, bit for bit.  ``GRAFT_ELASTIC=0`` turns a loss the salvage would take
into ``ResilienceExhausted``.  Where the two packages part by design, the
port is held to its own records beside the reference's: its one ``cpu``
rung is the salvage, which takes only a lost device that names its index,
so a whole-backend ``lost`` (which the reference's per-segment ``cpu``
rung takes from the live carry) and a kernel's own fault (a sticky CUDA
error, a failed build) raise ``ResilienceExhausted`` with no ``degraded``
event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu import ResilienceExhausted as JExhausted
from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import components as jcc
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import hits as jhits
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import ppr as jppr
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.models.pagerank import run_pagerank as jrun
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import elastic as jelastic
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted, obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import components as tcc
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import hits as thits
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ingest as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr as tppr
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank as trun
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

TOL = 1e-12
WEIGHT_TOL = 2e-6
GRAPH_KW = dict(dangling="redistribute", init="uniform", dtype="float64")
LADDER_EVENTS = ("degraded", "exhausted")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """Quick backoff, no plan or deadline from the env, and both packages'
    health registries empty before and after every case."""
    monkeypatch.setenv("GRAFT_BACKOFF_BASE_S", "0.001")
    for k in ("GRAFT_CHAOS", "GRAFT_SYNC_DEADLINE_S", "GRAFT_STEP_DEADLINE_S",
              "GRAFT_RETRY_MAX", "GRAFT_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    elastic.reset_health()
    jelastic.reset_health()
    yield
    elastic.reset_health()
    jelastic.reset_health()


@contextlib.contextmanager
def recording(bus_owner):
    s = bus_owner.MemorySink()
    bus_owner.bus().attach(s)
    try:
        yield s
    finally:
        bus_owner.bus().detach(s)


def ladder_records(sink) -> list:
    """The ordered ``(event, site, ladder, salvage point, rerun span)``
    records of the ladder's events."""
    return [(e["kind"], e.get("site"), e.get("ladder"),
             e.get("salvage_iter", e.get("salvage_chunk")),
             e.get("rerun_iters", e.get("rerun_chunks")))
            for e in sink.events if e["kind"] in LADDER_EVENTS]


def under_plan(spec: str, port_fn, jax_fn):
    """Run both packages under ``spec``, each from an empty health registry:
    ``(port outcome, jax outcome, port records, jax records)``, where an
    outcome is the result or the ``ResilienceExhausted`` raised."""
    out = []
    for bus_owner, mod, health, fn, exhausted in (
            (obs, chaos, elastic, port_fn, ResilienceExhausted),
            (jobs, jchaos, jelastic, jax_fn, JExhausted)):
        health.reset_health()
        with recording(bus_owner) as sink, mod.inject(spec):
            try:
                res = fn()
            except exhausted as exc:
                res = exc
        out.append((res, ladder_records(sink)))
        health.reset_health()
    (p, prec), (j, jrec) = out
    return p, j, prec, jrec


def graphs(n: int, e: int, seed: int):
    return tg.synthetic_powerlaw(n, e, seed=seed), jg.synthetic_powerlaw(n, e, seed=seed)


def degraded_of(metrics) -> list:
    return [r for r in metrics.records if r.get("event") == "degraded"]


def cpu_resume_from(cfg, salvage_iter: int, src_dir, tmp_path, graph):
    """The port's ``device="cpu"`` run resumed from the checkpoint a salvage
    took at ``salvage_iter`` (from the initial ranks where it took none),
    in a directory that holds only that checkpoint."""
    d = tmp_path / f"resume-{salvage_iter}"
    d.mkdir()
    if salvage_iter:
        name = f"ckpt_{salvage_iter:08d}.npz"
        shutil.copy(os.path.join(src_dir, name), d / name)
        (d / "LATEST").write_text(name)
    res = trun(graph, dataclasses.replace(cfg, checkpoint_dir=str(d)), resume=True,
               device="cpu")
    start = [r["start_iter"] for r in res.metrics.records if r.get("event") == "resume"]
    assert start == ([salvage_iter] if salvage_iter else [])
    return res


# --------------------------------------------- PageRank (tests/test_resilience.py)

@pytest.mark.parametrize("spec, impl, every, at", [
    ("pagerank_step:lost@1+", "segment", 0, None),
    ("pagerank_step:lost@3", "segment", 4, 8),
    ("pagerank_step:lost@3", "pallas", 4, 8),
    ("pagerank_step:lost@3", "hybrid", 4, 8),
])
def test_pagerank_backend_loss_is_not_salvaged(spec, impl, every, at, tmp_path):
    """tests/test_resilience.py:269, where the two packages part by design:
    a whole-backend loss (``lost``, no device index) takes the reference's
    per-segment cpu rung, which pulls the live carry and runs the segment
    on the CPU.  The port has no such rung: it raises
    ``ResilienceExhausted`` at ``pagerank_step`` naming the newest
    checkpoint, with no ``degraded`` event and no segment run on the CPU
    after the loss, and a resume gives the unbroken ranks."""
    tgr, jgr = graphs(300, 1500, 5)
    kw = dict(iterations=16, checkpoint_every=every, spmv_impl=impl, **GRAPH_KW)
    d = {k: str(tmp_path / k) if every else None for k in "pj"}
    m = MetricsRecorder()
    p, j, prec, jrec = under_plan(
        spec,
        lambda: trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=d["p"]), metrics=m,
                     device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=d["j"])))
    assert jrec == [("degraded", "pagerank_step", "cpu", None, None)]  # the reference's rung
    assert prec == [("exhausted", "pagerank_step", None, None, None)]
    assert isinstance(p, ResilienceExhausted) and p.site == "pagerank_step"
    assert isinstance(p.last_error, chaos.DeviceLostError) and p.last_error.device is None
    segments = [r["iter"] for r in m.records if "l1_delta" in r]
    assert segments == ([4, 8] if every else [])
    assert not any("backend" in r for r in m.records)
    if at is None:
        assert p.last_checkpoint is None
        return
    assert ckpt.peek_meta(p.last_checkpoint)["step"] == at
    full = trun(tgr, tcfg.PageRankConfig(**dict(kw, checkpoint_every=0)), device="cpu")
    res = trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=d["p"]), resume=True,
               device="cpu")
    assert res.ranks.tobytes() == full.ranks.tobytes()
    assert np.abs(res.ranks - np.asarray(j.ranks)).max() <= TOL


@pytest.mark.parametrize("site, salvage_iter", [
    ("pagerank_delta_sync", 0), ("pagerank_ckpt_pull", 0), ("pagerank_result_pull", 8),
])
def test_pagerank_device_lost_at_pull_sites(site, salvage_iter, tmp_path):
    """tests/test_resilience.py:293: a loss that names its device, first
    surfacing at a pull, takes the salvage: the newest checkpoint, the
    uncommitted span re-run on the CPU.  The salvaged ranks equal a CPU run
    resumed from that checkpoint bit for bit."""
    tgr, jgr = graphs(800, 3200, 7)
    kw = dict(iterations=12, checkpoint_every=4, **GRAPH_KW)
    m = MetricsRecorder()
    p, j, prec, jrec = under_plan(
        f"{site}:device_lost@dev:0",
        lambda: trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                     metrics=m, device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j"))))
    assert prec == jrec
    salvage = [r for r in prec if r[0] == "degraded"]
    assert len(salvage) == 1 and salvage[0][2:4] == ("cpu", salvage_iter)
    assert p.iterations == j.iterations == 12
    assert np.abs(p.ranks - np.asarray(j.ranks)).max() <= TOL
    resumed = cpu_resume_from(tcfg.PageRankConfig(**kw), salvage_iter, tmp_path / "p",
                              tmp_path, tgr)
    assert p.ranks.tobytes() == resumed.ranks.tobytes()
    if site != "pagerank_result_pull":  # every later segment ran on the CPU
        at = next(i for i, r in enumerate(m.records) if r.get("event") == "degraded")
        later = [r for r in m.records[at:] if "l1_delta" in r]
        assert later and all(r.get("backend") == "cpu" for r in later)


def test_pagerank_device_lost_resumed_at_the_step(tmp_path):
    """A loss at the first dispatch of a run resumed from checkpoint 8: the
    salvage reloads 8, re-runs 4 on the CPU and finishes there; the
    checkpoint written after it carries ``backend: "cpu"``."""
    tgr, jgr = graphs(800, 3200, 7)
    kw = dict(iterations=16, checkpoint_every=4, **GRAPH_KW)
    for d, run, cfgm in ((tmp_path / "p", lambda c: trun(tgr, c, device="cpu"), tcfg),
                         (tmp_path / "j", lambda c: jrun(jgr, c), jcfg)):
        run(cfgm.PageRankConfig(**dict(kw, iterations=9), checkpoint_dir=str(d)))
    shutil.copytree(tmp_path / "p", tmp_path / "at-loss")
    p, j, prec, jrec = under_plan(
        "pagerank_step:device_lost@dev:0",
        lambda: trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                     resume=True, device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")),
                     resume=True))
    assert prec == jrec == [("degraded", "pagerank_step", "cpu", 8, 4)]
    assert np.abs(p.ranks - np.asarray(j.ranks)).max() <= TOL
    resumed = trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "at-loss")),
                   resume=True, device="cpu")
    assert p.ranks.tobytes() == resumed.ranks.tobytes()
    assert ckpt.peek_meta(str(tmp_path / "p" / "ckpt_00000008.npz"))["extra"] == {}
    assert ckpt.peek_meta(str(tmp_path / "p" / "ckpt_00000012.npz"))["extra"] == {
        "backend": "cpu"}


def test_pagerank_device_lost_without_checkpoint(tmp_path):
    """tests/test_resilience.py:317: no checkpoint directory, so the salvage
    re-runs the whole span from the initial ranks."""
    tgr, jgr = graphs(500, 2000, 3)
    kw = dict(iterations=8, **GRAPH_KW)
    p, j, prec, jrec = under_plan(
        "pagerank_delta_sync:device_lost@dev:0",
        lambda: trun(tgr, tcfg.PageRankConfig(**kw), device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw)))
    assert prec == jrec
    assert [r for r in prec if r[0] == "degraded"] == [
        ("degraded", "pagerank_step", "cpu", 0, 8)]
    assert np.abs(p.ranks - np.asarray(j.ranks)).max() <= TOL
    assert p.ranks.tobytes() == trun(tgr, tcfg.PageRankConfig(**kw), device="cpu").ranks.tobytes()


def test_pagerank_exhausted_resumes_from_checkpoint(tmp_path):
    """tests/test_resilience.py:332: the reference's cpu rung takes the
    loss and then loses its own pull, so it exhausts after one
    ``degraded`` event; the port, with no such rung, exhausts at the step
    with none.  Both name checkpoint 8, and a resume gives the unbroken
    ranks."""
    tgr, jgr = graphs(800, 3200, 7)
    kw = dict(iterations=12, checkpoint_every=4, **GRAPH_KW)
    p, j, prec, jrec = under_plan(
        "pagerank_step:lost@3+;pagerank_cpu_pull:lost@1+",
        lambda: trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                     device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j"))))
    assert jrec == [("degraded", "pagerank_step", "cpu", None, None),
                    ("exhausted", "pagerank_cpu_pull", None, None, None),
                    ("exhausted", "pagerank_step", None, None, None)]
    assert prec == [("exhausted", "pagerank_step", None, None, None)]
    assert isinstance(p, ResilienceExhausted) and isinstance(j, JExhausted)
    assert ckpt.peek_meta(p.last_checkpoint)["step"] == 8
    assert ckpt.peek_meta(j.last_checkpoint)["step"] == 8
    cfg = tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p"))
    res = trun(tgr, cfg, resume=True, device="cpu")
    full = trun(tgr, tcfg.PageRankConfig(**dict(kw, checkpoint_every=0)), device="cpu")
    assert res.ranks.tobytes() == full.ranks.tobytes()


# ------------------------------------- the workloads (tests/test_dataflow.py)

@pytest.mark.parametrize("workload, site", [
    ("ppr", "ppr_delta_sync"), ("ppr", "ppr_result_pull"),
    ("hits", "hits_delta_sync"), ("cc", "cc_delta_sync"),
])
def test_workloads_inherit_the_salvage(workload, site, tmp_path):
    """tests/test_dataflow.py:272: PPR, HITS and components take the same
    salvage through run_single_chip_fixpoint."""
    tgr, jgr = graphs(300, 1200, 17)
    queries = [[int(tgr.node_ids[0])], [int(tgr.node_ids[5])]]

    def run(pkg_cfg, ppr, hits, cc, g, **kw):
        if workload == "ppr":
            cfg = pkg_cfg.PageRankConfig(iterations=20, **GRAPH_KW)
            return np.asarray(ppr.run_ppr_batch(g, cfg, queries, **kw).ranks)
        if workload == "hits":
            res = hits.run_hits(g, pkg_cfg.HitsConfig(iterations=30, tol=0.0, dtype="float64"),
                                **kw)
            return np.stack([np.asarray(res.hubs), np.asarray(res.authorities)])
        return np.asarray(cc.run_components(g, pkg_cfg.ComponentsConfig(), **kw).labels)

    p, j, prec, jrec = under_plan(
        f"{site}:device_lost@dev:0",
        lambda: run(tcfg, tppr, thits, tcc, tgr, device="cpu"),
        lambda: run(jcfg, jppr, jhits, jcc, jgr))
    assert prec == jrec
    assert [r[:3] for r in prec if r[0] == "degraded"] == [
        ("degraded", site if site.endswith("result_pull") else f"{workload}_step", "cpu")]
    clean = run(tcfg, tppr, thits, tcc, tgr, device="cpu")
    assert p.tobytes() == clean.tobytes()
    if workload == "cc":
        assert np.array_equal(p, j)
    else:
        assert np.abs(p - j).max() <= TOL


# ------------------------------ streaming (tests/test_ingest_pipeline.py)

def _chunks(n_chunks: int, docs_per_chunk: int = 2) -> list:
    docs = [f"tok{i} tok{i % 5} shared word extra{i % 3}"
            for i in range(n_chunks * docs_per_chunk)]
    return [docs[i:i + docs_per_chunk] for i in range(0, len(docs), docs_per_chunk)]


@pytest.mark.parametrize("spec, n_chunks, every", [
    ("ingest_h2d_put:device_lost@dev:0", 12, 4),
    ("ingest_h2d_wait:device_lost@dev:0", 14, 3),
    ("tfidf_chunk_sync:device_lost@dev:0", 14, 3),
    ("tfidf_df_commit:device_lost@dev:0", 14, 3),
])
def test_streaming_rolls_back_and_replays_on_the_cpu(spec, n_chunks, every, tmp_path):
    """tests/test_ingest_pipeline.py:279 and :300: a loss anywhere in the
    staged pipeline rolls back to the last commit and replays the rest on
    the CPU; one ``degraded`` event at the failing stage's site."""
    chunks = _chunks(n_chunks)
    kw = dict(vocab_bits=10, prefetch=2, pipeline_depth=2, checkpoint_every=every)
    clean = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=10), device="cpu")
    m = MetricsRecorder()
    p, j, prec, jrec = under_plan(
        spec,
        lambda: tm.run_tfidf_streaming(
            iter(chunks), tcfg.TfidfConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
            metrics=m, device="cpu"),
        lambda: jm.run_tfidf_streaming(
            iter(chunks), jcfg.TfidfConfig(**kw, checkpoint_dir=str(tmp_path / "j"))))
    assert prec == jrec
    assert len([r for r in prec if r[0] == "degraded"]) == 1
    assert [r["ladder"] for r in degraded_of(m)] == ["cpu"]
    for f in ("doc", "term", "count", "df", "doc_lengths"):
        a, b = getattr(p, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert np.abs(p.weight - np.asarray(j.weight)).max() <= WEIGHT_TOL
    for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"):
        assert getattr(p, f).tobytes() == getattr(clean, f).tobytes(), f


def test_streaming_loss_after_a_commit_rolls_back_to_it(tmp_path):
    """A loss that lands after a commit: eight chunks, a checkpoint every
    4 (with two launches in flight the barrier drains to chunk 6 and
    snapshots there), then the whole stream resumed from that snapshot
    loses the device at its next commit (chunk 12).  The commit's own
    ladder exhausts, the pipeline's recovery point takes the loss (the
    barrier left nothing in flight, so its stage is ``wait``), the host
    parts are truncated back to chunk 6 and the six retained chunks replay
    on the CPU, in both packages; the output is the unbroken stream's."""
    chunks = _chunks(14)
    kw = dict(vocab_bits=10, prefetch=2, pipeline_depth=2, checkpoint_every=4)
    clean = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=10), device="cpu")
    cfgs = {"p": tcfg.TfidfConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
            "j": jcfg.TfidfConfig(**kw, checkpoint_dir=str(tmp_path / "j"))}
    tm.run_tfidf_streaming(iter(chunks[:8]), cfgs["p"], device="cpu")
    jm.run_tfidf_streaming(iter(chunks[:8]), cfgs["j"])
    m = MetricsRecorder()
    p, j, prec, jrec = under_plan(
        "tfidf_df_commit:device_lost@dev:0",
        lambda: tm.run_tfidf_streaming(iter(chunks), cfgs["p"], metrics=m, resume=True,
                                       device="cpu"),
        lambda: jm.run_tfidf_streaming(iter(chunks), cfgs["j"], resume=True))
    assert prec == jrec == [("exhausted", "tfidf_df_commit", None, None, None),
                            ("degraded", "ingest_h2d_wait", "cpu", 6, 6)]
    assert [r["salvage_chunk"] for r in degraded_of(m)] == [6]
    for f in ("doc", "term", "count", "df", "doc_lengths"):
        assert getattr(p, f).tobytes() == np.asarray(getattr(j, f)).tobytes(), f
    assert np.abs(p.weight - np.asarray(j.weight)).max() <= WEIGHT_TOL
    for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"):
        assert getattr(p, f).tobytes() == getattr(clean, f).tobytes(), f


def test_streaming_commit_barrier_without_checkpoints():
    """With checkpointing off a commit (no snapshot file) still comes every
    ``_RETAIN_COMMIT_EVERY`` chunks, as in the reference, so a loss replays
    at most that many chunks; the output is unchanged."""
    chunks = _chunks(2 * tm._RETAIN_COMMIT_EVERY + 3)
    kw = dict(vocab_bits=10, prefetch=2, pipeline_depth=2)
    clean = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=10, prefetch=0,
                                                                  pipeline_depth=0),
                                   device="cpu")
    with recording(obs) as ps:
        p = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), device="cpu")
    with recording(jobs) as js:
        jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(**kw))
    commits = [e["chunks"] for e in ps.events if e["kind"] == "ingest_commit"]
    assert commits == [e["chunks"] for e in js.events if e["kind"] == "ingest_commit"]
    assert len(commits) == 3 and commits[0] >= tm._RETAIN_COMMIT_EVERY
    assert tm._RETAIN_COMMIT_EVERY == jm._RETAIN_COMMIT_EVERY
    assert p.to_dense().tobytes() == clean.to_dense().tobytes()


# ----------------------------------------------------------- GRAFT_ELASTIC=0

@pytest.mark.parametrize("spec", ["pagerank_ckpt_pull:device_lost@dev:0",
                                  "pagerank_result_pull:device_lost@dev:0"])
def test_elastic_off_exhausts(spec, tmp_path, monkeypatch):
    """With ``GRAFT_ELASTIC=0`` a loss the salvage would take raises
    ``ResilienceExhausted`` with no ``degraded`` event, in both packages."""
    monkeypatch.setenv("GRAFT_ELASTIC", "0")
    tgr, jgr = graphs(800, 3200, 7)
    kw = dict(iterations=12, checkpoint_every=4, **GRAPH_KW)
    p, j, prec, jrec = under_plan(
        spec,
        lambda: trun(tgr, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                     device="cpu"),
        lambda: jrun(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j"))))
    assert isinstance(p, ResilienceExhausted) and isinstance(j, JExhausted)
    assert prec == jrec and prec and all(r[0] == "exhausted" for r in prec)
    assert elastic.unwrap_device_loss(p).device == 0


def test_elastic_off_stream_raises(tmp_path, monkeypatch):
    """The stream's rollback is off too: the loss reaches the caller as it
    was raised, in both packages, and the last checkpoint stays."""
    monkeypatch.setenv("GRAFT_ELASTIC", "0")
    kw = dict(vocab_bits=10, prefetch=2, pipeline_depth=2, checkpoint_every=4)
    for mod, cm, inject, lost, tag in (
            (tm, tcfg, chaos.inject, chaos.DeviceLostError, "p"),
            (jm, jcfg, jchaos.inject, jchaos.DeviceLostError, "j")):
        cfg = cm.TfidfConfig(**kw, checkpoint_dir=str(tmp_path / tag))
        extra = {"device": "cpu"} if mod is tm else {}
        with inject("tfidf_chunk_sync:device_lost@dev:0;ingest_h2d_put:fail@1"):
            with pytest.raises((lost, ResilienceExhausted, JExhausted)) as ei:
                mod.run_tfidf_streaming(iter(_chunks(12)), cfg, **extra)
        assert type(ei.value).__name__ == "ResilienceExhausted", tag


# ------------------------------------------ a kernel's fault is not a loss

KERNEL_FAULTS = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("nvcc segment.cu exited 1:\nsegment.cu(12): error: identifier undefined"),
]


@pytest.mark.parametrize("fault", KERNEL_FAULTS, ids=["sticky", "build"])
def test_cpu_rungs_do_not_take_a_kernel_fault(fault, tmp_path, monkeypatch):
    """A runner that fails with a kernel's own error at ``pagerank_step``
    exhausts naming the newest checkpoint, with no ``degraded`` event: no
    rung runs the plain versions in the kernel's place.  (The reference's
    cpu rung takes any error that is not transient.)"""
    real = tops.make_pagerank_runner
    calls = []

    def faulty(n, cfg):
        run = real(n, cfg)

        def step(dg, ranks, e):
            calls.append(ranks.device.type)
            if len(calls) == 2:
                raise fault
            return run(dg, ranks, e)

        return step

    monkeypatch.setattr(tops, "make_pagerank_runner", faulty)
    g = tg.synthetic_powerlaw(200, 900, seed=5)
    cfg = tcfg.PageRankConfig(iterations=12, checkpoint_every=4,
                              checkpoint_dir=str(tmp_path), **GRAPH_KW)
    with recording(obs) as sink:
        with pytest.raises(ResilienceExhausted) as ei:
            trun(g, cfg, device="cpu")
    assert ei.value.last_error is fault and ei.value.site == "pagerank_step"
    assert ei.value.last_checkpoint.endswith("ckpt_00000004.npz")
    assert ladder_records(sink) == [("exhausted", "pagerank_step", None, None, None)]
    assert calls == ["cpu", "cpu"] and not elastic.health().lost()


def test_workload_rungs_do_not_take_a_kernel_fault(monkeypatch):
    """The same for the workloads' shared driver: a HITS runner's fault
    inside the segment."""
    real = thits.make_hits_runner

    def faulty(n, cfg):
        run = real(n, cfg)

        def step(g, hd):
            out, iters, _ = run(g, hd)
            raise RuntimeError("CUDA error: unspecified launch failure")

        return step

    monkeypatch.setattr(thits, "make_hits_runner", faulty)
    g = tg.synthetic_powerlaw(200, 900, seed=5)
    with recording(obs) as sink:
        with pytest.raises(ResilienceExhausted):
            thits.run_hits(g, tcfg.HitsConfig(iterations=8, tol=0.0), device="cpu")
    assert ladder_records(sink) == [("exhausted", "hits_step", None, None, None)]


def test_is_loss_classification():
    """What the rungs take: an injected loss, the reference's markers, and
    either inside ``ResilienceExhausted``; never a sticky CUDA error."""
    lost = chaos.DeviceLostError("x", device=2)
    wrapped = ResilienceExhausted("s", 1, lost, None)
    assert elastic.unwrap_device_loss(wrapped) is lost
    assert elastic.device_index(elastic.unwrap_device_loss(wrapped)) == 2
    assert elastic.is_device_loss(RuntimeError("PJRT: DEVICE_LOST on TPU_0"))
    assert elastic.device_index(chaos.DeviceLostError("whole backend")) is None
    for fault in KERNEL_FAULTS:
        assert elastic.unwrap_device_loss(fault) is None
        assert elastic.unwrap_device_loss(ResilienceExhausted("s", 1, fault, None)) is None
    for msg in ("x", "device lost", "device is lost", "PJRT: DEVICE_LOST",
                "CUDA error: an illegal memory access was encountered"):
        assert elastic.is_device_loss(RuntimeError(msg)) == jelastic.is_device_loss(
            RuntimeError(msg)), msg


def test_health_registry_matches_reference():
    h, jh = elastic.DeviceHealth(), jelastic.DeviceHealth()
    for reg in (h, jh):
        assert reg.mark_lost(1) and not reg.mark_lost(1) and reg.is_lost(1)
    assert h.lost() == jh.lost() == frozenset({1})
    h.reset()
    assert not h.lost()
    assert dflow.H2D_PUT_SITE == "ingest_h2d_put"
