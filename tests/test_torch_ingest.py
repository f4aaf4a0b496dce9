"""The port's staged ingest pipeline (``dataflow/ingest.py``) on the CPU,
against the JAX package's where the two compute the same thing.

Ported from ``tests/test_ingest_pipeline.py`` with plain callables: the
``Prefetched`` poison/close protocol (traceback, close, abandonment, and
the bound on every join), ``pack_doc_chunks`` order and determinism,
``overlap_fraction``, ``IngestConfig``, the capacity policy and its pad
plan, and ``chunked_ingest``'s recovery contract (the wait-site
redelivery tests, with a ``recover`` hook).  Every join and wait in these
tests has a bound.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import ingest as jflow
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.metrics import MetricsRecorder as JRecorder
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ingest as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import IngestConfig, TfidfConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder


def frames_of(exc: BaseException) -> list[str]:
    out, tb = [], exc.__traceback__
    while tb is not None:
        out.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    return out


def wait_until(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# ------------------------------------------------------------- Prefetched

def test_prefetched_producer_exception_keeps_traceback():
    def bad_source():
        yield 1
        raise ValueError("boom at item 2")

    it = dflow.prefetched(bad_source(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom at item 2") as ei:
        list(it)
    assert "bad_source" in frames_of(ei.value)


def test_prefetched_close_unblocks_full_queue_and_keeps_items():
    """close() stops a producer blocked on a full queue at once, and every
    item produced but not consumed (the one in hand too) is in leftover()."""
    produced: list[int] = []

    def source():
        for i in range(100):
            produced.append(i)
            yield i

    pf = dflow.Prefetched(source(), depth=2)
    assert next(pf) == 0
    assert wait_until(lambda: len(produced) >= 4)  # queue full, producer blocked
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 2.0
    assert not pf.thread.is_alive()
    left = pf.leftover()
    assert left == produced[1:] and len(left) >= 2


def test_prefetched_generator_abandonment_stops_producer():
    gen = dflow.prefetched(iter(range(1000)), depth=1)
    assert next(gen) == 0
    producers = [t for t in threading.enumerate() if t.name == "ingest-source"]
    gen.close()
    assert all(wait_until(lambda t=t: not t.is_alive()) for t in producers)


def test_prefetched_end_to_end_order():
    assert list(dflow.prefetched(iter(range(50)), depth=3)) == list(range(50))


def test_prefetched_join_is_bounded():
    """A producer that does not stop (here: stuck in its source) is
    reported, not waited on for ever."""
    release = threading.Event()

    def stuck():
        yield 0
        release.wait(10.0)
        yield 1

    pf = dflow.Prefetched(stuck(), depth=1, join_timeout=0.3)
    assert next(pf) == 0
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not stop within 0.3 s"):
        pf.close()
    assert time.perf_counter() - t0 < 2.0
    release.set()
    pf.thread.join(5.0)
    assert not pf.thread.is_alive()


# --------------------------------------------------------- pack, estimate

def test_pack_doc_chunks_fills_target_and_preserves_order():
    docs = [f"w{i} " * (i % 7 + 1) for i in range(40)]  # 1..7 tokens each
    chunks = [docs[i:i + 3] for i in range(0, len(docs), 3)]
    packed = list(dflow.pack_doc_chunks(iter(chunks), target_tokens=20))
    assert [d for c in packed for d in c] == docs
    for c in packed[:-1]:
        assert sum(dflow.estimate_tokens(d) for d in c) <= 20
    assert packed == list(jflow.pack_doc_chunks(iter(chunks), target_tokens=20))


def test_pack_doc_chunks_deterministic():
    docs = [f"a{i} b c" for i in range(30)]
    chunks = [docs[i:i + 4] for i in range(0, len(docs), 4)]
    assert list(dflow.pack_doc_chunks(iter(chunks), 10)) == \
        list(dflow.pack_doc_chunks(iter(chunks), 10))


def test_estimate_tokens_matches_reference_on_a_corpus():
    docs = tt.synthetic_corpus_lines(300, 40, 4) + [chr(c) * 3 + " z" for c in range(1, 600)]
    assert [dflow.estimate_tokens(d) for d in docs] == [jflow.estimate_tokens(d) for d in docs]


def test_pack_doc_chunks_oversized_doc_gets_own_chunk():
    docs = ["small doc", "x " * 200, "tiny"]
    packed = list(dflow.pack_doc_chunks(iter([docs]), 10))
    assert ["x " * 200] in [c for c in packed if len(c) == 1]
    assert [d for c in packed for d in c] == docs


@pytest.mark.parametrize("doc", ["a,b,c,d", "x\ny\nz", "one two", "a--b__c", "", "Ünï cödé 42",
                                 "é42é", "\x0b\x0ca\tb\r\nc", "日本語 text, 2 runs\x00x", "\ud800ab"])
@pytest.mark.parametrize("ngram", [1, 2])
def test_estimators_bound_the_tokenizer_and_match_reference(doc, ngram):
    est = dflow.ngram_estimator(ngram)
    assert est(doc) == jflow.ngram_estimator(ngram)(doc)
    assert est(doc) >= len(tt.add_ngrams(tt.tokenize(doc), ngram))
    assert (est is dflow.estimate_tokens) == (ngram == 1)


# --------------------------------------------------------- overlap, config

@pytest.mark.parametrize("h2d, compute, want", [
    ([(0, 2)], [(0, 4)], 1.0),
    ([(3, 5)], [(0, 4)], 0.5),
    ([(10, 12)], [(0, 4)], 0.0),
    ([], [(0, 4)], 0.0),
    ([(0, 4)], [(0, 2), (1, 3)], 0.75),
    ([(0, 1), (2, 3), (5, 9)], [(0.5, 2.5), (6, 7)], 2 / 6),
])
def test_overlap_fraction_matches_reference(h2d, compute, want):
    got = dflow.overlap_fraction(h2d, compute)
    assert got == pytest.approx(want) and got == jflow.overlap_fraction(h2d, compute)


@pytest.mark.parametrize("kw", [{}, {"prefetch": 0}, {"pipeline_depth": 5},
                                {"prefetch": -1}, {"pipeline_depth": -1}])
def test_ingest_config_matches_reference(kw):
    try:
        want = jcfg.IngestConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            IngestConfig(**kw)
        assert str(te.value) == str(e)
        return
    got = IngestConfig(**kw)
    assert (got.prefetch, got.pipeline_depth) == (want.prefetch, want.pipeline_depth)
    assert TfidfConfig(prefetch=1, pipeline_depth=3).ingest() == IngestConfig(1, 3)


@pytest.mark.parametrize("needs, cap0, min_bits", [
    ([100, 900, 3000, 70000], 0, 10),
    ([5, 3, 9], 0, 0),
    ([2048, 2049, 1, 10_000], 1024, 10),
    ([0], 0, 10),
])
def test_grow_chunk_cap_records_match_reference(needs, cap0, min_bits):
    m, jmr = MetricsRecorder(), JRecorder()
    cap, jcap = cap0, cap0
    for i, need in enumerate(needs):
        cap, changed = dflow.grow_chunk_cap(need, cap, m, min_bits=min_bits, chunk=i)
        jcap, jchanged = jflow.grow_chunk_cap(need, jcap, jmr, min_bits=min_bits, chunk=i)
        assert (cap, changed) == (jcap, jchanged)
    assert m.records == jmr.records
    assert tm.grow_chunk_cap is dflow.grow_chunk_cap


@pytest.mark.parametrize("counts, cap", [([100, 900, 3000], 0), ([1000] * 5, 1024),
                                         ([], 0), ([7, 70_000, 3], 0)])
def test_stream_pad_plan_matches_reference(counts, cap):
    assert tm.stream_pad_plan(counts, cap) == jm.stream_pad_plan(counts, cap)


# ----------------------------------------------------- the staging ring

def test_staging_ring_on_the_cpu_pads_with_zeros():
    ring = dflow.StagingRing("cpu", 3)
    t, event = ring.stage((np.array([5, 6], np.int32), np.array([7], np.int32)), 4)
    assert event is None and t.dtype == torch.int32
    assert t.tolist() == [[5, 6, 0, 0], [7, 0, 0, 0]]
    assert dflow.StagingRing.consume(t, None) is t


# ------------------------------------------------------- chunked_ingest

def test_commit_barrier_drains_then_commits_then_saves():
    order: list[str] = []
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    try:
        fixpoint.commit_barrier(lambda: order.append("drain"), lambda: order.append("commit"),
                                lambda: order.append("save"))
        fixpoint.commit_barrier(lambda: order.append("drain"), lambda: order.append("commit"))
    finally:
        obs.bus().detach(sink)
    assert order == ["drain", "commit", "save", "drain", "commit"]
    assert [e["name"] for e in sink.of_kind("span_end")] == ["ingest.commit_barrier"] * 2


@pytest.mark.parametrize("depth, pipeline_depth", [(0, 0), (2, 0), (2, 2), (3, 1)])
def test_checkpoints_only_see_drained_state(depth, pipeline_depth):
    """A commit runs with nothing in flight, however deep the pipeline."""
    launched: list[int] = []
    drained: list[int] = []
    commits: list[tuple[int, int]] = []
    m = MetricsRecorder()
    dflow.chunked_ingest(
        range(10), stage=lambda it: it, launch=lambda s: (launched.append(s), s)[1],
        drain=drained.append, commit=lambda: commits.append((len(launched), len(drained))),
        depth=depth, pipeline_depth=pipeline_depth,
        checkpoint_due=lambda: len(drained) % 3 == 0 and len(drained) > 0,
        save_checkpoint=lambda: None, metrics=m,
    )
    assert drained == list(range(10))
    assert all(a == b for a, b in commits) and commits[-1] == (10, 10)
    rec = [r for r in m.records if r["event"] == "ingest_overlap"]
    assert len(rec) == 1 and rec[0]["chunks"] == 10
    assert (rec[0]["depth"], rec[0]["pipeline_depth"]) == (depth, pipeline_depth)


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_wait_site_does_not_retry_iterator_failures(pipeline_depth):
    """A stage failure, whatever its message, propagates: the run does not
    complete as if successful, and what drained is a contiguous prefix
    before the casualty."""
    drained: list = []

    def stage(item):
        if item == 4:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return item

    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        dflow.chunked_ingest(
            range(8), stage=stage, launch=lambda s: s,
            drain=drained.append, commit=lambda: None,
            depth=2, pipeline_depth=pipeline_depth,
        )
    assert drained == list(range(len(drained))) and len(drained) <= 4


def test_wait_site_recovery_redelivers_after_marker_failure():
    """With a recover hook every unprocessed item, the casualty too, is
    re-delivered once: no truncation, no double drain."""
    fail = {"armed": True}
    drained: list = []
    seen: list = []

    def stage(item):
        if item == 4 and fail["armed"]:
            fail["armed"] = False
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return item

    def recover(exc, remaining, where):
        assert where == "stage" and "RESOURCE_EXHAUSTED" in str(exc)
        seen.append(sorted(remaining))
        return seen[-1]

    dflow.chunked_ingest(
        iter(range(8)), stage=stage, launch=lambda s: s,
        drain=drained.append, commit=lambda: None,
        depth=2, pipeline_depth=2, recover=recover,
    )
    assert len(seen) == 1 and 4 in seen[0]
    assert sorted(drained) == list(range(8))
    assert drained[:len(drained) - len(seen[0])] == list(range(8 - len(seen[0])))


@pytest.mark.parametrize("where", ["launch", "drain"])
def test_recovery_redelivers_launch_and_drain_casualties(where):
    """A launch or drain fault with chunks retained until commit: the hook
    sees the failed stage, and every item is drained exactly once."""
    fail = {"armed": True}
    drained: list = []
    calls: list = []

    def maybe_fail(item):
        if item == 5 and fail["armed"]:
            fail["armed"] = False
            raise RuntimeError(f"{where} fault")

    def launch(s):
        if where == "launch":
            maybe_fail(s)
        return s

    def drain(rec):
        if where == "drain":
            maybe_fail(rec)
        drained.append(rec)

    def recover(exc, remaining, w):
        calls.append(w)
        del drained[committed[-1]:]  # roll back to the last commit
        return remaining

    committed = [0]
    dflow.chunked_ingest(
        range(9), stage=lambda it: it, launch=launch, drain=drain,
        commit=lambda: committed.append(len(drained)), depth=2, pipeline_depth=1,
        checkpoint_due=lambda: len(drained) == 3, save_checkpoint=lambda: None,
        recover=recover, retain_until_commit=True,
    )
    assert calls == [where]
    assert drained == list(range(9))


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_swept_source_exception_fails_recovery_replay(pipeline_depth):
    """A source exception the consumer never saw (it died on a drain fault
    first) re-surfaces in the replay at its stream position."""
    drained: list = []
    recovered: list = []

    def source():
        yield from range(4)
        raise ValueError("corrupt input past doc 3")

    armed = {"on": True}

    def drain(rec):
        if rec == 1 and armed["on"]:
            armed["on"] = False
            time.sleep(0.2)  # let the producer run into the source fault
            raise RuntimeError("persistent drain fault")
        drained.append(rec)

    def recover(exc, remaining, where):
        recovered.append(type(exc).__name__)
        if isinstance(exc, ValueError):
            raise exc
        return remaining

    with pytest.raises(ValueError, match="corrupt input"):
        dflow.chunked_ingest(
            source(), stage=lambda it: it, launch=lambda s: s,
            drain=drain, commit=lambda: None,
            depth=2, pipeline_depth=pipeline_depth, recover=recover,
        )
    assert recovered == ["RuntimeError", "ValueError"]
    assert drained == sorted(set(drained)) and set(drained) <= {0, 1, 2, 3}


def test_unstaged_items_flow_to_launch():
    drained: list = []
    dflow.chunked_ingest(iter("abc"), launch=str.upper, drain=drained.append,
                         commit=lambda: None, ingest=IngestConfig(prefetch=1, pipeline_depth=0))
    assert drained == ["A", "B", "C"]
