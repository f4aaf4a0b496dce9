"""Streaming TF-IDF of the PyTorch port against the JAX package and
against the port's own batch path, on the CPU.

Exact parity with the JAX package: the masked ``count_pairs`` (``n_pairs``
and its first ``n_pairs`` rows; the reference scatters padding into row
``cap - 1``, so the rows past ``n_pairs`` are not compared), the DF carry
of ``chunk_counts_carry``, and the DF and counts of a whole streaming run.
Weights within ``RTOL`` (``finalize_weights`` and whole runs; IDF with the
carve-out of ``tests/test_torch_tfidf.py``).  Against the port's batch
path the dense output is byte-equal at every pipeline depth and with
packing.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.ops import tfidf as jops
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs, tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder
from tests.test_torch_tfidf import check_float, ill_rows, ill_terms, oracle, within

MODES = {
    "raw-classic": {},
    "smooth-l2": {"idf_mode": "smooth", "l2_normalize": True},
    "lognorm": {"tf_mode": "lognorm"},
}


def chunks_of(n_chunks: int, docs_per_chunk: int = 3, seed: int = 0, tokens: int = 12):
    docs = tt.synthetic_corpus_lines(n_chunks * docs_per_chunk, tokens, seed)
    return [docs[i:i + docs_per_chunk] for i in range(0, len(docs), docs_per_chunk)]


def flat(chunks):
    return [d for c in chunks for d in c]


def padded_chunk(seed: int, cap: int, n: int, vocab_bits: int = 6, n_docs: int = 7):
    rng = np.random.default_rng(seed)
    doc = np.sort(rng.integers(0, n_docs, cap)).astype(np.int32)
    term = rng.integers(0, 1 << vocab_bits, cap).astype(np.int32)
    return doc, term, np.arange(cap) < n


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("seed, cap, n", [
    (0, 64, 40), (1, 64, 0), (2, 64, 64), (3, 256, 200), (4, 1024, 1000), (5, 8, 1),
])
def test_masked_count_pairs_matches_reference(seed, cap, n):
    doc, term, valid = padded_chunk(seed, cap, n)
    p = tops.count_pairs(torch.from_numpy(doc), torch.from_numpy(term),
                         token_valid=torch.from_numpy(valid))
    j = jops.count_pairs(jnp.asarray(doc), jnp.asarray(term), token_valid=jnp.asarray(valid))
    k = int(j.n_pairs)
    assert isinstance(p, tops.PaddedCounts) and p.n_pairs.dim() == 0 and int(p.n_pairs) == k
    assert p.doc.shape == p.term.shape == p.count.shape == (cap,)
    for f in ("doc", "term", "count"):
        a, b = getattr(p, f).numpy()[:k], np.asarray(getattr(j, f))[:k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert p.valid.numpy().tolist() == (np.asarray(j.valid) > 0).tolist()
    # every row past n_pairs is zero
    assert not p.doc[k:].any() and not p.term[k:].any() and not p.count[k:].any()


def test_masked_count_pairs_every_token_its_own_pair():
    """n_pairs == cap: every row is a pair, the spare row never shows."""
    cap = 32
    doc = np.arange(cap, dtype=np.int32)
    term = np.arange(cap, dtype=np.int32)[::-1].copy()
    p = tops.count_pairs(torch.from_numpy(doc), torch.from_numpy(term),
                         token_valid=torch.ones(cap, dtype=torch.bool))
    assert int(p.n_pairs) == cap and p.valid.all()
    assert p.term.tolist() == sorted(term.tolist()) and (p.count == 1).all()


def test_batch_count_pairs_is_exact_length():
    doc, term, _ = padded_chunk(0, 64, 64)
    p = tops.count_pairs(torch.from_numpy(doc), torch.from_numpy(term))
    assert isinstance(p, tops.SparseCounts) and p.n_pairs == p.doc.shape[0] < 64


@pytest.mark.parametrize("vocab_bits", [6, 9])
def test_chunk_counts_carry_matches_reference(vocab_bits):
    """The carry over five chunks (one with no valid token, one with every
    token its own pair) equals the JAX package's donated carry."""
    vocab = 1 << vocab_bits
    chunks = [padded_chunk(s, 128, n, vocab_bits) for s, n in
              enumerate((100, 0, 128, 37, 1))]
    chunks.append((np.arange(128, dtype=np.int32), np.arange(128, dtype=np.int32) % vocab,
                   np.ones(128, bool)))
    carry = torch.zeros(vocab)
    jcarry = jnp.zeros(vocab, jnp.float32)
    for doc, term, valid in chunks:
        counts, out = tops.chunk_counts_carry(torch.from_numpy(doc), torch.from_numpy(term),
                                              torch.from_numpy(valid), carry, vocab=vocab)
        assert out is carry  # updated in place
        jc, jcarry = jops.chunk_counts_carry(jnp.asarray(doc), jnp.asarray(term),
                                             jnp.asarray(valid), jcarry, vocab=vocab)
        assert int(counts.n_pairs) == int(jc.n_pairs)
        assert carry.numpy().tobytes() == np.asarray(jcarry).tobytes()
    _, inc = tops.chunk_counts(*(torch.from_numpy(a) for a in chunks[0]), vocab=vocab)
    _, jinc = jops.chunk_counts(*(jnp.asarray(a) for a in chunks[0]), vocab=vocab)
    assert inc.dtype == torch.float32 and inc.numpy().tobytes() == np.asarray(jinc).tobytes()


@pytest.mark.parametrize("tf_mode", list(tcfg.TfMode), ids=lambda m: m.value)
@pytest.mark.parametrize("l2", [False, True], ids=["nol2", "l2"])
def test_finalize_weights_matches_reference(tf_mode, l2):
    rng = np.random.default_rng(7)
    n_docs, nnz = 40, 600
    doc = np.sort(rng.integers(0, n_docs, nnz)).astype(np.int32)
    count = rng.integers(1, 9, nnz).astype(np.float32)
    lengths = np.bincount(doc, weights=count, minlength=n_docs).astype(np.int32)
    idf = rng.uniform(0.1, 5.0, nnz).astype(np.float32)
    got = tops.finalize_weights(torch.from_numpy(doc), torch.from_numpy(count),
                                torch.from_numpy(lengths), torch.from_numpy(idf),
                                n_docs=n_docs, tf_mode=tf_mode, l2_normalize=l2).numpy()
    ref = np.asarray(jops.finalize_weights(
        jnp.asarray(doc), jnp.asarray(count), jnp.asarray(lengths), jnp.asarray(idf),
        n_docs=n_docs, tf_mode=jcfg.TfMode(tf_mode.value), l2_normalize=l2))
    assert got.dtype == np.float32 and within(got, ref).all()


# ---------------------------------------------------- run_tfidf_streaming

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("depth", [0, 1, 2, 4, "packed"])
def test_streaming_byte_equal_to_batch(depth, mode):
    """Only scheduling changes with the pipeline depth and the packing: the
    dense output equals the port's batch output byte for byte."""
    chunks = chunks_of(10)
    kw = dict(vocab_bits=10, **MODES[mode])
    batch = tm.run_tfidf(flat(chunks), tcfg.TfidfConfig(**kw), device="cpu")
    if depth == "packed":
        cfg = tcfg.TfidfConfig(chunk_tokens=128, pack_target_tokens=100, **kw)
    else:
        cfg = tcfg.TfidfConfig(chunk_tokens=64, prefetch=2, pipeline_depth=depth, **kw)
    m = MetricsRecorder()
    out = tm.run_tfidf_streaming(iter(chunks), cfg, metrics=m, device="cpu")
    assert out.to_dense().tobytes() == batch.to_dense().tobytes()
    assert out.df.tobytes() == batch.df.tobytes() and out.idf.tobytes() == batch.idf.tobytes()
    n_chunks = len([r for r in m.records if r.get("event") == "chunk"])
    assert (n_chunks < 10) if depth == "packed" else n_chunks == 10


@pytest.mark.parametrize("mode", list(MODES))
def test_streaming_matches_reference(mode):
    """Against the JAX package's run_tfidf_streaming: DF and the counts
    exact row for row, weights within RTOL of the reference where it is
    within RTOL of the float64 oracle (the rest are its ill-conditioned
    IDF terms)."""
    chunks = chunks_of(12, docs_per_chunk=4, seed=3)
    p = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=9, chunk_tokens=128,
                                                               **MODES[mode]), device="cpu")
    j = jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(vocab_bits=9, chunk_tokens=128,
                                                              **MODES[mode]))
    assert p.n_docs == j.n_docs == 48
    for f in ("doc", "term", "count", "df", "doc_lengths"):
        a, b = getattr(p, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    cfg = tcfg.TfidfConfig(vocab_bits=9, **MODES[mode])
    c = tt.tokenize_corpus(flat(chunks), vocab_bits=9)
    o = oracle(c, cfg.tf_mode, cfg.idf_mode, cfg.l2_normalize)
    ill = ill_terms(o["df"], c.n_docs, cfg.idf_mode)
    check_float("idf", p.idf, np.asarray(j.idf), o["idf"], ill)
    order = np.lexsort((p.doc, p.term))  # the oracle's (term, doc) order
    check_float("weight", p.weight[order], np.asarray(j.weight)[order], o["weight"],
                ill_rows(o, ill, cfg.l2_normalize))


def test_streaming_bigrams_and_cap_bumps_match_reference():
    """ngram=2 and chunks that outgrow the starting capacity: the port
    bumps at the same chunks to the same capacities, and gives the batch
    path's bits."""
    chunks = chunks_of(4, docs_per_chunk=2, tokens=6) + chunks_of(3, docs_per_chunk=6, seed=1)
    kw = dict(vocab_bits=10, ngram=2, chunk_tokens=16)
    m, jmr = MetricsRecorder(), jm.MetricsRecorder()
    p = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), metrics=m, device="cpu")
    jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(**kw), metrics=jmr)
    bumps = [r for r in m.records if r.get("event") == "chunk_cap_bump"]
    assert bumps and bumps == [r for r in jmr.records if r.get("event") == "chunk_cap_bump"]
    batch = tm.run_tfidf(flat(chunks), tcfg.TfidfConfig(vocab_bits=10, ngram=2), device="cpu")
    assert p.to_dense().tobytes() == batch.to_dense().tobytes()


@pytest.mark.parametrize("chunks", [[], [[]], [[], ["a b", ""], []]], ids=["none", "empty", "holes"])
def test_empty_streams_match_reference(chunks):
    p = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(vocab_bits=8), device="cpu")
    j = jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(vocab_bits=8))
    assert (p.n_docs, p.nnz) == (j.n_docs, j.nnz)
    for f in ("doc", "term", "weight", "df", "idf"):
        a, b = getattr(p, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape and within(a, b).all(), f


def test_api_streaming_equals_batch():
    chunks = chunks_of(5)
    s = tfidf(iter(chunks), streaming=True, vocab_bits=10, l2_normalize=True, device="cpu")
    b = tfidf(flat(chunks), vocab_bits=10, l2_normalize=True, device="cpu")
    assert s.device == b.device == "cpu"
    assert s.to_dense().tobytes() == b.to_dense().tobytes()


def ingest_threads():
    return [t for t in threading.enumerate() if t.name.startswith("ingest")]


@pytest.mark.parametrize("prefetch, depth", [(0, 0), (2, 0), (0, 2), (2, 2)])
def test_source_fault_reaches_the_caller_with_its_traceback(prefetch, depth):
    """A fault in the tokenizer thread's source reaches the caller with the
    source's frame in its traceback, and no ingest thread is left."""

    def bad_source():
        yield from chunks_of(3)
        raise OSError("corpus shard unreadable")

    cfg = tcfg.TfidfConfig(vocab_bits=8, prefetch=prefetch, pipeline_depth=depth)
    with pytest.raises(OSError, match="unreadable") as ei:
        tm.run_tfidf_streaming(bad_source(), cfg, device="cpu")
    frames = []
    tb = ei.value.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "bad_source" in frames
    assert not ingest_threads()


def test_stage_fault_reaches_the_caller(monkeypatch):
    """A fault on the transfer thread (the staging ring) raises as itself,
    and the threads are joined."""

    def broken(self, rows, cap):
        raise MemoryError("pinned allocation failed")

    monkeypatch.setattr(tm.dflow.StagingRing, "stage", broken)
    with pytest.raises(MemoryError, match="pinned"):
        tm.run_tfidf_streaming(iter(chunks_of(4)), tcfg.TfidfConfig(vocab_bits=8), device="cpu")
    assert not ingest_threads()


def test_doc_ids_stay_below_the_key_field(monkeypatch):
    monkeypatch.setattr(tops, "DOC_BITS", 3)  # 8 documents fit
    with pytest.raises(ValueError, match="doc ids below 2\\^3"):
        tm.run_tfidf_streaming(iter(chunks_of(4)), tcfg.TfidfConfig(vocab_bits=8), device="cpu")


def test_metrics_and_spans_match_reference_names(tmp_path):
    """The records and spans the JAX package's tools read: one chunk record
    per chunk, the ingest_overlap record, finalize; the spans of both
    layers; and trace_report's ingest section."""
    import importlib.util
    import pathlib

    sink, jsink = obs.MemorySink(), jobs.MemorySink()
    obs.bus().attach(sink)
    jobs.bus().attach(jsink)
    try:
        m, jmr = MetricsRecorder(), jm.MetricsRecorder()
        # unfaulted runs in both packages: each package counts an env plan's
        # calls on its own, so a GRAFT_CHAOS plan would fault different calls
        with chaos.inject(""), jchaos.inject(""):
            with obs.run("ingesttrace", trace_dir=str(tmp_path)):
                tm.run_tfidf_streaming(iter(chunks_of(4)), tcfg.TfidfConfig(vocab_bits=10),
                                       metrics=m, device="cpu")
            jm.run_tfidf_streaming(iter(chunks_of(4)), jcfg.TfidfConfig(vocab_bits=10),
                                   metrics=jmr)
    finally:
        obs.bus().detach(sink)
        jobs.bus().detach(jsink)
    events = [r["event"] for r in m.records]
    assert events == [r["event"] for r in jmr.records]
    assert events.count("chunk") == 4 and events[-2:] == ["ingest_overlap", "finalize"]
    spans = {e["name"] for e in sink.of_kind("span_end")}
    jspans = {e["name"] for e in jsink.of_kind("span_end")}
    assert spans >= {"tfidf.stream", "tfidf.chunk", "tfidf.df_commit", "tfidf.finalize",
                     "ingest.tokenize", "ingest.h2d", "ingest.compute",
                     "ingest.commit_barrier", "io.tokenize"}
    assert spans <= jspans | {"io.tokenize"}
    assert len(sink.of_kind("ingest_commit")) == 1
    trace = next(tmp_path.glob("ingesttrace.*.trace.jsonl"))
    spec = importlib.util.spec_from_file_location(
        "trace_report", pathlib.Path(__file__).resolve().parents[1] / "tools" / "trace_report.py")
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    rep = tr.report(str(trace))
    assert rep["ingest"] and rep["ingest"][0]["chunks"] == 4
    assert "ingest pipeline" in tr.render_human(rep)
