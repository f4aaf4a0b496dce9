"""The port's serving query path (``ops/tfidf.py`` scorers,
``serving/server.py``, ``cli/serve.py``) against the JAX package's, on the
CPU.

The batched scorers go through both packages on the same postings and
canonical queries: against a float64 numpy oracle the port's scores are
within ``RTOL``, and its doc ids equal the JAX package's wherever the
oracle separates a score (or a group of exactly tied scores) from its
neighbours by more than ``RTOL``; exact ties keep the lower doc id, and
in the merge the older segment.  Inside the port the order contract of
``ops/tfidf.py`` holds bit for bit: the COO and impacted scorers agree,
and a served result equals the one-shot ``score_query``.  The server
tests of ``tests/test_serving.py`` that need no retry executor, chaos or
registry are ported one for one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu import serving as jserving
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.ops import tfidf as jops
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs, serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import serve as cli_serve
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as cli_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
    ServerShutdown,
    _Pending,
    batch_cap,
    batch_shape_matrix,
    serve_pad_plan,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    TfidfConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

REPO = Path(__file__).resolve().parents[1]
FIXTURE = Path(__file__).parent / "fixtures" / "tiny.txt"
CFG = TfidfConfig(vocab_bits=10, idf_mode="smooth", l2_normalize=True)
RTOL = 2e-6
QUERIES = [
    ["directed", "graph"],
    ["node"],
    ["0", "1"],
    ["dangling", "node", "4"],
    ["zebra", "unseen"],
]


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", REPO / "tools" / "trace_report.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_server(index, **kw) -> serving.TfidfServer:
    return serving.TfidfServer(index, serving.ServeConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def oracle_index(tmp_path_factory):
    """The sklearn-oracle corpus (tests/fixtures/tiny.txt) built by the
    port into a servable index with BM25 weights and a PageRank prior."""
    out = run_tfidf(FIXTURE.read_text().splitlines(), CFG, device="cpu")
    d = tmp_path_factory.mktemp("idx")
    ranks = np.linspace(0.5, 1.5, out.n_docs).astype(np.float32)
    serving.save_index(str(d), out, CFG, ranks=ranks, bm25=Bm25Config())
    return serving.load_index(str(d))


@pytest.fixture(scope="module")
def dup_index(tmp_path_factory):
    """A seeded synthetic corpus with every document twice (exact ties the
    top-k must order by doc id), raw TF / classic IDF, BM25 and a prior."""
    docs = [d for d in tt.synthetic_corpus_lines(120, 25, 5) for _ in range(2)]
    cfg = TfidfConfig(vocab_bits=10)
    out = run_tfidf(docs, cfg, device="cpu")
    d = tmp_path_factory.mktemp("dup")
    ranks = np.random.default_rng(5).uniform(0.5, 1.5, out.n_docs).astype(np.float32)
    serving.save_index(str(d), out, cfg, ranks=ranks, bm25=Bm25Config())
    return serving.load_index(str(d))


def corpus_queries(index, n: int, seed: int) -> list[list[str]]:
    """Queries of 1-8 words drawn from the synthetic corpus's vocabulary,
    some with a word no document holds."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = [f"w{int(w)}" for w in rng.zipf(1.3, size=rng.integers(1, 9)) % 400]
        if i % 7 == 3:
            words.append("absentword")
        out.append(words)
    return out


def oracle_scores(index, table, q_term, q_weight) -> np.ndarray:
    """float64 numpy: Σ over the query's terms of weight · q, by posting run."""
    off = np.asarray(index.term_offsets)
    doc = np.asarray(index.doc)
    w = np.asarray(table, np.float64)
    scores = np.zeros(index.n_docs)
    for t, q in zip(q_term, q_weight):
        run = slice(int(off[t]), int(off[t + 1]))
        scores[doc[run]] += w[run] * float(q)
    return scores


def separated(want_sorted: np.ndarray, k: int) -> np.ndarray:
    """bool [k]: positions whose group of exactly equal oracle scores is set
    apart from the next distinct scores above and below by more than
    ``RTOL`` relative."""
    vals = np.unique(want_sorted)
    ok = np.ones(k, bool)
    for j in range(k):
        v = want_sorted[j]
        i = np.searchsorted(vals, v)
        tol = RTOL * max(abs(v), 1e-30)
        if i > 0 and v - vals[i - 1] <= tol:
            ok[j] = False
        if i + 1 < len(vals) and vals[i + 1] - v <= tol:
            ok[j] = False
    return ok


def assert_topk(got_s, got_i, want: np.ndarray, k: int, ref_i=None, label=""):
    """Scores within RTOL of the oracle's top-k; ids (and the reference's
    ids) equal the oracle's stable order wherever it is separated."""
    order = np.lexsort((np.arange(want.size), -want))
    top = want[order]
    np.testing.assert_allclose(np.asarray(got_s, np.float64), top[:k], rtol=RTOL, atol=0,
                               err_msg=label)
    mask = separated(top, k)
    np.testing.assert_array_equal(np.asarray(got_i)[mask], order[:k][mask], err_msg=label)
    if ref_i is not None:
        np.testing.assert_array_equal(np.asarray(ref_i)[mask], order[:k][mask], err_msg=label)
    return mask


def padded_queries(srv, queries, q: int):
    cap = len(queries)
    q_term = np.zeros((cap, q), np.int32)
    q_weight = np.zeros((cap, q), np.float32)
    q_valid = np.zeros((cap, q), np.float32)
    canon = []
    for i, words in enumerate(queries):
        qt, qw = srv.make_query(words)
        canon.append((qt, qw))
        q_term[i, :len(qt)] = qt
        q_weight[i, :len(qt)] = qw
        q_valid[i, :len(qt)] = 1.0
    return q_term, q_weight, q_valid, canon


def _one_shot(index, q_term, q_weight, k, table=None):
    """The one-shot path: a dense vocabulary vector through the port's
    ``ops.score_query`` — the equality oracle of the served path."""
    res = ops.TfidfResult(
        doc=torch.from_numpy(np.array(index.doc)), term=torch.from_numpy(np.array(index.term)),
        weight=torch.from_numpy(np.array(index.weight if table is None else table)),
        idf=torch.from_numpy(np.array(index.idf)), df=torch.from_numpy(np.array(index.df)),
    )
    q = np.zeros(index.vocab_size, np.float32)
    np.add.at(q, q_term, q_weight)
    scores, idx = ops.score_query(res, torch.from_numpy(q), n_docs=index.n_docs, k=k)
    return scores.numpy(), idx.numpy()


def _dense(scores, idx, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    out[idx] = scores
    return out


# ---------------------------------------------- scorers against the reference

TABLES = {"tfidf": "weight", "bm25": "bm25_weight"}


@pytest.mark.parametrize("use_prior", [False, True], ids=["no-prior", "prior"])
@pytest.mark.parametrize("ranker", ["tfidf", "bm25"])
def test_score_query_batch_matches_reference(dup_index, ranker, use_prior):
    idx = dup_index
    table = np.asarray(getattr(idx, TABLES[ranker]))
    prior = np.asarray(idx.ranks) if use_prior else np.zeros(idx.n_docs, np.float32)
    srv = make_server(idx)
    queries = corpus_queries(idx, 8, seed=1)
    q_term, q_weight, q_valid, canon = padded_queries(srv, queries, 16)
    k = 12
    s, i = ops.score_query_batch(
        *(torch.from_numpy(np.array(a)) for a in (idx.doc, idx.term, table,
                                                  np.ones(idx.nnz, np.float32),
                                                  q_term, q_weight, q_valid, prior)),
        n_docs=idx.n_docs, vocab=idx.vocab_size, k=k, use_prior=use_prior)
    js, ji = jops.score_query_batch(
        *(jnp.asarray(np.array(a)) for a in (idx.doc, idx.term, table,
                                             np.ones(idx.nnz, np.float32),
                                             q_term, q_weight, q_valid, prior)),
        n_docs=idx.n_docs, vocab=idx.vocab_size, k=k, use_prior=use_prior)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for row, (qt, qw) in enumerate(canon):
        want = oracle_scores(idx, table, qt, qw) + (prior if use_prior else 0.0)
        assert_topk(s[row].numpy(), i[row].numpy(), want, k, np.asarray(ji)[row],
                    label=str(queries[row]))
        np.testing.assert_allclose(s[row].numpy(), np.asarray(js)[row], rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("use_prior", [False, True], ids=["no-prior", "prior"])
@pytest.mark.parametrize("ranker", ["tfidf", "bm25"])
def test_score_impacted_batch_matches_reference(dup_index, ranker, use_prior):
    idx = dup_index
    table = np.asarray(getattr(idx, TABLES[ranker]))
    prior = np.asarray(idx.ranks) if use_prior else np.zeros(idx.n_docs, np.float32)
    srv = make_server(idx, scoring="impacted", impact_bucket_width=4)
    seg = srv._build_segs(srv._segset, srv.k)[0]
    queries = corpus_queries(idx, 8, seed=2)
    uniq = [_Pending(b"k", *srv.make_query(q)) for q in queries]
    b_start, b_len, b_row, b_qw, b_slot, total = srv._plan_impacted([seg], uniq, np.float32)[0]
    assert total > 0 and (b_len[total:] == 0).all()
    k = 12
    kw = dict(n_docs=idx.n_docs, batch=len(queries), bucket_width=4, k=k, use_prior=use_prior)
    s, i = ops.score_impacted_batch(
        *(torch.from_numpy(np.array(a)) for a in (idx.doc, table, b_start, b_len, b_row,
                                                  b_qw, prior)),
        bucket_slot=torch.from_numpy(b_slot), query_terms=16, **kw)
    js, ji = jops.score_impacted_batch(
        *(jnp.asarray(np.array(a)) for a in (idx.doc, table, b_start, b_len, b_row, b_qw,
                                             prior)), **kw)
    for row, p in enumerate(uniq):
        want = oracle_scores(idx, table, p.q_term, p.q_weight) + (prior if use_prior else 0.0)
        assert_topk(s[row].numpy(), i[row].numpy(), want, k, np.asarray(ji)[row],
                    label=str(queries[row]))


def test_topk_merge_matches_reference():
    """Candidates of three segments with ties inside and across them: the
    port's merge takes the JAX package's ids and scores exactly, a tie
    keeping the older (lower-base) segment."""
    rng = np.random.default_rng(3)
    bases = (0, 40, 90)
    scores = [np.sort(rng.integers(0, 6, (4, 5)).astype(np.float32), axis=1)[:, ::-1].copy()
              for _ in bases]
    ids = [np.sort(rng.choice(40, (4, 5), replace=True), axis=1).astype(np.int32)
           for _ in bases]
    got_s, got_i = ops.topk_merge(tuple(map(torch.from_numpy, scores)),
                                  tuple(map(torch.from_numpy, ids)), bases, k=7)
    js, ji = jops.topk_merge(tuple(map(jnp.asarray, scores)), tuple(map(jnp.asarray, ids)),
                             bases, k=7)
    assert got_s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    assert got_i.dtype == torch.int32
    # a tie across segments: the candidate of the lower base comes first
    flat_s = np.concatenate(scores, 1)
    flat_i = np.concatenate([i + b for i, b in zip(ids, bases)], 1)
    order = np.argsort(-flat_s, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(got_i.numpy(), np.take_along_axis(flat_i, order, 1))


@pytest.mark.parametrize("cap", [1, 2, 4, 8])
def test_coo_equals_impacted_bit_for_bit(dup_index, cap):
    """The order contract: every posting (COO) and the query terms' runs
    alone (impacted) give the same bits, for each ranker's table and the
    prior, at each batch cap, empty and padded rows included."""
    idx = dup_index
    srv = make_server(idx, scoring="impacted", impact_bucket_width=3)
    seg = srv._build_segs(srv._segset, srv.k)[0]
    queries = corpus_queries(idx, cap, seed=10 + cap)
    if cap > 1:
        queries[-1] = []
    q_term, q_weight, q_valid, canon = padded_queries(srv, queries, 16)
    uniq = [_Pending(b"k", qt, qw) for qt, qw in canon]
    b_start, b_len, b_row, b_qw, b_slot, _ = srv._plan_impacted([seg], uniq, np.float32)[0]
    t = {a: torch.from_numpy(np.array(getattr(idx, a))) for a in ("doc", "term")}
    for ranker, prior in (("tfidf", None), ("bm25", None), ("tfidf", idx.ranks)):
        table = torch.from_numpy(np.array(getattr(idx, TABLES[ranker])))
        p = torch.from_numpy(np.array(idx.ranks if prior is None else prior))
        coo = ops.score_query_batch(
            t["doc"], t["term"], table, torch.ones(idx.nnz), torch.from_numpy(q_term),
            torch.from_numpy(q_weight), torch.from_numpy(q_valid), p,
            n_docs=idx.n_docs, vocab=idx.vocab_size, k=idx.n_docs,
            use_prior=prior is not None)
        imp = ops.score_impacted_batch(
            t["doc"], table, *(torch.from_numpy(a) for a in (b_start, b_len, b_row, b_qw)), p,
            bucket_slot=torch.from_numpy(b_slot), query_terms=16, n_docs=idx.n_docs,
            batch=cap, bucket_width=3, k=idx.n_docs, use_prior=prior is not None)
        assert coo[0].numpy().tobytes() == imp[0].numpy().tobytes(), ranker
        assert torch.equal(coo[1], imp[1]), ranker


def test_negative_zero_keeps_id_order(oracle_index):
    """Products of ``-0.0`` query weights land in the buffer as ``-0.0``,
    but every score starts from ``+0.0``: the top-k holds only ``+0.0``
    and keeps doc-id order, on both scorers."""
    idx = oracle_index
    srv = make_server(idx, scoring="impacted")
    seg = srv._build_segs(srv._segset, srv.k)[0]
    qt, _ = srv.make_query(["directed", "graph", "node"])
    qw = np.full(qt.shape, -0.0, np.float32)
    q_term = torch.from_numpy(qt[None, :])
    q_weight = torch.from_numpy(qw[None, :])
    n = idx.n_docs
    zero = torch.zeros(n)
    t = {a: torch.from_numpy(np.array(getattr(idx, a))) for a in ("doc", "term", "weight")}
    coo_s, coo_i = ops.score_query_batch(t["doc"], t["term"], t["weight"], torch.ones(idx.nnz),
                                         q_term, q_weight, torch.ones_like(q_weight), zero,
                                         n_docs=n, vocab=idx.vocab_size, k=n)
    plan = srv._plan_impacted([seg], [_Pending(b"k", qt, qw)], np.float32)[0]
    assert plan[-1] > 0  # the query's terms are held by some documents
    imp_s, imp_i = ops.score_impacted_batch(
        t["doc"], t["weight"], *(torch.from_numpy(a) for a in plan[:4]), zero,
        bucket_slot=torch.from_numpy(plan[4]), query_terms=16, n_docs=n, batch=1,
        bucket_width=srv.cfg.impact_bucket_width, k=n)
    for s, i in ((coo_s, coo_i), (imp_s, imp_i)):
        assert not torch.signbit(s).any()
        assert i[0].tolist() == list(range(n))
    q = torch.zeros(idx.vocab_size)
    q[torch.from_numpy(qt).long()] = -0.0
    q[0] = -0.0
    s, i = ops.score_query(ops.TfidfResult(t["doc"], t["term"], t["weight"], zero, zero), q,
                           n_docs=n, k=n)
    assert not torch.signbit(s).any() and i.tolist() == list(range(n))


# ------------------------------------------------------- served == one-shot

def test_served_topk_byte_equal_to_one_shot(oracle_index):
    """The batched path returns the one-shot ops.score_query's top-k bit
    for bit on the sklearn-oracle corpus, on both scorers."""
    for scoring in ("coo", "impacted"):
        with make_server(oracle_index, top_k=4, max_batch=4, scoring=scoring) as srv:
            futs = [srv.submit(q) for q in QUERIES]
            for q, fut in zip(QUERIES, futs):
                scores, idx = fut.result(30.0)
                qt, qw = srv.make_query(q)
                e_scores, e_idx = _one_shot(oracle_index, qt, qw, srv.k)
                assert scores.tobytes() == e_scores.tobytes(), (scoring, q)
                assert idx.tobytes() == e_idx.tobytes(), (scoring, q)


def test_served_rank_prior_blend(oracle_index):
    """rank_alpha blends the artifact's PageRank prior on the device:
    score + alpha * rank, before top-k."""
    alpha = 0.25
    n = oracle_index.n_docs
    with make_server(oracle_index, top_k=n, rank_alpha=alpha) as srv:
        scores, idx = srv.query(["directed", "graph"])
        qt, qw = srv.make_query(["directed", "graph"])
    base = _dense(*_one_shot(oracle_index, qt, qw, n), n)
    expect = base + alpha * np.asarray(oracle_index.ranks)
    np.testing.assert_allclose(_dense(scores, idx, n), expect, atol=1e-6)


def test_bm25_serving_ab_ranker_byte_stable(tmp_path):
    """Per-request ranker selection returns BM25-ordered results equal bit
    for bit to scoring the BM25 weight table through score_query."""
    docs = ["apollo guidance computer", "apollo program apollo",
            "guidance law", "computer science computer"]
    cfg = TfidfConfig(vocab_bits=10)
    serving.save_index(str(tmp_path), run_tfidf(docs, cfg, device="cpu"), cfg,
                       bm25=Bm25Config())
    idx = serving.load_index(str(tmp_path))
    with make_server(idx, top_k=4) as srv:
        scores, docs_idx = srv.query(["apollo"], ranker="bm25")
        qt, qw = srv.make_query(["apollo"])
        want_s, want_i = _one_shot(idx, qt, qw, 4, table=idx.bm25_weight)
        assert scores.tobytes() == want_s.tobytes()
        assert docs_idx.tobytes() == want_i.tobytes()
        t_scores, _ = srv.query(["apollo"], ranker="tfidf")
        assert t_scores.tobytes() != scores.tobytes()


# ------------------------------------------------------------------ LRU

def test_lru_hit_returns_identical_results(oracle_index):
    with make_server(oracle_index, top_k=3) as srv:
        s1, i1 = srv.query(["node", "graph"])
        s2, i2 = srv.query(["graph", "node"])  # canonicalized: same key
        s3, i3 = srv.query(["node", "graph"])
        stats = srv.stats()
    assert s1.tobytes() == s2.tobytes() == s3.tobytes()
    assert np.array_equal(i1, i2) and np.array_equal(i2, i3)
    assert stats["cache_hits"] == 2 and stats["cache_misses"] == 1


def test_lru_eviction_bound(oracle_index):
    with make_server(oracle_index, top_k=2, cache_size=2) as srv:
        srv.query(["node"])
        srv.query(["graph"])
        srv.query(["edge"])  # evicts "node"
        srv.query(["node"])  # miss again
        stats = srv.stats()
    assert stats["cache_misses"] == 4 and stats["cache_hits"] == 0
    assert len(srv._cache) == 2


def test_cache_disabled(oracle_index):
    with make_server(oracle_index, top_k=2, cache_size=0) as srv:
        a = srv.query(["node"])
        b = srv.query(["node"])
        stats = srv.stats()
    assert stats["cache_hits"] == 0 and stats["cache_misses"] == 2
    assert a[0].tobytes() == b[0].tobytes()


def test_cache_put_rejects_stale_prior_generation(oracle_index):
    """A batch dispatched against a pre-set_prior operand must not land
    its result in the cache after the invalidation."""
    n = oracle_index.n_docs
    with make_server(oracle_index, top_k=n, prior_alpha=1.0) as srv:
        stale_gen = srv._prior_gen
        srv.set_prior(np.ones(n, np.float32))  # bumps the generation
        srv._cache_put(b"stale-key", ("x", "y"), stale_gen)
        assert b"stale-key" not in srv._cache
        srv._cache_put(b"fresh-key", ("x", "y"), srv._prior_gen)
        assert b"fresh-key" in srv._cache


# ------------------------------------------------------- batching policy

@pytest.mark.parametrize("kw", [{}, {"top_k": 3, "max_batch": 6, "scoring": "impacted",
                                     "prior_alpha": 0.5, "impact_bucket_width": 4},
                                {"top_k": 0}, {"max_batch": 0}, {"max_query_terms": 0},
                                {"queue_depth": 0}, {"cache_size": -1}, {"scoring": "dense"},
                                {"impact_bucket_width": 1}, {"impact_warm_buckets": 63}])
def test_serve_config_matches_reference(kw):
    """Fields, defaults and refusals are the JAX package's."""
    try:
        want = jserving.ServeConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            serving.ServeConfig(**kw)
        assert str(te.value) == str(e)
        return
    got = serving.ServeConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_batch_cap_is_grow_chunk_cap_at_min_bits_zero():
    m = MetricsRecorder()
    assert [batch_cap(b, 8, m) for b in (1, 2, 3, 4, 5, 7, 8)] == \
        [1, 2, 4, 4, 8, 8, 8]
    assert batch_cap(100, 8, m) == 8  # clipped at max_batch


def test_batch_shape_matrix_finite():
    assert batch_shape_matrix(8) == [1, 2, 4, 8]
    assert batch_shape_matrix(1) == [1]
    assert batch_shape_matrix(6) == [1, 2, 4, 6]  # clip keeps it bounded


def test_serve_pad_plan_matches_policy():
    (label, frac), = serve_pad_plan((1, 2, 3, 5, 7, 8), 8)
    assert label == "serve"
    # raw 26 slots over caps 1+2+4+8+8+8=31
    assert frac == pytest.approx((31 - 26) / 31)


def test_warmup_runs_full_shape_matrix(oracle_index):
    srv = make_server(oracle_index, top_k=2, max_batch=8)
    try:
        srv.start(warm=False)
        assert srv.warmup() == [1, 2, 4, 8]
    finally:
        srv.stop()


# ---------------------------------------------------------------- queries

def test_make_query_applies_index_tokenizer(oracle_index):
    """Query terms run through the INDEX's tokenizer: 'from-node' scores
    like 'from node'."""
    srv = make_server(oracle_index, top_k=2)
    qt1, qw1 = srv.make_query(["from-node"])
    qt2, qw2 = srv.make_query(["from", "node"])
    np.testing.assert_array_equal(qt1, qt2)
    np.testing.assert_array_equal(qw1, qw2)


def test_make_query_builds_ngrams(tmp_path):
    """An ngram=2 index's server hashes the same space-joined bigrams the
    build side hashed."""
    cfg2 = TfidfConfig(vocab_bits=10, ngram=2)
    out = run_tfidf(["alpha beta gamma", "beta gamma delta"], cfg2, device="cpu")
    serving.save_index(str(tmp_path), out, cfg2)
    srv = make_server(serving.load_index(str(tmp_path)), top_k=2)
    qt, _ = srv.make_query(["alpha", "beta"])
    bigram_id = int(tt.hash_to_vocab(tt.fnv1a_64(["alpha beta"]), 10)[0])
    assert bigram_id in qt.tolist()


@pytest.mark.parametrize("words", [["node", "Graph", "node", "w1"], ["a-b", "b", "A"], []])
def test_make_query_matches_reference(oracle_index, words):
    """The canonical query equals the JAX server's on the same index."""
    port = make_server(oracle_index, max_query_terms=3).make_query(words)
    ref = jserving.TfidfServer(oracle_index_as_jax(oracle_index),
                               jserving.ServeConfig(max_query_terms=3)).make_query(words)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def oracle_index_as_jax(index):
    return jserving.load_index(str(Path(index.path).parent), version=index.version)


def test_query_truncation_and_empty(oracle_index):
    with make_server(oracle_index, top_k=2, max_query_terms=4) as srv:
        qt, qw = srv.make_query([f"t{i}" for i in range(20)])
        assert qt.shape[0] == 4 and (np.diff(qt) > 0).all()
        qe, we = srv.make_query([])
        assert qe.shape[0] == 0
        scores, idx = srv.query([])  # empty query: all-zero scores
        assert scores.shape == (2,) and idx.tolist() == [0, 1]


def test_stop_fails_raced_submit_instead_of_hanging(oracle_index):
    """A request slipping into the queue around shutdown is failed by
    stop()'s leftover drain, and post-stop submits refuse."""
    srv = make_server(oracle_index, top_k=2)
    srv.start()
    qt, qw = srv.make_query(["node"])
    leftover = _Pending(srv.query_key(qt, qw), qt, qw)
    srv._queue.put(leftover)  # may land after the _STOP sentinel
    srv.stop()
    assert leftover.done  # resolved OR failed by the leftover drain
    assert srv._thread is None
    with pytest.raises(ServerShutdown, match="server stopped"):
        srv.submit(["node"])
    with pytest.raises(RuntimeError, match="not started"):
        make_server(oracle_index, top_k=2).submit(["node"])


# ------------------------------------------------------------ prior ranker

def test_prior_ranker_per_request_blend(oracle_index):
    """ranker='prior' blends prior_alpha * ranks for exactly the requests
    that opt in; plain tfidf requests on the SAME server stay equal to the
    one-shot path bit for bit."""
    alpha = 0.5
    n = oracle_index.n_docs
    with make_server(oracle_index, top_k=n, prior_alpha=alpha, cache_size=0) as srv:
        qt, qw = srv.make_query(["directed", "graph"])
        s_plain, i_plain = srv.query(["directed", "graph"])
        s_prior, i_prior = srv.query(["directed", "graph"], ranker="prior")
    e_scores, e_idx = _one_shot(oracle_index, qt, qw, n)
    assert s_plain.tobytes() == e_scores.tobytes()
    assert i_plain.tobytes() == e_idx.tobytes()
    expect = _dense(s_plain, i_plain, n) + alpha * np.asarray(oracle_index.ranks)
    np.testing.assert_allclose(_dense(s_prior, i_prior, n), expect, atol=1e-6)


def test_prior_ranker_refusal_paths(oracle_index, tmp_path):
    with make_server(oracle_index) as srv:
        with pytest.raises(ValueError, match="prior_alpha"):
            srv.submit(["node"], ranker="prior")
    out = run_tfidf(FIXTURE.read_text().splitlines(), CFG, device="cpu")
    serving.save_index(str(tmp_path), out, CFG)  # no ranks, no BM25
    bare = serving.load_index(str(tmp_path))
    with pytest.raises(ValueError, match="prior"):
        make_server(bare, prior_alpha=0.5)
    with make_server(bare) as srv:
        with pytest.raises(ValueError, match="BM25"):
            srv.submit(["node"], ranker="bm25")
        with pytest.raises(ValueError, match="unknown ranker"):
            srv.submit(["node"], ranker="pagerank")


def test_set_prior_hot_swap_and_cache_invalidation(oracle_index):
    """set_prior on a RUNNING server re-blends subsequent prior queries
    (an operand swap) and invalidates cached results."""
    alpha = 1.0
    n = oracle_index.n_docs
    with make_server(oracle_index, top_k=n, prior_alpha=alpha) as srv:
        s1, i1 = srv.query(["node"], ranker="prior")
        s1b, _ = srv.query(["node"], ranker="prior")
        assert s1.tobytes() == s1b.tobytes()
        assert srv.stats()["cache_hits"] == 1
        new_ranks = np.linspace(5.0, 1.0, n).astype(np.float32)
        srv.set_prior(new_ranks)
        s2, i2 = srv.query(["node"], ranker="prior")
        qt, qw = srv.make_query(["node"])
        with pytest.raises(ValueError, match="shape"):
            srv.set_prior(np.ones(n + 1, np.float32))
    dense_base = _dense(*_one_shot(oracle_index, qt, qw, n), n)
    dense2 = _dense(s2, i2, n)
    # the float32 sum of the one-shot score and the new prior, bit for bit
    assert dense2.tobytes() == (dense_base + alpha * new_ranks).tobytes()
    assert not np.allclose(_dense(s1, i1, n), dense2)


def test_set_prior_requires_prior_capable_server(oracle_index):
    with make_server(oracle_index) as srv:
        with pytest.raises(RuntimeError, match="prior operand"):
            srv.set_prior(np.ones(oracle_index.n_docs, np.float32))
    with pytest.raises(RuntimeError, match="not started"):
        make_server(oracle_index, prior_alpha=1.0).set_prior(
            np.ones(oracle_index.n_docs, np.float32))


def test_concurrent_clients_lose_no_request(oracle_index):
    """Twelve client threads against the drain thread and prior swaps, with
    a short switch interval: every request resolves once, the counters
    add up, and every tfidf answer is the one-shot's bits."""
    n = oracle_index.n_docs
    want = {tuple(q): _one_shot(oracle_index, *make_server(oracle_index).make_query(q), 3)
            for q in QUERIES}
    results, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with make_server(oracle_index, top_k=3, max_batch=4, prior_alpha=1.0,
                         cache_size=4) as srv:
            def client(c: int) -> None:
                try:
                    for i in range(30):
                        q = QUERIES[(c + i) % len(QUERIES)]
                        ranker = ("tfidf", "prior")[i % 2]
                        results.append((q, ranker, srv.query(q, timeout=60.0, ranker=ranker)))
                except Exception as exc:  # noqa: BLE001 — asserted below
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(12)]
            for t in threads:
                t.start()
            rng = np.random.default_rng(0)
            for _ in range(5):
                srv.set_prior(rng.uniform(0.5, 1.5, n).astype(np.float32))
            for t in threads:
                t.join(120.0)
            assert not any(t.is_alive() for t in threads)
            stats = srv.stats()
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(results) == 12 * 30
    assert stats["requests"] == 12 * 30
    assert stats["cache_hits"] + stats["cache_misses"] + stats["dedup_hits"] == 12 * 30
    for q, ranker, (s, i) in results:
        if ranker == "tfidf":
            assert s.tobytes() == want[tuple(q)][0].tobytes() and np.array_equal(
                i, want[tuple(q)][1])


# ------------------------------------------------------------ no fallback

def test_scorer_error_fails_only_its_batch(oracle_index, monkeypatch):
    """A scorer that raises fails its batch's futures with the error; the
    drain keeps going and later requests serve, equal to the one-shot."""
    real = ops.score_query_batch
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected scorer fault")
        return real(*a, **kw)

    with make_server(oracle_index, top_k=3, cache_size=0, max_batch=2,
                     flush_ms=50.0) as srv:
        monkeypatch.setattr(ops, "score_query_batch", flaky)
        first = srv.submit(["node"])
        second = srv.submit(["graph"])
        for fut in (first, second):
            with pytest.raises(RuntimeError, match="injected scorer fault"):
                fut.result(30.0)
        scores, idx = srv.query(["directed", "graph"])
        stats = srv.stats()
    assert stats["batch_errors"] == 1
    qt, qw = srv.make_query(["directed", "graph"])
    es, ei = _one_shot(oracle_index, qt, qw, 3)
    assert scores.tobytes() == es.tobytes() and idx.tobytes() == ei.tobytes()


def test_server_runs_on_cuda_unless_told(oracle_index, monkeypatch):
    """No device means cuda: without CUDA the constructor raises, and the
    CLI exits with the error instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.TfidfServer(oracle_index)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main([str(Path(oracle_index.path).parent), "--queries", str(FIXTURE)])


# ------------------------------------------------------------- reference

def test_jax_built_index_served_by_port_gives_jax_ids(tmp_path):
    """An index the JAX package built and saved, served by the port and by
    the JAX server: scores within RTOL, ids equal wherever the float64
    oracle separates them, for every ranker and both scorings."""
    docs = tt.synthetic_corpus_lines(150, 30, 9)
    jcfg_ = jcfg.TfidfConfig(vocab_bits=10, idf_mode="smooth", l2_normalize=True)
    out = jm.run_tfidf(docs, jcfg_)
    ranks = np.random.default_rng(9).uniform(0.5, 1.5, out.n_docs).astype(np.float32)
    jserving.save_index(str(tmp_path), out, jcfg_, ranks=ranks, bm25=jcfg.Bm25Config())
    jidx = jserving.load_index(str(tmp_path))
    pidx = serving.load_index(str(tmp_path))
    queries = corpus_queries(pidx, 12, seed=4)
    k = 8
    kw = dict(top_k=k, prior_alpha=0.5, cache_size=0)
    with jserving.TfidfServer(jidx, jserving.ServeConfig(**kw)) as jsrv:
        ref = {(r, tuple(q)): jsrv.query(q, ranker=r) for r in serving.RANKERS for q in queries}
    for scoring in ("coo", "impacted"):
        with make_server(pidx, scoring=scoring, **kw) as srv:
            for r in serving.RANKERS:
                table = np.asarray(pidx.bm25_weight if r == "bm25" else pidx.weight)
                for q in queries:
                    s, i = srv.query(q, ranker=r)
                    qt, qw = srv.make_query(q)
                    want = oracle_scores(pidx, table, qt, qw)
                    if r == "prior":
                        want = want + 0.5 * ranks.astype(np.float64)
                    js, ji = ref[(r, tuple(q))]
                    assert_topk(s, i, want, k, ji, label=f"{scoring} {r} {q}")
                    np.testing.assert_allclose(s, js, rtol=RTOL, atol=1e-7)


# ------------------------------------------------------ telemetry and CLI

def test_serve_trace_accounting(oracle_index, tmp_path, monkeypatch):
    """A traced serve run leaves queue-wait/pad/dispatch/pull accounting
    and per-request latency percentiles readable by trace_report, under
    the JAX package's span and event names."""
    monkeypatch.setenv("GRAFT_TRACE_PARENT", "round-42")
    obs.start_run("serve", str(tmp_path))
    try:
        with make_server(oracle_index, top_k=3, max_batch=4) as srv:
            srv.query(["directed", "graph"])  # populate the cache
            futs = [srv.submit(["directed", "graph"]) for _ in range(6)]
            futs += [srv.submit([f"w{i}"]) for i in range(5)]
            for f in futs:
                f.result(60.0)
    finally:
        obs.end_run()
    mod = _trace_report()
    trace = next(tmp_path.glob("serve.*.trace.jsonl"))
    rep = mod.report(str(trace))
    assert rep["trace_parent"] == "round-42"
    sv = rep["serving"]
    assert sv["requests"] == 12
    assert sv["cache_hits"] >= 6
    assert sv["errors"] == 0
    assert sv["latency_p99_s"] >= sv["latency_p50_s"] >= 0
    assert {"dispatch", "pull", "pad"} <= set(sv["phases"])
    man = json.loads(next(tmp_path.glob("serve.*.manifest.json")).read_text())
    assert man["trace_parent"] == "round-42"


def test_cli_build_and_serve(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(FIXTURE.read_text())
    idx_dir = tmp_path / "index"
    rc = cli_tfidf.main([
        str(corpus), "--lines", "--vocab-bits", "10", "--idf-mode", "smooth",
        "--l2-normalize", "--save-index", str(idx_dir), "--device", "cpu",
    ])
    assert rc == 0
    assert (idx_dir / "LATEST").exists()
    capsys.readouterr()
    queries = tmp_path / "q.txt"
    queries.write_text("directed graph\nnode\n\n0 1\n")
    rc = cli_serve.main([str(idx_dir), "--queries", str(queries), "--top-k", "3",
                         "--max-batch", "2", "--device", "cpu"])
    assert rc == 0
    out, err = capsys.readouterr()
    rows = [ln.split("\t") for ln in out.strip().splitlines() if ln]
    assert rows and all(len(r) == 3 for r in rows)
    assert 0 in {int(r[0]) for r in rows}  # "directed graph" matched something
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["requests"] == 3 and stats["p50_ms"] is not None
    assert stats["p99_ms"] >= stats["p50_ms"]
    # the lines are the server's own results, hits with a positive score
    idx = serving.load_index(str(idx_dir))
    want = []
    with make_server(idx, top_k=3) as srv:
        for qid, line in enumerate(queries.read_text().splitlines()):
            if line.split():
                s, d = srv.query(line.split())
                want += [[str(qid), str(int(i)), f"{float(v):.10g}"]
                         for v, i in zip(s, d) if v > 0]
    assert rows == want


def test_cli_matches_reference_cli(tmp_path, capsys):
    """The port's CLI prints the JAX CLI's lines on a JAX-built index
    (ids equal, scores within RTOL)."""
    cfg = jcfg.TfidfConfig(vocab_bits=10, idf_mode="smooth", l2_normalize=True)
    jserving.save_index(str(tmp_path / "idx"), jm.run_tfidf(
        FIXTURE.read_text().splitlines(), cfg), cfg, bm25=jcfg.Bm25Config())
    queries = tmp_path / "q.txt"
    queries.write_text("directed graph\n@bm25 node\nzebra\n0 1 2\n")
    from page_rank_and_tfidf_using_apache_spark_tpu.cli import serve as jcli_serve

    printed = {}
    for name, main, extra in (("port", cli_serve.main, ["--device", "cpu"]),
                              ("jax", jcli_serve.main, ["--tuned-profile", "off"])):
        assert main([str(tmp_path / "idx"), "--queries", str(queries), "--top-k", "4",
                     *extra]) == 0
        printed[name] = [ln.split("\t") for ln in capsys.readouterr()[0].splitlines()]
    assert [r[:2] for r in printed["port"]] == [r[:2] for r in printed["jax"]]
    np.testing.assert_allclose([float(r[2]) for r in printed["port"]],
                               [float(r[2]) for r in printed["jax"]], rtol=RTOL)


def test_cli_refuses_later_flags(oracle_index, tmp_path, capsys):
    """The serve CLI refuses no flag of the JAX CLI: ``--tuned-profile off``
    serves with every knob at its TUNABLE_DEFAULTS value, the lines of a
    run with no profile."""
    queries = tmp_path / "q.txt"
    queries.write_text("node graph\n")
    idx = str(Path(oracle_index.path).parent)
    outs = []
    for extra in (["--tuned-profile", "off"], []):
        assert cli_serve.main([idx, "--queries", str(queries), "--device", "cpu",
                               *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
