"""Batch TF-IDF of the PyTorch port against the JAX package, on the CPU.

The same seeded corpora go through both packages.  The COO ``(doc, term,
count)`` and ``df`` must be equal, in the reference's (term, doc) order.
``idf`` and ``weight`` are held to ``RTOL`` of an independent float64
numpy oracle everywhere, and to ``RTOL`` of the JAX package wherever the
JAX package is itself within ``RTOL`` of that oracle.  Where it is not, the
cause is the reference's float32 ``log(N / df)`` for terms in nearly every
document, which the port evaluates as ``log1p((N - df) / df)`` (ROADMAP
Queue 3); each such test asserts that this is the only cause.

Also: the sklearn-convention oracle of ``tests/test_tfidf_oracle.py``,
position-stable top-k through ``convert.tfidf_result``, the empty corpus,
the CLI against the JAX CLI (its batch flags, and one case for each
streaming, checkpoint, index and BM25 flag), the CLI flags of later
slices, the config, and the graph loaders with the native layer on and
off.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu import tfidf as j_api_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu.cli import tfidf as jcli
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.io import text as jt
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.ops import tfidf as jops
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils import native as jnative
from page_rank_and_tfidf_using_apache_spark_tpu_torch import TfidfConfig, convert, tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native
from tests import test_tfidf_oracle as sk
from tests.test_torch_graph import assert_same_graph

RTOL = 2e-6
TINY = pathlib.Path(__file__).resolve().parent / "fixtures" / "tiny.txt"
MODES = list(itertools.product(tcfg.TfMode, tcfg.IdfMode, [False, True]))
MODE_IDS = [f"{tf.value}-{idf.value}-{'l2' if l2 else 'nol2'}" for tf, idf, l2 in MODES]


def corpus(n_docs=300, tokens=40, seed=3, vocab_bits=11, dup=False):
    docs = tt.synthetic_corpus_lines(n_docs, tokens, seed)
    if dup:  # every document twice: equal scores, so top-k must break ties by position
        docs = [d for d in docs for _ in range(2)]
    return docs, tt.tokenize_corpus(docs, vocab_bits=vocab_bits)


def port_pipeline(c, **kw):
    return tops.tfidf_pipeline(torch.from_numpy(c.doc_ids), torch.from_numpy(c.term_ids),
                               torch.from_numpy(c.doc_lengths), n_docs=max(c.n_docs, 1),
                               vocab=1 << c.vocab_bits, **kw)


def jax_pipeline(c, tf_mode=tcfg.TfMode.RAW, idf_mode=tcfg.IdfMode.CLASSIC,
                 l2_normalize=False):
    return jops.tfidf_pipeline(jnp.asarray(c.doc_ids), jnp.asarray(c.term_ids),
                               jnp.asarray(c.doc_lengths), n_docs=max(c.n_docs, 1),
                               vocab=1 << c.vocab_bits, tf_mode=jcfg.TfMode(tf_mode.value),
                               idf_mode=jcfg.IdfMode(idf_mode.value),
                               l2_normalize=l2_normalize)


def oracle(c, tf_mode, idf_mode, l2):
    """float64 numpy: one np.unique of the (term, doc) key, np.bincount for
    DF, and the formulas of the JAX package's ops/tfidf.py."""
    n, vocab = float(max(c.n_docs, 1)), 1 << c.vocab_bits
    key, count = np.unique(c.term_ids.astype(np.int64) * (1 << 31) + c.doc_ids,
                           return_counts=True)
    doc, term = (key % (1 << 31)).astype(np.int32), (key >> 31).astype(np.int32)
    df = np.bincount(term, minlength=vocab).astype(np.float64)
    idf = oracle_idf(df, n, idf_mode)
    tf = {"raw": count.astype(np.float64),
          "freq": count / np.maximum(c.doc_lengths[doc], 1),
          "lognorm": 1 + np.log(count)}[tf_mode.value]
    w = tf * idf[term]
    if l2:
        sq = np.bincount(doc, weights=w * w, minlength=int(n))
        w = w / np.sqrt(np.maximum(sq, 1e-30))[doc]
    return {"doc": doc, "term": term, "count": count.astype(np.float32), "df": df,
            "idf": idf, "weight": w}


def within(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) <= rtol * np.abs(want)


def check_float(name, port, ref, exact, ill_conditioned):
    """``port`` within RTOL of the float64 ``exact`` everywhere, and of the
    JAX ``ref`` wherever ``ref`` is within RTOL of ``exact``; the rest must
    be rows of ``ill_conditioned`` terms."""
    assert within(port, exact).all(), (name, np.abs(port / exact - 1).max())
    ref_ok = within(ref, exact)
    assert within(port[ref_ok], ref[ref_ok]).all(), name
    assert ill_conditioned[~ref_ok].all(), (name, "reference off the oracle elsewhere")


def ill_terms(df, n, idf_mode):
    """Terms whose reference float32 IDF is a log of a quotient near 1:
    df within a tenth of N (CLASSIC, MLLIB)."""
    return (idf_mode is not tcfg.IdfMode.SMOOTH) & (df > 0.9 * n)


def ill_rows(o, ill, l2):
    """COO rows of ill-conditioned terms and, under L2, every row of a
    document holding one (its norm sums them)."""
    rows = ill[o["term"]]
    if l2:
        rows = rows | (np.bincount(o["doc"], weights=rows)[o["doc"]] > 0)
    return rows


def assert_same_coo(p, j):
    n = int(j.n_pairs)
    for f in ("doc", "term"):
        a, b = getattr(p, f).numpy(), np.asarray(getattr(j, f))[:n]
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes(), f
    assert p.count.dtype == torch.float32
    assert p.count.numpy().tobytes() == np.asarray(j.count)[:n].tobytes()
    key = p.term.numpy().astype(np.int64) * (1 << 31) + p.doc.numpy()
    assert (np.diff(key) > 0).all(), "COO not strictly sorted by (term, doc)"


# ---------------------------------------------------------------- config

def test_config_fields_and_defaults_match():
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.TfidfConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.TfidfConfig)}
    assert tf == jf
    assert {m.value for m in tcfg.TfMode} == {m.value for m in jcfg.TfMode}
    assert {m.value for m in tcfg.IdfMode} == {m.value for m in jcfg.IdfMode}
    assert TfidfConfig is tcfg.TfidfConfig
    for k, v in tcfg.TUNABLE_DEFAULTS.items():
        assert jcfg.TUNABLE_DEFAULTS[k] == v, k


@pytest.mark.parametrize("kw", [
    {},
    {"vocab_bits": 10, "idf_mode": "smooth", "l2_normalize": True},
    {"tf_mode": "lognorm", "ngram": 2, "lowercase": False, "min_token_len": 3},
    {"chunk_tokens": 1024, "prefetch": 0, "checkpoint_every": 2, "dtype": "float64"},
])
def test_config_hash_and_vocab_size_match(kw):
    t, j = tcfg.TfidfConfig(**kw), jcfg.TfidfConfig(**kw)
    assert t.config_hash() == j.config_hash()
    assert t.vocab_size == j.vocab_size
    assert (t.tf_mode.value, t.idf_mode.value) == (j.tf_mode.value, j.idf_mode.value)


@pytest.mark.parametrize("kw", [
    {"vocab_bits": 0}, {"vocab_bits": 31}, {"ngram": 3}, {"prefetch": -1},
    {"pipeline_depth": -1}, {"pack_target_tokens": -1}, {"tf_mode": "log"},
    {"idf_mode": "bm25"},
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError) as te:
        tcfg.TfidfConfig(**kw)
    with pytest.raises(ValueError) as je:
        jcfg.TfidfConfig(**kw)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("seed, vocab_bits", [(3, 11), (4, 10), (5, 12)])
def test_count_pairs_and_df_match(seed, vocab_bits):
    _, c = corpus(seed=seed, vocab_bits=vocab_bits)
    p = tops.count_pairs(torch.from_numpy(c.doc_ids), torch.from_numpy(c.term_ids))
    j = jops.count_pairs(jnp.asarray(c.doc_ids), jnp.asarray(c.term_ids))
    assert_same_coo(p, j)
    assert p.n_pairs == int(j.n_pairs)
    df = tops.document_frequency(p, 1 << vocab_bits)
    jdf = jops.document_frequency(j, 1 << vocab_bits)
    assert df.dtype == torch.float32 and df.numpy().tobytes() == np.asarray(jdf).tobytes()


@pytest.mark.parametrize("idf_mode", list(tcfg.IdfMode), ids=lambda m: m.value)
def test_idf_vector_matches(idf_mode):
    n = 300
    df = np.r_[0, 1, 2, 7, 150, 270, 295, 298, 299, 300].astype(np.float32)
    got = tops.idf_vector(torch.from_numpy(df), n, idf_mode).numpy()
    ref = np.asarray(jops.idf_vector(jnp.asarray(df), float(n), jcfg.IdfMode(idf_mode.value)))
    exact = oracle_idf(df.astype(np.float64), n, idf_mode)
    assert got.dtype == np.float32 and np.isfinite(got).all() and got[0] == 0
    check_float("idf", got, ref, exact, ill_terms(df, n, idf_mode))


@pytest.mark.parametrize("idf_mode", [tcfg.IdfMode.CLASSIC, tcfg.IdfMode.MLLIB],
                         ids=lambda m: m.value)
def test_idf_near_n_keeps_its_accuracy(idf_mode):
    """The divergence ROADMAP Queue 3 records: for df = 296 of N = 300 the
    reference's float32 ``log`` of a rounded quotient near 1 leaves the
    float64 value by more than RTOL (CLASSIC), while the port's ``log1p``
    of the exact difference stays within a few units of float32 rounding
    in every mode."""
    n, df = 300, np.array([296.0], np.float32)
    exact = oracle_idf(df.astype(np.float64), n, idf_mode)
    got = tops.idf_vector(torch.from_numpy(df), n, idf_mode).numpy()
    ref = np.asarray(jops.idf_vector(jnp.asarray(df), float(n), jcfg.IdfMode(idf_mode.value)))
    assert within(got, exact, rtol=2.0 ** -23).all()
    if idf_mode is tcfg.IdfMode.CLASSIC:
        assert not within(ref, exact).all()


def oracle_idf(df, n, idf_mode):
    with np.errstate(divide="ignore"):
        idf = {"classic": np.log(n / np.maximum(df, 1)), "mllib": np.log((n + 1) / (df + 1)),
               "smooth": np.log((1 + n) / (1 + df)) + 1}[idf_mode.value]
    return np.where(df > 0, idf, 0.0)


@pytest.mark.parametrize("tf_mode", list(tcfg.TfMode), ids=lambda m: m.value)
def test_tf_values_match(tf_mode):
    _, c = corpus(seed=6)
    p = tops.count_pairs(torch.from_numpy(c.doc_ids), torch.from_numpy(c.term_ids))
    j = jops.count_pairs(jnp.asarray(c.doc_ids), jnp.asarray(c.term_ids))
    got = tops.tf_values(p, torch.from_numpy(c.doc_lengths), tf_mode).numpy()
    ref = np.asarray(jops.tf_values(j, jnp.asarray(c.doc_lengths),
                                    jcfg.TfMode(tf_mode.value)))[:p.n_pairs]
    assert got.dtype == np.float32
    assert within(got, ref).all()


@pytest.mark.parametrize("tf_mode, idf_mode, l2", MODES, ids=MODE_IDS)
def test_pipeline_matches_reference_and_oracle(tf_mode, idf_mode, l2):
    _, c = corpus()
    kw = dict(tf_mode=tf_mode, idf_mode=idf_mode, l2_normalize=l2)
    p, j, o = port_pipeline(c, **kw), jax_pipeline(c, **kw), oracle(c, tf_mode, idf_mode, l2)
    assert_same_coo(p, j)
    np.testing.assert_array_equal(p.doc.numpy(), o["doc"])
    np.testing.assert_array_equal(p.term.numpy(), o["term"])
    assert p.df.numpy().tobytes() == np.asarray(j.df).tobytes()
    np.testing.assert_array_equal(p.df.numpy(), o["df"])
    ill = ill_terms(o["df"], c.n_docs, idf_mode)
    check_float("idf", p.idf.numpy(), np.asarray(j.idf), o["idf"], ill)
    n = int(j.n_pairs)
    check_float("weight", p.weight.numpy(), np.asarray(j.weight)[:n], o["weight"],
                ill_rows(o, ill, l2))
    assert p.weight.dtype == p.idf.dtype == torch.float32


def test_pipeline_bits_repeat():
    _, c = corpus(seed=9)
    kw = dict(tf_mode=tcfg.TfMode.LOGNORM, idf_mode=tcfg.IdfMode.SMOOTH, l2_normalize=True)
    a, b = port_pipeline(c, **kw), port_pipeline(c, **kw)
    for f in ("doc", "term", "weight", "idf", "df", "count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_doc_sums_fixed_order():
    """doc_sums adds each document's rows in their own order, in float64."""
    values = torch.tensor([1.0, 2.0 ** -60, 3.0, -1.0, 5.0], dtype=torch.float32)
    doc = torch.tensor([2, 0, 2, 2, 0], dtype=torch.int32)
    got = tops.doc_sums(values, doc, 4)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), [2.0 ** -60 + 5.0, 0.0, 3.0, 0.0])


# ---------------------------------------------------------------- model and API

@pytest.mark.parametrize("kw", [
    {"vocab_bits": 11},
    {"vocab_bits": 10, "tf_mode": "freq", "idf_mode": "smooth", "l2_normalize": True},
    {"vocab_bits": 12, "ngram": 2, "idf_mode": "mllib", "min_token_len": 2},
])
def test_run_tfidf_matches_reference(kw):
    docs, _ = corpus(n_docs=120, tokens=30, seed=11)
    cfg = TfidfConfig(**kw)
    p = tm.run_tfidf(docs, cfg, device="cpu")
    j = jm.run_tfidf(docs, jcfg.TfidfConfig(**kw))
    assert (p.n_docs, p.vocab_bits, p.nnz) == (j.n_docs, j.vocab_bits, j.nnz)
    for f in ("doc", "term", "count", "df", "doc_lengths"):
        a, b = getattr(p, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    c = tt.tokenize_corpus(docs, vocab_bits=cfg.vocab_bits, ngram=cfg.ngram,
                           min_token_len=cfg.min_token_len)
    o = oracle(c, cfg.tf_mode, cfg.idf_mode, cfg.l2_normalize)
    ill = ill_terms(o["df"], c.n_docs, cfg.idf_mode)
    check_float("idf", p.idf, j.idf, o["idf"], ill)
    check_float("weight", p.weight, j.weight, o["weight"], ill_rows(o, ill, cfg.l2_normalize))
    events = {r["event"]: r for r in p.metrics.records if "event" in r}
    assert events["tokenize"]["native"] is True
    assert events["tokenize"]["tokens"] == c.n_tokens and events["tokenize"]["docs"] == 120
    assert events["pipeline"]["pairs"] == p.nnz and events["pipeline"]["secs"] > 0
    dense = p.to_dense()
    assert dense.shape == (120, 1 << cfg.vocab_bits)
    np.testing.assert_array_equal(dense[p.doc, p.term], p.weight)


def test_sklearn_convention_oracle_on_tiny():
    """The reference of tests/test_tfidf_oracle.py (sklearn's smooth IDF,
    raw TF, per-document L2), at that file's tolerance."""
    docs = sk._corpus()
    out = tfidf(docs, vocab_bits=sk.VOCAB_BITS, tf_mode="raw", idf_mode="smooth",
                l2_normalize=True, device="cpu")
    np.testing.assert_allclose(out.to_dense(), sk._reference_dense(docs), rtol=1e-5, atol=1e-7)


def test_api_matches_reference_api_and_refuses_streaming():
    """Batch and ``streaming=True`` against the JAX package's ``api.tfidf``;
    streaming gives the batch bits."""
    docs, _ = corpus(n_docs=40, tokens=10, seed=2)
    p = tfidf(docs, vocab_bits=10, device="cpu")
    j = j_api_tfidf(docs, vocab_bits=10)
    assert p.doc.tobytes() == np.asarray(j.doc).tobytes()
    p2 = tfidf(docs, TfidfConfig(vocab_bits=12), vocab_bits=10, device="cpu")
    assert p2.weight.tobytes() == p.weight.tobytes()
    chunks = [docs[i:i + 7] for i in range(0, len(docs), 7)]
    s = tfidf(iter(chunks), streaming=True, vocab_bits=10, device="cpu")
    js = j_api_tfidf(iter(chunks), streaming=True, vocab_bits=10)
    assert s.to_dense().tobytes() == p.to_dense().tobytes()
    for f in ("doc", "term", "count", "df"):
        assert getattr(s, f).tobytes() == np.asarray(getattr(js, f)).tobytes(), f


@pytest.mark.parametrize("docs", [[], [""], ["", "", ""], ["", "a b", ""]])
def test_empty_corpora_match_reference(docs):
    p = tfidf(docs, vocab_bits=10, idf_mode="classic", l2_normalize=True, device="cpu")
    j = j_api_tfidf(docs, vocab_bits=10, idf_mode="classic", l2_normalize=True)
    assert (p.n_docs, p.nnz) == (j.n_docs, j.nnz) == (len(docs), int(p.df.sum()))
    for f in ("doc", "term", "df", "weight", "idf"):
        a, b = getattr(p, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert within(a, b).all(), f
    assert np.isfinite(p.idf).all() and np.isfinite(p.weight).all()


# ---------------------------------------------------------------- query

def test_score_query_ties_through_convert():
    """Duplicate documents score equal; both packages rank them by
    position, on one COO carried across by convert.tfidf_result."""
    docs, c = corpus(n_docs=60, tokens=30, seed=4, dup=True)
    j = jax_pipeline(c, l2_normalize=True)
    res = convert.tfidf_result(j, device="cpu")
    assert res.n_pairs == int(j.n_pairs)
    vocab, n = 1 << c.vocab_bits, c.n_docs
    for words in (["w1"], ["w5"], ["w3", "w40"], ["w2", "w7", "w11"]):
        q = np.zeros(vocab, np.float32)
        q[jt.hash_to_vocab(jt.fnv1a_64(words), c.vocab_bits)] = 1.0
        for k in (1, 10, n):
            s, i = tops.score_query(res, torch.from_numpy(q), n_docs=n, k=k)
            js, ji = jops.score_query(j, jnp.asarray(q), n_docs=n, k=k)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji), err_msg=str((words, k)))
            assert within(s.numpy(), np.asarray(js)).all()
        assert (s[::2].numpy() == s[1::2].numpy()).all()  # the duplicates tie


def test_convert_tfidf_result_from_output_and_checks():
    docs, _ = corpus(n_docs=30, tokens=10, seed=8)
    out = jm.run_tfidf(docs, jcfg.TfidfConfig(vocab_bits=10))
    res = convert.tfidf_result(out, device="cpu")
    for f in ("doc", "term", "weight", "idf", "df", "count"):
        assert getattr(res, f).numpy().tobytes() == np.asarray(getattr(out, f)).tobytes(), f
    j = jax_pipeline(tt.tokenize_corpus(docs, vocab_bits=10))
    bad = j._replace(valid=j.valid.at[0].set(0.0))
    with pytest.raises(ValueError, match="valid"):
        convert.tfidf_result(bad, device="cpu")
    with pytest.raises(ValueError, match="no fields"):
        convert.tfidf_result({"doc": [0]}, device="cpu")


def test_score_query_rejects_k_past_n_docs():
    _, c = corpus(n_docs=5, tokens=5)
    res = port_pipeline(c)
    with pytest.raises(ValueError, match="k must be"):
        tops.score_query(res, torch.zeros(1 << c.vocab_bits), n_docs=5, k=6)


# ---------------------------------------------------------------- CLI

def read_weights(path):
    rows = [ln.split("\t") for ln in pathlib.Path(path).read_text().splitlines()]
    return [r[:2] for r in rows], np.array([float(r[2]) for r in rows])


@pytest.mark.parametrize("flags", [
    ["--vocab-bits", "10", "--idf-mode", "smooth", "--l2-normalize", "--query", "node",
     "graph"],
    ["--vocab-bits", "12", "--tf-mode", "lognorm", "--idf-mode", "mllib", "--query", "Node",
     "--top-k", "3"],
    ["--vocab-bits", "11", "--ngram", "2", "--min-token-len", "2", "--tf-mode", "freq"],
])
def test_cli_matches_reference_cli(flags, tmp_path, capsys):
    outs, printed = {}, {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--tuned-profile", "off"])):
        out = tmp_path / f"{name}.tsv"
        # unfaulted runs in both packages: each package counts an env plan's
        # calls on its own, so a GRAFT_CHAOS plan would fault different calls
        with chaos.inject(""), jchaos.inject(""):
            assert main([str(TINY), "--lines", "--output", str(out),
                         "--metrics-json", str(tmp_path / f"{name}.json"), *flags, *extra]) == 0
        cap = capsys.readouterr()
        outs[name] = read_weights(out)
        printed[name] = ([ln.split("\t") for ln in cap.out.splitlines()],
                         [ln for ln in cap.err.splitlines() if ln.startswith('{"docs"')])
    assert outs["port"][0] == outs["jax"][0]  # names and term ids, line for line
    assert within(outs["port"][1], outs["jax"][1]).all()
    (p_rows, p_err), (j_rows, j_err) = printed["port"], printed["jax"]
    assert p_err == j_err and json.loads(p_err[0])["docs"] == 12
    assert [r[0] for r in p_rows] == [r[0] for r in j_rows]
    assert within(np.array([float(r[1]) for r in p_rows]),
                  np.array([float(r[1]) for r in j_rows])).all()
    records = json.loads((tmp_path / "port.json").read_text())["records"]
    assert [r["event"] for r in records] == ["tokenize", "pipeline"]


@pytest.mark.parametrize("flag", ["--mesh"])
def test_cli_refuses_flags_of_later_slices(flag, tmp_path, capsys):
    """``--mesh`` (ROADMAP Queue 1 item 11) is ported and no flag is left
    to refuse as unported; the CLI refuses ``--mesh`` without
    ``--streaming``, as the JAX CLI does, and writes nothing."""
    assert tcli.build_parser().parse_args([str(TINY), flag, "2"]).mesh == 2
    out = tmp_path / "w.tsv"
    with pytest.raises(SystemExit) as e:
        tcli.main([str(TINY), "--lines", "--device", "cpu", "--output", str(out), flag, "2"])
    assert e.value.code != 0
    assert "--mesh requires --streaming" in str(e.value.code)
    assert not out.exists()


# Each flag of the streaming, checkpoint, index and BM25 paths, with what it
# needs beside it ({d}: a directory of the run's own, {r}: a ranks file).
SLICE_FLAGS = {
    "--streaming": ["--streaming"],
    "--chunk-docs": ["--streaming", "--chunk-docs", "5"],
    "--chunk-tokens": ["--streaming", "--chunk-docs", "4", "--chunk-tokens", "16"],
    "--prefetch": ["--streaming", "--chunk-docs", "2", "--prefetch", "0"],
    "--pipeline-depth": ["--streaming", "--chunk-docs", "2", "--pipeline-depth", "3"],
    "--pack-target": ["--streaming", "--chunk-docs", "1", "--pack-target", "20"],
    "--checkpoint-dir": ["--streaming", "--chunk-docs", "2", "--checkpoint-dir", "{d}/ck"],
    "--checkpoint-every": ["--streaming", "--chunk-docs", "2", "--checkpoint-dir", "{d}/ck",
                           "--checkpoint-every", "2"],
    "--resume": ["--streaming", "--chunk-docs", "2", "--checkpoint-dir", "{d}/ck",
                 "--checkpoint-every", "2", "--resume"],
    "--save-index": ["--save-index", "{d}/idx"],
    "--index-ranks": ["--streaming", "--save-index", "{d}/idx", "--index-ranks", "{r}"],
    "--no-index-bm25": ["--save-index", "{d}/idx", "--no-index-bm25"],
    "--bm25-k1": ["--streaming", "--chunk-docs", "3", "--save-index", "{d}/idx",
                  "--bm25-k1", "0.9"],
    "--bm25-b": ["--save-index", "{d}/idx", "--bm25-b", "0.3"],
}


@pytest.mark.parametrize("flag", list(SLICE_FLAGS))
def test_cli_flags_of_this_slice_match_reference_cli(flag, tmp_path, capsys):
    """Each flag through the port's CLI and the JAX CLI: the same output
    file (names and term ids line for line, weights within RTOL), the same
    summaries, and the same checkpoints and indexes.  ``--resume`` resumes
    from a checkpoint the same CLI left over the first 6 lines."""
    from page_rank_and_tfidf_using_apache_spark_tpu.serving import load_index
    from page_rank_and_tfidf_using_apache_spark_tpu.utils import checkpoint as jckpt

    assert flag in SLICE_FLAGS[flag]
    ranks = tmp_path / "ranks.npy"
    np.save(ranks, np.linspace(0, 1, 12).astype(np.float32))
    head = tmp_path / "head.txt"
    head.write_text("".join(TINY.read_text().splitlines(keepends=True)[:6]))
    outs, printed, dirs = {}, {}, {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--tuned-profile", "off"])):
        d = dirs[name] = tmp_path / name
        argv = [a.format(d=d, r=ranks) for a in SLICE_FLAGS[flag]]
        if flag == "--resume":
            assert main([str(head), "--lines", "--vocab-bits", "10",
                         *[a for a in argv if a != "--resume"], *extra]) == 0
            assert (d / "ck" / "LATEST").exists()
            capsys.readouterr()
        out = tmp_path / f"{name}.tsv"
        assert main([str(TINY), "--lines", "--vocab-bits", "10", "--output", str(out),
                     *argv, *extra]) == 0
        outs[name] = read_weights(out)
        printed[name] = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
                         if ln.startswith(('{"docs"', '{"index"'))]
    assert outs["port"][0] == outs["jax"][0]
    assert within(outs["port"][1], outs["jax"][1]).all()
    for rec in printed["port"] + printed["jax"]:
        if "index" in rec:
            rec["index"] = pathlib.Path(rec["index"]).name
    assert printed["port"] == printed["jax"] and printed["port"][-1]["docs"] == 12
    if (dirs["jax"] / "ck").exists():
        p, j = (jckpt.load_checkpoint(jckpt.latest_checkpoint(str(dirs[n] / "ck")))
                for n in ("port", "jax"))
        assert p[0] == j[0] and p[1].keys() == j[1].keys()
        assert all(p[1][k].tobytes() == j[1][k].tobytes() for k in p[1])
    assert (dirs["port"] / "ck").exists() == (dirs["jax"] / "ck").exists()
    assert (dirs["port"] / "idx").exists() == (dirs["jax"] / "idx").exists()
    if (dirs["jax"] / "idx").exists():
        p, j = (load_index(str(dirs[n] / "idx")) for n in ("port", "jax"))
        for f in ("doc", "term", "df", "term_offsets", "ranks"):
            a, b = getattr(p, f), getattr(j, f)
            assert (a is None) == (b is None) and (a is None or a.tobytes() == b.tobytes()), f
        assert within(p.weight, j.weight).all()
        assert (p.bm25_weight is None) == (j.bm25_weight is None) == (flag == "--no-index-bm25")
        if p.bm25_weight is not None:
            assert within(p.bm25_weight, j.bm25_weight).all()
        assert p.extra == j.extra


# ---------------------------------------------------------------- graph loaders

def force_numpy(monkeypatch):
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "parse_edge_file", lambda *a, **k: None)
        monkeypatch.setattr(mod, "sort_dedup_edges", lambda *a, **k: None)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("kw", [{}, {"dedup": False}, {"drop_self_loops": True}])
def test_load_snap_matches_reference(path, kw, monkeypatch):
    if path == "numpy":
        force_numpy(monkeypatch)
    g = tg.load_snap(str(TINY), **kw)
    assert_same_graph(g, jg.load_snap(str(TINY), **kw))
    assert g.native_steps == (("parse", "sort") if path == "native" else ())


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("kw", [{}, {"dedup": False}, {"compact_ids": False}])
def test_from_edges_matches_reference(path, kw, monkeypatch):
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 2000, 50_000), rng.integers(0, 2000, 50_000)
    if path == "numpy":
        force_numpy(monkeypatch)
    g = tg.from_edges(src, dst, **kw)
    assert_same_graph(g, jg.from_edges(src, dst, **kw))
    assert g.native_steps == (("sort",) if path == "native" else ())


def test_native_and_numpy_graphs_equal(monkeypatch):
    g = tg.synthetic_powerlaw(3000, 20_000, seed=5)
    assert g.native_steps == ("sort",)
    force_numpy(monkeypatch)
    assert_same_graph(g, tg.synthetic_powerlaw(3000, 20_000, seed=5))


def test_weighted_graphs_take_the_lexsort():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    w = rng.uniform(0.1, 3.0, 300)
    g = tg.from_edges(src, dst, weight=w)
    assert g.native_steps == ()
    assert g.weight.tobytes() == jg.from_edges(src, dst, weight=w).weight.tobytes()
