"""The port's servable index build (``serving/artifact.py``, BM25,
``--save-index``) against the JAX package's, on the CPU.

The on-disk format is shared, so the test is direct: the JAX package's own
``load_index`` reads an index the port wrote (and the reverse).  Against
the JAX package's index of the same corpus, ``doc``, ``term``, ``df`` and
``term_offsets`` are equal, ``idf`` and ``weight`` within ``RTOL`` (with
the IDF carve-out of ``tests/test_torch_tfidf.py``) and ``bm25_weight``
within ``RTOL``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu import serving as jserving
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import bm25 as jbm25
from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import bm25
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from tests.test_torch_streaming import chunks_of, flat
from tests.test_torch_tfidf import check_float, ill_rows, ill_terms, oracle, within

INDEX_ARRAYS = ("doc", "term", "weight", "idf", "df", "term_offsets", "bm25_weight")


def bm25_oracle(doc, term, count, lengths, df, n_docs, k1, b):
    """float64 numpy BM25 by the reference's formula."""
    dl = lengths[doc].astype(np.float64)
    avgdl = max(lengths.astype(np.float64).sum() / n_docs, 1.0)
    d = df.astype(np.float64)[term]
    idf = np.log1p((n_docs - d + 0.5) / (d + 0.5))
    c = count.astype(np.float64)
    return idf * c * (k1 + 1.0) / (c + k1 * (1.0 - b + b * dl / avgdl))


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("kw", [{}, {"k1": 0.9, "b": 0.4}, {"k1": 0.0, "b": 1.0},
                                {"k1": -1.0}, {"b": 1.5}])
def test_bm25_config_matches_reference(kw):
    try:
        want = jcfg.Bm25Config(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tcfg.Bm25Config(**kw)
        assert str(te.value) == str(e)
        return
    got = tcfg.Bm25Config(**kw)
    assert got.config_hash() == want.config_hash()
    assert tcfg.config_to_json(got) == jcfg.config_to_json(want)


@pytest.mark.parametrize("kw", [{}, {"vocab_bits": 12, "l2_normalize": True, "idf_mode": "smooth"},
                                {"ngram": 2, "chunk_tokens": 1 << 18, "pack_target_tokens": 1 << 18}])
def test_config_json_matches_reference(kw):
    assert tcfg.config_to_json(tcfg.TfidfConfig(**kw)) == jcfg.config_to_json(jcfg.TfidfConfig(**kw))


# ------------------------------------------------------------------ BM25

@pytest.mark.parametrize("k1, b", [(1.5, 0.75), (0.9, 0.4), (2.0, 0.0), (0.0, 1.0)])
def test_bm25_weights_match_reference_and_oracle(k1, b):
    out = tm.run_tfidf(tt.synthetic_corpus_lines(80, 30, 2), tcfg.TfidfConfig(vocab_bits=10),
                       device="cpu")
    args = (out.doc, out.term, out.count, out.doc_lengths, out.df)
    got = bm25.bm25_weights(*(torch.from_numpy(a) for a in args), n_docs=out.n_docs, k1=k1, b=b)
    ref = np.asarray(jbm25.bm25_weights(*(jnp.asarray(a) for a in args), n_docs=out.n_docs,
                                        k1=k1, b=b))
    want = bm25_oracle(*args, out.n_docs, k1, b)
    assert got.dtype == torch.float32
    assert within(got.numpy(), want).all() and within(got.numpy(), ref).all()
    from_out = bm25.bm25_from_tfidf(out, tcfg.Bm25Config(k1=k1, b=b))
    assert from_out.tobytes() == got.numpy().tobytes()


def test_bm25_needs_raw_counts():
    out = tm.run_tfidf(["a b", "b c"], tcfg.TfidfConfig(vocab_bits=8), device="cpu")
    bare = tm.TfidfOutput(**{**out.__dict__, "count": None})
    with pytest.raises(ValueError, match="no raw counts"):
        bm25.bm25_from_tfidf(bare)


# ----------------------------------------------------------------- index

def build_both(tmp_path, cfg_kw, *, streaming: bool, bm25_kw=None, ranks=None):
    chunks = chunks_of(8, docs_per_chunk=4, seed=6)
    tcfg_, jcfg_ = tcfg.TfidfConfig(**cfg_kw), jcfg.TfidfConfig(**cfg_kw)
    if streaming:
        p = tm.run_tfidf_streaming(iter(chunks), tcfg_, device="cpu")
        j = jm.run_tfidf_streaming(iter(chunks), jcfg_)
    else:
        p = tm.run_tfidf(flat(chunks), tcfg_, device="cpu")
        j = jm.run_tfidf(flat(chunks), jcfg_)
    pb = None if bm25_kw is None else tcfg.Bm25Config(**bm25_kw)
    jb = None if bm25_kw is None else jcfg.Bm25Config(**bm25_kw)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    serving.save_index(pdir, p, tcfg_, bm25=pb, ranks=ranks)
    jserving.save_index(jdir, j, jcfg_, bm25=jb, ranks=ranks)
    return p, pdir, jdir, flat(chunks)


@pytest.mark.parametrize("streaming", [False, True], ids=["batch", "streaming"])
@pytest.mark.parametrize("mode", [{}, {"idf_mode": "smooth", "l2_normalize": True}],
                         ids=["raw-classic", "smooth-l2"])
def test_port_index_loads_in_the_reference(streaming, mode, tmp_path):
    cfg_kw = dict(vocab_bits=10, **mode)
    out, pdir, jdir, docs = build_both(tmp_path, cfg_kw, streaming=streaming, bm25_kw={})
    ours = serving.load_index(pdir)
    read = jserving.load_index(pdir)  # the reference reads the port's index
    ref = jserving.load_index(jdir)  # the reference's own index
    assert read.version == ours.version == 1 and read.n_docs == out.n_docs == len(docs)
    assert read.cfg.config_hash() == tcfg.TfidfConfig(**cfg_kw).config_hash()
    for f in INDEX_ARRAYS:
        a, b = np.asarray(getattr(read, f)), np.asarray(getattr(ours, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("doc", "term", "df", "term_offsets"):
        a, b = np.asarray(getattr(read, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    key = read.term.astype(np.int64) * (1 << 31) + read.doc
    assert (np.diff(key) > 0).all()  # (term, doc)-sorted, streaming builds too
    c = tt.tokenize_corpus(docs, vocab_bits=10)
    cfg = tcfg.TfidfConfig(**cfg_kw)
    o = oracle(c, cfg.tf_mode, cfg.idf_mode, cfg.l2_normalize)
    ill = ill_terms(o["df"], c.n_docs, cfg.idf_mode)
    check_float("idf", np.asarray(read.idf), np.asarray(ref.idf), o["idf"], ill)
    check_float("weight", np.asarray(read.weight), np.asarray(ref.weight), o["weight"],
                ill_rows(o, ill, cfg.l2_normalize))
    assert within(read.bm25_weight, ref.bm25_weight).all()
    want = bm25_oracle(o["doc"], o["term"], o["count"], c.doc_lengths, o["df"], c.n_docs,
                       1.5, 0.75)
    assert within(read.bm25_weight, want).all()


def test_reference_index_loads_in_the_port(tmp_path):
    _, pdir, jdir, _ = build_both(tmp_path, dict(vocab_bits=10), streaming=False, bm25_kw={})
    read, ref = serving.load_index(jdir), jserving.load_index(jdir)
    for f in INDEX_ARRAYS:
        assert np.asarray(getattr(read, f)).tobytes() == np.asarray(getattr(ref, f)).tobytes(), f
    assert read.cfg == tcfg.TfidfConfig(vocab_bits=10) and read.extra == ref.extra


def test_streaming_index_equals_batch_index(tmp_path):
    """save_index sorts the streaming COO by (term, doc) once: the index is
    the batch build's, byte for byte."""
    chunks = chunks_of(6)
    cfg = tcfg.TfidfConfig(vocab_bits=10, l2_normalize=True)
    s = tm.run_tfidf_streaming(iter(chunks), cfg, device="cpu")
    b = tm.run_tfidf(flat(chunks), cfg, device="cpu")
    serving.save_index(str(tmp_path / "s"), s, cfg, bm25=tcfg.Bm25Config())
    serving.save_index(str(tmp_path / "b"), b, cfg, bm25=tcfg.Bm25Config())
    a, c = serving.load_index(str(tmp_path / "s")), serving.load_index(str(tmp_path / "b"))
    for f in INDEX_ARRAYS:
        assert np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(c, f)).tobytes(), f


def test_ranks_are_bundled_and_versions_advance(tmp_path):
    ranks = np.linspace(0.0, 1.0, 32).astype(np.float32)
    out, pdir, _, _ = build_both(tmp_path, dict(vocab_bits=10), streaming=True, ranks=ranks)
    idx = jserving.load_index(pdir)
    assert idx.ranks.tobytes() == ranks.tobytes() and idx.bm25_weight is None
    cfg = tcfg.TfidfConfig(vocab_bits=10)
    path = serving.save_index(pdir, out, cfg)
    assert path.endswith("v0002") and serving.load_index(pdir).version == 2
    with pytest.raises(ValueError, match="ranks prior"):
        serving.save_index(pdir, out, cfg, ranks=ranks[:5])
    with pytest.raises(ValueError, match="refusing to serve"):
        serving.load_index(pdir, expect_config_hash=tcfg.TfidfConfig(vocab_bits=11).config_hash())


def test_serving_exports_the_artifact_only():
    """The artifact's names, and since the query slice the reference's
    serving surface but the fleet and the soak (ROADMAP Queue 1 item 13)."""
    later = {"FabricConfig", "ServingFabric", "SoakConfig", "run_soak", "commit_floor",
             "read_floor"}
    assert set(serving.__all__) == (set(jserving.__all__) - later) | {
        "INDEX_FORMAT", "build_term_offsets"}
    assert all(hasattr(serving, name) for name in serving.__all__)
    from page_rank_and_tfidf_using_apache_spark_tpu.serving import artifact as jartifact

    assert serving.INDEX_FORMAT == jartifact.INDEX_FORMAT
    term = np.array([0, 0, 2, 5, 5, 5], np.int32)
    assert serving.build_term_offsets(term, 8).tolist() == \
        jartifact.build_term_offsets(term, 8).tolist()
