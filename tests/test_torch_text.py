"""The port's text ingest (``io/text.py``) against the JAX package's: the
tokenizer, the hash, ``tokenize_corpus`` on the native and the numpy
paths, the corpus readers and chunker, and the synthetic 20-Newsgroups
stand-in against the one ``bench.py`` builds.
"""

from __future__ import annotations

import numpy as np
import pytest

import bench
from page_rank_and_tfidf_using_apache_spark_tpu.io import text as jt
from page_rank_and_tfidf_using_apache_spark_tpu.utils import native as jnative
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native

DOCS = [
    "The quick brown fox jumps over the lazy dog",
    "the dog sat, the cat sat",
    "",
    "MiXeD CaSe 123 abc123def 42 x",
    "café naïve résumé İstanbul 300K",
    "a bb ccc dddd a bb",
]


def assert_same_corpus(a, b):
    assert (a.n_docs, a.vocab_bits, a.doc_names) == (b.n_docs, b.vocab_bits, b.doc_names)
    for f in ("doc_ids", "term_ids", "doc_lengths"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("lowercase, min_token_len", [(True, 1), (False, 1), (True, 3)])
def test_tokenize_matches_reference(lowercase, min_token_len):
    for d in DOCS:
        assert tt.tokenize(d, lowercase=lowercase, min_token_len=min_token_len) == \
            jt.tokenize(d, lowercase=lowercase, min_token_len=min_token_len)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_add_ngrams_matches_reference(n):
    toks = jt.tokenize(DOCS[0])
    assert tt.add_ngrams(toks, n) == jt.add_ngrams(toks, n)


@pytest.mark.parametrize("vocab_bits", [1, 10, 18, 30])
def test_hash_matches_reference(vocab_bits):
    toks = [t for d in DOCS for t in jt.add_ngrams(jt.tokenize(d), 2)] + ["", "é"]
    h = tt.fnv1a_64(toks)
    np.testing.assert_array_equal(h, jt.fnv1a_64(toks))
    assert h.dtype == np.uint64
    np.testing.assert_array_equal(tt.hash_to_vocab(h, vocab_bits),
                                  jt.hash_to_vocab(h, vocab_bits))
    assert tt.fnv1a_64([]).shape == (0,)


CORPUS_KW = [
    {"vocab_bits": 12},
    {"vocab_bits": 10, "ngram": 2, "lowercase": False},
    {"vocab_bits": 11, "min_token_len": 2, "doc_id_offset": 5},
    {"vocab_bits": 12, "doc_names": [f"n{i}" for i in range(len(DOCS))]},
]


@pytest.mark.parametrize("kw", CORPUS_KW)
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_tokenize_corpus_matches_reference(kw, path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "tokenize_and_hash", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "tokenize_and_hash", lambda *a, **k: None)
    got = tt.tokenize_corpus(DOCS, **kw)
    assert got.native == (path == "native")
    assert_same_corpus(got, jt.tokenize_corpus(DOCS, **kw))


def test_tokenize_corpus_native_equals_numpy(monkeypatch):
    docs = tt.synthetic_corpus_lines(200, 30, 5)
    fast = tt.tokenize_corpus(docs, vocab_bits=12, ngram=2)
    monkeypatch.setattr(native, "tokenize_and_hash", lambda *a, **k: None)
    slow = tt.tokenize_corpus(docs, vocab_bits=12, ngram=2)
    assert fast.native and not slow.native
    assert_same_corpus(fast, slow)


@pytest.mark.parametrize("docs", [[], [""], ["", "", ""]])
def test_tokenize_corpus_empty(docs):
    got = tt.tokenize_corpus(docs, vocab_bits=10)
    assert got.n_tokens == 0 and got.n_docs == len(docs)
    assert_same_corpus(got, jt.tokenize_corpus(docs, vocab_bits=10))


@pytest.mark.parametrize("n_docs, tokens_per_doc, seed", [(50, 20, 7), (7, 3, 0), (0, 5, 1)])
def test_synthetic_corpus_lines_match_bench(n_docs, tokens_per_doc, seed):
    assert tt.synthetic_corpus_lines(n_docs, tokens_per_doc, seed) == \
        bench._synth_corpus_lines(n_docs, tokens_per_doc, seed)


def test_corpus_readers_match_reference(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    for i, doc in enumerate(DOCS):
        (d / f"f{i:02d}.txt").write_text(doc)
    (d / "sub").mkdir()  # directories are skipped
    flat = tmp_path / "lines.txt"
    flat.write_text("\n".join(DOCS) + "\n")
    assert tt.load_corpus_dir(str(d)) == jt.load_corpus_dir(str(d))
    assert tt.load_corpus_lines(str(flat)) == jt.load_corpus_lines(str(flat))
    assert list(tt.iter_corpus_dir(str(d))) == list(jt.iter_corpus_dir(str(d)))
    assert list(tt.iter_corpus_lines(str(flat))) == list(jt.iter_corpus_lines(str(flat)))


@pytest.mark.parametrize("chunk, skip, expect", [(2, 0, None), (4, 0, None), (2, 2, 4),
                                                 (4, 1, 4), (5, 2, 10)])
def test_iter_corpus_chunks_matches_reference(chunk, skip, expect):
    docs = [f"d{i}" for i in range(11)]
    assert list(tt.iter_corpus_chunks(docs, chunk, skip_chunks=skip,
                                      expect_skipped_docs=expect)) == \
        list(jt.iter_corpus_chunks(docs, chunk, skip_chunks=skip, expect_skipped_docs=expect))


@pytest.mark.parametrize("chunk, skip, expect", [(2, 2, 5), (4, 4, 16)])
def test_iter_corpus_chunks_mismatch_raises_like_reference(chunk, skip, expect):
    docs = [f"d{i}" for i in range(11)]
    with pytest.raises(ValueError) as te:
        list(tt.iter_corpus_chunks(docs, chunk, skip_chunks=skip, expect_skipped_docs=expect))
    with pytest.raises(ValueError) as je:
        list(jt.iter_corpus_chunks(docs, chunk, skip_chunks=skip, expect_skipped_docs=expect))
    assert str(te.value) == str(je.value)
