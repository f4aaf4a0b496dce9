"""The port's native C++ ingest layer (``utils/native.py`` over
``native/fastio.cpp``): equal to the port's numpy paths and to the JAX
package's native layer, bit for bit, on the same bytes.

The C++ source is a byte-identical copy of the JAX package's; the library
is built into the port's own ``_build/`` and never from or into the JAX
package.  Where it cannot be built, every entry point returns None and
says why.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.utils import native as jnative
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
JAX_PKG = ROOT / "page_rank_and_tfidf_using_apache_spark_tpu"

SNAP_TEXT = (
    "# Directed graph (each unordered pair of nodes is saved once)\n"
    "# FromNodeId\tToNodeId\n"
    "0\t1\n"
    "1\t2\n"
    "  \n"
    "2\t0\n"
    "2\t1\r\n"
    "   # indented comment\n"
    "3 3\n"
    "0\t1\n"  # duplicate edge: dedup happens downstream in from_edges
    "10    7\n"  # multi-space separator, dangling node 7
)

DOCS = [
    "The quick brown fox jumps over the lazy dog",
    "to be or not to be, that is the question!",
    "",
    "   punctuation-only:  ...!!!   ",
    "MiXeD CaSe 123 abc123def 42",
    "café naïve résumé",  # multi-byte UTF-8 acts as a separator
    "İstanbul is large",  # U+0130: lower() -> 'i' + combining dot (token break)
    "300K is hot, AKB too",  # U+212A KELVIN: lower() -> ASCII 'k'
    "İİ double dotted-İ edge İ",
    "a bb ccc dddd",
    "single",
]


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), native.unavailable_reason()
    assert _reference_library_loads(), "the JAX package's native library did not load"


def _reference_library_loads(wait_s: float = 120.0) -> bool:
    """Load the JAX package's library, waiting out another process's build
    of it.  That package compiles straight to the library's path, so a
    process that loads it while another's ``g++`` is still writing the file
    fails to load it, and the package then stops trying for the rest of the
    process; the test's worker clears that mark and loads again once the
    file is whole."""
    deadline = time.monotonic() + wait_s
    while not jnative.available():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        jnative._lib_failed = False
    return True


def _numpy_pairs(text: str) -> np.ndarray:
    lines = [ln for ln in text.splitlines() if ln and not ln.lstrip().startswith("#")]
    return np.array(" ".join(lines).split(), dtype=np.int64).reshape(-1, 2)


def test_source_is_byte_identical_to_the_reference():
    assert (PORT / "native" / "fastio.cpp").read_bytes() == \
        (JAX_PKG / "native" / "fastio.cpp").read_bytes()


def test_library_builds_inside_the_port():
    for path in (native.SRC, native.BUILD_DIR, native.LIB_PATH):
        assert pathlib.Path(path).resolve().is_relative_to(PORT), path
    assert pathlib.Path(native.LIB_PATH).is_file()
    assert native.unavailable_reason() is None


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("min_token_len", [1, 2])
def test_tokenizer_matches_numpy_and_reference(ngram, lowercase, min_token_len):
    kw = dict(vocab_bits=18, ngram=ngram, lowercase=lowercase, min_token_len=min_token_len)
    got = native.tokenize_and_hash(DOCS, **kw)
    assert got is not None
    for want, source in ((tt.tokenize_and_hash(DOCS, **kw), "port numpy"),
                         (jnative.tokenize_and_hash(DOCS, **kw), "JAX native")):
        for g, w, name in zip(got, want, ["doc_ids", "term_ids", "doc_lengths"]):
            assert g.dtype == w.dtype == np.int32, (source, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{source} {name}")


@pytest.mark.parametrize("text", ["İ", "K", "xİy", "aKb", "İK İK"])
def test_tokenizer_unicode_lowercase_cases(text):
    """U+0130 ends a token after its 'i'; U+212A continues it as 'k'."""
    kw = dict(vocab_bits=12, ngram=2, lowercase=True, min_token_len=1)
    got = native.tokenize_and_hash([text], **kw)
    want = tt.tokenize_and_hash([text], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_tokenizer_empty_batch():
    got = native.tokenize_and_hash([], vocab_bits=18, ngram=1, lowercase=True, min_token_len=1)
    assert all(a.size == 0 for a in got)


def test_tokenizer_small_vocab_bits():
    kw = dict(vocab_bits=4, ngram=2, lowercase=True, min_token_len=1)
    got = native.tokenize_and_hash(DOCS, **kw)
    np.testing.assert_array_equal(got[1], tt.tokenize_and_hash(DOCS, **kw)[1])
    assert got[1].max() < 16


def test_edge_parser_matches_numpy_and_reference(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text(SNAP_TEXT)
    got = native.parse_edge_file(str(p))
    np.testing.assert_array_equal(got, _numpy_pairs(SNAP_TEXT))
    np.testing.assert_array_equal(got, jnative.parse_edge_file(str(p)))


@pytest.mark.parametrize("text, want", [
    ("0 1\n2 3", [[0, 1], [2, 3]]),
    ("", np.empty((0, 2))),
    ("# nothing here\n#\n", np.empty((0, 2))),
])
def test_edge_parser_edges(tmp_path, text, want):
    p = tmp_path / "edges.txt"
    p.write_text(text)
    got = native.parse_edge_file(str(p))
    assert got.dtype == np.int64 and got.shape == np.shape(want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["99999999999999999999 3\n", "0 1\n2 x\n", "0 1 2\n",
                                 "12abc 3\n"])
def test_edge_parser_rejects_what_numpy_rejects(tmp_path, bad):
    """The native parser bails (None) where the numpy path raises, so
    ``load_snap`` falls through and raises the numpy path's error."""
    p = tmp_path / "bad.txt"
    p.write_text(bad)
    assert native.parse_edge_file(str(p)) is None
    with pytest.raises((ValueError, OverflowError)):
        tg.load_snap(str(p))


@pytest.mark.parametrize("dedup", [True, False])
def test_sort_dedup_edges_matches_lexsort_and_reference(dedup):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 500, 20_000).astype(np.int64)
    dst = rng.integers(0, 500, 20_000).astype(np.int64)
    src[::97] = dst[::97]  # self-loops
    src[1000:1100] = src[:100]  # duplicates
    dst[1000:1100] = dst[:100]
    got = native.sort_dedup_edges(src.copy(), dst.copy(), dedup=dedup)  # sorts in place
    order = np.lexsort((src, dst))
    s, d = src[order], dst[order]
    if dedup:
        keep = np.r_[True, (s[1:] != s[:-1]) | (d[1:] != d[:-1])]
        s, d = s[keep], d[keep]
    ref = jnative.sort_dedup_edges(src.copy(), dst.copy(), dedup=dedup)
    for g, w, r in zip(got, (s, d), ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


def test_sort_dedup_edges_refuses_ids_past_2_31():
    src = np.array([0, 1 << 31], np.int64)
    dst = np.array([1, 0], np.int64)
    assert native.sort_dedup_edges(src.copy(), dst.copy()) is None


def test_unbuildable_library_returns_none_and_says_why(tmp_path, monkeypatch):
    """With no library, every entry point returns None, ``available`` is
    False, the reason is kept, and the callers take the numpy path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libfastio.so"))
    assert not native.available()
    assert "missing.cpp" in native.unavailable_reason()
    p = tmp_path / "edges.txt"
    p.write_text(SNAP_TEXT)
    assert native.parse_edge_file(str(p)) is None
    assert native.sort_dedup_edges(np.arange(3), np.arange(3)) is None
    assert native.tokenize_and_hash(DOCS, vocab_bits=10, ngram=1, lowercase=True,
                                    min_token_len=1) is None
    corpus = tt.tokenize_corpus(DOCS, vocab_bits=10)
    assert not corpus.native
    g = tg.load_snap(str(p))
    assert g.native_steps == ()
    np.testing.assert_array_equal(corpus.term_ids, tt.tokenize_and_hash(
        DOCS, vocab_bits=10, ngram=1, lowercase=True, min_token_len=1)[1])
