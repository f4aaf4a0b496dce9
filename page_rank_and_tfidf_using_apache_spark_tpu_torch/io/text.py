"""Host-side text ingest: corpus → tokens → hashed (doc_id, term_id) arrays.

Counterpart of the JAX package's ``io/text.py``, copied so the port never
imports that package.  Tokenize on the host, hash every token with a
stable 64-bit FNV-1a into a ``2**vocab_bits`` id space, and hand flat int32
``(doc_id, term_id)`` arrays to the device, where TF and DF become one sort
and a run-length encoding (``ops/tfidf.py``).

The hash is implemented twice with identical results: a vectorized numpy
column sweep here and the C++ tokenizer of ``native/fastio.cpp``
(``utils/native.py``).  ``tokenize_corpus`` takes the C++ path where the
library loads and says which path ran (``TokenizedCorpus.native``);
``tests/test_torch_native.py`` and ``tests/test_torch_text.py`` pin both
paths equal to each other and to the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterable, Iterator, Sequence

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native

_TOKEN_RE = re.compile(r"[A-Za-z0-9]+")

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def tokenize(text: str, *, lowercase: bool = True, min_token_len: int = 1) -> list[str]:
    """Split on non-alphanumerics (the canonical course-project tokenizer —
    SURVEY.md A7), optionally lowercasing and dropping short tokens."""
    if lowercase:
        text = text.lower()
    toks = _TOKEN_RE.findall(text)
    if min_token_len > 1:
        toks = [t for t in toks if len(t) >= min_token_len]
    return toks


def add_ngrams(tokens: Sequence[str], n: int) -> list[str]:
    """Extend a unigram stream with joined n-grams up to ``n`` (n=2 matches
    BASELINE.json:11's "bigram vocab": unigrams + space-joined bigrams)."""
    out = list(tokens)
    for k in range(2, n + 1):
        out.extend(" ".join(tokens[i : i + k]) for i in range(len(tokens) - k + 1))
    return out


def fnv1a_64(tokens: Sequence[str]) -> np.ndarray:
    """Stable 64-bit FNV-1a of each token's UTF-8 bytes, vectorized.

    Tokens are right-padded into a uint8 matrix and hashed with one numpy
    sweep per byte column, masked past each token's length — no per-token
    python loop.
    """
    if len(tokens) == 0:
        return np.empty(0, dtype=np.uint64)
    bts = [t.encode("utf-8") for t in tokens]
    lens = np.fromiter((len(b) for b in bts), dtype=np.int64, count=len(bts))
    width = max(1, int(lens.max()))
    mat = np.zeros((len(bts), width), dtype=np.uint8)
    joined = np.frombuffer(b"".join(bts), dtype=np.uint8)
    # Scatter the concatenated bytes into the padded matrix rows.
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    col = np.arange(width)
    idx = starts[:, None] + col[None, :]
    valid = col[None, :] < lens[:, None]
    mat[valid] = joined[idx[valid]]

    h = np.full(len(bts), _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for c in range(width):
            m = valid[:, c]
            h[m] = (h[m] ^ mat[:, c][m].astype(np.uint64)) * _FNV_PRIME
    return h


def hash_to_vocab(hashes: np.ndarray, vocab_bits: int) -> np.ndarray:
    """Fold 64-bit hashes into ``[0, 2**vocab_bits)`` (mask — power-of-two
    vocab, BASELINE.json:8)."""
    mask = np.uint64((1 << vocab_bits) - 1)
    return (hashes & mask).astype(np.int32)


def tokenize_and_hash(
    docs: Sequence[str],
    *,
    vocab_bits: int,
    ngram: int,
    lowercase: bool,
    min_token_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy path of :func:`tokenize_corpus`: (doc_ids int32 [T],
    term_ids int32 [T], doc_lengths int32 [D]), the same bits as the C++
    ``utils/native.tokenize_and_hash``."""
    per_doc: list[list[str]] = [
        add_ngrams(tokenize(d, lowercase=lowercase, min_token_len=min_token_len), ngram)
        for d in docs
    ]
    doc_lengths = np.fromiter((len(p) for p in per_doc), dtype=np.int32, count=len(per_doc))
    flat = [t for p in per_doc for t in p]
    term_ids = hash_to_vocab(fnv1a_64(flat), vocab_bits)
    doc_ids = np.repeat(np.arange(len(docs), dtype=np.int32), doc_lengths)
    return doc_ids, term_ids, doc_lengths


@dataclasses.dataclass(frozen=True)
class TokenizedCorpus:
    """Flat device-ready token stream for a batch of documents.

    ``doc_ids[t]`` / ``term_ids[t]`` give document index and hashed vocab id
    of token occurrence ``t``; ``doc_lengths[d]`` counts tokens of doc ``d``
    (for TF normalization).  ``doc_names`` maps doc index → source name.
    ``native`` says whether the C++ tokenizer ran (else the numpy path).
    """

    n_docs: int
    vocab_bits: int
    doc_ids: np.ndarray  # int32 [n_tokens]
    term_ids: np.ndarray  # int32 [n_tokens]
    doc_lengths: np.ndarray  # int32 [n_docs]
    doc_names: tuple[str, ...]
    native: bool = False

    @property
    def n_tokens(self) -> int:
        return int(self.doc_ids.shape[0])


def tokenize_corpus(
    docs: Sequence[str],
    *,
    vocab_bits: int = 18,
    ngram: int = 1,
    lowercase: bool = True,
    min_token_len: int = 1,
    doc_names: Sequence[str] | None = None,
    doc_id_offset: int = 0,
) -> TokenizedCorpus:
    """Tokenize + hash a batch of document strings.

    Uses the native C++ tokenizer+hasher where the library loads, else the
    numpy FNV sweep (:func:`tokenize_and_hash`); the result's ``native``
    says which ran.  ``doc_id_offset`` lets streaming ingest assign
    globally unique doc ids chunk by chunk.

    Each call is an ``io.tokenize`` span, as in the JAX package: the
    tokenizer is the host's bottleneck, so its share of a traced run must
    be separable in the timeline.
    """
    kw = dict(vocab_bits=vocab_bits, ngram=ngram, lowercase=lowercase,
              min_token_len=min_token_len)
    with obs.span("io.tokenize", docs=len(docs)):
        res = native.tokenize_and_hash(docs, **kw)
        is_native = res is not None
        doc_ids, term_ids, doc_lengths = res if is_native else tokenize_and_hash(docs, **kw)

    names = tuple(doc_names) if doc_names is not None else tuple(
        f"doc{doc_id_offset + i}" for i in range(len(docs))
    )
    return TokenizedCorpus(
        n_docs=len(docs),
        vocab_bits=vocab_bits,
        doc_ids=doc_ids + np.int32(doc_id_offset),
        term_ids=term_ids,
        doc_lengths=doc_lengths,
        doc_names=names,
        native=is_native,
    )


def synthetic_corpus_lines(n_docs: int, tokens_per_doc: int, seed: int) -> list[str]:
    """Zipf-distributed synthetic corpus at 20-Newsgroups scale: Poisson
    document lengths (at least 8 tokens), Zipf(1.3) unigrams ``w<id>`` over
    a 50,000-word vocabulary.  The same documents as the JAX package's
    ``bench.py`` stand-in for a seed (``tests/test_torch_text.py``)."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(
        rng.poisson(tokens_per_doc, n_docs), 8).astype(np.int64)
    total = int(lens.sum())
    ids = rng.zipf(1.3, total) % 50_000
    words = np.char.add("w", ids.astype("U6"))
    docs, pos = [], 0
    for ln in lens:
        docs.append(" ".join(words[pos:pos + ln]))
        pos += ln
    return docs


def load_corpus_dir(path: str) -> tuple[list[str], list[str]]:
    """Directory of text files → (docs, names); one document per file —
    the reference's ``wholeTextFiles`` (SURVEY.md §3.2)."""
    names, docs = [], []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if os.path.isfile(full):
            with open(full, "r", errors="replace") as f:
                docs.append(f.read())
            names.append(name)
    return docs, names


def load_corpus_lines(path: str) -> tuple[list[str], list[str]]:
    """One document per line (the usual flat-file corpus dump shape)."""
    with open(path, "r", errors="replace") as f:
        docs = f.read().splitlines()
    return docs, [f"line{i}" for i in range(len(docs))]


def iter_corpus_lines(path: str) -> Iterator[str]:
    """Lazy one-doc-per-line reader: streaming ingest must not materialize
    the whole corpus on host (the Wikipedia config, BASELINE.json:11)."""
    with open(path, "r", errors="replace") as f:
        for line in f:
            yield line.rstrip("\n")


def iter_corpus_dir(path: str) -> Iterator[str]:
    """Lazy directory reader (one doc per file), same contract as above."""
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if os.path.isfile(full):
            with open(full, "r", errors="replace") as f:
                yield f.read()


def iter_corpus_chunks(
    docs: Iterable[str],
    chunk_docs: int,
    *,
    skip_chunks: int = 0,
    expect_skipped_docs: int | None = None,
) -> Iterator[list[str]]:
    """Fixed-size document chunks for streaming ingest (BASELINE.json:11).

    ``skip_chunks``: the resumable-streaming fast path.  A resuming
    consumer (models.tfidf ``resume=True``) ignores the first
    ``resume_point(cfg)`` chunks by *index*, so for those chunks this
    iterator yields an empty placeholder instead of buffering their
    documents — chunk indices (and therefore checkpoint bookkeeping) stay
    stable while the ingested prefix is never materialized on host.

    ``expect_skipped_docs``: the checkpoint's ingested document count.
    Chunk indices only line up if the corpus is re-chunked identically, so
    when given, the skipped prefix must cover exactly this many documents
    — a different ``chunk_docs`` between runs fails loudly here instead of
    silently re-ingesting (or dropping) documents.
    """
    buf: list[str] = []
    pending = 0  # docs counted through the current skipped chunk
    skipped_docs = 0
    emitted = 0
    for d in docs:
        if emitted < skip_chunks:
            pending += 1
            skipped_docs += 1
            if pending == chunk_docs:
                yield []  # placeholder: keeps downstream chunk indices stable
                pending = 0
                emitted += 1
                if emitted == skip_chunks and (
                    expect_skipped_docs is not None
                    and skipped_docs != expect_skipped_docs
                ):
                    raise ValueError(
                        f"resume chunking mismatch: skipping {skip_chunks} "
                        f"chunk(s) of {chunk_docs} covers {skipped_docs} "
                        f"documents but the checkpoint ingested "
                        f"{expect_skipped_docs}; rerun with the original "
                        "--chunk-docs"
                    )
            continue
        buf.append(d)
        if len(buf) == chunk_docs:
            yield buf
            buf = []
            emitted += 1
    # The corpus may legitimately end inside the skipped prefix when the
    # checkpoint covers a partial final chunk (e.g. a crash after ingest,
    # during finalize) — only a document-count mismatch is an error.
    if (
        emitted < skip_chunks
        and expect_skipped_docs is not None
        and skipped_docs != expect_skipped_docs
    ):
        raise ValueError(
            f"resume chunking mismatch: the corpus ended after "
            f"{skipped_docs} documents, inside the {skip_chunks}-chunk "
            f"skipped prefix (checkpoint ingested {expect_skipped_docs}); "
            "the corpus or --chunk-docs changed since the checkpoint"
        )
    if buf or pending:
        yield buf
