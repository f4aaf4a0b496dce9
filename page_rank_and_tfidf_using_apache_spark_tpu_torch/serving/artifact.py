"""Servable index artifact: build once, serve many.

Counterpart of the JAX package's ``serving/artifact.py``, copied so the
port never imports that package; its code is held to the reference's by
``tests/test_torch_artifact.py``, so an index the port writes loads in the
JAX package's ``load_index`` and the reverse.

A TF-IDF build (batch or streaming, optionally with a PageRank prior) is
written once as a versioned, mmap-loadable index directory, and a server
starts by mapping it: no corpus re-ingest, no tokenizer warm-up.

Format (``utils/checkpoint.save_array_dir``)::

    index_dir/
      LATEST            -> "v0003"          (atomic pointer)
      v0003/
        META.json        {step: 3, config_hash, extra: {...}}
        doc.npy term.npy weight.npy         postings COO, (term, doc)-sorted
        idf.npy df.npy term_offsets.npy     per-term tables
        bm25_weight.npy                     optional BM25 weights, same rows
        ranks.npy                           optional PageRank doc prior

``extra`` carries what the query side needs to hash queries as the build
hashed documents (the full TfidfConfig JSON) and corpus stats (n_docs,
nnz, vocab_bits).  ``config_hash`` guards semantic drift as checkpoints
do: a reader refuses an index written under another TF-IDF configuration.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import TfidfOutput
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    Bm25Config,
    TfidfConfig,
    config_to_json,
)

INDEX_FORMAT = 1  # bump on any layout/meaning change of the arrays below


@dataclasses.dataclass(frozen=True)
class ServableIndex:
    """A loaded (mmap-backed by default) index version, ready for a server
    to device_put.  Arrays are read-only views into the artifact files."""

    path: str
    version: int
    n_docs: int
    vocab_bits: int
    cfg: TfidfConfig
    doc: np.ndarray  # int32 [nnz]
    term: np.ndarray  # int32 [nnz]
    weight: np.ndarray  # f[nnz]
    idf: np.ndarray  # f[vocab]
    df: np.ndarray  # f[vocab]
    ranks: np.ndarray | None  # f[n_docs] PageRank prior, or None
    extra: dict
    # BM25 weights over the SAME postings rows (dataflow/bm25.py) — the
    # A/B-able second ranker; None on indexes built without it.
    bm25_weight: np.ndarray | None = None
    # CSC-by-term postings offsets: ``term_offsets[t] ..
    # term_offsets[t+1]`` is term t's posting run in the (term, doc)-sorted
    # COO above — the host-side slice table of the impacted-list scorer.
    # Always present after load (computed for pre-offsets artifacts).
    term_offsets: np.ndarray | None = None  # int64 [vocab + 1]
    # Raw per-pair counts + per-doc lengths (save_index(..., counts=True),
    # the delta-segment layout): what a reader needs to RE-weight this
    # segment's postings under index-wide statistics (serving/segments.py).
    count: np.ndarray | None = None  # f[nnz]
    doc_lengths: np.ndarray | None = None  # int32 [n_docs]

    @property
    def nnz(self) -> int:
        return int(self.doc.shape[0])

    @property
    def vocab_size(self) -> int:
        return 1 << self.vocab_bits


def build_term_offsets(term: np.ndarray, vocab: int) -> np.ndarray:
    """CSC-by-term offsets over a term-sorted postings COO: offsets[t] ..
    offsets[t+1] is term t's posting run.  int64 so a web-scale nnz can
    never wrap; the impacted-list planner slices with it host-side."""
    offsets = np.zeros(vocab + 1, np.int64)
    if term.shape[0]:
        offsets[1:] = np.cumsum(np.bincount(term, minlength=vocab))
    return offsets


def _term_sorted(doc: np.ndarray, term: np.ndarray) -> bool:
    if term.shape[0] < 2:
        return True
    t0, t1 = term[:-1], term[1:]
    return bool(np.all((t1 > t0) | ((t1 == t0) & (doc[1:] >= doc[:-1]))))


def save_index(
    directory: str,
    output: TfidfOutput,
    cfg: TfidfConfig,
    *,
    ranks: np.ndarray | None = None,
    bm25: Bm25Config | None = None,
    counts: bool = False,
    extra: dict | None = None,
) -> str:
    """Serialize a TF-IDF build (+ optional PageRank doc prior and BM25
    second-ranker weights) as the next index version under ``directory``;
    returns the version path.

    ``ranks`` must be per-*document* priors aligned with the output's doc
    ids (how documents map onto graph nodes is the caller's contract —
    the PageRank-over-citation-graph correspondence of the reference).
    ``bm25`` re-weights the SAME postings COO from the output's raw
    counts (dataflow/bm25.py) into one extra array, making the artifact
    servable under either ranker per request.

    The postings are stored strictly (term, doc)-sorted with a CSC-by-term
    ``term_offsets`` table: the batch pipeline already emits
    that order, the streaming pipeline's chunk-major concatenation is
    re-sorted here ONCE at build time so the serving side can slice a
    term's whole posting run by offset — the impacted-list layout.
    ``counts=True`` additionally persists the raw per-pair counts and
    per-doc lengths, which is what makes a *delta segment* self-contained:
    a reader can re-weight this slice of the corpus under index-wide
    DF/N statistics (serving/segments.py) without ever re-ingesting it.
    """
    if ranks is not None and ranks.shape[0] != output.n_docs:
        raise ValueError(
            f"ranks prior has {ranks.shape[0]} entries but the index holds "
            f"{output.n_docs} documents"
        )
    doc = np.ascontiguousarray(output.doc, np.int32)
    term = np.ascontiguousarray(output.term, np.int32)
    weight = np.ascontiguousarray(output.weight)
    count = (np.ascontiguousarray(output.count)
             if output.count is not None else None)
    perm: np.ndarray | None = None
    if not _term_sorted(doc, term):
        perm = np.lexsort((doc, term))
        doc, term, weight = doc[perm], term[perm], weight[perm]
        if count is not None:
            count = count[perm]
    arrays: dict[str, np.ndarray] = {
        "doc": doc,
        "term": term,
        "weight": weight,
        "idf": np.ascontiguousarray(output.idf),
        "df": np.ascontiguousarray(output.df),
        "term_offsets": build_term_offsets(term, cfg.vocab_size),
    }
    if counts:
        if count is None or output.doc_lengths is None:
            raise ValueError(
                "counts=True needs TfidfOutput.count/doc_lengths — rebuild "
                "with a pipeline version that exports raw counts"
            )
        arrays["count"] = count
        arrays["doc_lengths"] = np.ascontiguousarray(
            output.doc_lengths, np.int32
        )
    if ranks is not None:
        arrays["ranks"] = np.ascontiguousarray(ranks)
    if bm25 is not None:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.bm25 import (
            bm25_from_tfidf,
        )

        bw = np.ascontiguousarray(bm25_from_tfidf(output, bm25))
        arrays["bm25_weight"] = bw if perm is None else bw[perm]
    version = ckpt.next_version(directory)
    meta = {
        "format": INDEX_FORMAT,
        "n_docs": int(output.n_docs),
        "vocab_bits": int(output.vocab_bits),
        "nnz": int(output.nnz),
        "has_ranks": ranks is not None,
        "has_bm25": bm25 is not None,
        "bm25_config": (json.loads(config_to_json(bm25))
                        if bm25 is not None else None),
        "tfidf_config": json.loads(config_to_json(cfg)),
        **(extra or {}),
    }
    with obs.span("serve.index_build", version=version, nnz=output.nnz):
        path = ckpt.save_array_dir(
            directory, version, arrays, cfg.config_hash(), extra=meta
        )
    return path


def load_index(
    directory: str,
    *,
    version: int | None = None,
    mmap: bool = True,
    expect_config_hash: str | None = None,
) -> ServableIndex:
    """Load an index version (LATEST by default) as a :class:`ServableIndex`.

    ``mmap=True`` maps the arrays instead of copying them: server startup
    touches metadata only, and concurrent server processes share one page
    cache for the postings."""
    if version is not None:
        import os

        path = os.path.join(directory, f"v{version:04d}")
    else:
        path = ckpt.latest_array_dir(directory)
        if path is None:
            raise FileNotFoundError(
                f"no committed index version under {directory!r} "
                "(build one with serving.artifact.save_index / "
                "cli.tfidf --save-index)"
            )
    ver, arrays, extra = ckpt.load_array_dir(
        path, expect_config_hash, mmap=mmap
    )
    fmt = int(extra.get("format", 0))
    if fmt != INDEX_FORMAT:
        raise ValueError(
            f"index {path} has format {fmt}; this build reads format "
            f"{INDEX_FORMAT} — rebuild the artifact"
        )
    cfg = TfidfConfig(**extra["tfidf_config"])
    offsets = arrays.get("term_offsets")
    if offsets is None:
        # an artifact from before term_offsets: same COO meaning —
        # derive them at load when the postings happen to be term-sorted
        # (every batch-built artifact).  A legacy chunk-major streaming
        # artifact keeps offsets None and serves via the COO path only;
        # artifacts THIS build writes are always sorted at save time.
        t = np.asarray(arrays["term"])
        if _term_sorted(np.asarray(arrays["doc"]), t):
            offsets = build_term_offsets(t, 1 << int(extra["vocab_bits"]))
    return ServableIndex(
        path=path,
        version=int(ver),
        n_docs=int(extra["n_docs"]),
        vocab_bits=int(extra["vocab_bits"]),
        cfg=cfg,
        doc=arrays["doc"],
        term=arrays["term"],
        weight=arrays["weight"],
        idf=arrays["idf"],
        df=arrays["df"],
        ranks=arrays.get("ranks"),
        extra=extra,
        bm25_weight=arrays.get("bm25_weight"),
        term_offsets=offsets,
        count=arrays.get("count"),
        doc_lengths=arrays.get("doc_lengths"),
    )
