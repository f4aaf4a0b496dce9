"""TF-IDF model driver, batch path: tokenize on the host, one device
pipeline, pull the COO back, and record metrics.

Counterpart of the JAX package's ``models/tfidf.py`` ``run_tfidf``.  The
numeric pipeline is ``ops/tfidf.py``.  Streaming ingest, checkpoints and
resume are not part of the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device, synchronize
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer


@dataclasses.dataclass(frozen=True)
class TfidfOutput:
    """Host-side sparse TF-IDF matrix in COO form, sorted by (term, doc),
    plus the dense DF/IDF tables."""

    n_docs: int
    vocab_bits: int
    doc: np.ndarray  # int32 [nnz]
    term: np.ndarray  # int32 [nnz]
    weight: np.ndarray  # float32 [nnz]
    df: np.ndarray  # float32 [vocab]
    idf: np.ndarray  # float32 [vocab]
    metrics: MetricsRecorder
    # Raw per-pair counts and per-doc lengths, so a second weighting over
    # the same postings needs no corpus re-pass.
    count: np.ndarray | None = None  # float32 [nnz]
    doc_lengths: np.ndarray | None = None  # int32 [n_docs]

    @property
    def nnz(self) -> int:
        return int(self.doc.shape[0])

    def to_dense(self) -> np.ndarray:
        """[n_docs, vocab] dense matrix — tests/small corpora only."""
        out = np.zeros((self.n_docs, 1 << self.vocab_bits), dtype=self.weight.dtype)
        out[self.doc, self.term] = self.weight
        return out


def pipeline(corpus: tio.TokenizedCorpus, cfg: TfidfConfig,
             device: torch.device) -> ops.TfidfResult:
    """The timed device part of :func:`run_tfidf`: copy the token arrays to
    ``device``, run ``ops.tfidf_pipeline``, and wait for it.  An empty
    corpus counts as one document, as in the reference."""
    result = ops.tfidf_pipeline(
        torch.from_numpy(corpus.doc_ids).to(device),
        torch.from_numpy(corpus.term_ids).to(device),
        torch.from_numpy(corpus.doc_lengths).to(device),
        n_docs=max(corpus.n_docs, 1),
        vocab=cfg.vocab_size,
        tf_mode=cfg.tf_mode,
        idf_mode=cfg.idf_mode,
        l2_normalize=cfg.l2_normalize,
    )
    synchronize(device)
    return result


def run_tfidf(
    docs: Sequence[str],
    cfg: TfidfConfig,
    *,
    metrics: MetricsRecorder | None = None,
    doc_names: Sequence[str] | None = None,
    device: str | torch.device | None = None,
) -> TfidfOutput:
    """Batch TF-IDF on one device: ``cuda`` unless ``device`` says
    otherwise.  Records a ``tokenize`` event (with ``native``: whether the
    C++ tokenizer ran) and a ``pipeline`` event."""
    dev = resolve_device(device)
    metrics = metrics or MetricsRecorder()
    with Timer() as t_tok:
        corpus = tio.tokenize_corpus(
            docs,
            vocab_bits=cfg.vocab_bits,
            ngram=cfg.ngram,
            lowercase=cfg.lowercase,
            min_token_len=cfg.min_token_len,
            doc_names=doc_names,
        )
    metrics.record(event="tokenize", docs=corpus.n_docs, tokens=corpus.n_tokens,
                   secs=t_tok.elapsed, native=corpus.native)

    with Timer() as t_dev:
        result = pipeline(corpus, cfg, dev)
    metrics.record(
        event="pipeline", pairs=result.n_pairs, secs=t_dev.elapsed,
        tokens_per_sec=corpus.n_tokens / t_dev.elapsed if t_dev.elapsed > 0 else float("inf"),
    )
    return TfidfOutput(
        n_docs=corpus.n_docs,
        vocab_bits=cfg.vocab_bits,
        doc=result.doc.cpu().numpy(),
        term=result.term.cpu().numpy(),
        weight=result.weight.cpu().numpy(),
        df=result.df.cpu().numpy(),
        idf=result.idf.cpu().numpy(),
        metrics=metrics,
        count=result.count.cpu().numpy(),
        doc_lengths=corpus.doc_lengths,
    )
