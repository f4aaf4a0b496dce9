"""BM25, the second ranker over the same postings arrays as TF-IDF.

Counterpart of the JAX package's ``dataflow/bm25.py``.  Okapi BM25 with
the Lucene idf variant (non-negative for every df)::

    idf(t)    = ln(1 + (N - df + 0.5) / (df + 0.5))
    w(d, t)   = idf(t) * c * (k1 + 1) / (c + k1 * (1 - b + b * |d|/avgdl))

where ``c`` is the raw (doc, term) count the TF-IDF pipeline already keeps
(``TfidfOutput.count``, so no second pass over the corpus), ``|d|`` the
document length and ``avgdl`` the corpus mean.  The weights land in the
same COO rows as the TF-IDF weights, so the serving index stores them as
one more array.  Plain elementwise PyTorch on the output's device, in the
reference's float32 formula; only ``avgdl`` differs: the lengths are summed
as integers, exactly, where the reference sums them in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import Bm25Config
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device


def bm25_weights(  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: the corpus's token total sums in int64 and avgdl divides in float64)
    doc: torch.Tensor,  # int32 [nnz]
    term: torch.Tensor,  # int32 [nnz]
    count: torch.Tensor,  # float32 [nnz] raw per-pair counts
    doc_lengths: torch.Tensor,  # int32 [n_docs]
    df: torch.Tensor,  # float32 [vocab]
    *,
    n_docs: int,
    k1: float,
    b: float,
) -> torch.Tensor:
    """Per-(doc, term) BM25 weights over the postings COO: a gather of each
    row's document length and of its term's df, then elementwise math."""
    dl = doc_lengths[doc].to(count.dtype)
    avgdl = (doc_lengths.sum(dtype=torch.int64).double() / n_docs).to(count.dtype).clamp_min(1.0)
    n = float(n_docs)
    df_pair = df[term]
    idf = torch.log1p((n - df_pair + 0.5) / (df_pair + 0.5))
    tf = count * (k1 + 1.0) / (count + k1 * (1.0 - b + b * dl / avgdl))
    return idf * tf


def bm25_from_tfidf(output, cfg: Bm25Config = Bm25Config()) -> np.ndarray:
    """BM25 weights aligned with a ``TfidfOutput``'s postings rows, computed
    on the device the output was (``output.device``; ``None`` is cuda) and
    pulled at the guarded site ``bm25_weights_pull``.
    An output without raw counts or document lengths raises: BM25
    re-weights counts, not tf-idf weights."""
    if output.count is None or output.doc_lengths is None:
        raise ValueError(
            "TfidfOutput carries no raw counts/doc lengths — rebuild the "
            "index with this version (BM25 re-weights counts, not tf-idf "
            "weights)"
        )
    dev = resolve_device(output.device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    with obs.span("bm25.weights", nnz=int(output.nnz)):
        w = bm25_weights(
            put(output.doc, np.int32), put(output.term, np.int32),
            put(output.count, output.weight.dtype), put(output.doc_lengths, np.int32),
            put(output.df, output.weight.dtype),
            n_docs=max(int(output.n_docs), 1), k1=float(cfg.k1), b=float(cfg.b),
        )
        return rx.device_get(w, site="bm25_weights_pull")
