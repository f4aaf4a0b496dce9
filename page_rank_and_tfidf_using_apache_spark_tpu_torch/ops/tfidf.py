"""TF-IDF numeric core: hashed-vocabulary TF / DF / weight passes on device.

Counterpart of the JAX package's ``ops/tfidf.py`` batch path.  Tokens
arrive as flat hashed ``(doc_id, term_id)`` int32 arrays (``io/text.py``).
The Spark reference's two ``reduceByKey`` passes become one sort and one
run-length encoding of the int64 key ``term << 31 | doc``: each run of
equal keys is one (term, doc) pair, so TF is the run lengths, DF the number
of runs per term, and the ``tf.join(idf)`` weight join a gather of
``idf[term]``.

PyTorch has no static shapes to keep, so every array is exact-length
(``nnz`` rows, sorted by (term, doc)) where the JAX package pads to the
token count with an ``n_pairs``/``valid`` pair.  No TPU kernel sits on this
path: the JAX package leaves all of it to XLA, and it is plain PyTorch here.

Reductions are deterministic, so the same postings give the same bits on
every run: counts and DF are integer sums; the per-document sums (the L2
norm, query scores) run in float64 over the pairs sorted by document with
``torch.segment_reduce``, which adds in a fixed order, where a float
``index_add_`` on CUDA would add in the order its atomics land.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import IdfMode, TfMode

# Bits of a doc id in the sort key ``term << DOC_BITS | doc``: every int32
# doc id fits, and at vocab_bits <= 30 the key stays under 2^61.
DOC_BITS = 31


class SparseCounts(NamedTuple):
    """COO of per-(doc, term) counts, sorted by (term, doc): the reference's
    TF ``reduceByKey`` output."""

    doc: torch.Tensor  # int32 [nnz]
    term: torch.Tensor  # int32 [nnz]
    count: torch.Tensor  # float32 [nnz]

    @property
    def n_pairs(self) -> int:
        return int(self.doc.shape[0])


class TfidfResult(NamedTuple):
    """Per-(doc, term) TF-IDF weights sorted by (term, doc), the dense DF
    and IDF vectors, and the raw per-pair counts (None on results built
    without them)."""

    doc: torch.Tensor  # int32 [nnz]
    term: torch.Tensor  # int32 [nnz]
    weight: torch.Tensor  # float32 [nnz]
    idf: torch.Tensor  # float32 [vocab]
    df: torch.Tensor  # float32 [vocab]
    count: torch.Tensor | None = None  # float32 [nnz]

    @property
    def n_pairs(self) -> int:
        return int(self.doc.shape[0])


def count_pairs(doc_ids: torch.Tensor, term_ids: torch.Tensor) -> SparseCounts:
    """The TF pass: ((term, doc), 1) → reduceByKey(add), as one sort + RLE of
    the key ``term << 31 | doc`` (non-negative int32 ids).  Pairs that tie
    on the key are the same pair, so the order of the COO is the key's.

    ``torch.unique`` learns the number of pairs on the host: one device
    sync per call."""
    key = (term_ids.long() << DOC_BITS) | doc_ids.long()
    pairs, count = torch.unique(key, sorted=True, return_counts=True)
    return SparseCounts(
        doc=(pairs & ((1 << DOC_BITS) - 1)).int(),
        term=(pairs >> DOC_BITS).int(),
        count=count.float(),
    )


def document_frequency(counts: SparseCounts, vocab: int) -> torch.Tensor:
    """The DF pass: distinct (term, doc) → (term, 1) → reduceByKey(add).
    Each COO row is one distinct pair, so DF counts rows per term (an
    integer sum, exact in float32 below 2^24 documents)."""
    df = torch.zeros(vocab, dtype=torch.int32, device=counts.term.device)
    return df.index_add_(0, counts.term, torch.ones_like(counts.term)).float()


def idf_vector(df: torch.Tensor, n_docs: int, mode: IdfMode) -> torch.Tensor:
    """IDF formula variants; terms with df == 0 get idf 0 (they never
    appear), which keeps ``inf`` out under CLASSIC.

    Each ``log(a / b)`` is evaluated as ``log1p((a - b) / b)``: ``a - b`` is
    an exact difference of integers, so a term in nearly every document
    keeps its relative accuracy in float32, where the reference's rounded
    quotient leaves ``log`` an absolute error of about 2^-24."""
    n = float(n_docs)  # exact in float32 below 2^24 documents; no copy to the device
    if mode is IdfMode.CLASSIC:
        safe_df = df.clamp_min(1.0)
        idf = torch.log1p((n - safe_df) / safe_df)
    elif mode is IdfMode.MLLIB:
        idf = torch.log1p((n - df) / (df + 1.0))
    elif mode is IdfMode.SMOOTH:
        idf = torch.log1p((n - df) / (df + 1.0)) + 1.0
    else:
        raise ValueError(f"unknown idf mode {mode}")
    return torch.where(df > 0, idf, torch.zeros_like(idf))


def tf_values(counts: SparseCounts, doc_lengths: torch.Tensor, mode: TfMode) -> torch.Tensor:
    """TF variants over the raw per-pair counts."""
    if mode is TfMode.RAW:
        return counts.count
    if mode is TfMode.FREQ:
        dl = doc_lengths[counts.doc].to(counts.count.dtype).clamp_min(1.0)
        return counts.count / dl
    if mode is TfMode.LOGNORM:
        c = counts.count
        return torch.where(c > 0, 1.0 + torch.log(c), torch.zeros_like(c))
    raise ValueError(f"unknown tf mode {mode}")


def doc_sums(values: torch.Tensor, doc: torch.Tensor, n_docs: int) -> torch.Tensor:
    """float64 [n_docs]: the sum of ``values`` over each document's rows, in
    a fixed order (the rows' own order within a document), so equal inputs
    give equal bits on every run."""
    order = torch.argsort(doc, stable=True)
    # rows per document; torch.bincount would sync to learn its length
    lengths = torch.zeros(n_docs, dtype=torch.int64, device=doc.device)
    lengths.index_add_(0, doc, torch.ones_like(doc, dtype=torch.int64))
    return torch.segment_reduce(values.double()[order], "sum", lengths=lengths, unsafe=True)


def tfidf_pipeline(
    doc_ids: torch.Tensor,
    term_ids: torch.Tensor,
    doc_lengths: torch.Tensor,
    *,
    n_docs: int,
    vocab: int,
    tf_mode: TfMode = TfMode.RAW,
    idf_mode: IdfMode = IdfMode.CLASSIC,
    l2_normalize: bool = False,
) -> TfidfResult:
    """The full batch pipeline: TF pass → DF pass → IDF vector → weight join
    (→ optional per-doc L2 norm, sklearn-style, accumulated in float64)."""
    counts = count_pairs(doc_ids, term_ids)
    df = document_frequency(counts, vocab)
    idf = idf_vector(df, n_docs, idf_mode)
    w = tf_values(counts, doc_lengths, tf_mode) * idf[counts.term]
    if l2_normalize:
        sq = doc_sums(w.double() ** 2, counts.doc, n_docs)
        w = (w.double() / sq.clamp_min(1e-30).sqrt()[counts.doc]).float()
    return TfidfResult(doc=counts.doc, term=counts.term, weight=w, idf=idf, df=df,
                       count=counts.count)


def score_query(
    result: TfidfResult,
    query_weights: torch.Tensor,  # float32 [vocab]: the query's weight per term
    *,
    n_docs: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k query scoring: score(doc) = Σ_t w[doc, t]·q[t], summed in
    float64 (:func:`doc_sums`) and rounded to float32, then the ``k``
    highest scores and their doc ids.  Equal scores keep the lower doc id
    first, as ``lax.top_k`` does in the reference."""
    if not 0 <= k <= n_docs:
        raise ValueError(f"k must be in [0, n_docs={n_docs}], got {k}")
    per_pair = result.weight.double() * query_weights.double()[result.term]
    scores = doc_sums(per_pair, result.doc, n_docs).float()
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]
