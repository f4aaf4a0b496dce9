"""TF-IDF numeric core: hashed-vocabulary TF / DF / weight passes on device.

Counterpart of the JAX package's ``ops/tfidf.py``.  Tokens arrive as flat
hashed ``(doc_id, term_id)`` int32 arrays (``io/text.py``).  The Spark
reference's two ``reduceByKey`` passes become one sort and one run-length
encoding of the int64 key ``term << 31 | doc``: each run of equal keys is
one (term, doc) pair, so TF is the run lengths, DF the number of runs per
term, and the ``tf.join(idf)`` weight join a gather of ``idf[term]``.

The batch path keeps no static shapes: its arrays are exact-length (``nnz``
rows, sorted by (term, doc)) where the JAX package pads to the token count
with an ``n_pairs``/``valid`` pair, and ``count_pairs`` learns ``nnz`` with
one host sync.  The streaming path cannot wait on the device once a chunk:
``count_pairs(..., token_valid=...)`` and ``chunk_counts_carry`` are
fixed-shape, with rows in the chunk's capacity and ``n_pairs`` a 0-d
tensor on the device, and the DF carry is updated in place.  No TPU kernel
sits on either path: the JAX package leaves all of it to XLA, and it is
plain PyTorch here.

Reductions are deterministic, so the same postings give the same bits on
every run: counts and DF are integer sums; the L2 norm's per-document sums
run in float64 over the pairs sorted by document with
``torch.segment_reduce``, whose order is fixed, where a float
``index_add_`` on CUDA would add in the order its atomics land.

Query scores keep one order on every path and every device, so the
one-shot :func:`score_query`, the batched COO scorer
:func:`score_query_batch` and the impacted scorer
:func:`score_impacted_batch` agree bit for bit:

    score[row, doc] is the float64 sum, strictly left to right in
    ascending term order, of the exact float64 products ``weight · q`` of
    the query's terms that the document holds.  It is rounded to float32
    once.  The prior is then added in float32, as the reference adds it.

A query row is canonical (its terms ascending, each once), so its term
``j`` has slot ``j``.  Each product is written, with no accumulation, into
a zeroed float64 buffer ``[Q + 1, B, n_docs]`` at ``(slot, row, doc)``:
a document holds a term once, so no two products share a cell below slot
``Q``.  Postings of other terms and padding go to the spare slot ``Q``,
which is never read.  The sum then adds the ``Q`` slot planes one after
another, an elementwise float64 add each, from ``+0.0``: exact zeros
change nothing, so the COO path (every posting) and the impacted path
(the query terms' runs alone) give the same bits, and no ``-0.0`` reaches
the sort.  A float32 weight times a float32 query weight is exact in
float64.  Top-k is a stable descending sort, so equal scores keep the
lower doc id first, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import IdfMode, TfMode

# Bits of a doc id in the sort key ``term << DOC_BITS | doc``: every int32
# doc id fits, and at vocab_bits <= 30 the key stays under 2^61.
DOC_BITS = 31
# The key of a masked (padding) token: past every real key, so the sort
# puts padding last.
MASKED_KEY = torch.iinfo(torch.int64).max


class SparseCounts(NamedTuple):
    """COO of per-(doc, term) counts, sorted by (term, doc): the reference's
    TF ``reduceByKey`` output."""

    doc: torch.Tensor  # int32 [nnz]
    term: torch.Tensor  # int32 [nnz]
    count: torch.Tensor  # float32 [nnz]

    @property
    def n_pairs(self) -> int:
        return int(self.doc.shape[0])


class PaddedCounts(NamedTuple):
    """Fixed-shape COO of one padded chunk's per-(doc, term) counts: rows
    ``[0, n_pairs)`` sorted by (term, doc), the rest zero, and ``n_pairs``
    a 0-d tensor on the device, so nothing waits for it."""

    doc: torch.Tensor  # int32 [cap]
    term: torch.Tensor  # int32 [cap]
    count: torch.Tensor  # float32 [cap]
    n_pairs: torch.Tensor  # int64 0-d
    valid: torch.Tensor  # bool [cap]: row < n_pairs


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


def count_pairs(doc_ids: torch.Tensor, term_ids: torch.Tensor, *,  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: the sort key term << 31 | doc needs 62 bits)
                token_valid: torch.Tensor | None = None) -> SparseCounts | PaddedCounts:
    """The TF pass: ((term, doc), 1) → reduceByKey(add), as one sort + RLE of
    the key ``term << 31 | doc`` (non-negative int32 ids).  Pairs that tie
    on the key are the same pair, so the order of the COO is the key's.

    Without ``token_valid`` (the batch path) the result is exact-length:
    ``torch.unique`` learns the number of pairs on the host, one device
    sync per call.  With it (a padded streaming chunk) the result is a
    :class:`PaddedCounts` of the chunk's capacity and nothing waits for
    the device: masked tokens take :data:`MASKED_KEY`, one sort puts them
    last, run starts come from neighbour differences and run ids from a
    cumulative sum; each run's first token writes its doc and term, and
    its count is an integer ``index_add_``."""
    if token_valid is not None:
        return _count_padded(doc_ids, term_ids, token_valid)
    key = (term_ids.long() << DOC_BITS) | doc_ids.long()
    pairs, count = torch.unique(key, sorted=True, return_counts=True)  # graftlint: disable=transfer-census (ROADMAP Queue 3, host reads by design: the batch TF pass learns its pair count on the host, once a call)
    return SparseCounts(
        doc=(pairs & ((1 << DOC_BITS) - 1)).int(),
        term=(pairs >> DOC_BITS).int(),
        count=count.float(),
    )


def _count_padded(doc_ids: torch.Tensor, term_ids: torch.Tensor,  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: the 62-bit sort key, and its run ids and rows)
                  token_valid: torch.Tensor) -> PaddedCounts:
    cap = doc_ids.shape[0]
    dev = doc_ids.device
    key = (term_ids.long() << DOC_BITS) | doc_ids.long()
    key = torch.sort(torch.where(token_valid, key, MASKED_KEY)).values
    real = key != MASKED_KEY
    start = real.clone()
    start[1:] &= key[1:] != key[:-1]
    run = torch.cumsum(start, 0) - 1
    n_pairs = start.sum()
    # one write per run into rows [0, n_pairs); every other token writes
    # the spare row `cap`, which is cut off
    row = torch.where(start, run, cap)
    doc = torch.zeros(cap + 1, dtype=torch.int32, device=dev).scatter_(
        0, row, (key & ((1 << DOC_BITS) - 1)).int())
    term = torch.zeros(cap + 1, dtype=torch.int32, device=dev).scatter_(
        0, row, (key >> DOC_BITS).int())
    count = torch.zeros(cap + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(real, run, cap), real.int())
    return PaddedCounts(doc=doc[:cap], term=term[:cap], count=count[:cap].float(),
                        n_pairs=n_pairs,
                        valid=torch.arange(cap, device=dev) < n_pairs)


def document_frequency(counts: SparseCounts | PaddedCounts, vocab: int) -> torch.Tensor:
    """The DF pass: distinct (term, doc) → (term, 1) → reduceByKey(add).
    Each COO row (each valid row, for :class:`PaddedCounts`) is one
    distinct pair, so DF counts rows per term (an integer sum, exact in
    float32 below 2^24 documents)."""
    ones = (counts.valid.int() if isinstance(counts, PaddedCounts)
            else torch.ones_like(counts.term))
    df = torch.zeros(vocab, dtype=torch.int32, device=counts.term.device)
    return df.index_add_(0, counts.term, ones).float()


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
    return _tf(counts.count, counts.doc, doc_lengths, mode)


def _tf(count: torch.Tensor, doc: torch.Tensor, doc_lengths: torch.Tensor,
        mode: TfMode) -> torch.Tensor:
    if mode is TfMode.RAW:
        return count
    if mode is TfMode.FREQ:
        return count / doc_lengths[doc].to(count.dtype).clamp_min(1.0)
    if mode is TfMode.LOGNORM:
        return torch.where(count > 0, 1.0 + torch.log(count), torch.zeros_like(count))
    raise ValueError(f"unknown tf mode {mode}")


def doc_sums(values: torch.Tensor, doc: torch.Tensor, n_docs: int) -> torch.Tensor:  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: the L2 sums run in float64; argsort and segment_reduce's lengths are int64)
    """float64 [n_docs]: the sum of ``values`` over each document's rows in
    an order fixed by the rows' order within the document, so equal inputs
    give equal bits on every run.  On the CPU that order is left to right;
    on CUDA ``segment_reduce`` adds a document's rows in a tree (on the
    H100, 63 of 64 documents of 4,096 mixed-magnitude rows differ from a
    left-to-right float64 sum: ``chip_smoke.py`` phase 11a), the same tree
    on every run.  The query scorers do not use it: their order is the
    module's contract."""
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
    w = finalize_weights(counts.doc, counts.count, doc_lengths, idf[counts.term],
                         n_docs=n_docs, tf_mode=tf_mode, l2_normalize=l2_normalize)
    return TfidfResult(doc=counts.doc, term=counts.term, weight=w, idf=idf, df=df,
                       count=counts.count)


def finalize_weights(  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: the L2 norm is a float64 sum)
    doc: torch.Tensor,  # int32 [nnz]
    count: torch.Tensor,  # float32 [nnz]
    doc_lengths: torch.Tensor,  # int32 [n_docs]
    idf_per_pair: torch.Tensor,  # float32 [nnz]: idf[term]
    *,
    n_docs: int,
    tf_mode: TfMode,
    l2_normalize: bool,
) -> torch.Tensor:
    """TF weighting, the idf join and the optional per-document L2 norm
    over a COO, the batch pipeline's last step and the streaming path's
    second pass.  A document's rows are summed in their order in the COO,
    so a COO whose rows of each document come in the same order (term
    ascending, as both paths give them) gets the same bits."""
    w = _tf(count, doc, doc_lengths, tf_mode) * idf_per_pair
    if l2_normalize:
        sq = doc_sums(w.double() ** 2, doc, n_docs)
        w = (w.double() / sq.clamp_min(1e-30).sqrt()[doc]).float()
    return w


def chunk_counts(
    doc_ids: torch.Tensor,
    term_ids: torch.Tensor,
    token_valid: torch.Tensor,
    *,
    vocab: int,
) -> tuple[PaddedCounts, torch.Tensor]:
    """One padded chunk → (per-pair counts, the chunk's DF increment,
    float32 [vocab])."""
    counts = count_pairs(doc_ids, term_ids, token_valid=token_valid)
    return counts, document_frequency(counts, vocab)


def chunk_counts_carry(
    doc_ids: torch.Tensor,
    term_ids: torch.Tensor,
    token_valid: torch.Tensor,
    df_carry: torch.Tensor,
    *,
    vocab: int,
) -> tuple[PaddedCounts, torch.Tensor]:
    """The streaming-ingest step: one padded chunk → (per-pair counts, the
    DF carry with this chunk added).  ``df_carry`` (float32 [vocab]) lives
    on the device for the whole stream and is updated in place, where the
    JAX package donates its buffer; nothing here waits for the device.  The
    increment is an integer ``index_add_``, so the carry is exact and the
    same on every run below 2^24 documents."""
    counts, df = chunk_counts(doc_ids, term_ids, token_valid, vocab=vocab)
    return counts, df_carry.add_(df)


def _ordered_scores(flat: torch.Tensor, prod: torch.Tensor, n_slots: int, batch: int,  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: a score is a float64 sum in the module's order, over int64 flat slots)
                    n_docs: int) -> torch.Tensor:
    """float32 [batch, n_docs]: the products ``prod`` written at the flat
    indices ``flat`` of a zeroed float64 ``[n_slots + 1, batch, n_docs]``
    buffer (unique below slot ``n_slots``), then the slot planes added
    left to right from ``+0.0`` and rounded once."""
    buf = torch.zeros((n_slots + 1) * batch * n_docs, dtype=torch.float64, device=prod.device)
    buf[flat.reshape(-1)] = prod.reshape(-1)
    planes = buf.view(n_slots + 1, batch, n_docs)
    total = torch.zeros(batch, n_docs, dtype=torch.float64, device=prod.device)
    for j in range(n_slots):  # not planes.sum(0): its order on CUDA is the library's
        total.add_(planes[j])
    return total.float()


def _coo_scores(doc, term, weight, term_valid, q_term, q_weight, q_real, *,  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: exact float64 products at int64 flat slots)
                n_docs: int, vocab: int) -> torch.Tensor:
    """float32 [B, n_docs] scores of every posting against ``B`` canonical
    query rows: a ``[B, vocab + 1]`` table of slots (padding writes the
    spare column ``vocab``, which no posting reads), one slot lookup and one
    exact product a posting and row."""
    b, q = q_term.shape
    dev = weight.device
    slots = torch.arange(q, device=dev).expand(b, q)
    table = torch.full((b, vocab + 1), q, dtype=torch.int64, device=dev)
    table.scatter_(1, torch.where(q_real, q_term.long(), vocab), torch.where(q_real, slots, q))
    qw = torch.zeros(b, q + 1, dtype=torch.float64, device=dev)
    qw[:, :q] = torch.where(q_real, q_weight.double(), 0.0)
    term = term.long() if term_valid is None else torch.where(term_valid, term.long(), vocab)
    slot = table[:, term]  # [B, nnz]
    prod = weight.double() * qw.gather(1, slot)
    flat = slot.mul_(b).add_(torch.arange(b, device=dev)[:, None]).mul_(n_docs).add_(doc.long())
    return _ordered_scores(flat, prod, q, b, n_docs)


def _top_k(scores: torch.Tensor, k: int,  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: torch.sort gives int64 positions)
           doc_prior: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` highest scores of each row and their int32 doc ids, after
    the float32 prior if one is given; a stable sort keeps the lower doc id
    first."""
    if doc_prior is not None:
        scores = scores + doc_prior
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), idx[:, :k].int()


def score_query(  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: torch.nonzero gives int64 term ids)
    result: TfidfResult,
    query_weights: torch.Tensor,  # float32 [vocab]: the query's weight per term
    *,
    n_docs: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k query scoring: score(doc) = Σ_t w[doc, t]·q[t] in the module's
    order (float64, left to right in ascending term order, rounded to
    float32 once), then the ``k`` highest scores and their int32 doc ids.
    Equal scores keep the lower doc id first, as ``lax.top_k`` does in the
    reference.  The query's nonzero terms are its slots: learning them is
    this path's one host sync."""
    if not 0 <= k <= n_docs:
        raise ValueError(f"k must be in [0, n_docs={n_docs}], got {k}")
    q_term = torch.nonzero(query_weights).reshape(1, -1)  # graftlint: disable=transfer-census (ROADMAP Queue 3, host reads by design: the one-shot scorer learns the query's terms on the host, once a call)
    q_weight = query_weights[q_term]
    scores = _coo_scores(result.doc, result.term, result.weight, None, q_term, q_weight,
                         torch.ones_like(q_term, dtype=torch.bool), n_docs=n_docs,
                         vocab=query_weights.shape[0])
    top, idx = _top_k(scores, k)
    return top[0], idx[0]


def score_query_batch(
    doc: torch.Tensor,  # int32 [nnz] postings (on the device across calls)
    term: torch.Tensor,  # int32 [nnz]
    weight: torch.Tensor,  # float32 [nnz]
    valid: torch.Tensor,  # float32 [nnz]: 1.0 for real rows
    q_term: torch.Tensor,  # int32 [B, Q] canonical query term ids (padded)
    q_weight: torch.Tensor,  # float32 [B, Q] per-term query weights
    q_valid: torch.Tensor,  # float32 [B, Q]: 1.0 for real query slots
    doc_prior: torch.Tensor,  # float32 [n_docs] additive prior (e.g. scaled PageRank)
    *,
    n_docs: int,
    vocab: int,
    k: int,
    use_prior: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The serving path's batched scorer over every posting: per-query
    ``(scores [B, k], int32 doc ids [B, k])``, so the ``[B, n_docs]`` score
    matrix never leaves the device.  Each row's real terms must be
    ascending and distinct (``TfidfServer.make_query`` gives them so); a
    row's scores are :func:`score_query`'s bit for bit, plus the float32
    prior when ``use_prior``.  Nothing here waits for the device."""
    scores = _coo_scores(doc, term, weight, valid > 0, q_term, q_weight, q_valid > 0,
                         n_docs=n_docs, vocab=vocab)
    return _top_k(scores, k, doc_prior if use_prior else None)


def score_impacted_batch(  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: exact float64 products at int64 flat slots)
    doc: torch.Tensor,  # int32 [nnz] postings, (term, doc)-sorted
    weight: torch.Tensor,  # float32 [nnz] ranker weights over the same rows
    bucket_start: torch.Tensor,  # int32 [C] postings offset of each bucket's first row
    bucket_len: torch.Tensor,  # int32 [C] live rows in the bucket (0 for pad buckets)
    bucket_row: torch.Tensor,  # int32 [C] padded query row the bucket scores into
    bucket_qw: torch.Tensor,  # float32 [C] query weight of the bucket's term
    doc_prior: torch.Tensor,  # float32 [n_docs] additive prior
    *,
    bucket_slot: torch.Tensor,  # int32 [C] the term's position in its query row
    query_terms: int,  # Q, the slots a query row has
    n_docs: int,
    batch: int,
    bucket_width: int,
    k: int,
    use_prior: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The latency-shaped serving scorer: a padded query batch scored
    against only its query terms' posting runs, cut by the host planner
    (``serving/server.py``) into fixed-width buckets, so the work follows
    Σ df(query terms), not nnz.  Each live lane writes its exact product at
    its term's slot, so the scores are :func:`score_query_batch`'s bit for
    bit; dead lanes and pad buckets write the spare slot.  Doc ids are
    local to the postings (:func:`topk_merge` globalizes them)."""
    lane = torch.arange(bucket_width, device=doc.device)
    live = lane < bucket_len[:, None]  # [C, W]
    idx = torch.where(live, bucket_start[:, None].long() + lane, 0)
    prod = weight[idx].double() * bucket_qw.double()[:, None]
    slot = torch.where(live, bucket_slot[:, None].long(), query_terms)
    flat = slot.mul_(batch).add_(bucket_row[:, None].long()).mul_(n_docs).add_(doc[idx].long())
    scores = _ordered_scores(flat, prod, query_terms, batch, n_docs)
    return _top_k(scores, k, doc_prior if use_prior else None)


def topk_merge(seg_scores, seg_ids, seg_bases, *, k: int):  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, 64-bit values by design: torch.sort gives int64 positions)
    """Merge per-segment top-k candidates: ``seg_scores``/``seg_ids`` are
    per-segment ``[B, k_i]`` tensors (local int32 doc ids), ``seg_bases``
    the segments' global doc-id bases.  One stable sort of the candidates
    in base order, so only ``[B, k]`` leaves the device and a tie keeps the
    older (lower-base) segment, as ``lax.top_k`` does in the reference."""
    scores = torch.cat(list(seg_scores), dim=1)
    ids = torch.cat([i + int(b) for i, b in zip(seg_ids, seg_bases)], dim=1)
    top, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), ids.gather(1, pos[:, :k])
