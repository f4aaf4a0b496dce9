"""TF-IDF model drivers: batch and streaming ingest.

Counterpart of the JAX package's ``models/tfidf.py``.  The batch path
tokenizes on the host, runs one device pipeline (``ops/tfidf.py``) and
pulls the COO back.  The streaming path feeds fixed-capacity token chunks
through ``dataflow/ingest.chunked_ingest``: the DF carry and the document
count accumulate on the device and in host state, each chunk's TF counts
come back to the host, and IDF and the weights are a second pass at the
end, which gives the batch path's bits.

Checkpoints: every ``checkpoint_every`` chunks the accumulated ``(df,
n_docs, chunk_index, TF counts so far)`` is written in the JAX package's
format (``utils/checkpoint.py``), so either package resumes the other's.
A resume skips the chunks already ingested.

Faults: every host sync runs under the retry executor at the JAX
package's sites (``tfidf_batch_sync``, ``tfidf_chunk_sync``,
``tfidf_df_commit``, ``tfidf_finalize_sync``, and the staged ingest's
``ingest_h2d_put`` / ``ingest_h2d_wait``), so a transient fault retries
with the unfaulted run's bits.  A lost device that names its index hands
the stream to the CPU, as in the JAX package: host state rolls back to the
last commit point, and the uncommitted chunks replay on the CPU from the
host copies the pipeline kept (the ``tfidf.cpu_salvage`` span, one
``degraded`` event).  Any other loss, or a spent retry budget, raises
``ResilienceExhausted`` naming the newest checkpoint, from which
``resume=True`` continues.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ingest as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device
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
    # The device the output was computed on; a second weighting of the
    # same postings (BM25, dataflow/bm25.py) runs there too.  None means
    # cuda, as for every entry point.
    device: str | None = None

    @property
    def nnz(self) -> int:
        return int(self.doc.shape[0])

    def to_dense(self) -> np.ndarray:
        """[n_docs, vocab] dense matrix — tests/small corpora only."""
        out = np.zeros((self.n_docs, 1 << self.vocab_bits), dtype=self.weight.dtype)
        out[self.doc, self.term] = self.weight
        return out


def pipeline(corpus: tio.TokenizedCorpus, cfg: TfidfConfig,
             device: torch.device, *,
             metrics: MetricsRecorder | None = None) -> ops.TfidfResult:
    """The timed device part of :func:`run_tfidf`: copy the token arrays to
    ``device``, run ``ops.tfidf_pipeline``, and wait for it at the guarded
    ``tfidf_batch_sync`` fence.  An empty corpus counts as one document, as
    in the reference.  The whole of it is the ``tfidf.pipeline`` span."""
    with obs.span("tfidf.pipeline"):
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
        rx.block_until_ready(result, site="tfidf_batch_sync", metrics=metrics)
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
    C++ tokenizer ran) and a ``pipeline`` event; the tokenizer opens its
    own ``io.tokenize`` span and the device part (:func:`pipeline`) is a
    ``tfidf.pipeline`` span, as in the JAX package."""
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
        result = pipeline(corpus, cfg, dev, metrics=metrics)
    metrics.record(
        event="pipeline", pairs=result.n_pairs, secs=t_dev.elapsed,
        tokens_per_sec=corpus.n_tokens / t_dev.elapsed if t_dev.elapsed > 0 else float("inf"),
    )
    doc, term, weight, df, idf, count = (
        t.cpu().numpy()  # graftlint: disable=unguarded-host-sync (ROADMAP Queue 3: run_tfidf pulls its results after the guarded tfidf_batch_sync fence)
        for t in (result.doc, result.term, result.weight, result.df, result.idf, result.count))
    return TfidfOutput(
        n_docs=corpus.n_docs,
        vocab_bits=cfg.vocab_bits,
        doc=doc,
        term=term,
        weight=weight,
        df=df,
        idf=idf,
        metrics=metrics,
        count=count,
        doc_lengths=corpus.doc_lengths,
        device=str(dev),
    )


grow_chunk_cap = dflow.grow_chunk_cap


def stream_pad_plan(
    raw_token_counts: Sequence[int], cap: int = 0
) -> list[tuple[str, float]]:
    """Padding-waste plan of the streaming ingest: run the raw per-chunk
    token counts through :func:`grow_chunk_cap` (nothing runs on a device)
    and return ``[("stream", pad_frac)]``, the share of the token slots the
    chunks are padded to that hold padding."""
    log = logging.getLogger("pr_tfidf_torch")
    was_disabled = log.disabled
    log.disabled = True  # cap-bump records are run telemetry, not a plan's
    try:
        metrics = MetricsRecorder()
        total_raw = 0
        total_cap = 0
        for raw in raw_token_counts:
            cap, _ = grow_chunk_cap(raw, cap, metrics)
            total_raw += int(raw)
            total_cap += cap
    finally:
        log.disabled = was_disabled
    pad_frac = (total_cap - total_raw) / max(total_cap, 1)
    return [("stream", pad_frac)]


@dataclasses.dataclass
class IngestState:
    """Accumulated streaming-ingest state: what a checkpoint snapshots, so
    a killed run resumes at the first unprocessed chunk.  ``ingest_secs``
    is the wall time up to the last checkpoint, carried across resumes."""

    df_total: np.ndarray  # float32 [vocab]
    chunk_index: int = 0  # chunks fully ingested (== next chunk to process)
    n_docs: int = 0
    n_tokens: int = 0
    ingest_secs: float = 0.0
    parts: list = dataclasses.field(default_factory=list)  # (doc, term, count)
    doc_length_parts: list = dataclasses.field(default_factory=list)


def resume_point(cfg: TfidfConfig) -> int:
    """Chunk index a ``resume=True`` run starts at (0 = from scratch).
    Reads checkpoint metadata only, so a caller can skip reading the
    ingested prefix (``io.text.iter_corpus_chunks(skip_chunks=...)``)."""
    if not cfg.checkpoint_dir:
        return 0
    latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
    if latest is None:
        return 0
    return int(ckpt.peek_meta(latest)["step"])


def resume_ingest(cfg: TfidfConfig, metrics: MetricsRecorder) -> IngestState:
    """Load the latest ingest checkpoint, the JAX package's or the port's;
    a zero state when there is none.  Raises under another semantic
    configuration (``config_hash``)."""
    if not cfg.checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    fresh = IngestState(df_total=np.zeros(cfg.vocab_size, np.float32))
    latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
    if latest is None:
        return fresh
    chunk_index, arrays, extra = ckpt.load_checkpoint(latest, cfg.config_hash())
    st = IngestState(
        df_total=arrays["df"].astype(np.float32),  # integers: exact
        chunk_index=int(chunk_index),
        n_docs=int(extra["n_docs"]),
        n_tokens=int(extra.get("n_tokens", 0)),
        ingest_secs=float(extra.get("ingest_secs", 0.0)),
        parts=[(arrays["doc"], arrays["term"], arrays["count"])],
        doc_length_parts=[arrays["doc_lengths"]],
    )
    metrics.record(event="resume", path=latest, chunk=st.chunk_index, docs=st.n_docs)
    return st


def save_ingest_checkpoint(
    cfg: TfidfConfig, metrics: MetricsRecorder, st: IngestState,
    extra_meta: dict | None = None,
) -> None:
    """Snapshot the accumulated state, compacting the part lists in place
    so host memory stays flat across checkpoints."""
    doc_a, term_a, count_a = (np.concatenate(x) for x in zip(*st.parts))
    st.parts = [(doc_a, term_a, count_a)]
    st.doc_length_parts = [np.concatenate(st.doc_length_parts)]
    path = ckpt.save_checkpoint(
        cfg.checkpoint_dir,
        st.chunk_index,
        {
            "df": st.df_total, "doc": doc_a, "term": term_a, "count": count_a,
            "doc_lengths": st.doc_length_parts[0],
        },
        cfg.config_hash(),
        extra={
            "n_docs": st.n_docs,
            "n_tokens": st.n_tokens,
            "ingest_secs": round(st.ingest_secs, 3),
            **(extra_meta or {}),
        },
    )
    metrics.record(event="checkpoint", path=path, chunk=st.chunk_index)


def finalize_tfidf(
    st: IngestState,
    cfg: TfidfConfig,
    metrics: MetricsRecorder,
    device: torch.device,
) -> TfidfOutput:
    """The streaming path's second pass, on ``device`` at every size: IDF
    from the accumulated DF, then ``ops.finalize_weights`` over the COO.

    The COO stays in chunk order (the reference's too).  A document lies in
    one chunk and a chunk's rows are term-major, so each document's rows
    come in the order the batch COO holds them, and the per-document sums
    of the L2 norm add in the same order: the batch path's bits.  Where the
    JAX package takes a float32 numpy branch below ``DEVICE_FINALIZE_MIN_NNZ``
    pairs, the port has one path, the batch path's formulas.  After a
    salvage the stream's device is the CPU, and the second pass runs there
    (the reference's stays on its default device)."""
    n_docs = st.n_docs
    if not st.parts:
        z = np.zeros(0, np.int32)
        return TfidfOutput(0, cfg.vocab_bits, z, z, np.zeros(0, np.float32), st.df_total,
                           np.zeros(cfg.vocab_size, np.float32), metrics, device=str(device))

    doc_a = np.concatenate([p[0] for p in st.parts])
    term_a = np.concatenate([p[1] for p in st.parts])
    count_a = np.concatenate([p[2] for p in st.parts]).astype(np.float32)
    doc_lengths = np.concatenate(st.doc_length_parts)

    with obs.span("tfidf.finalize", nnz=int(doc_a.shape[0])), Timer() as t_fin:
        def put(a):
            return torch.from_numpy(a).to(device)

        idf_dev = ops.idf_vector(put(st.df_total), max(n_docs, 1), cfg.idf_mode)
        idf = rx.device_get(idf_dev, site="tfidf_finalize_sync", metrics=metrics,
                            checkpoint_dir=cfg.checkpoint_dir)
        weight = rx.device_get(ops.finalize_weights(
            put(doc_a), put(count_a), put(doc_lengths), idf_dev[put(term_a)],
            n_docs=max(n_docs, 1), tf_mode=cfg.tf_mode, l2_normalize=cfg.l2_normalize,
        ), site="tfidf_finalize_sync", metrics=metrics, checkpoint_dir=cfg.checkpoint_dir)
    metrics.record(event="finalize", where=device.type, nnz=int(doc_a.shape[0]),
                   secs=t_fin.elapsed)
    metrics.scalar("n_docs", n_docs)
    metrics.scalar("nnz", int(doc_a.shape[0]))
    return TfidfOutput(
        n_docs=n_docs, vocab_bits=cfg.vocab_bits,
        doc=doc_a, term=term_a, weight=weight,
        df=st.df_total, idf=idf, metrics=metrics,
        count=count_a, doc_lengths=doc_lengths, device=str(device),
    )


def _tokenized_chunks(
    doc_chunks: Iterable[Sequence[str]],
    cfg: TfidfConfig,
    start_chunk: int,
    n_docs0: int,
) -> Iterator[tuple[int, tio.TokenizedCorpus]]:
    """Tokenize chunks in order with globally unique doc ids, skipping the
    chunks a resumed run already ingested.  When the skipped prefix comes as
    real chunks (not ``iter_corpus_chunks(skip_chunks=...)``'s empty
    placeholders, which check on their own side), its document count must
    equal the checkpoint's: a corpus chunked differently would otherwise
    skip the wrong documents."""
    n_docs = n_docs0
    skipped_docs = 0
    for i, docs in enumerate(doc_chunks):
        if i < start_chunk:
            skipped_docs += len(docs)
            if i == start_chunk - 1 and skipped_docs not in (0, n_docs0):
                raise ValueError(
                    f"resume chunking mismatch: the skipped prefix of "
                    f"{start_chunk} chunk(s) holds {skipped_docs} documents "
                    f"but the checkpoint ingested {n_docs0}; rerun with the "
                    "original chunking (e.g. the same --chunk-docs)"
                )
            continue
        if n_docs + len(docs) > 1 << ops.DOC_BITS:
            raise ValueError(f"streaming ingest holds doc ids below 2^{ops.DOC_BITS}; "
                             f"chunk {i} would reach {n_docs + len(docs)} documents")
        corpus = tio.tokenize_corpus(  # opens its own io.tokenize span
            docs,
            vocab_bits=cfg.vocab_bits,
            ngram=cfg.ngram,
            lowercase=cfg.lowercase,
            min_token_len=cfg.min_token_len,
            doc_id_offset=n_docs,
        )
        n_docs += corpus.n_docs
        yield i, corpus


def _pull(counts: ops.PaddedCounts):
    """Queue one chunk's result copies to pinned host memory on the current
    stream and record an event after them: (host tensors, event).  On the
    CPU the tensors are already on the host (no event)."""
    tensors = (counts.doc, counts.term, counts.count, counts.n_pairs)
    if counts.doc.device.type != "cuda":
        return tensors, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                 for t in tensors)
    event = torch.cuda.Event()
    event.record()
    return host, event


# The commit barrier's interval, in chunks, where checkpointing is off: it
# bounds how many drained chunks' host copies retain_until_commit holds (the
# salvage replays at most this span after a device loss).  At 2^18-token
# chunks that keeps about 16M tokens of int32 pairs: flat host memory, for
# one pipeline drain every 16 chunks.
_RETAIN_COMMIT_EVERY = 16


def run_tfidf_streaming(
    doc_chunks: Iterable[Sequence[str]],
    cfg: TfidfConfig,
    *,
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> TfidfOutput:
    """Streaming TF-IDF over an iterable of document chunks, on ``cuda``
    unless ``device`` says otherwise.

    Documents never span chunks, so per-chunk DF increments add up to the
    exact global DF.  Chunks are padded to a fixed capacity
    (``cfg.chunk_tokens``, or the first chunk's size rounded up to a power
    of two); a larger chunk doubles it (a ``chunk_cap_bump`` record).

    The pipeline (``chunked_ingest``): a thread tokenizes up to
    ``cfg.prefetch`` chunks ahead; a transfer thread writes each into a
    pinned slot of a :class:`~..dataflow.ingest.StagingRing` of
    ``cfg.pipeline_depth + 1`` slots and copies it to the device on the
    ring's stream; the main thread makes the compute stream wait on that
    copy, queues ``ops.chunk_counts_carry`` and the copies of its results
    to pinned host memory, and drains a chunk (one wait on one event) once
    ``cfg.prefetch`` launches are in flight.  ``prefetch=0,
    pipeline_depth=0`` is fully serial.  ``cfg.pack_target_tokens > 0``
    re-packs the chunks to fill the capacity.  Every depth gives the same
    bits.

    The DF carry stays on the device and reaches the host only at commit
    points, the checkpoints and the end (and every ``_RETAIN_COMMIT_EVERY``
    chunks where checkpointing is off), behind the drain-before-commit
    barrier.  A fault anywhere (a thread's included) stops the pipeline.
    A lost device that names its index (``device_lost``) is acknowledged,
    host state rolls back to the last commit point, the DF carry is rebuilt
    on the CPU from the committed host DF, and the pipeline replays the
    uncommitted chunks on the CPU from the host copies it kept
    (``retain_until_commit``), in stream order; the second pass then runs
    on the CPU too.  Committed chunks are never reprocessed.  Any other
    fault raises with its traceback; the last checkpoint stays resumable.
    """
    dev = resolve_device(device)
    metrics = metrics or MetricsRecorder()
    vocab = cfg.vocab_size
    cap = cfg.chunk_tokens

    st = (resume_ingest(cfg, metrics) if resume
          else IngestState(df_total=np.zeros(vocab, np.float32)))
    secs0 = st.ingest_secs
    run_started = time.perf_counter()
    last_ckpt = st.chunk_index
    df_dev = torch.tensor(st.df_total, device=dev)  # the DF carry, updated in place
    ring = dflow.StagingRing(dev, cfg.pipeline_depth + 1)

    if cfg.pack_target_tokens > 0:
        doc_chunks = dflow.pack_doc_chunks(
            doc_chunks, cfg.pack_target_tokens,
            estimate=dflow.ngram_estimator(cfg.ngram))
    source = _tokenized_chunks(doc_chunks, cfg, st.chunk_index, st.n_docs)

    # The rollback point of the salvage: st as it stood at the last commit.
    # Chunks drained since have host TF parts, but their DF lives only in
    # the device carry; the salvage truncates them here and the pipeline
    # replays their kept host copies.
    committed: dict = {}

    def snap_commit() -> None:
        committed.update(
            parts=len(st.parts), dls=len(st.doc_length_parts),
            n_docs=st.n_docs, n_tokens=st.n_tokens, chunk=st.chunk_index,
        )

    snap_commit()

    def stage_chunk(item):
        """The H2D stage (the transfer thread when pipeline_depth > 0): one
        tokenized chunk into the ring at the current capacity."""
        nonlocal cap
        i, corpus = item
        cap, _ = grow_chunk_cap(corpus.n_tokens, cap, metrics, chunk=i)
        tokens, copied = dflow.staged_put(
            lambda: ring.stage((corpus.doc_ids, corpus.term_ids), cap), metrics=metrics)
        return i, corpus, tokens, copied

    def launch(staged):
        """Queue one chunk's compute and its result copies; nothing waits
        for the device here."""
        nonlocal df_dev
        i, corpus, tokens, copied = staged
        with Timer() as t:
            tokens = ring.consume(tokens, copied)
            valid = torch.arange(tokens.shape[1], device=dev) < corpus.n_tokens
            # the carry is updated in place; rebinding it keeps the read
            # of the carry after this call a read of what the call returned
            counts, df_dev = ops.chunk_counts_carry(tokens[0], tokens[1], valid, df_dev,
                                                    vocab=vocab)
            pulled = _pull(counts)
        return i, pulled, corpus.doc_lengths, corpus.n_docs, corpus.n_tokens, t

    def drain_one(rec):
        i, (host, done), doc_lengths, n_chunk_docs, n_tokens, t = rec
        with Timer() as t_sync, obs.span("tfidf.chunk", chunk=i):
            # the wait and the host reads are the guarded tfidf_chunk_sync
            # site; the append below is not, so a retry appends nothing twice
            def wait_and_read():
                if done is not None:
                    done.synchronize()
                return tuple(x.numpy() for x in host)

            h_doc, h_term, h_count, h_n_pairs = rx.run_guarded(
                wait_and_read, site="tfidf_chunk_sync", metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )
            k = int(h_n_pairs)
            # copies, so parts hold k rows and not views of cap-sized buffers
            st.parts.append((h_doc[:k].copy(), h_term[:k].copy(), h_count[:k].copy()))
        st.doc_length_parts.append(doc_lengths)
        st.n_docs += n_chunk_docs
        st.n_tokens += n_tokens
        st.chunk_index = i + 1
        metrics.record(event="chunk", chunk=i, docs=st.n_docs, tokens=n_tokens,
                       pairs=k, dispatch_secs=round(t.elapsed, 6),
                       secs=t_sync.elapsed)
        obs.counter("tfidf.chunks")
        obs.histogram("tfidf.chunk_secs", t_sync.elapsed)

    def commit_df():
        # chunked_ingest commits with nothing in flight, so the carry holds
        # exactly the chunks the state counts as ingested
        with obs.span("tfidf.df_commit"):
            st.df_total = rx.device_get(
                df_dev, site="tfidf_df_commit", metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )
        snap_commit()

    def recover(exc, remaining, where):
        """The salvage of the staged pipeline: a loss that names its device,
        anywhere in it (the transfer thread's put included), rolls host
        state back to the last commit and replays the rest on the CPU.
        Anything else (``GRAFT_ELASTIC=0``, a whole-backend loss) re-raises."""
        nonlocal dev, ring, df_dev
        lost = elastic.unwrap_device_loss(exc)
        idx = elastic.device_index(lost) if lost is not None else None
        if not elastic.enabled() or idx is None:
            raise exc
        elastic.health().mark_lost(idx)
        site = {"stage": dflow.H2D_PUT_SITE,
                "wait": dflow.H2D_WAIT_SITE}.get(where, "tfidf_chunk_sync")
        rerun = st.chunk_index - committed["chunk"]
        obs.emit("degraded", site=site, ladder="cpu",
                 salvage_chunk=committed["chunk"], rerun_chunks=rerun,
                 error=f"{type(exc).__name__}: {exc}"[:200])
        obs.counter("degraded")
        metrics.record(event="degraded", site=site, ladder="cpu",
                       salvage_chunk=committed["chunk"], rerun_chunks=rerun)
        with obs.span("tfidf.cpu_salvage", at_chunk=committed["chunk"],
                      rerun_chunks=rerun):
            del st.parts[committed["parts"]:]
            del st.doc_length_parts[committed["dls"]:]
            st.n_docs = committed["n_docs"]
            st.n_tokens = committed["n_tokens"]
            st.chunk_index = committed["chunk"]
            # the closures read these at call time; the card's in-flight
            # pulls and their events went with the pipeline's records, and
            # the old ring is not waited on: its card may be gone
            dev = torch.device("cpu")
            ring = dflow.StagingRing(dev, cfg.pipeline_depth + 1)
            df_dev = torch.tensor(st.df_total, device=dev)
        return remaining

    def checkpoint_due() -> bool:
        if cfg.checkpoint_every > 0 and cfg.checkpoint_dir:
            return st.chunk_index - last_ckpt >= cfg.checkpoint_every
        # Checkpointing off: retain_until_commit would otherwise hold every
        # drained chunk's host copy until the one commit at the end, a
        # second copy of the corpus.  A commit with no snapshot file every
        # _RETAIN_COMMIT_EVERY chunks keeps host memory flat.
        return st.chunk_index - last_ckpt >= _RETAIN_COMMIT_EVERY

    def save_ckpt():
        nonlocal last_ckpt
        last_ckpt = st.chunk_index
        if not (cfg.checkpoint_every > 0 and cfg.checkpoint_dir):
            return  # the barrier's commit already ran
        st.ingest_secs = secs0 + (time.perf_counter() - run_started)
        save_ingest_checkpoint(cfg, metrics, st)
        # the save compacts st.parts in place: the rollback point's list
        # indices must match the compacted lists
        snap_commit()

    with obs.span("tfidf.stream", resume_chunk=st.chunk_index):
        dflow.chunked_ingest(
            source,
            stage=stage_chunk,
            launch=launch,
            drain=drain_one,
            commit=commit_df,
            ingest=cfg.ingest(),
            checkpoint_due=checkpoint_due,
            save_checkpoint=save_ckpt,
            recover=recover,
            retain_until_commit=True,
            metrics=metrics,
        )

    return finalize_tfidf(st, cfg, metrics, dev)
