"""Long-lived TF-IDF query server: device-resident postings, padded
micro-batches, top-k on the device, a hot-query LRU cache, and
impacted-list scoring over live delta segments.

Counterpart of the JAX package's ``serving/server.py``, in PyTorch on one
device (``cuda`` unless the caller asks for the CPU).  Request lifecycle::

    submit(terms) ──► bounded queue ──► drain thread ──► LRU cache?
                                                 │ miss
                                                 ▼
                      pad to batch cap (grow_chunk_cap, min_bits=0)
                                                 ▼
            ┌─ scoring="coo":      ops.score_query_batch per segment
            └─ scoring="impacted": host planner slices each query term's
               posting run from the CSC-by-term offsets, pads the runs
               into fixed-width buckets, ONE ops.score_impacted_batch
               dispatch per segment — work ∝ Σ df(query terms), not nnz
                                                 ▼
                      >1 live segment: ops.topk_merge (on the device,
                      globalizes doc ids; only [B, k] crosses D2H)
                                                 ▼
                      one pull ──► per-request futures resolve

Design points:

- **Finite batch-shape matrix.**  A micro-batch of ``b`` misses pads to
  ``grow_chunk_cap(b, 0, min_bits=0)`` — the next power of two — clipped
  by ``max_batch``, so a dispatch only ever sees ``{1, 2, 4, ...,
  max_batch}`` rows.  Nothing compiles here, but :meth:`TfidfServer.warmup`
  still runs every shape once against every live segment (and the merge),
  so the first launches and the caching allocator's first blocks are paid
  before traffic.  The impacted path pads one more axis, the bucket count,
  to a carried power of two (``grow_chunk_cap`` at
  ``IMPACT_MIN_BUCKET_BITS``), pre-grown by the warmup.
- **One order of every sum.**  Both scorers write each exact float64
  product at its query term's slot and add the slots left to right
  (``ops/tfidf.py``), so impacted results equal COO results, and a served
  result equals the one-shot ``ops.score_query``, bit for bit, on the CPU
  and on the card.
- **One pull a batch.**  The scorers never wait for the device: no
  ``.item()``, ``nonzero`` or ``unique`` on the serve path.  The host plans
  go up as small copies and the ``[cap, k]`` pair comes back once.
- **One stream.**  The drain thread runs on the stream that was current
  where the server started; ``set_prior`` and ``refresh_segments`` build
  their tensors on it too, so a batch is ordered after the state it reads,
  and tensors an in-flight batch still holds stay alive until it is done.
- **Segments.**  The server holds N live segments (delta commits of the
  streaming ingest — ``serving/segments.py``) and scores a batch across
  all of them with a merge of per-segment top-k.  :meth:`refresh_segments`
  hot-swaps the live set without restart: the new device state is built
  and warmed first, then swapped under the lock; in-flight batches finish
  against the old buffers, and the result cache is invalidated by
  generation.
- **Resilience.**  The dispatch and the pull run under the retry executor
  (sites ``serve_dispatch`` / ``serve_pull``, the warmup's fence
  ``serve_warmup``): a transient fault retries invisibly; anything else
  fails exactly its batch's futures with ``ResilienceExhausted`` and the
  queue keeps draining.  A retried dispatch re-uploads its plans into
  fresh pinned tensors and scores into fresh buffers (the float64 slot
  buffer is allocated per call), so an abandoned attempt writes nothing a
  retry reads.  Nothing moves to the CPU.
- **Telemetry.**  Every batch is a ``serve.batch`` span with ``serve.pad``
  / ``serve.dispatch`` / ``serve.pull`` children; every request publishes
  a ``serve_request`` event carrying queue-wait and total latency, so
  ``tools/trace_report.py`` renders queue-wait vs pad vs dispatch vs pull
  and per-request p50/p99 from the trace alone.
- **LRU.**  Results are cached under a hash of the *canonical* query
  vector (term-id-sorted, duplicate terms combined), so "foo bar" and
  "bar foo" hit the same entry; hits resolve on the drain thread without
  touching the device and publish ``serve.cache_hits`` counters.
  :meth:`TfidfServer.cache_lookup` and :meth:`TfidfServer.cache_insert`
  read and fill it under the same key for the fleet's peer cache
  (``serving/fabric.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import grow_chunk_cap
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.artifact import ServableIndex
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.segments import (
    LoadedSegment,
    SegmentSet,
    wrap_index_as_set,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    TUNABLE_DEFAULTS,
    TfidfConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
    resolve_device,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

# Floor of the impacted-list bucket-count cap: the carried pow2 cap starts
# at 2**this and doubles on demand, the streaming chunk-cap policy at a
# serving-sized floor.
IMPACT_MIN_BUCKET_BITS = 6

# How long stop() waits for the drain thread to finish the batch in hand.
JOIN_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Operational knobs of one server instance (semantics live in the
    index artifact's TfidfConfig — a server never re-interprets weights)."""

    top_k: int = 10
    # micro-batch cap; padded shapes are pow2 <= this
    max_batch: int = TUNABLE_DEFAULTS["max_batch"]
    max_query_terms: int = 16  # Q: fixed per-query sparse slot count
    queue_depth: int = 64  # bound on submitted-but-undrained requests
    flush_ms: float = 2.0  # how long the drain waits to fill a batch
    cache_size: int = 1024  # LRU entries (0 disables the result cache)
    rank_alpha: float = 0.0  # additive PageRank-prior scale (0 = off),
    # applied to EVERY request (the server-level blend)
    prior_alpha: float = 0.0  # per-REQUEST PageRank-prior scale: > 0
    # enables ranker="prior" (tfidf weights + prior_alpha * ranks for
    # exactly the requests that opt in); the prior is a per-dispatch
    # operand, so tfidf/bm25/prior share every batch shape
    scoring: str = "coo"  # "coo" (every posting) or "impacted" (CSC-by-term
    # run slicing — work ∝ the query's terms' posting runs; equal results)
    # fixed bucket width W the impacted planner pads posting runs to
    # (sort_shuffle's bucket trick)
    impact_bucket_width: int = TUNABLE_DEFAULTS["impact_bucket_width"]
    impact_warm_buckets: int = TUNABLE_DEFAULTS[
        "impact_warm_buckets"]  # ceiling on the bucket cap the warmup
    # PRE-GROWS to (sized from the live set's heaviest posting runs); the
    # cap can still grow past it at serve time (logged)

    def __post_init__(self) -> None:
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_query_terms < 1:
            raise ValueError(
                f"max_query_terms must be >= 1, got {self.max_query_terms}"
            )
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.cache_size < 0 or self.rank_alpha < 0 or self.prior_alpha < 0:
            raise ValueError(
                "cache_size, rank_alpha and prior_alpha must be >= 0"
            )
        if self.scoring not in ("coo", "impacted"):
            raise ValueError(
                f"scoring must be 'coo' or 'impacted', got {self.scoring!r}"
            )
        if self.impact_bucket_width < 2:
            raise ValueError(
                f"impact_bucket_width must be >= 2, got "
                f"{self.impact_bucket_width}"
            )
        if self.impact_warm_buckets < (1 << IMPACT_MIN_BUCKET_BITS):
            raise ValueError(
                f"impact_warm_buckets must be >= {1 << IMPACT_MIN_BUCKET_BITS}, "
                f"got {self.impact_warm_buckets}"
            )


def batch_cap(b: int, max_batch: int, metrics: MetricsRecorder) -> int:
    """The serving micro-batcher's padding policy: literally
    :func:`models.tfidf.grow_chunk_cap` with ``min_bits=0`` and no carried
    cap — a batch of ``b`` pads to the next power of two, clipped by
    ``max_batch``."""
    cap, _ = grow_chunk_cap(min(b, max_batch), 0, metrics, min_bits=0)
    return min(cap, max_batch)


def batch_shape_matrix(max_batch: int) -> list[int]:
    """Every padded batch size the policy can produce: the finite shape
    matrix the warmup runs."""
    caps: list[int] = []
    metrics = MetricsRecorder()
    for b in range(1, max_batch + 1):
        c = batch_cap(b, max_batch, metrics)
        if c not in caps:
            caps.append(c)
    return caps


def serve_pad_plan(
    batch_sizes: Sequence[int],
    max_batch: int = TUNABLE_DEFAULTS["max_batch"],
) -> list[tuple[str, float]]:
    """Padding waste of the serving micro-batcher: raw batch sizes through
    the real :func:`batch_cap` policy, as ``[("serve", pad_frac)]``, the
    serving counterpart of ``models.tfidf.stream_pad_plan``."""
    metrics = MetricsRecorder()
    total_raw = 0
    total_cap = 0
    for b in batch_sizes:
        total_raw += min(int(b), max_batch)
        total_cap += batch_cap(int(b), max_batch, metrics)
    pad_frac = (total_cap - total_raw) / max(total_cap, 1)
    return [("serve", pad_frac)]


def impacted_pad_plan(
    bucket_counts: Sequence[int], *, min_bits: int = IMPACT_MIN_BUCKET_BITS
) -> list[tuple[str, float]]:
    """Padding waste of the impacted-list bucket axis: raw per-batch bucket
    counts through the real carried grow_chunk_cap policy (pow2 floor
    ``2**min_bits``, doubling bumps), as ``[("impacted", pad_frac)]``."""
    metrics = MetricsRecorder()
    cap = 0
    total_raw = 0
    total_cap = 0
    for n in bucket_counts:
        cap, _ = grow_chunk_cap(max(int(n), 1), cap, metrics,
                                min_bits=min_bits)
        total_raw += int(n)
        total_cap += cap
    pad_frac = (total_cap - total_raw) / max(total_cap, 1)
    return [("impacted", pad_frac)]


# "prior" scores with the tfidf weight table plus the per-request
# PageRank-prior blend (ServeConfig.prior_alpha).  All rankers share every
# batch shape: the weight table AND the prior vector are operands.
RANKERS = ("tfidf", "bm25", "prior")


class ServerShutdown(RuntimeError):
    """The server stopped (graceful drain) while this request was in
    flight, or a submit arrived after stop().  Typed so a caller can tell
    an orderly shutdown (re-submit elsewhere) from a real serving failure:
    a stopped server never hangs a client, it fails fast with this."""


class _Pending:
    """One in-flight request: a tiny future the drain thread resolves."""

    __slots__ = ("key", "q_term", "q_weight", "ranker", "t_submit", "t_done",
                 "t_queue_wait", "cache", "_event", "_result", "_error")

    def __init__(self, key: bytes, q_term: np.ndarray, q_weight: np.ndarray,
                 ranker: str = "tfidf"):
        self.key = key
        self.q_term = q_term
        self.q_weight = q_weight
        self.ranker = ranker
        self.t_submit = time.perf_counter()
        self.t_done: float | None = None
        self.t_queue_wait = 0.0
        self.cache = "miss"
        self._event = threading.Event()
        self._result: tuple[np.ndarray, np.ndarray] | None = None
        self._error: BaseException | None = None

    def _resolve(self, result: tuple[np.ndarray, np.ndarray]) -> None:
        self._result = result
        self.t_done = time.perf_counter()
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self.t_done = time.perf_counter()
        self._event.set()

    @property
    def done(self) -> bool:
        """True once the request resolved or failed (non-blocking)."""
        return self._event.is_set()

    @property
    def error(self) -> BaseException | None:
        """The failure that resolved this request, or None (non-blocking)."""
        return self._error

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self, timeout: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Block for this request's ``(scores[k], doc_ids[k])``; re-raises
        the batch's failure."""
        if not self._event.wait(timeout):
            raise TimeoutError("serve request did not complete in time")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


_STOP = object()


@dataclasses.dataclass
class _DevSegment:
    """Device-resident serving state of ONE live segment."""

    name: str
    doc_base: int
    n_docs: int
    nnz: int
    k: int  # per-segment top-k width (min(server k, n_docs))
    dev_doc: torch.Tensor  # int32 [nnz] on the device
    dev_term: torch.Tensor | None  # int32 [nnz] (COO path; None on impacted)
    valid: torch.Tensor | None  # f[nnz] (COO path; None on impacted)
    weights: dict  # ranker -> device weight table [nnz]
    offsets: np.ndarray | None  # int64 [vocab+1] host CSC slice table
    # (None only on a legacy COO-only artifact)
    ranks: np.ndarray | None  # host prior source (segment-local slice)
    prior: torch.Tensor | None = None  # every-request blend operand [n_docs]
    prior_req: torch.Tensor | None = None  # ranker="prior" operand [n_docs]


@dataclasses.dataclass(frozen=True)
class _ServingView:
    """What ``server.index`` exposes when the server fronts a segment set
    (aggregate stats; the per-segment artifacts live in the set)."""

    version: int
    n_docs: int
    nnz: int
    vocab_bits: int
    cfg: TfidfConfig
    weight: np.ndarray  # zero-length dtype carrier
    ranks: np.ndarray | None
    bm25_weight: np.ndarray | None
    segments: int

    @property
    def vocab_size(self) -> int:
        return 1 << self.vocab_bits


def _set_view(segset: SegmentSet) -> _ServingView:
    dtype = segset.segments[0].weights["tfidf"].dtype
    marker = np.zeros(0, dtype)
    return _ServingView(
        version=segset.version,
        n_docs=segset.n_docs,
        nnz=segset.nnz,
        vocab_bits=segset.vocab_bits,
        cfg=segset.cfg,
        weight=marker,
        ranks=marker if segset.has_ranks else None,
        bm25_weight=marker if segset.has_bm25 else None,
        segments=len(segset.segments),
    )


def _check_impacted_servable(cfg: ServeConfig, segset: SegmentSet) -> None:
    """The impacted path needs real CSC offsets: a legacy (pre-offsets,
    non-term-sorted) artifact loads with ``term_offsets=None`` and can
    only serve via the COO path — refusing beats silently slicing runs
    that do not exist."""
    if cfg.scoring != "impacted":
        return
    for seg in segset.segments:
        if seg.term_offsets is None:
            raise ValueError(
                f"scoring='impacted' needs the CSC-by-term offsets, but "
                f"segment {seg.ref.name} is a legacy non-term-sorted "
                "artifact (COO-only) — rebuild it with this version, or "
                "serve with scoring='coo'"
            )
        if seg.ref.nnz >= 1 << 31:
            # bucket_start is int32 on the device; a single segment past
            # 2^31 postings would wrap its run starts into silently wrong
            # scores.  Split the corpus into segments instead.
            raise ValueError(
                f"segment {seg.ref.name} holds {seg.ref.nnz} postings — "
                "impacted scoring addresses segments with int32 offsets; "
                "split the index into (merge-bounded) segments under "
                "2^31 nnz each"
            )


class TfidfServer:
    """The long-lived online query path over one :class:`ServableIndex`
    or a live :class:`~..serving.segments.SegmentSet`, on ``device``
    (``cuda`` unless the caller asks for the CPU; a missing card raises).

    Usage::

        index = serving.load_index("/path/to/index")
        with TfidfServer(index, ServeConfig(top_k=10)) as srv:
            scores, docs = srv.query(["apollo", "guidance"])

    ``start()`` puts the postings on the device once and (by default)
    warms every padded batch shape; ``submit`` is thread-safe and returns
    a future.  :meth:`refresh_segments` hot-swaps the live set (a new delta
    commit, a background merge) without restart.
    """

    def __init__(
        self,
        index: "ServableIndex | SegmentSet",
        cfg: ServeConfig = ServeConfig(),
        *,
        metrics: MetricsRecorder | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if isinstance(index, SegmentSet):
            segset = index
            self.index: "ServableIndex | _ServingView" = _set_view(segset)
        else:
            segset = wrap_index_as_set(index)
            self.index = index
        if segset.n_docs < 1 or segset.nnz < 1:
            raise ValueError("cannot serve an empty index")
        if (cfg.rank_alpha > 0 or cfg.prior_alpha > 0) and not segset.has_ranks:
            raise ValueError(
                "rank_alpha/prior_alpha > 0 needs a PageRank prior in the "
                "index (save_index(..., ranks=...))"
            )
        _check_impacted_servable(cfg, segset)
        self._segset = segset
        # the host dtype of the weight tables (every set a server takes
        # shares the config, so the dtype too)
        self._dtype = segset.segments[0].weights["tfidf"].dtype
        self.cfg = cfg
        self.metrics = metrics or MetricsRecorder()
        self.k = min(cfg.top_k, segset.n_docs)
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
        self._thread: threading.Thread | None = None
        self._stream: torch.cuda.Stream | None = None
        self._started = False
        self._stopped = False  # distinguishes drained from never-started
        self._cache: collections.OrderedDict[bytes, tuple] = collections.OrderedDict()
        self._lock = threading.Lock()  # cache + stats + live segment list
        # Orders submit()'s {started-check, enqueue} against stop()'s flag
        # flip.  Deliberately NOT self._lock: the drain thread takes that
        # one per batch, and a submitter may block on a full queue while
        # holding this lock — the drain must be free to keep consuming.
        self._submit_lock = threading.Lock()
        self._stats = collections.Counter()
        self._segs: list[_DevSegment] = []  # live device state, base order
        self._prior_gen = 0  # bumped per prior swap AND per segment
        # refresh; the stale-result cache guard
        self._use_prior = False
        self._bucket_cap = 0  # carried impacted bucket-count cap (pow2)
        # the last hot-swapped GLOBAL prior (set_prior): refresh_segments
        # re-applies it to the new live set — a commit landing between
        # two prior ticks must not silently revert serving to the
        # artifact-carried placeholder priors
        self._prior_ranks: np.ndarray | None = None

    # ------------------------------------------------------------ lifecycle

    def _on_stream(self):
        """Run on the server's stream (the one current at start)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the server's device (a read-only mapped array
        is copied first: torch cannot wrap it)."""
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A batch's small host plan on the device without waiting for it:
        staged through pinned memory, so the copy queues behind the
        stream's work where a pageable one would wait for it."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _build_seg(self, seg: LoadedSegment, k: int) -> _DevSegment:
        """Put one segment's serving state on the device (mmap pages fault
        in exactly once; queries then touch only device memory)."""
        idx = seg.index
        weights = {r: self._put(w) for r, w in seg.weights.items()}
        coo = self.cfg.scoring == "coo"
        return _DevSegment(
            name=seg.ref.name,
            doc_base=seg.ref.doc_base,
            n_docs=idx.n_docs,
            nnz=idx.nnz,
            k=min(k, idx.n_docs),
            dev_doc=self._put(idx.doc),
            # the term array and validity mask are COO-path operands only
            # — the impacted scorer reads doc + weights + host offsets, so
            # skipping these saves two nnz-sized device buffers per segment
            dev_term=self._put(idx.term) if coo else None,
            valid=(torch.ones(idx.nnz, dtype=weights["tfidf"].dtype, device=self.device)
                   if coo else None),
            weights=weights,
            offsets=seg.term_offsets,
            ranks=(np.ascontiguousarray(idx.ranks)
                   if idx.ranks is not None else None),
        )

    def _build_segs(self, segset: SegmentSet, k: int) -> list[_DevSegment]:
        segs = [self._build_seg(s, k) for s in segset.segments]
        with self._lock:
            ranks = self._prior_ranks
        self._apply_prior(segs, ranks)
        return segs

    def start(self, warm: bool = True) -> "TfidfServer":
        """Load device state and launch the drain thread.  ``warm=True``
        runs every padded batch shape before the first request."""
        if self._started:
            return self
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
        segset = self._segset
        with obs.span("serve.load", version=segset.version, nnz=segset.nnz,
                      segments=len(segset.segments)):
            self._use_prior = (
                self.cfg.rank_alpha > 0 or self.cfg.prior_alpha > 0
            )
            self._segs = self._build_segs(segset, self.k)
        self._started = True
        self._stopped = False
        if warm:
            self.warmup()
        self._thread = threading.Thread(
            target=self._drain, name="tfidf-serve-drain", daemon=True
        )
        self._thread.start()
        obs.emit("serve_start", version=segset.version, n_docs=segset.n_docs,
                 nnz=segset.nnz, k=self.k, max_batch=self.cfg.max_batch,
                 segments=len(segset.segments), scoring=self.cfg.scoring)
        return self

    def _warm_segs(self, segs: list[_DevSegment], k: int, *,
                   only: "set[str] | None" = None) -> list[int]:
        """Run every padded batch shape once against ``segs`` and wait for
        it — shared by start-time warmup and segment refresh.  One pass
        covers every ranker: the weight table is an operand of the same
        shape and dtype.  ``only`` restricts the per-segment dispatches to
        the named (NEW) segments — carried-over segments were warmed
        already; the cross-segment merge is always warmed (its shape
        depends on the whole set)."""
        caps = batch_shape_matrix(self.cfg.max_batch)
        q = self.cfg.max_query_terms
        if self.cfg.scoring == "impacted":
            # Pre-grow the carried bucket cap for a HEAVY plausible batch
            # — max_batch queries of a few terms each hitting the live
            # set's heaviest posting run — clipped by impact_warm_buckets.
            # Sized for typical traffic, not the adversarial worst: every
            # dispatch gathers the FULL padded cap, so an over-grown cap
            # taxes each request; a heavier stream grows past this, one
            # logged bump per doubling.
            w = self.cfg.impact_bucket_width
            df_max = max(
                (int(np.diff(seg.offsets).max()) if seg.offsets.shape[0] > 1
                 else 0)
                for seg in segs
            )
            heavy_terms = min(q, 4)
            worst = (self.cfg.max_batch * heavy_terms
                     * ((df_max + w - 1) // w))
            target = min(max(worst, 1), self.cfg.impact_warm_buckets)
            with self._lock:
                cap_before = self._bucket_cap
                cap, _ = grow_chunk_cap(
                    target, self._bucket_cap, self.metrics,
                    min_bits=IMPACT_MIN_BUCKET_BITS,
                )
                self._bucket_cap = max(self._bucket_cap, cap)
                cap_grew = self._bucket_cap != cap_before
            if cap_grew:
                # the bucket axis changed shape for EVERY segment, not
                # just the new ones: warm the whole set this pass
                only = None
        dtype = segs[0].weights["tfidf"].dtype
        dev = self.device
        for cap in caps:
            with obs.span("serve.warmup", batch=cap,
                          scoring=self.cfg.scoring):
                zt = torch.zeros((cap, q), dtype=torch.int32, device=dev)
                zw = torch.zeros((cap, q), dtype=dtype, device=dev)
                warm_set = [s for s in segs
                            if only is None or s.name in only]
                outs = []
                for seg in warm_set:
                    if self.cfg.scoring == "impacted":
                        zc = torch.zeros(self._bucket_cap, dtype=torch.int32, device=dev)
                        outs.append(ops.score_impacted_batch(
                            seg.dev_doc, seg.weights["tfidf"],
                            zc, zc, zc, zc.to(dtype), seg.prior,
                            bucket_slot=zc, query_terms=q,
                            n_docs=seg.n_docs, batch=cap,
                            bucket_width=self.cfg.impact_bucket_width,
                            k=seg.k, use_prior=self._use_prior,
                        ))
                    else:
                        outs.append(ops.score_query_batch(
                            seg.dev_doc, seg.dev_term,
                            seg.weights["tfidf"], seg.valid,
                            zt, zw, zw, seg.prior,
                            n_docs=seg.n_docs, vocab=self.vocab_size,
                            k=seg.k, use_prior=self._use_prior,
                        ))
                if len(segs) > 1:
                    # the merge's shape depends on the WHOLE live set —
                    # warm it against zero candidates even when the
                    # per-segment dispatches were restricted to new ones
                    outs.append(ops.topk_merge(
                        tuple(torch.zeros((cap, s.k), dtype=dtype, device=dev)
                              for s in segs),
                        tuple(torch.zeros((cap, s.k), dtype=torch.int32, device=dev)
                              for s in segs),
                        tuple(s.doc_base for s in segs),
                        k=min(k, sum(s.k for s in segs)),
                    ))
                if outs:
                    rx.block_until_ready(
                        outs, site="serve_warmup", metrics=self.metrics
                    )
        return caps

    def warmup(self) -> list[int]:
        """Run every padded batch shape the policy can produce against the
        CURRENT live segment set, on the server's stream; returns the
        shapes."""
        with self._lock:
            segs = list(self._segs)
            k = self.k
        with self._on_stream():
            return self._warm_segs(segs, k)

    @property
    def vocab_size(self) -> int:
        return 1 << self._segset.vocab_bits

    def _apply_prior(self, segs: list[_DevSegment],
                     global_ranks: np.ndarray | None) -> None:
        """(Re)build each segment's two device prior operands — the
        every-request blend (``rank_alpha·ranks``) and the ranker="prior"
        blend (``(rank_alpha + prior_alpha)·ranks``) — from a GLOBAL
        ranks vector (sliced per segment by doc range) or, when None,
        from each segment's artifact-carried local prior.  Zeros when the
        server carries no prior.  The device operands are built OUTSIDE
        the lock and assigned to every segment in one locked section, so a
        batch snapshotting the live set never sees segment A under the new
        prior and segment B under the old."""
        np_dtype = self._dtype
        built = []
        for seg in segs:
            if global_ranks is not None:
                local = np.ascontiguousarray(
                    global_ranks[seg.doc_base:seg.doc_base + seg.n_docs],
                    np_dtype)
                if local.shape[0] < seg.n_docs:
                    # a segment committed AFTER the last set_prior: its
                    # docs have no global rank yet — give them the
                    # neutral mean-1 value (priors are mean-normalized)
                    # until the next prior refresh covers them
                    pad = np.ones(seg.n_docs - local.shape[0], np_dtype)
                    local = np.concatenate([local, pad])
            elif seg.ranks is not None:
                local = np.ascontiguousarray(seg.ranks, np_dtype)
            else:
                local = None
            if local is None or not self._use_prior:
                base = np.zeros(seg.n_docs, np_dtype)
                req = base
            else:
                base = (self.cfg.rank_alpha * local
                        if self.cfg.rank_alpha > 0
                        else np.zeros(seg.n_docs, np_dtype))
                req = base + self.cfg.prior_alpha * local
            base_dev = self._put(base.astype(np_dtype))
            req_dev = (base_dev if req is base
                       else self._put(req.astype(np_dtype)))
            built.append((base_dev, req_dev))
        with self._lock:
            for seg, (base_dev, req_dev) in zip(segs, built):
                seg.prior = base_dev
                seg.prior_req = req_dev

    def set_prior(self, ranks: np.ndarray) -> None:
        """Hot-swap the PageRank prior on a RUNNING server: rebuilds the
        per-segment prior operands from the GLOBAL ``ranks`` vector and
        invalidates the result cache (cached top-k blended the old prior).
        Requires a server constructed with ``rank_alpha > 0`` or
        ``prior_alpha > 0``."""
        if not self._started:
            raise RuntimeError("server not started")
        if not self._use_prior:
            raise RuntimeError(
                "server built without a prior operand — construct with "
                "ServeConfig(rank_alpha=... ) or ServeConfig(prior_alpha=...)"
            )
        ranks = np.ascontiguousarray(ranks)
        with self._lock:
            segs = list(self._segs)
            n_docs = sum(s.n_docs for s in segs)
        if ranks.shape != (n_docs,):
            raise ValueError(
                f"prior has shape {ranks.shape}; this index holds "
                f"{n_docs} documents"
            )
        with self._on_stream():
            self._apply_prior(segs, ranks)
        with self._lock:
            self._prior_ranks = ranks  # re-applied by refresh_segments
            self._prior_gen += 1
            self._cache.clear()
        obs.emit("serve_prior_update", n_docs=int(ranks.shape[0]))

    def refresh_segments(self, segset: SegmentSet) -> None:
        """Hot-swap the live segment set WITHOUT restart (a new delta
        commit, a background merge): device state for the new set is
        built and warmed FIRST (in-flight batches keep scoring against the
        old, still-live buffers), then the list is swapped under the lock
        and the result cache invalidated by generation.  Queued and future
        requests see the new set; nothing is dropped and nothing
        restarts."""
        if not self._started:
            raise RuntimeError("server not started")
        if segset.cfg.config_hash() != self._segset.cfg.config_hash():
            raise ValueError(
                "refusing to refresh across semantic config changes "
                f"({segset.cfg.config_hash()} != "
                f"{self._segset.cfg.config_hash()})"
            )
        _check_impacted_servable(self.cfg, segset)
        t0 = time.perf_counter()
        with obs.span("serve.refresh", version=segset.version,
                      segments=len(segset.segments)), self._on_stream():
            new_k = min(self.cfg.top_k, segset.n_docs)
            segs = self._build_segs(segset, new_k)
            with self._lock:
                live = {s.name for s in self._segs}
            self._warm_segs(segs, new_k,
                            only={s.name for s in segs} - live)
            with self._lock:
                self._segset = segset
                self._segs = segs
                self.k = new_k
                self._prior_gen += 1
                self._cache.clear()
                self._stats["refreshes"] += 1
            # submit()'s ranker refusal checks read self.index — it must
            # describe the LIVE set, whatever the server was built from
            self.index = _set_view(segset)
        obs.emit("serve_refresh", version=segset.version,
                 segments=len(segset.segments), n_docs=segset.n_docs,
                 warm_s=round(time.perf_counter() - t0, 4))

    def stop(self) -> None:
        """Graceful shutdown: stop accepting, drain what's queued, fail
        anything that slipped past the drain with :class:`ServerShutdown`
        — clients always get an answer or a typed refusal, never a hang.
        Raises ``RuntimeError`` when the drain thread does not finish its
        batch within ``JOIN_TIMEOUT_S``."""
        with self._submit_lock:
            self._started = False  # new submits refuse from here on
            self._stopped = True
        thread, self._thread = self._thread, None
        if thread is not None:
            self._queue.put(_STOP, timeout=JOIN_TIMEOUT_S)
            thread.join(JOIN_TIMEOUT_S)
        # A submit racing this shutdown can still have slipped a request in
        # around the sentinel; with the drain thread gone, fail it rather
        # than leave its future hanging forever.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _Pending):
                item._fail(ServerShutdown("server stopped"))
        obs.emit("serve_stop", **{k: int(v) for k, v in self._stats.items()})
        if thread is not None and thread.is_alive():
            raise RuntimeError(
                f"serve drain thread did not stop within {JOIN_TIMEOUT_S} s")

    def __enter__(self) -> "TfidfServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- queries

    def make_query(self, terms: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Host-side query prep: run the query through the INDEX's real
        tokenizer pipeline (``io.text.tokenize`` + ``add_ngrams`` with the
        artifact's config — so "state-of-the-art" splits exactly like the
        corpus did, and an ngram=2 index gets its bigram terms), then hash
        into canonical (term_ids, weights) — term-id-sorted, duplicates
        combined (weight = occurrence count), truncated to the
        ``max_query_terms`` heaviest terms, still term-sorted."""
        cfg = self._segset.cfg
        dtype = self.index.weight.dtype
        toks: list[str] = []
        for t in terms:
            toks.extend(tio.tokenize(t, lowercase=cfg.lowercase,
                                     min_token_len=cfg.min_token_len))
        toks = tio.add_ngrams(toks, cfg.ngram)
        if not toks:
            return (np.zeros(0, np.int32), np.zeros(0, dtype))
        ids = tio.hash_to_vocab(tio.fnv1a_64(toks), cfg.vocab_bits)
        uniq, counts = np.unique(ids, return_counts=True)
        if uniq.shape[0] > self.cfg.max_query_terms:
            # keep the heaviest terms, recorded so operators see
            # truncation happening
            order = np.argsort(-counts, kind="stable")[: self.cfg.max_query_terms]
            order.sort()
            uniq, counts = uniq[order], counts[order]
            obs.counter("serve.query_truncated")
        return uniq.astype(np.int32), counts.astype(dtype)

    @staticmethod
    def query_key(q_term: np.ndarray, q_weight: np.ndarray,
                  ranker: str = "tfidf") -> bytes:
        """LRU key: hash of the canonical sparse query vector + the
        ranker that scored it (an A/B pair must never share a cache
        entry)."""
        h = hashlib.sha1()
        h.update(ranker.encode())
        h.update(q_term.tobytes())
        h.update(q_weight.tobytes())
        return h.digest()

    def submit(self, terms: Sequence[str], *, ranker: str = "tfidf") -> _Pending:
        """Enqueue one query; returns a future.  Blocks when the bounded
        queue is full (backpressure, not unbounded memory).  ``ranker``
        picks the weight table per request (the A/B switch): ``tfidf``
        always, ``bm25`` when the index bundles BM25 weights, ``prior``
        when the server has a per-request prior scale."""
        if ranker not in RANKERS:
            raise ValueError(f"unknown ranker {ranker!r} (want {RANKERS})")
        if ranker == "bm25" and self.index.bm25_weight is None:
            raise ValueError(
                "this index carries no BM25 weights — rebuild with "
                "save_index(..., bm25=Bm25Config()) / cli.tfidf "
                "--save-index (BM25 is bundled by default)"
            )
        if ranker == "prior" and self.cfg.prior_alpha <= 0:
            raise ValueError(
                "ranker='prior' needs a per-request prior scale — construct "
                "the server with ServeConfig(prior_alpha=...) over an index "
                "saved with a ranks prior"
            )
        q_term, q_weight = self.make_query(terms)
        pending = _Pending(self.query_key(q_term, q_weight, ranker),
                           q_term, q_weight, ranker)
        with self._submit_lock:
            # the started-check AND the enqueue happen under the lock
            # stop() flips the flag under, so a racing submit either
            # raises here or its request is in the queue BEFORE the stop
            # sentinel (served, or failed by the leftover drain) — never
            # silently dropped with a hanging future
            if not self._started:
                if self._stopped:
                    raise ServerShutdown("server stopped")
                raise RuntimeError("server not started")
            self._queue.put(pending)  # graftlint: disable=blocking-under-lock (ROADMAP Queue 3, shared with the reference: deliberate backpressure belongs inside the started-check; the drain consumes without ever taking _submit_lock, so a blocked put always unblocks — see the _submit_lock comment above)
        with self._lock:
            self._stats["requests"] += 1
            # per-ranker traffic split, counted at submit so cache hits
            # are included, unlike the per-dispatch tallies
            self._stats[f"requests_{ranker}"] += 1
        return pending

    def query(
        self, terms: Sequence[str], timeout: float | None = 30.0,
        *, ranker: str = "tfidf",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous convenience wrapper: submit + wait."""
        return self.submit(terms, ranker=ranker).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            out = {k: int(v) for k, v in self._stats.items()}
            out["segments"] = len(self._segs)
        out.setdefault("requests", 0)
        for key in ("cache_hits", "cache_misses", "dedup_hits", "batches",
                    "batch_errors", "refreshes", "peer_stores"):
            out.setdefault(key, 0)
        return out

    # ------------------------------------------------------- peer-cache hooks

    def cache_lookup(
        self, terms: Sequence[str], *, ranker: str = "tfidf",
    ) -> "tuple[np.ndarray, np.ndarray] | None":
        """Non-computing probe of the local result LRU under the SAME
        canonical key the serve path uses (:meth:`query_key`) — the
        replica-side answer to a peer's ``POST /cache/peek``
        (``serving/fabric.py``): a hit returns the cached ``(scores,
        docs)`` without touching the dispatch queue or the device, a miss
        returns None and costs one tokenize."""
        q_term, q_weight = self.make_query(terms)
        return self._cache_get(self.query_key(q_term, q_weight, ranker))

    def cache_insert(
        self, terms: Sequence[str], scores, docs, *, ranker: str = "tfidf",
    ) -> bool:
        """Install an externally computed result into the local LRU (the
        ``POST /cache/fill`` write-back from a non-owner replica).  The
        value is stored against the CURRENT prior-generation stamp, so a
        racing hot-swap invalidates it exactly like a locally computed
        entry; values are stored in the serve path's own types, the weight
        tables' dtype and int32 — the wire carried doubles that started as
        results of that dtype, so the cast back is exact and a later hit
        re-serialises byte for byte like the compute that produced them.
        (The reference casts to float32, its only score dtype; the port
        serves a float64 index in float64, so it casts to the tables'
        dtype.)"""
        q_term, q_weight = self.make_query(terms)
        key = self.query_key(q_term, q_weight, ranker)
        value = (np.asarray(scores, dtype=self._dtype),
                 np.asarray(docs, dtype=np.int32))
        with self._lock:
            gen = self._prior_gen
        self._cache_put(key, value, gen)
        with self._lock:
            self._stats["peer_stores"] += 1
        return True

    # ---------------------------------------------------------- drain thread

    def _cache_get(self, key: bytes):
        if self.cfg.cache_size <= 0:
            return None
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
        return hit

    def _cache_put(self, key: bytes, value: tuple, gen: int) -> None:
        if self.cfg.cache_size <= 0:
            return
        with self._lock:
            if gen != self._prior_gen:
                # the batch was dispatched against a prior operand (or a
                # segment set) that set_prior/refresh_segments has since
                # hot-swapped: caching it would serve the stale result as
                # hits after the invalidation
                return
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.cfg.cache_size:
                self._cache.popitem(last=False)

    def _drain(self) -> None:
        """The micro-batching loop, on the server's stream: block for one
        request, gather up to ``max_batch`` within ``flush_ms``, serve the
        batch, repeat."""
        with self._on_stream():
            while True:
                try:
                    first = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if first is _STOP:
                    return
                batch = [first]
                deadline = time.perf_counter() + self.cfg.flush_ms / 1e3
                stop_after = False
                while len(batch) < self.cfg.max_batch:
                    wait = deadline - time.perf_counter()
                    try:
                        item = (self._queue.get(timeout=wait) if wait > 0
                                else self._queue.get_nowait())
                    except queue.Empty:
                        break
                    if item is _STOP:
                        stop_after = True
                        break
                    batch.append(item)
                try:
                    self._serve_batch(batch)
                except Exception as exc:  # noqa: BLE001 — the drain must survive
                    # _serve_group isolates the scoring; this catches everything
                    # else (pad bookkeeping, a misbehaving caller-supplied
                    # metrics recorder, cache publication) so the ONLY queue
                    # consumer never dies: the batch's futures fail, later
                    # requests keep serving.
                    with self._lock:
                        self._stats["batch_errors"] += 1
                    obs.counter("serve.batch_errors")
                    for p in batch:
                        if not p._event.is_set():
                            p._fail(exc)
                if stop_after:
                    return

    def _publish_request(self, p: _Pending, batch: int, error: str | None = None) -> None:
        obs.emit(
            "serve_request",
            cache=p.cache,
            queue_wait_s=round(p.t_queue_wait, 6),
            total_s=round(p.latency_s or 0.0, 6),
            batch=batch,
            **({"error": error} if error else {}),
        )
        obs.histogram("serve.latency_s", p.latency_s or 0.0)
        obs.histogram("serve.queue_wait_s", p.t_queue_wait)

    def _serve_batch(self, batch: list[_Pending]) -> None:
        t_dequeue = time.perf_counter()
        for p in batch:
            p.t_queue_wait = t_dequeue - p.t_submit
        with obs.span("serve.batch", size=len(batch)):
            misses: list[_Pending] = []
            for p in batch:
                hit = self._cache_get(p.key)
                if hit is not None:
                    p.cache = "hit"
                    p._resolve(hit)
                    with self._lock:
                        self._stats["cache_hits"] += 1
                    obs.counter("serve.cache_hits")
                    self._publish_request(p, batch=len(batch))
                else:
                    misses.append(p)
            if not misses:
                return
            # Per-ranker groups: a mixed batch dispatches once per ranker
            # present (the weight table is a per-dispatch operand; shapes
            # are shared).  The common case is one ranker per flush window
            # = one dispatch.
            by_ranker: dict[str, list[_Pending]] = {}
            for p in misses:
                by_ranker.setdefault(p.ranker, []).append(p)
            for ranker, plist in by_ranker.items():
                self._serve_group(ranker, plist, batch_size=len(batch))

    @staticmethod
    def _query_plan(uniq: list[_Pending], dtype):
        """Segment-INDEPENDENT half of the impacted planner: one flat
        (row, term id, query weight, slot) entry per query term across the
        deduped batch — built once per batch, shared by every segment.  A
        term's slot is its position in its canonical query."""
        n_terms = [p.q_term.shape[0] for p in uniq]
        if sum(n_terms) == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, dtype), np.zeros(0, np.int32))
        rows = np.repeat(np.arange(len(uniq), dtype=np.int32), n_terms)
        terms = np.concatenate([p.q_term for p in uniq]).astype(np.int64)
        qws = np.concatenate([p.q_weight for p in uniq]).astype(dtype)
        slots = np.concatenate([np.arange(n, dtype=np.int32) for n in n_terms])
        return rows, terms, qws, slots

    def _plan_impacted(
        self, segs: list[_DevSegment], uniq: list[_Pending], dtype
    ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
        """Host half of the impacted-list path: slice every query term's
        posting run out of each segment's CSC offsets and pad the runs
        into fixed-width buckets (vectorized — no per-bucket Python).
        The query-side arrays are built once, the carried pow2 cap is
        grown ONCE for the batch's worst segment (monotonic under the
        lock, so a refresh warming on another thread can never race the
        cap back down), and each segment gets (start, len, row, qw, slot)
        arrays at that cap and its bucket count."""
        W = self.cfg.impact_bucket_width
        rows, terms, qws, slots = self._query_plan(uniq, dtype)
        runs = []
        need = 1
        for seg in segs:
            off = seg.offsets
            starts = off[terms]
            lens = off[terms + 1] - starts
            nb = (lens + W - 1) // W  # buckets per run (0 = absent term)
            total = int(nb.sum())
            runs.append((starts, lens, nb, total))
            need = max(need, total)
        with self._lock:
            cap, _ = grow_chunk_cap(
                need, self._bucket_cap, self.metrics,
                min_bits=IMPACT_MIN_BUCKET_BITS)
            cap = self._bucket_cap = max(self._bucket_cap, cap)
        plans = []
        for starts, lens, nb, total in runs:
            cum = np.cumsum(nb) - nb
            intra = np.arange(total, dtype=np.int64) - np.repeat(cum, nb)
            b_start = np.zeros(cap, np.int32)
            b_len = np.zeros(cap, np.int32)
            b_row = np.zeros(cap, np.int32)
            b_qw = np.zeros(cap, dtype)
            b_slot = np.zeros(cap, np.int32)
            b_start[:total] = (np.repeat(starts, nb)
                               + W * intra).astype(np.int32)
            b_len[:total] = np.minimum(
                W, np.repeat(lens, nb) - W * intra).astype(np.int32)
            b_row[:total] = np.repeat(rows, nb)
            b_qw[:total] = np.repeat(qws, nb)
            b_slot[:total] = np.repeat(slots, nb)
            plans.append((b_start, b_len, b_row, b_qw, b_slot, total))
        return plans

    def _pad(self, uniq: list[_Pending], segs: list[_DevSegment], cap: int):
        """The batch's host plans: per-segment bucket arrays (impacted) or
        the padded ``[cap, Q]`` query arrays (COO)."""
        np_dtype = self._dtype
        if self.cfg.scoring == "impacted":
            return self._plan_impacted(segs, uniq, np_dtype)
        q = self.cfg.max_query_terms
        q_term = np.zeros((cap, q), np.int32)
        q_weight = np.zeros((cap, q), np_dtype)
        q_valid = np.zeros((cap, q), np_dtype)
        for i, p in enumerate(uniq):
            m = min(p.q_term.shape[0], q)
            q_term[i, :m] = p.q_term[:m]
            q_weight[i, :m] = p.q_weight[:m]
            q_valid[i, :m] = 1.0
        return q_term, q_weight, q_valid

    def _dispatch(self, ranker: str, plans, segs: list[_DevSegment], priors: list,
                  k: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Score one padded batch across every live segment: the host
        plans go up as small copies, and the result is the merged
        ``[cap, k]`` (scores, global int32 doc ids) pair, still on the
        device.  ranker="prior" is the tfidf table with the per-request
        prior operand; tfidf/bm25 use the every-request (rank_alpha) one."""
        impacted = self.cfg.scoring == "impacted"
        if impacted:
            per_seg = [(self._upload(np.stack([s, ln, r, sl])), self._upload(qw))
                       for s, ln, r, qw, sl, _total in plans]
        else:
            q_term, q_weight, q_valid = (self._upload(a) for a in plans)
        outs = []
        for i, (seg, prior) in enumerate(zip(segs, priors)):
            table = seg.weights["tfidf" if ranker == "prior" else ranker]
            if impacted:
                ints, qw = per_seg[i]
                outs.append(ops.score_impacted_batch(
                    seg.dev_doc, table, ints[0], ints[1], ints[2], qw, prior,
                    bucket_slot=ints[3], query_terms=self.cfg.max_query_terms,
                    n_docs=seg.n_docs, batch=cap,
                    bucket_width=self.cfg.impact_bucket_width,
                    k=seg.k, use_prior=self._use_prior,
                ))
            else:
                outs.append(ops.score_query_batch(
                    seg.dev_doc, seg.dev_term, table, seg.valid,
                    q_term, q_weight, q_valid, prior,
                    n_docs=seg.n_docs, vocab=self.vocab_size,
                    k=seg.k, use_prior=self._use_prior,
                ))
        if len(outs) == 1:
            # single live segment: doc ids are already global (base 0)
            return outs[0]
        return ops.topk_merge(
            tuple(o[0] for o in outs),
            tuple(o[1] for o in outs),
            tuple(s.doc_base for s in segs),
            k=min(k, sum(s.k for s in segs)),
        )

    def _serve_group(self, ranker: str, misses: list[_Pending],
                     *, batch_size: int) -> None:
        """Dedup, pad, dispatch and resolve one ranker's share of a
        micro-batch — across every live segment, merged on the device."""
        # In-batch dedup: N copies of one hot query arriving inside a
        # single flush window dispatch ONCE (the cache can only serve
        # repeats across batches; this closes the within-batch gap).
        groups: dict[bytes, list[_Pending]] = {}
        for p in misses:
            groups.setdefault(p.key, []).append(p)
        uniq = [ps[0] for ps in groups.values()]
        for ps in groups.values():
            for p in ps[1:]:
                p.cache = "dedup"
        with self._lock:
            self._stats["cache_misses"] += len(uniq)
            self._stats["dedup_hits"] += len(misses) - len(uniq)
            self._stats["batches"] += 1
            # the live set + per-segment prior operands + generation,
            # read atomically: a refresh or set_prior landing mid-batch
            # cannot smuggle this batch's result past its cache
            # invalidation, and every segment of this batch scores under
            # ONE prior generation (the old tensors stay alive while this
            # batch holds them)
            segs = list(self._segs)
            priors = [s.prior_req if ranker == "prior" else s.prior
                      for s in segs]
            prior_gen = self._prior_gen
            k = self.k
        obs.counter("serve.cache_misses", len(uniq))

        cap = batch_cap(len(uniq), self.cfg.max_batch, self.metrics)
        try:
            with obs.span("serve.pad", size=len(uniq), cap=cap, ranker=ranker,
                          segments=len(segs)):
                plans = self._pad(uniq, segs, cap)
            with obs.span("serve.dispatch", cap=cap, ranker=ranker,
                          segments=len(segs), scoring=self.cfg.scoring):
                scores_dev, idx_dev = rx.run_guarded(
                    lambda: self._dispatch(ranker, plans, segs, priors, k, cap),
                    site="serve_dispatch", metrics=self.metrics,
                )
            with obs.span("serve.pull", cap=cap):
                # ONE [cap, k] pull — the only bytes that cross
                # device->host per batch
                scores, idx = rx.device_get(
                    (scores_dev, idx_dev), site="serve_pull",
                    metrics=self.metrics,
                )
        except Exception as exc:  # noqa: BLE001 — isolated per batch
            # fail exactly this group's requests; the drain loop (and
            # every other queued request) keeps going
            with self._lock:
                self._stats["batch_errors"] += 1
            obs.counter("serve.batch_errors")
            err = f"{type(exc).__name__}: {exc}"[:200]
            for p in misses:
                p._fail(exc)
                self._publish_request(p, batch=batch_size, error=err)
            return
        for i, key in enumerate(groups):
            result = (scores[i].copy(), idx[i].copy())
            self._cache_put(key, result, prior_gen)
            for p in groups[key]:
                p._resolve(result)
                self._publish_request(p, batch=batch_size)
