"""``chunked_ingest``: the dataflow core's staged, double-buffered ingest
pipeline over a bounded source, and the H2D staging ring under it.

Counterpart of the JAX package's ``dataflow/ingest.py``.  A bounded host
source feeds fixed-capacity padded chunks to the device, with a
device-resident carry, bounded in-flight launches, and commit points that
only ever snapshot fully drained state::

    source ──► tokenize ──► H2D staging ──► compute ──► drain ─► commit
               (prefetch      (pipeline_depth   (prefetch     (barrier)
                thread,        transfer thread,  in-flight
                bounded queue) bounded queue)    launches)

- the **tokenize** stage is the caller's source iterator, run on a
  background thread (:class:`Prefetched`) holding up to ``prefetch``
  chunks; the native tokenizer releases the GIL, so it overlaps the rest;
- the **H2D staging** stage runs the caller's ``stage(item)`` closure on a
  transfer thread holding at most ``pipeline_depth`` staged chunks, which
  backpressures the tokenizer;
- the **compute** stage (``launch``) consumes staged device buffers only;
  up to ``prefetch`` launches stay in flight before the oldest drains;
- **commit points** run behind :func:`fixpoint.commit_barrier`, so a
  checkpoint never holds state of a chunk still in flight.

On the card the copies are what needs care: ``jax.device_put`` copies
asynchronously from any host buffer, but ``.to(device, non_blocking=True)``
does so only from pinned memory.  :class:`StagingRing` holds pinned
buffers, reused in turn, and issues every copy on a stream of its own with
an event the compute stream waits on.

Each stage opens its obs span (``ingest.tokenize``, ``ingest.h2d``,
``ingest.compute``), and each run publishes one ``ingest_overlap`` event
and the ``h2d_overlap_frac`` gauge, the share of H2D staging wall time
spent while chunk compute was in flight: the JAX package's names, so
``tools/trace_report.py`` reads the port's traces as it reads the
reference's.

Faults: the two pipeline sites (``ingest_h2d_put`` on the transfer
thread, ``ingest_h2d_wait`` where the consumer takes a staged chunk) retry
transient faults like every guarded site but propagate persistent ones RAW
(``resilience.executor.retry_transient``) to the single recovery point:
the caller's ``recover`` hook, or, without one, the caller, with its
traceback.  Before either sees it, the pipeline stops and joins its
threads, each within :data:`JOIN_TIMEOUT_S`.  An exception raised by the
staged iterator itself is never retried at the wait site: the iterator is
stateful, and a second ``next()`` would skip the item that failed.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import IngestConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

# Chaos/retry sites of the pipeline's own stages (resilience/chaos.py
# grammar: e.g. GRAFT_CHAOS="ingest_h2d_put:fail@%3").
H2D_PUT_SITE = "ingest_h2d_put"
H2D_WAIT_SITE = "ingest_h2d_wait"

# A recovery loop that cannot make progress must end.
_MAX_RECOVERIES = 16

# How long stopping a pipeline thread may take before it is reported as
# stuck: a thread finishes the item in hand first (one chunk's tokenize or
# staging, milliseconds at 2^18 tokens).
JOIN_TIMEOUT_S = 60.0


def grow_chunk_cap(
    need: int, cap: int, metrics: MetricsRecorder, *, min_bits: int = 10,
    **context
) -> tuple[int, bool]:
    """Fixed-shape capacity policy: a power-of-two start (at least
    ``2**min_bits``), doubled while ``need`` exceeds it, each bump a
    ``chunk_cap_bump`` record.  Returns (cap, changed)."""
    changed = False
    if cap <= 0:
        cap = 1 << max(min_bits, int(np.ceil(np.log2(max(need, 1)))))
        changed = True
    while need > cap:
        cap *= 2
        changed = True
        metrics.record(event="chunk_cap_bump", cap=cap, **context)
    return cap, changed


# Byte table mapping ASCII letters and digits to themselves and every other
# byte to a space: the alphanumeric runs of a document's UTF-8 bytes are then
# its whitespace-separated words.  A non-ASCII character encodes to bytes
# >= 0x80 only, none of them alphanumeric, so the runs are those of
# ``io.text._TOKEN_RE`` on the string.
_RUN_BYTES = bytes(c if chr(c).isascii() and chr(c).isalnum() else 0x20 for c in range(256))


def estimate_tokens(doc: str) -> int:
    """Alphanumeric-run count: the split rule of the default tokenizer
    (``io.text._TOKEN_RE``), so an upper bound of a document's unigrams
    (``min_token_len`` can only drop runs).  Counted by ``bytes.translate``
    and ``split`` in C: iterating the regex's matches in Python cost more
    than the native tokenizer itself."""
    return len(doc.encode("utf-8", "surrogatepass").translate(_RUN_BYTES).split())


def ngram_estimator(ngram: int) -> Callable[[str], int]:
    """Token-count upper bound matching ``io.text.add_ngrams``: ``t``
    unigram runs expand to ``t + (t-1) + ... + (t-n+1)`` tokens."""
    if ngram <= 1:
        return estimate_tokens

    def estimate(doc: str) -> int:
        t = estimate_tokens(doc)
        return sum(max(t - k + 1, 0) for k in range(1, ngram + 1))

    return estimate


def pack_doc_chunks(
    doc_chunks: Iterable[Sequence[str]],
    target_tokens: int,
    *,
    estimate: Callable[[str], int] = estimate_tokens,
) -> Iterator[list[str]]:
    """Regroup documents so each chunk carries about ``target_tokens``
    tokens.  Documents never split, so per-chunk DF stays exact; the chunk
    kernel works on the padded capacity, so filling it is what keeps
    streaming close to batch.  Deterministic for a source and target, so
    checkpoint chunk indices (which count packed chunks) stay valid across
    a resume with the same target."""
    target = max(int(target_tokens), 1)
    cur: list[str] = []
    est = 0
    for chunk in doc_chunks:
        for doc in chunk:
            e = max(int(estimate(doc)), 1)
            if cur and est + e > target:
                yield cur
                cur, est = [], 0
            cur.append(doc)
            est += e
    if cur:
        yield cur


def staged_put(put: Callable[[], Any], *,
               metrics: MetricsRecorder | None = None) -> Any:
    """Issue one H2D transfer at the ``ingest_h2d_put`` chaos/retry site:
    transient faults retried with backoff, persistent ones (device loss)
    propagated RAW to the pipeline's recovery point
    (``chunked_ingest(recover=...)``).  ``put`` must be re-invocable:
    :meth:`StagingRing.stage` claims a fresh slot each call."""
    return rx.retry_transient(put, site=H2D_PUT_SITE, metrics=metrics)


# ------------------------------------------------------------ staging ring


class StagingRing:
    """Pinned host buffers, reused in turn, and the copy stream that moves
    them to ``device``.

    :meth:`stage` writes 1-D int32 arrays (each at most ``cap`` long) into
    the first columns of the next slot's rows, issues one
    ``non_blocking`` copy of the slot to the device on the copy stream, and
    records an event after it.  It returns ``(tensor [rows, cap], event)``.
    Columns past an array's length hold whatever the slot held before:
    the caller masks them.

    A slot is refilled only after the event of its last copy has completed,
    so with ``slots`` = staged chunks held + 1 the stager waits only for a
    copy issued ``slots`` chunks earlier.  A new shape rebuilds the ring
    once every copy out of the old buffers has completed.  A pinned
    allocation that fails raises: nothing falls back to pageable memory.

    The consumer calls :meth:`consume` on its own stream before it reads a
    staged tensor: the stream waits on the copy's event, and the tensor,
    allocated on the copy stream, is marked as used by the consumer's, so
    the caching allocator cannot hand its memory to a later copy while the
    consumer still reads it.

    On the CPU nothing is pinned and nothing is queued: :meth:`stage`
    returns a fresh zero-padded tensor and no event.  One thread stages at
    a time (the transfer thread, or the caller with ``pipeline_depth`` 0),
    except that a retry at the ``ingest_h2d_put`` site may run beside the
    attempt its watchdog abandoned, which keeps running: so each call
    claims a slot no other call holds (adding a slot where every one is
    held) and releases it once its copy is queued, and no call refills a
    slot whose event another still waits on.
    """

    def __init__(self, device: torch.device | str, slots: int):
        self.device = torch.device(device)
        self.slots = max(int(slots), 1)
        self._bufs: list[torch.Tensor] = []
        self._events: list = []
        self._next = 0
        self._busy: set[int] = set()  # slots a call is filling
        self._lock = threading.Lock()
        self._shape: tuple[int, int] | None = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _claim(self, shape: tuple[int, int]) -> tuple[int, list, list, set]:
        """(Re)build the ring for ``shape``, then claim the next slot no
        call holds, adding one where every slot is held.  Returns the slot
        and the lists it lives in (a rebuild replaces them; a call still
        filling an old slot then finishes on the old lists)."""
        with self._lock:
            if shape != self._shape:
                self.wait()
                self._bufs = [torch.empty(shape, dtype=torch.int32, pin_memory=True)
                              for _ in range(self.slots)]
                self._events = [None] * self.slots
                self._busy = set()
                self._shape = shape
            n = len(self._bufs)
            for _ in range(n):
                i = self._next
                self._next = (i + 1) % n
                if i not in self._busy:
                    break
            else:
                self._bufs.append(torch.empty(shape, dtype=torch.int32, pin_memory=True))
                self._events.append(None)
                i = n
            self._busy.add(i)
            return i, self._bufs, self._events, self._busy

    def stage(self, rows: Sequence[np.ndarray], cap: int):
        if self._stream is None:
            out = np.zeros((len(rows), cap), np.int32)
            for r, a in enumerate(rows):
                out[r, :a.shape[0]] = a
            return torch.from_numpy(out), None
        i, bufs, events, busy = self._claim((len(rows), int(cap)))
        try:
            if events[i] is not None:
                events[i].synchronize()  # graftlint: disable=unguarded-host-sync (ROADMAP Queue 3: StagingRing.stage refills a slot after its last copy, inside the caller's staged_put)
            buf = bufs[i]
            host = buf.numpy()
            for r, a in enumerate(rows):
                host[r, :a.shape[0]] = a
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                dev = buf.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            events[i] = event
        finally:
            with self._lock:
                busy.discard(i)
        return dev, event

    def wait(self) -> None:
        """Block until every copy out of the ring has completed."""
        for event in self._events:
            if event is not None:
                event.synchronize()  # graftlint: disable=unguarded-host-sync,blocking-under-lock (ROADMAP Queue 3: StagingRing.stage rebuilds the ring after its copies, under its lock, inside the caller's staged_put)

    @staticmethod
    def consume(tensor: torch.Tensor, event) -> torch.Tensor:
        """Order the current stream after ``tensor``'s copy and keep its
        memory for that stream's work (see the class docstring)."""
        if event is not None:
            stream = torch.cuda.current_stream(tensor.device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return tensor


# ------------------------------------------------------------- prefetcher


class _Item:
    __slots__ = ("item",)

    def __init__(self, item):
        self.item = item


class _Raised:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _End:
    pass


_END = _End()


class Prefetched:
    """Bounded background-thread buffer over an iterator, with a
    poison/close protocol:

    - up to ``depth`` items are produced ahead on a daemon thread; a full
      queue backpressures the producer;
    - a producer exception travels through the queue and re-raises on the
      consumer side with its original traceback;
    - :meth:`close` stops the producer promptly even when it is blocked on
      a full queue, and keeps every item the consumer never saw:
      :meth:`leftover` (and the still-held ``source`` iterator) lets a
      recovery path resume the stream with nothing lost.

    Every join of the thread is bounded by ``join_timeout``; a thread that
    outlives it raises ``RuntimeError`` naming it.  Abandoning the iterator
    without ``close()`` leaves only a daemon thread that exits at its next
    queue poll.
    """

    def __init__(self, source: Iterator, depth: int, *,
                 name: str = "ingest-source",
                 join_timeout: float = JOIN_TIMEOUT_S):
        self.source = source
        self.join_timeout = join_timeout
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._orphans: list = []
        self._leftover: list = []
        self._raised: list = []
        self._lock = threading.Lock()  # the producer's parking lists
        self._closed = False
        self._finished = False
        self.thread = threading.Thread(target=self._produce, name=name,
                                       daemon=True)
        self.thread.start()

    def _put(self, env) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(env, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for item in self.source:
                if not self._put(_Item(item)):
                    # close() hit while this item was in hand: park it for
                    # leftover(); close() joins before it reads them.
                    with self._lock:
                        self._orphans.append(item)
                    return
        except BaseException as exc:  # noqa: BLE001 — forwarded to the consumer
            if not self._put(_Raised(exc)):
                with self._lock:
                    self._raised.append(exc)
        else:
            self._put(_END)

    def _join(self, timeout: float) -> None:
        self.thread.join(max(timeout, 0.0))
        if self.thread.is_alive():
            raise RuntimeError(
                f"ingest thread {self.thread.name!r} did not stop within "
                f"{self.join_timeout} s")

    def __iter__(self) -> "Prefetched":
        return self

    def __next__(self):
        if self._closed or self._finished:
            raise StopIteration
        env = self._q.get()
        if env is _END:
            self._finished = True
            self._join(self.join_timeout)
            raise StopIteration
        if isinstance(env, _Raised):
            self._finished = True
            self._join(self.join_timeout)
            raise env.exc.with_traceback(env.exc.__traceback__)
        return env.item

    def _sweep(self, left: list, wait: float) -> bool:
        """Move one queued envelope into ``left``/``_raised``; False when
        the queue stayed empty for ``wait`` seconds."""
        try:
            env = self._q.get(timeout=wait) if wait else self._q.get_nowait()
        except queue.Empty:
            return False
        if isinstance(env, _Item):
            left.append(env.item)
        elif isinstance(env, _Raised):
            self._raised.append(env.exc)
        return True

    def close(self) -> None:
        """Poison the producer and reap it, keeping unconsumed items (the
        queue is drained, so a producer blocked on a full one unblocks at
        once)."""
        if self._closed or self._finished:
            self._closed = True
            return
        self._closed = True
        self._stop.set()
        deadline = time.monotonic() + self.join_timeout
        left: list = []
        while self.thread.is_alive() and time.monotonic() < deadline:
            self._sweep(left, 0.05)
        self._join(deadline - time.monotonic())
        while self._sweep(left, 0.0):  # a put may have landed before the exit
            pass
        left.extend(self._orphans)
        self._leftover = left

    def leftover(self) -> list:
        """Items produced but never consumed, in stream order; valid after
        :meth:`close`.  ``source`` may still hold more."""
        return list(self._leftover)

    def raised(self) -> list:
        """Producer exceptions that :meth:`close` swept up before the
        consumer saw them; a recovery path must inspect these, or an item a
        failing producer had in hand would vanish with its exception."""
        return list(self._raised)


def prefetched(source: Iterator, depth: int) -> Iterator:
    """Generator over :class:`Prefetched`: background production up to
    ``depth`` ahead, producer exceptions re-raised on the consumer side,
    the producer stopped when the consumer abandons the generator."""
    pf = Prefetched(iter(source), depth)
    try:
        for item in pf:
            yield item
    finally:
        pf.close()


# ---------------------------------------------------------------- pipeline


class _IteratorRaised(BaseException):
    """Carrier for an exception raised from INSIDE the staged iterator at
    the wait site.  BaseException with an empty message, so the retry
    machinery can neither catch it (``retry_transient`` retries only
    ``Exception``) nor marker-match the inner error as transient — the
    pull of a stateful iterator must never be re-invoked after it raised.
    Unwrapped immediately at the call site."""

    def __init__(self, exc: BaseException):
        super().__init__()
        self.exc = exc


class _StageFailure(RuntimeError):
    """The H2D staging stage failed for ``item`` (transfer thread side):
    items staged before it are buffered or launched, items after it never
    left the source."""

    def __init__(self, item, cause: BaseException):
        super().__init__(str(cause))
        self.item = item
        self.cause = cause


class _LaunchFailure(RuntimeError):
    """``launch`` failed for ``item``: it came off the staged queue before
    anything still buffered there."""

    def __init__(self, item, cause: BaseException):
        super().__init__(str(cause))
        self.item = item
        self.cause = cause


class _DrainFailure(RuntimeError):
    """``drain`` failed; its chunk is still in the in-flight deque (popped
    only on success)."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def _merge_intervals(ivs: list) -> list:
    out: list = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_fraction(h2d: list, compute: list) -> float:
    """Share of the total H2D staging wall time spent while chunk compute
    was in flight; 0.0 with no staging time."""
    total = sum(b - a for a, b in h2d)
    if total <= 0:
        return 0.0
    merged = _merge_intervals(compute)
    ov = 0.0
    j = 0
    for a, b in sorted(h2d):
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            lo, hi = max(a, merged[k][0]), min(b, merged[k][1])
            if lo < hi:
                ov += hi - lo
            k += 1
    return min(max(ov / total, 0.0), 1.0)


def chunked_ingest(
    source: Iterable,
    *,
    launch: Callable,
    drain: Callable,
    commit: Callable[[], None],
    depth: int = 0,
    checkpoint_due: Callable[[], bool] | None = None,
    save_checkpoint: Callable[[], None] | None = None,
    prefetch_source: bool = True,
    stage: Callable | None = None,
    pipeline_depth: int = 0,  # graftlint: disable=untuned-knob-read (ROADMAP Queue 3, suppressed as in the reference: 0 is the serial path of a caller without an IngestConfig; the tuned depth arrives through ingest=)
    ingest: IngestConfig | None = None,
    recover: Callable | None = None,
    retain_until_commit: bool = False,
    metrics: MetricsRecorder | None = None,
) -> None:
    """Drive a bounded source through the staged launch/drain pipeline with
    commit points:

    - ``stage(item)`` (optional) runs the H2D staging stage and returns a
      staged record.  With ``pipeline_depth > 0`` it runs on a transfer
      thread holding at most that many staged records; with 0 it runs
      inline.  Omitted, items flow to ``launch`` unstaged.
    - ``launch(staged)`` queues one chunk's compute and returns an
      in-flight record; up to ``depth`` launches stay in flight before the
      oldest is drained (``depth == 0`` is fully serial).
    - ``drain(record)`` completes one launch (the host pull).
    - ``commit()`` pulls the carry the compute accumulates on the device.
      It runs behind :func:`fixpoint.commit_barrier` at each checkpoint and
      once at the end.
    - ``checkpoint_due()`` / ``save_checkpoint()``: when due, the barrier
      drains everything in flight, commits, then snapshots.
    - ``recover(exc, remaining, where)`` (optional): the single recovery
      point for faults anywhere in the pipeline.  By the time it runs the
      threads are stopped and ``remaining`` iterates every unprocessed item
      in stream order.  ``where`` names the stage that failed (``"stage"``,
      ``"wait"``, ``"launch"``, ``"drain"``).  The hook re-raises what it
      does not own, or returns the iterable to continue with.  Without a
      hook the fault propagates as it is.
    - ``retain_until_commit=True`` also keeps every drained item until the
      next commit and re-delivers those first on recovery, for callers
      whose drain is not a full commit.

    ``ingest=IngestConfig(...)`` sets ``depth`` (its ``prefetch``) and
    ``pipeline_depth`` in one bundle.
    """
    if ingest is not None:
        depth = ingest.prefetch
        pipeline_depth = ingest.pipeline_depth
    depth = max(int(depth), 0)
    pipeline_depth = max(int(pipeline_depth), 0)

    tok_iv: list = []
    h2d_iv: list = []
    comp_iv: list = []
    inflight: collections.deque = collections.deque()  # (item, record, t0)
    drained: list = []  # items drained since the last commit barrier
    # (kept only under retain_until_commit, replayed on recovery)

    def spanned_source(it: Iterator) -> Iterator:
        # runs on whichever thread consumes it: the tokenizer thread when
        # prefetch > 0, else the transfer or main thread
        while True:
            t0 = time.perf_counter()
            with obs.span("ingest.tokenize"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            tok_iv.append((t0, time.perf_counter()))
            yield item

    def stage_wrap(item):
        t0 = time.perf_counter()
        try:
            with obs.span("ingest.h2d"):
                staged = stage(item)
        except BaseException as exc:
            raise _StageFailure(item, exc) from exc
        h2d_iv.append((t0, time.perf_counter()))
        return (item, staged)

    def drain_oldest() -> None:
        item, rec, t0 = inflight[0]
        try:
            with obs.span("ingest.compute"):
                drain(rec)
        except BaseException as exc:
            raise _DrainFailure(exc) from exc
        inflight.popleft()
        if retain_until_commit:
            drained.append(item)
        comp_iv.append((t0, time.perf_counter()))

    def drain_all() -> None:
        while inflight:
            drain_oldest()

    def commit_and_release() -> None:
        # nothing is in flight here: once the carry pull lands, the drained
        # chunks are committed and their retained host copies can go
        commit()
        obs.emit("ingest_commit", chunks=len(comp_iv),
                 retained=len(drained))
        drained.clear()

    def maybe_checkpoint() -> None:
        if checkpoint_due is None or save_checkpoint is None:
            return
        if not checkpoint_due():
            return
        fixpoint.commit_barrier(drain_all, commit_and_release,
                                save_checkpoint)

    # The wait site runs WITHOUT the sync watchdog: its pull is a local
    # thread handoff (queue read / inline stage), not a device sync — every
    # device-facing block that feeds it is already deadlined at the put
    # site on the thread that runs it.  A watchdog here would abandon an
    # attempt still blocked inside next() on the stateful staged iterator
    # and retry concurrently; whatever item the abandoned thread then
    # consumed would vanish from the committed output.
    wait_policy = dataclasses.replace(rx.RetryPolicy.from_env(), deadline_s=0.0)
    items: Iterator = iter(source)
    recoveries = 0
    while True:
        tok_pf: Prefetched | None = None
        stage_pf: Prefetched | None = None
        try:
            feed: Iterator = spanned_source(items)
            if prefetch_source and depth > 0:
                tok_pf = Prefetched(feed, depth)
                feed = tok_pf
            if stage is not None:
                staged_feed: Iterator = map(stage_wrap, feed)
                if pipeline_depth > 0:
                    stage_pf = Prefetched(staged_feed, pipeline_depth,
                                          name="ingest-h2d")
                    staged_feed = stage_pf

                def next_staged(sf=staged_feed):
                    # the consumer-side handoff from the staging stage, its
                    # own chaos/retry site.  The chaos hook fires BEFORE the
                    # pull, so a retried injected fault never consumed an
                    # item; an exception coming OUT of the iterator
                    # propagates raw even when its message carries a
                    # transient marker: a second next() would skip the
                    # failed item (or read _END off a finished Prefetched).
                    def pull():
                        try:
                            return next(sf, _END)
                        except BaseException as exc:
                            raise _IteratorRaised(exc)
                    try:
                        return rx.retry_transient(
                            pull, site=H2D_WAIT_SITE, metrics=metrics,
                            policy=wait_policy,
                        )
                    except _IteratorRaised as carrier:
                        raise carrier.exc
            else:
                plain = map(lambda it_: (it_, it_), feed)

                def next_staged(sf=plain):
                    return next(sf, _END)

            while True:
                env = next_staged()
                if env is _END:
                    break
                item, staged = env
                t0 = time.perf_counter()
                try:
                    rec = launch(staged)
                except BaseException as exc:
                    raise _LaunchFailure(item, exc) from exc
                inflight.append((item, rec, t0))
                while len(inflight) > depth:
                    drain_oldest()
                maybe_checkpoint()
            while inflight:
                drain_oldest()
                maybe_checkpoint()
            fixpoint.commit_barrier(drain_all, commit_and_release)
            break
        except BaseException as exc:  # noqa: BLE001 — dispatched below
            cause: BaseException = exc
            where = "drain"
            failed_early: list = []  # failed item ordered before buffers
            failed_late: list = []  # failed item ordered after buffers
            if isinstance(exc, _DrainFailure):
                cause, where = exc.cause, "drain"
            elif isinstance(exc, _LaunchFailure):
                cause, where = exc.cause, "launch"
                failed_early = [exc.item]
            elif isinstance(exc, _StageFailure):
                cause, where = exc.cause, "stage"
                failed_late = [exc.item]
            elif inflight or stage is not None:
                where = "drain" if inflight else "wait"
            # Stop the pipeline first, so recovery never races the transfer
            # thread, and collect every unprocessed item in stream order:
            # drained but uncommitted (when retained), launched but not
            # drained, the launch casualty, staged but not launched, the
            # stage casualty, then tokenized but not staged.
            replay = list(drained)
            drained.clear()
            pending = [it for (it, _rec, _t0) in inflight]
            inflight.clear()
            staged_left: list = []
            src_raised: list = []  # source exceptions swept up unread: the
            # stream ends past them, so a replay must raise them in place
            if stage_pf is not None:
                stage_pf.close()
                staged_left = [it for (it, _st) in stage_pf.leftover()]
                # a stage failure the consumer never read carries its
                # casualty item; anything else swept here came through the
                # transfer thread from the source
                for r_exc in stage_pf.raised():
                    if isinstance(r_exc, _StageFailure):
                        staged_left.append(r_exc.item)
                    else:
                        src_raised.append(r_exc)
            tok_left: list = []
            if tok_pf is not None:
                tok_pf.close()
                tok_left = tok_pf.leftover()
                src_raised.extend(tok_pf.raised())
            if recover is None:
                raise cause
            recoveries += 1
            if recoveries > _MAX_RECOVERIES:
                raise cause
            head = (replay + pending + failed_early + staged_left
                    + failed_late + tok_left)

            def chained(head=head, tail=items, swept=src_raised):
                yield from head
                if swept:
                    # the source raised before the stop and nobody read it:
                    # past this point the stream does not exist
                    raise swept[0].with_traceback(swept[0].__traceback__)
                yield from tail

            items = iter(recover(cause, chained(), where))

    frac = overlap_fraction(h2d_iv, comp_iv)
    summary = {
        "h2d_overlap_frac": round(frac, 4),
        "tokenize_secs": round(sum(b - a for a, b in tok_iv), 4),
        "h2d_secs": round(sum(b - a for a, b in h2d_iv), 4),
        "compute_secs": round(sum(b - a for a, b in comp_iv), 4),
        "chunks": len(comp_iv),
        "depth": depth,
        "pipeline_depth": pipeline_depth,
    }
    obs.gauge("h2d_overlap_frac", frac)
    obs.emit("ingest_overlap", **summary)
    if metrics is not None:
        metrics.record(event="ingest_overlap", **summary)
