"""Retry/deadline executor guarding every dispatch and host-sync boundary.

Counterpart of the JAX package's ``resilience/executor.py``, with its
names, signatures, events and counters.  Escalation order: **retry** the
failed dispatch or sync on the card, walk the caller's degradation rungs
(``fallbacks``: the CPU salvage of ``dataflow/fixpoint.py`` and the mesh
shrink of the sharded runners, which take only a lost device that names
its index), and finally hand the terminal state to the caller as a
structured :class:`ResilienceExhausted` carrying the latest checkpoint
path, to **resume** from (utils/checkpoint.py).  Rung names are declared
in ``utils/config.DEGRADE_LADDER``.

Every long-running path of the port (the segment driver
``dataflow/fixpoint.py``, the TF-IDF drivers, the staged ingest, the
server, the segment merger, the federation scraper) routes its host
round-trips through :func:`run_guarded`, :func:`retry_transient`,
:func:`attempt_once` or the :func:`device_get` / :func:`block_until_ready`
wrappers, at the JAX package's site names.

Env knobs (``utils/config.GRAFT_ENV_KNOBS``):

- ``GRAFT_RETRY_MAX``        max retries per guarded call (default 3)
- ``GRAFT_SYNC_DEADLINE_S``  per-call watchdog deadline in seconds;
                             0 (default) disables the watchdog thread
- ``GRAFT_BACKOFF_BASE_S``   first backoff delay (default 0.05)
- ``GRAFT_BACKOFF_MAX_S``    backoff ceiling (default 2.0)
- ``GRAFT_CHAOS``            fault-injection plan (resilience/chaos.py)

Retries are only issued for *transient* failures: an injected
``ChaosError``, a blown sync deadline, a ``torch.cuda.OutOfMemoryError``
(the counterpart of XLA's ``RESOURCE_EXHAUSTED``), or an error carrying one
of XLA's retryable status markers.  A CUDA error that leaves the context
dead (an illegal memory access, a launch failure, or anything a
``torch.cuda.synchronize()`` raises again) is never transient: a retry on a
dead context cannot succeed.  ``DeviceLostError`` and transient failures
that exhaust the retry budget fall through to the rungs, then to
:class:`ResilienceExhausted`.  Backoff jitter is deterministic (a hash of
site and attempt, the reference's), so chaos tests replay exactly.

Streams: the watchdog runs each attempt on a fresh thread, and in PyTorch
the current stream belongs to a thread.  The attempt thread enters the
caller's current device and stream before it calls ``fn``, so a retried
attempt launches where the caller would have, and an abandoned attempt and
its retry stay ordered on one stream (a kernel plan serves one stream at a
time, ``ops/segment_kernels.py``).

Retry safety: an abandoned attempt keeps running (a thread cannot be
killed), and torch tensors, unlike JAX arrays, are mutable.  So every
guarded ``fn`` of the port either only reads (a pull, a fence, a wait on an
event) or writes only into fresh tensors it returns: a retried dispatch
cannot double-apply work, and an abandoned one writes nothing anyone reads.

Telemetry: every rung publishes a structured event on the obs bus —
``retry`` / ``backoff`` per retried attempt, ``watchdog`` when the sync
deadline fires, ``degraded`` on a named rung, ``exhausted`` before raising
— with the counters ``retries``, ``watchdog_fires``, ``degraded``,
``exhausted`` and the ``backoff_secs`` histogram.  ``metrics.record``
mirrors the retry/degraded events into the per-run recorder for callers
that pass one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Callable

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder


class SyncDeadlineExceeded(RuntimeError):
    """A guarded call blew its GRAFT_SYNC_DEADLINE_S watchdog — the
    signature of a hung host sync.  Transient: the retry re-issues the sync
    against the still-live device tensors."""


class ResilienceExhausted(RuntimeError):
    """Every rung of the ladder failed.  Carries what the caller needs to
    restart-from-snapshot: the site, the last error, and the most recent
    checkpoint path (None when the caller checkpoints nowhere)."""

    def __init__(
        self,
        site: str,
        attempts: int,
        last_error: BaseException,
        last_checkpoint: str | None,
    ):
        self.site = site
        self.attempts = attempts
        self.last_error = last_error
        self.last_checkpoint = last_checkpoint
        resume = (
            f"resume from checkpoint {last_checkpoint}"
            if last_checkpoint
            else "no checkpoint available; restart from scratch"
        )
        super().__init__(
            f"resilience exhausted at {site!r} after {attempts} attempt(s): "
            f"{type(last_error).__name__}: {last_error} — {resume}"
        )


# Status markers XLA/PJRT put in retryable runtime errors, kept so the
# classification of a message is the reference's.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "CANCELLED",
)

# CUDA errors that are sticky: the context is dead after them, and every
# later call on it fails the same way.
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "hardware stack error",
    "device-side assert",
    "uncorrectable ECC error",
    "launch timed out",
)


def _context_dead(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA error that left the context dead: a sticky
    one by its message, or any CUDA error that a synchronize raises again."""
    msg = str(exc)
    if any(m in msg for m in _STICKY_CUDA_MARKERS):
        return True
    if "CUDA error" not in msg or not torch.cuda.is_initialized():
        return False
    try:
        torch.cuda.synchronize()
    except RuntimeError:
        return True
    return False


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, (chaos.ChaosError, SyncDeadlineExceeded)):
        return True
    # A fully-exhausted inner ladder is not transient by definition — and
    # its message quotes the inner error, so the marker scan below would
    # otherwise re-classify it (nested guards: a pull inside a step).
    if isinstance(exc, (chaos.DeviceLostError, ResilienceExhausted)):
        return False
    if _context_dead(exc):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return any(m in str(exc) for m in _TRANSIENT_MARKERS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    deadline_s: float = 0.0  # 0 = no watchdog thread

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            max_retries=int(os.environ.get("GRAFT_RETRY_MAX", 3)),
            backoff_base_s=float(os.environ.get("GRAFT_BACKOFF_BASE_S", 0.05)),
            backoff_max_s=float(os.environ.get("GRAFT_BACKOFF_MAX_S", 2.0)),
            deadline_s=float(os.environ.get("GRAFT_SYNC_DEADLINE_S", 0.0)),
        )


def backoff_delay(site: str, attempt: int, policy: RetryPolicy) -> float:
    """Exponential backoff with deterministic jitter: attempt k (1-based)
    waits base * 2^(k-1) * (1 + frac), frac in [0, 0.5) derived from a hash
    of (site, attempt) — decorrelates concurrent retriers without RNG state
    (chaos tests replay bit-identically)."""
    raw = policy.backoff_base_s * (2.0 ** (attempt - 1))
    h = hashlib.sha256(f"{site}:{attempt}".encode()).digest()
    frac = h[0] / 512.0  # [0, 0.498]
    return min(raw * (1.0 + frac), policy.backoff_max_s)


def _caller_stream() -> Callable[[], contextlib.AbstractContextManager]:
    """A context factory that enters the calling thread's current CUDA
    device and stream on another thread (nothing where CUDA is not
    initialized: no tensor of the caller lies on a card)."""
    if not torch.cuda.is_initialized():
        return contextlib.nullcontext
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev)

    def enter() -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    return enter


def _attempt(fn: Callable[[], Any], site: str, policy: RetryPolicy) -> Any:
    """One guarded attempt: chaos hook + fn, under the watchdog when a
    deadline is set.  The watchdog runs the attempt on a fresh daemon
    thread, on the caller's device and stream, and abandons it on timeout
    — a thread wedged inside a hung sync cannot be killed from Python,
    only orphaned."""

    def watched() -> Any:
        chaos.on_call(site)
        return fn()

    if policy.deadline_s <= 0:
        return watched()

    box: dict[str, Any] = {}
    enter = _caller_stream()

    def runner() -> None:
        try:
            with enter():
                box["result"] = watched()
        except BaseException as exc:  # noqa: BLE001 — re-raised on the caller side
            box["error"] = exc

    t = threading.Thread(target=runner, name=f"resilience-{site}", daemon=True)
    t.start()
    t.join(policy.deadline_s)
    if t.is_alive():
        obs.emit("watchdog", site=site, deadline_s=policy.deadline_s)
        obs.counter("watchdog_fires")
        raise SyncDeadlineExceeded(
            f"guarded call at {site!r} exceeded the {policy.deadline_s}s "
            "sync deadline (hung host sync); abandoning the attempt thread"
        )
    if "error" in box:
        raise box["error"]
    return box["result"]


def attempt_once(
    fn: Callable[[], Any],
    *,
    site: str,
    policy: RetryPolicy | None = None,
) -> Any:
    """ONE chaos-hooked, watchdog-deadlined attempt with no retry loop, no
    rungs and no ``exhausted`` emission — for callers that own their
    recovery (the federation scraper: a failed scrape is a stale replica).
    Faults propagate raw; ``fn`` must be re-invocable."""
    policy = policy or RetryPolicy.from_env()
    return _attempt(fn, site, policy)


def _retry_pause(
    site: str,
    attempts: int,
    exc: BaseException,
    policy: RetryPolicy,
    metrics: MetricsRecorder | None,
) -> None:
    """The shared between-attempts pause of both retry loops: emit the
    ``retry`` event/counter (and mirror it to the caller's metrics), sleep
    the backoff, then emit ``backoff``.  The backoff event is emitted
    AFTER the sleep: it records that the backoff completed (a kill
    mid-backoff then shows a retry with no backoff event)."""
    delay = backoff_delay(site, attempts, policy)
    err = f"{type(exc).__name__}: {exc}"[:200]
    obs.emit("retry", site=site, attempt=attempts, error=err,
             backoff_s=round(delay, 4))
    obs.counter("retries")
    if metrics is not None:
        metrics.record(event="retry", site=site, attempt=attempts,
                       error=err, backoff_s=round(delay, 4))
    time.sleep(delay)
    obs.emit("backoff", site=site, attempt=attempts, secs=round(delay, 4))
    obs.histogram("backoff_secs", delay)


def retry_transient(
    fn: Callable[[], Any],
    *,
    site: str,
    policy: RetryPolicy | None = None,
    metrics: MetricsRecorder | None = None,
) -> Any:
    """:func:`run_guarded`'s transient-retry half WITHOUT the terminal
    rung-walking or ``exhausted`` emission: transient faults retry with the
    same backoff/telemetry, but persistent faults (device loss) and an
    expired retry budget propagate RAW to the caller.

    For call sites whose recovery lives at a coarser granularity than one
    guarded call — the staged ingest pipeline (``dataflow.ingest``), whose
    recovery point is ``chunked_ingest(recover=...)``.  ``fn`` must be
    re-invocable."""
    policy = policy or RetryPolicy.from_env()
    attempts = 0
    while True:
        attempts += 1
        try:
            return _attempt(fn, site, policy)
        except Exception as exc:
            if not is_transient(exc) or attempts > policy.max_retries:
                raise
            _retry_pause(site, attempts, exc, policy, metrics)


def run_guarded(
    fn: Callable[[], Any],
    *,
    site: str,
    policy: RetryPolicy | None = None,
    metrics: MetricsRecorder | None = None,
    checkpoint_dir: str | None = None,
    fallback: Callable[[], Any] | None = None,
    fallbacks: "list[tuple[str | None, Callable[[BaseException], Any]]] | None" = None,
) -> Any:
    """Run ``fn`` under the full degradation ladder.

    1. up to ``policy.max_retries`` retries with exponential backoff, for
       transient failures only;
    2. the ``fallbacks`` rungs in order — each a ``(ladder, fn(exc))``
       pair.  A named rung publishes the ``degraded`` event here before
       running (``ladder`` must be declared in utils/config.DEGRADE_LADDER);
       ``ladder=None`` hands emission to the rung itself.  A rung that
       raises passes the ladder to the next.  ``fallback=`` is sugar for
       one trailing no-arg ``cpu`` rung.
    3. :class:`ResilienceExhausted` carrying the latest checkpoint under
       ``checkpoint_dir`` so the caller (or the operator) can resume.

    ``fn`` must be safe to re-invoke (fresh outputs, or a pure read).
    """
    policy = policy or RetryPolicy.from_env()
    attempts = 0
    last_exc: Exception | None = None
    while attempts <= policy.max_retries:
        attempts += 1
        try:
            return _attempt(fn, site, policy)
        # Exception, not BaseException: KeyboardInterrupt / SystemExit must
        # propagate — a Ctrl-C is an operator decision, not a device fault
        # for the ladder to "recover" from.
        except Exception as exc:
            last_exc = exc
            if not is_transient(exc):
                break
            if attempts > policy.max_retries:
                break
            _retry_pause(site, attempts, exc, policy, metrics)

    rungs = list(fallbacks or [])
    if fallback is not None:
        rungs.append(("cpu", lambda _exc, _fb=fallback: _fb()))
    for ladder, rung_fn in rungs:
        if ladder is not None:
            err = f"{type(last_exc).__name__}: {last_exc}"[:200]
            obs.emit("degraded", site=site, ladder=ladder,
                     after_attempts=attempts, error=err)
            obs.counter("degraded")
            if metrics is not None:
                metrics.record(
                    event="degraded", site=site, ladder=ladder,
                    after_attempts=attempts, error=err,
                )
        try:
            return rung_fn(last_exc)
        except Exception as exc:  # try the next rung; interrupts propagate
            last_exc = exc

    assert last_exc is not None
    last_ckpt = ckpt.latest_checkpoint(checkpoint_dir) if checkpoint_dir else None
    obs.emit(
        "exhausted", site=site, attempts=attempts,
        error=f"{type(last_exc).__name__}: {last_exc}"[:200],
        checkpoint=last_ckpt,
    )
    obs.counter("exhausted")
    raise ResilienceExhausted(site, attempts, last_exc, last_ckpt) from last_exc


def _cuda_devices(tree: Any, out: set) -> set:
    """The devices of the CUDA tensors in a nested tuple/list/dict."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _cuda_devices(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _cuda_devices(x, out)
    return out


def _fence(devices: set) -> None:
    """Wait for the caller's current stream on each of ``devices``."""
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a nested tuple (named too), list or
    dict; anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        vals = [_map(fn, x) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _pull(tree: Any) -> Any:
    """numpy for every tensor of ``tree`` with one fence for the whole
    tree: every CUDA tensor's copy is queued non-blocking (into pinned
    memory) on the current stream, then each device's stream is waited on
    once.  Every array is a snapshot, a CPU tensor's too (a copy): torch
    tensors are mutable, and a carry updated in place after the pull must
    not change what the pull returned."""
    host = _map(lambda t: t.to("cpu", non_blocking=True) if t.device.type == "cuda"
                else t.clone(), tree)
    _fence(_cuda_devices(tree, set()))
    return _map(lambda t: t.numpy(), host)


def device_get(
    tree: Any,
    *,
    site: str = "device_get",
    policy: RetryPolicy | None = None,
    metrics: MetricsRecorder | None = None,
    checkpoint_dir: str | None = None,
    fallbacks: "list[tuple[str | None, Callable[[BaseException], Any]]] | None" = None,
) -> Any:
    """Guarded pull of a nested tuple/list/dict of tensors to numpy: ONE
    fence per call (non-blocking copies, then one synchronize), not a
    blocking ``.cpu()`` per leaf; retried/deadlined by the executor.
    Device tensors outlive a failed pull and the pull only reads them, so
    re-issuing it is always safe.  ``fallbacks`` apply exactly as in
    :func:`run_guarded`."""
    return run_guarded(
        lambda: _pull(tree), site=site, policy=policy,
        metrics=metrics, checkpoint_dir=checkpoint_dir, fallbacks=fallbacks,
    )


def block_until_ready(
    tree: Any,
    *,
    site: str = "block_until_ready",
    policy: RetryPolicy | None = None,
    metrics: MetricsRecorder | None = None,
    checkpoint_dir: str | None = None,
) -> Any:
    """Guarded fence: wait for the caller's current stream on each device
    that holds one of ``tree``'s CUDA tensors — the stream every producer
    of the port launches on (kernel wrappers launch on the current stream;
    the ingest copy stream is joined to it by an event before compute
    reads its tensors) — and return ``tree``.  On the CPU it waits for
    nothing."""

    def fence() -> Any:
        _fence(_cuda_devices(tree, set()))
        return tree

    return run_guarded(
        fence, site=site, policy=policy,
        metrics=metrics, checkpoint_dir=checkpoint_dir,
    )
