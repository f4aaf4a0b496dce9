"""Context-propagated span tracer.

Reference counterpart: the Spark UI stage/task timeline.  A *span* is one
named host-side phase (``obs.span("tfidf.chunk", chunk=24)``) with a
monotonic start/stop, an id, and a parent — nested spans form the per-run
call tree that ``tools/trace_report.py`` reconstructs into a wall-time
breakdown.

Design points:

- **Context propagation** rides on :mod:`contextvars`: each thread starts
  with an empty span stack, so spans opened on the streaming tokenizer
  thread nest among themselves and never steal the main thread's parent
  (the bug class the ``unsynced-thread-state`` lint patrols).  Explicit
  cross-thread parentage is available via ``span(..., parent=sid)``.
- **Crash evidence by construction**: ``span_begin`` is published (and the
  JSONL sink flushes it) *before* the body runs, so a SIGKILL mid-span
  leaves a begin with no end — exactly what trace_report reports as "the
  last incomplete span".  An exception ends the span with
  ``status="error:<Type>"`` and re-raises.
- **Profiler bridge**: when torch is already imported, every span also
  enters a ``torch.profiler.record_function`` of the same name, so host
  phases line up with the card's kernels in a ``torch.profiler`` trace
  (``utils/profiling.trace``).  The bridge never *imports* torch
  (``"torch" in sys.modules`` gates it), and outside a profiler the range
  costs next to nothing.  Processes that only read traces do so through
  the stdlib-only ``tools/trace_report.py``.

Counterpart of the JAX package's ``obs/trace.py``, whose bridge opens a
``jax.profiler.TraceAnnotation`` instead.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
from typing import Any, Iterator

import time

from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.events import EventBus

_current_span: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "graft_obs_span", default=None
)


class SpanTracer:
    """Allocates span ids and publishes span_begin/span_end to a bus."""

    def __init__(self, bus: EventBus):
        self._bus = bus
        self._lock = threading.Lock()
        self._next_id = 1

    def _new_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        return sid

    def current(self) -> int | None:
        """Span id of the innermost open span in this context (None at the
        top level — including on a freshly spawned thread)."""
        return _current_span.get()

    @contextlib.contextmanager
    def span(
        self, name: str, /, *, parent: int | None = None, **attrs: Any
    ) -> Iterator[int]:
        sid = self._new_id()
        par = parent if parent is not None else _current_span.get()
        t0 = time.perf_counter()
        self._bus.publish(
            "span_begin", span=sid, parent=par, name=name, attrs=attrs
        )
        token = _current_span.set(sid)
        status = "ok"
        with contextlib.ExitStack() as bridge:
            if "torch" in sys.modules:  # annotate, never import
                try:
                    from torch.profiler import record_function

                    bridge.enter_context(record_function(name))
                except Exception:  # noqa: BLE001 — the bridge is best-effort
                    pass
            try:
                yield sid
            except BaseException as exc:
                status = f"error:{type(exc).__name__}"
                raise
            finally:
                _current_span.reset(token)
                self._bus.publish(
                    "span_end",
                    span=sid,
                    parent=par,
                    name=name,
                    secs=time.perf_counter() - t0,
                    status=status,
                    attrs=attrs,
                )
