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
  (``"torch" in sys.modules`` gates it; once torch is loaded the lookup is
  cached on the tracer), and it enters the range only while a profiler
  records (``torch.autograd._profiler_enabled()``), so a span outside a
  profiler costs no ``record_function``.  Processes that only read traces
  do so through the stdlib-only ``tools/trace_report.py``.

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
        # (profiler_enabled, record_function) once torch is loaded
        self._bridge: tuple | None = None

    def _new_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        return sid

    def _profiler_range(self, name: str):
        """A ``torch.profiler.record_function(name)`` while a profiler
        records, else None."""
        if self._bridge is None:
            if "torch" not in sys.modules:  # annotate, never import
                return None
            try:
                import torch

                self._bridge = (torch.autograd._profiler_enabled,
                                torch.profiler.record_function)
            except Exception:  # noqa: BLE001 — the bridge is best-effort
                return None
        enabled, record_function = self._bridge
        return record_function(name) if enabled() else None

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
            profiler_range = self._profiler_range(name)
            if profiler_range is not None:
                try:
                    bridge.enter_context(profiler_range)
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
