"""Run lifecycle and the process-global telemetry entry points.

One process has ONE event bus and ONE span tracer (module globals here);
``obs.emit`` / ``obs.span`` work from anywhere — resilience retries, the
streaming tokenizer thread, checkpoint writes — whether or not a run is
active.  With no run, events fan out to whatever sinks tests attached and
aggregation is a no-op, so instrumented library code costs nothing.

:func:`start_run` turns the stream into durable artifacts: it resolves a
trace directory (explicit argument, else the ``GRAFT_TRACE_DIR`` env knob),
opens the crash-safe JSONL sink at ``<dir>/<name>.<pid>.trace.jsonl``,
writes the startup manifest next to it, and publishes ``run_start``.
:func:`end_run` publishes ``run_end`` carrying the counter/gauge/histogram
summary and finalizes the manifest.  An ``atexit`` hook finalizes a run the
caller forgot (status ``"atexit"``); only SIGKILL leaves ``"running"`` —
which is precisely the durable evidence of *where* it died.

A copy of the JAX package's ``obs/runtime.py`` (stdlib), so the port never
imports that package; a trace it writes reads back through the same
``tools/trace_report.py``.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading
from typing import Any, Iterator

from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import manifest as mf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.events import (
    Aggregates,
    EventBus,
    JsonlSink,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.trace import SpanTracer

_BUS = EventBus()
_TRACER = SpanTracer(_BUS)

_run_lock = threading.Lock()
_active_run: "Run | None" = None
_atexit_registered = False


class Run:
    """One traced run: JSONL sink + manifest + aggregates."""

    def __init__(self, name: str, trace_dir: str | None):
        self.name = name
        self.aggregates = Aggregates()
        self.trace_path: str | None = None
        self.manifest_path: str | None = None
        self._manifest_doc: dict[str, Any] | None = None
        self._sink: JsonlSink | None = None
        self._events0 = 0
        self._finalized = False
        # Cross-process span propagation: a parent
        # process that wants one trace tree over many children exports an
        # opaque trace id as GRAFT_TRACE_PARENT; every child run adopts it
        # here — in the run_start event AND the manifest — so
        # tools/trace_report.py --stitch can reassemble the round's tree
        # from the artifacts alone, no pid archaeology.
        self.trace_parent = os.environ.get("GRAFT_TRACE_PARENT") or None
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            stem = f"{name}.{os.getpid()}"
            self.trace_path = os.path.join(trace_dir, f"{stem}.trace.jsonl")
            self.manifest_path = os.path.join(trace_dir, f"{stem}.manifest.json")
            # manifest first, sink last: the failure-prone steps (atomic
            # manifest write, trace-file open) run before anything attaches
            # to the bus, so a failed construction can never leak an
            # attached orphan sink collecting a run that never started
            self._manifest_doc = mf.write_manifest(
                self.manifest_path, name, self.trace_path,
                extra=(
                    {"trace_parent": self.trace_parent}
                    if self.trace_parent else None
                ),
            )
            self._sink = JsonlSink(self.trace_path)
            _BUS.attach(self._sink)
        start = _BUS.publish(
            "run_start", name=name, run_pid=os.getpid(),
            **({"trace_parent": self.trace_parent} if self.trace_parent else {}),
        )
        self._events0 = start["seq"]

    # ------------------------------------------------------------- metrics

    def counter(self, name: str, n: float = 1) -> None:
        self.aggregates.counter(name, n)

    def gauge(self, name: str, value: float) -> None:
        self.aggregates.gauge(name, value)

    def histogram(self, name: str, value: float) -> None:
        self.aggregates.histogram(name, value)

    # ------------------------------------------------------------ lifecycle

    def finalize(self, status: str = "ok", extra: dict[str, Any] | None = None) -> None:
        if self._finalized:
            return
        self._finalized = True
        summary = self.aggregates.summary()
        end = _BUS.publish("run_end", name=self.name, status=status, summary=summary)
        if self._sink is not None:
            _BUS.detach(self._sink)
            self._sink.close()
        if self.manifest_path and self._manifest_doc is not None:
            mf.finalize_manifest(
                self.manifest_path,
                self._manifest_doc,
                status=status,
                events=end["seq"] - self._events0 + 1,
                summary=summary,
                extra=extra,
            )


# ---------------------------------------------------------------- module API


def bus() -> EventBus:
    return _BUS


def tracer() -> SpanTracer:
    return _TRACER


def emit(kind: str, /, **fields: Any) -> dict[str, Any]:
    """Publish one event on the process bus."""
    return _BUS.publish(kind, **fields)


def span(name: str, /, *, parent: int | None = None, **attrs: Any):
    """Open a traced span (context manager; see obs/trace.py)."""
    return _TRACER.span(name, parent=parent, **attrs)


def current_run() -> Run | None:
    with _run_lock:
        return _active_run


def counter(name: str, n: float = 1) -> None:
    run = current_run()
    if run is not None:
        run.counter(name, n)


def gauge(name: str, value: float) -> None:
    run = current_run()
    if run is not None:
        run.gauge(name, value)


def histogram(name: str, value: float) -> None:
    run = current_run()
    if run is not None:
        run.histogram(name, value)


def _finalize_leftover() -> None:
    run = current_run()
    if run is not None:
        end_run(status="atexit")


def start_run(name: str, trace_dir: str | None = None) -> Run:
    """Begin a traced run.  ``trace_dir`` defaults to the GRAFT_TRACE_DIR
    env knob; with neither, the run has no JSONL sink or manifest (events
    still reach any attached sinks, aggregates still fold).  Starting a
    run while one is active finalizes the old one first (status
    ``"superseded"``) — runs never nest."""
    global _active_run, _atexit_registered
    if trace_dir is None:
        trace_dir = os.environ.get("GRAFT_TRACE_DIR") or None
    prev = current_run()
    if prev is not None:
        prev.finalize(status="superseded")
    run = Run(name, trace_dir)
    with _run_lock:
        _active_run = run
        if not _atexit_registered:
            atexit.register(_finalize_leftover)
            _atexit_registered = True
    return run


def end_run(status: str = "ok", extra: dict[str, Any] | None = None) -> None:
    """Finalize and clear the active run (no-op when none is active)."""
    global _active_run
    with _run_lock:
        run, _active_run = _active_run, None
    if run is not None:
        run.finalize(status=status, extra=extra)


@contextlib.contextmanager
def run(name: str, trace_dir: str | None = None) -> Iterator[Run]:
    """``with obs.run("tfidf"):`` — start_run/end_run with error status
    propagation (an exception finalizes as ``error:<Type>`` and re-raises)."""
    r = start_run(name, trace_dir)
    try:
        yield r
    except BaseException as exc:
        end_run(status=f"error:{type(exc).__name__}")
        raise
    else:
        end_run(status="ok")
