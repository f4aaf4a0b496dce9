"""Event model, bus and sinks for the run-telemetry subsystem.

Reference counterpart: the Spark event log (``spark.eventLog.enabled``) —
an append-only record of everything the application did, written durably enough
that a dead executor still leaves evidence.  Here the equivalents are:

- :class:`EventBus` — the process-global publish point.  Every event is a
  flat dict stamped with a monotonic timestamp (``t``, ``time.perf_counter``
  — comparable across threads within one process), a wall clock (``wall``),
  a per-process sequence number, and the emitting thread.  Publishers never
  block on a broken sink: a sink that raises is detached with one stderr
  warning (telemetry must never kill the run it observes).
- :class:`JsonlSink` — the crash-safe trace file: one JSON line per event,
  appended and flushed *per event*, so a SIGKILLed child still leaves every
  completed event on disk (a timeout kill would otherwise leave nothing
  but a scraped stderr tail).  A kill mid-write can
  truncate only the final line; readers (tools/trace_report.py) skip it.
- :class:`MemorySink` — in-memory capture for tests.
- :class:`Aggregates` — counters / gauges / histograms folded in-process,
  summarized once at run end (the Spark UI stage-counter equivalent).

A copy of the JAX package's ``obs/events.py`` (stdlib), so the port never
imports that package.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable


def jsonable(obj: Any) -> Any:
    """``json.dumps`` fallback: numpy scalars → float, everything else →
    repr.  The trace must never lose an event to a serialization error."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


class EventBus:
    """Thread-safe fan-out of structured events to attached sinks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sinks: list[Any] = []
        self._seq = 0

    def attach(self, sink: Any) -> None:
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def detach(self, sink: Any) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def sink_count(self) -> int:
        with self._lock:
            return len(self._sinks)

    def publish(self, kind: str, /, **fields: Any) -> dict[str, Any]:
        """Stamp and deliver one event.  Returns the event dict (tests and
        callers may want the assigned ``seq``/``t``).  ``kind`` is
        positional-only so arbitrary field dicts (e.g. forwarded
        MetricsRecorder records) can never collide with it."""
        event: dict[str, Any] = {
            "t": time.perf_counter(),
            "wall": time.time(),
            "kind": kind,
            "thread": threading.current_thread().name,
        }
        for key, value in fields.items():
            # the envelope stamps are load-bearing for trace_report: a
            # colliding payload field is prefixed, never dropped or allowed
            # to overwrite them
            event[key if key not in event and key != "seq" else f"f_{key}"] = value
        with self._lock:
            event["seq"] = self._seq
            self._seq += 1
            sinks = tuple(self._sinks)
        for sink in sinks:
            try:
                sink.emit(event)
            except Exception as exc:  # noqa: BLE001 — observability must not kill the run
                self.detach(sink)
                print(
                    f"obs: detached broken sink {type(sink).__name__}: "
                    f"{type(exc).__name__}: {exc}",
                    file=sys.stderr,
                )
                # Best-effort tombstone: if the failure was transient (one
                # full-disk write, an NFS blip), a final marker line keeps a
                # truncated-but-finished run distinguishable from a SIGKILL
                # in trace_report ("sink_detached" vs no evidence at all).
                try:
                    sink.emit(
                        {
                            "t": time.perf_counter(),
                            "wall": time.time(),
                            "kind": "sink_detached",
                            "thread": threading.current_thread().name,
                            "error": f"{type(exc).__name__}: {exc}"[:200],
                            "seq": event["seq"],
                        }
                    )
                except Exception:  # noqa: BLE001 — the sink really is dead
                    pass
        return event


class JsonlSink:
    """Append-one-line-per-event trace file, flushed per event so a killed
    process leaves every completed event parseable on disk."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, event: dict[str, Any]) -> None:
        line = json.dumps(event, default=jsonable, separators=(",", ":"))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class MemorySink:
    """Test sink: collects events in memory."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []

    def emit(self, event: dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    def close(self) -> None:
        pass

    @property
    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def kinds(self) -> list[str]:
        return [e["kind"] for e in self.events]

    def of_kind(self, kind: str) -> list[dict[str, Any]]:
        return [e for e in self.events if e["kind"] == kind]


class Aggregates:
    """Run-scoped counters, gauges and histograms, summarized at run end.

    The histograms are O(bins) streaming instruments
    (:class:`obs.metrics.StreamingHistogram`), not retained sample
    lists: count/sum/min/max/mean stay exact over a soak-length run,
    quantiles are correct to within one geometric bin, and memory never
    grows with the event count (pinned by the 10^6-event regression test
    in tests/test_slo_metrics.py)."""

    def __init__(self) -> None:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import (
            StreamingHistogram,
        )

        self._make_hist = StreamingHistogram
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Any] = {}

    def counter(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def histogram(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = self._make_hist()
        hist.observe(float(value))

    def summary(self) -> dict[str, Any]:
        with self._lock:
            hists = {name: h.snapshot() for name, h in self._hists.items()}
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": hists,
            }


SinkFactory = Callable[[str], Any]
