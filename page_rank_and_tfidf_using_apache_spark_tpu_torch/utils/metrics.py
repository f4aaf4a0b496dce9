"""Structured metrics, a wall-clock timer and the latency percentile.

Counterpart of the JAX package's ``utils/metrics.py``: every record is kept
in memory, published on the obs event bus as a ``kind="metric"`` event (so
a traced run's JSONL file carries the record stream beside its spans),
logged to stderr as one JSON line, and dumpable as JSON.  The stderr log
level follows the ``GRAFT_LOG_LEVEL`` env knob (default INFO; declared in
``utils/config.GRAFT_ENV_KNOBS``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import threading
import time
from typing import Any

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs


def resolve_log_level(spec: str | None, default: int = logging.INFO) -> int:
    """Map a GRAFT_LOG_LEVEL string ('debug', 'WARNING', '30', ...) to a
    logging level int; unknown spellings fall back to ``default``."""
    if not spec:
        return default
    spec = spec.strip()
    if spec.isdigit():
        # "0" means "log everything": setLevel(NOTSET) would instead defer
        # to the root logger (WARNING), silencing the metric lines
        return int(spec) or logging.DEBUG
    level = logging.getLevelName(spec.upper())
    return level if isinstance(level, int) else default


logger = logging.getLogger("pr_tfidf_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(resolve_log_level(os.environ.get("GRAFT_LOG_LEVEL")))


@dataclasses.dataclass
class MetricsRecorder:
    """Collects per-step structured records and run-level scalars.

    Thread-safe: ``record``/``scalar`` may be called from worker threads
    concurrently with the main loop."""

    records: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    scalars: dict[str, Any] = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record(self, **kwargs: Any) -> None:
        with self._lock:
            self.records.append(kwargs)
        obs.emit("metric", **kwargs)
        logger.info("%s", json.dumps(kwargs, default=float))

    def scalar(self, name: str, value: Any) -> None:
        with self._lock:
            self.scalars[name] = value

    def to_json(self) -> str:
        with self._lock:
            return json.dumps(
                {"records": list(self.records), "scalars": dict(self.scalars)},
                default=float,
            )

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def percentile(sorted_xs, p: float):
    """Nearest-rank percentile over an ascending sequence (None when
    empty): the convention of the JAX package's latency reports and of
    ``tools/trace_report.py``'s ``_pct``, so one run never reports two
    different p99s across artifacts."""
    if not sorted_xs:
        return None
    n = len(sorted_xs)
    rank = -(-int(p * 100) * n // 100)  # ceil without math
    return sorted_xs[min(n - 1, max(0, rank - 1))]


class Timer:
    """Wall-clock timer context; synchronise the device (read a result
    back to the host) inside the block — CUDA launches are asynchronous."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self.start


def timed() -> Timer:
    """A fresh :class:`Timer` (``with timed() as t: ...; t.elapsed``)."""
    return Timer()
