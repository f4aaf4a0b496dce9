"""Structured metrics and a wall-clock timer.

Counterpart of the JAX package's ``utils/metrics.py`` without the event
bus: every step record is kept in memory, logged to stderr as one JSON
line, and dumpable as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import threading
import time
from typing import Any

logger = logging.getLogger("pr_tfidf_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


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


class Timer:
    """Wall-clock timer context; synchronise the device (read a result
    back to the host) inside the block — CUDA launches are asynchronous."""

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self.start
