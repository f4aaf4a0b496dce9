"""Run manifest: the who/where/how header every traced run writes at
startup and finalizes at exit.

Reference counterpart: the Spark application page — app id, executors,
resolved ``SparkConf``.  Here the manifest records the backend and device
topology (from ``torch.cuda``, when torch is already imported — writing a
manifest never forces the torch import in), the resolved value of every
declared ``GRAFT_*`` knob (``utils/config.GRAFT_ENV_KNOBS``), the git sha,
and run identity.  Processes that only read manifests do so through the
stdlib-only ``tools/trace_report.py``.

Counterpart of the JAX package's ``obs/manifest.py``, which reads jax's
devices and its tuned profile.  The port has no tuned profile yet, so
``tuned_profile`` is always None here.

The startup write is atomic (tmp + rename) and self-sufficient: a child
that is later SIGKILLed still leaves ``status: "running"`` plus its full
environment snapshot — evidence, not a mystery.  ``finalize`` rewrites the
file with the end state (status, wall seconds, event count, the
counter/gauge/histogram summary).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any


def _git_sha() -> str | None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        proc = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None if proc.returncode == 0 else None


def _device_snapshot() -> dict[str, Any]:
    """Backend + topology, only when torch is already in the process — the
    manifest write itself must never be what pulls the torch import in.
    Backend ``cuda`` with the cards' names where CUDA is available, else
    ``cpu``."""
    if "torch" not in sys.modules:
        return {"backend": None, "devices": None, "device_count": None}
    try:
        import torch

        if not torch.cuda.is_available():
            return {"backend": "cpu", "devices": ["cpu"], "device_count": 1}
        count = torch.cuda.device_count()
        return {
            "backend": "cuda",
            "devices": [torch.cuda.get_device_name(i) for i in range(count)],
            "device_count": count,
        }
    except Exception as exc:  # noqa: BLE001 — a dead backend is itself evidence
        return {
            "backend": f"error:{type(exc).__name__}",
            "devices": None,
            "device_count": None,
        }


def knob_snapshot() -> dict[str, str | None]:
    """Resolved value (or None) of every declared GRAFT_* knob."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        GRAFT_ENV_KNOBS,
    )

    return {k: os.environ.get(k) for k in sorted(GRAFT_ENV_KNOBS)}


def _atomic_write(path: str, doc: dict[str, Any]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, default=str)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def write_manifest(
    path: str,
    name: str,
    trace_path: str | None,
    extra: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Write the startup manifest; returns the document."""
    doc: dict[str, Any] = {
        "name": name,
        "status": "running",
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "started_wall": time.time(),
        "trace_path": trace_path,
        "git_sha": _git_sha(),
        "lint_clean": None,  # filled by callers that ran the gate (bench.py)
        "knobs": knob_snapshot(),
        "tuned_profile": None,  # the port has no tuned profile yet
    }
    doc.update(_device_snapshot())
    if extra:
        doc.update(extra)
    _atomic_write(path, doc)
    return doc


def finalize_manifest(
    path: str,
    doc: dict[str, Any],
    *,
    status: str,
    events: int,
    summary: dict[str, Any] | None = None,
    extra: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Rewrite the manifest with the run's end state."""
    doc = dict(doc)
    doc["status"] = status
    doc["finished_wall"] = time.time()
    doc["wall_secs"] = doc["finished_wall"] - doc["started_wall"]
    doc["events"] = events
    if summary is not None:
        doc["summary"] = summary
    # the backend may only have resolved after startup (torch imported later)
    if doc.get("backend") is None:
        doc.update(_device_snapshot())
    if extra:
        doc.update(extra)
    _atomic_write(path, doc)
    return doc
