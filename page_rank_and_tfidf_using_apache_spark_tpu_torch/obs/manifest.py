"""Run manifest: the who/where/how header every traced run writes at
startup and finalizes at exit.

Reference counterpart: the Spark application page — app id, executors,
resolved ``SparkConf``.  Here the manifest records the backend and device
topology (from ``torch.cuda``, when torch is already imported — writing a
manifest never forces the torch import in), the resolved value of every
declared ``GRAFT_*`` knob (``utils/config.GRAFT_ENV_KNOBS``), the tuned
profile the run resolved its knobs from, the git sha, and run identity.
Processes that only read manifests do so through the stdlib-only
``tools/trace_report.py``.

Counterpart of the JAX package's ``obs/manifest.py``, which reads jax's
devices and records the default backend's profile in every manifest.
Here a run records the profile it was handed: a CLI resolves the profile
of the device it runs on (:func:`resolve_tuned_profile`) and opens its run
inside :func:`recording_profile`, and a run opened outside one (an API
caller's) records None.

The startup write is atomic (tmp + rename) and self-sufficient: a child
that is later SIGKILLed still leaves ``status: "running"`` plus its full
environment snapshot — evidence, not a mystery.  ``finalize`` rewrites the
file with the end state (status, wall seconds, event count, the
counter/gauge/histogram summary).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Iterator


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


def _snapshot(prof) -> dict[str, Any] | None:
    if prof is None:
        return None
    return {
        "path": str(prof.path) if prof.path is not None else None,
        "backend": prof.backend,
        "git_sha": prof.git_sha,
        "source": prof.source,
        "knobs": dict(prof.knobs),
    }


# The snapshot of the profile that the command in this context resolved:
# the startup write records it, None outside recording_profile().
_PROFILE: contextvars.ContextVar = contextvars.ContextVar("tuned_profile", default=None)


@contextlib.contextmanager
def recording_profile(snapshot: dict[str, Any] | None) -> Iterator[None]:
    """Runs opened inside record ``snapshot`` (from
    :func:`resolve_tuned_profile`) as their manifest's ``tuned_profile``."""
    token = _PROFILE.set(snapshot)
    try:
        yield
    finally:
        _PROFILE.reset(token)


def resolve_tuned_profile(backend: str, path: str | None) -> tuple:
    """The CLIs' tuned-profile rung, resolved before the run opens: load
    the profile for ``backend`` (the backend of the device the command
    resolved) through ``utils/config.load_tuned_profile``, ``path`` being
    ``--tuned-profile`` (``"off"`` disables profile loading).  Returns
    ``(profile, snapshot, refused)``: the profile or None, its manifest
    snapshot (the reference's ``_tuned_profile_snapshot`` for this backend
    and path), and the error a broken or wrong-backend profile raised —
    its snapshot is ``{"error": ...}``, evidence rather than a crash inside
    manifest writing; the command raises it once its run is open."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.artifacts import (
        ProvenanceError,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        TunedProfileError,
        load_tuned_profile,
    )

    try:
        prof = None if path == "off" else load_tuned_profile(backend, path=path)
    except (TunedProfileError, ProvenanceError) as exc:
        return None, {"error": f"{type(exc).__name__}: {exc}"}, exc
    return prof, _snapshot(prof), None


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
        "tuned_profile": _PROFILE.get(),
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
