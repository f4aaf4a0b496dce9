"""Process-level fault handling: the supervisor side of the serving
fabric.

A copy of the JAX package's ``resilience/process.py`` (stdlib and ``obs``),
so the port never imports that package; ``tests/test_torch_fabric.py``
holds its code to the reference's.

Every rung so far degrades *inside* one process (retry, mesh_shrink,
single_device, cpu).  A replica process that is SIGKILLed — the chaos
kind ``proc_kill``, or a real OOM, segfault or lost CUDA context — is past
all of them: the recovery is a *different* process respawning it, which is
Spark's driver-replaces-executor story applied to serving replicas.  This
module owns that rung: a thin :class:`ProcessHandle` around
``subprocess.Popen`` (spawn, ready handshake, graceful TERM with a KILL
deadline), and :func:`respawn`, which publishes the ``degraded`` event on
the declared ``respawn`` ladder rung (``utils/config.py``
``DEGRADE_LADDER``) before bringing the replacement up.

``Popen`` forks and then execs a fresh interpreter, so a supervisor that
has already initialised CUDA may spawn replicas: the child inherits no
CUDA state.

The ready handshake is one JSON line on the child's stdout (the fabric
replica prints ``{"ready": true, "port": ..., ...}`` once it can serve):
supervisors must not route to a replica that is still loading segments.
Stdout after the handshake keeps streaming into a drain thread so a chatty
child can never fill the pipe and wedge itself.
"""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import threading
import time
from typing import Any, Callable, Sequence

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs


class ProcessSpawnError(RuntimeError):
    """The child died (or said something unparseable) before its ready
    handshake — spawn-time failure, distinct from a crash while serving."""


class ProcessHandle:
    """One supervised child process.

    Lifecycle: ``spawn()`` forks it and waits for the one-line JSON ready
    handshake on stdout; ``alive()`` polls; ``terminate()`` is the
    graceful path (SIGTERM, bounded wait, SIGKILL only past the
    deadline); ``kill()`` is the chaos/crash path (immediate SIGKILL).
    The handle is re-spawnable: :func:`respawn` builds a fresh one from
    the same argv/env."""

    def __init__(self, argv: Sequence[str], *,
                 env: dict[str, str] | None = None,
                 ready_timeout_s: float = 60.0):
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self.ready_timeout_s = ready_timeout_s
        self.ready: dict[str, Any] = {}
        self.proc: subprocess.Popen | None = None
        self._drain: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def spawn(self) -> "ProcessHandle":
        """Fork the child and block for its ready handshake (one JSON
        line on stdout).  Raises :class:`ProcessSpawnError` when the
        child exits or prints garbage instead."""
        self.proc = subprocess.Popen(
            self.argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=self.env,
        )
        assert self.proc.stdout is not None
        deadline = time.monotonic() + self.ready_timeout_s
        line = ""
        while True:
            if time.monotonic() > deadline:
                self.kill()
                raise ProcessSpawnError(
                    f"no ready handshake within {self.ready_timeout_s}s: "
                    f"{self.argv!r}"
                )
            # select-bounded read: a silent-but-alive child must not wedge
            # the supervisor in a blocking readline past the deadline
            ready_r, _, _ = select.select([self.proc.stdout], [], [], 0.25)
            if not ready_r:
                if self.proc.poll() is not None:
                    raise ProcessSpawnError(
                        f"child exited rc={self.proc.returncode} before "
                        f"ready handshake: {self.argv!r}"
                    )
                continue
            line = self.proc.stdout.readline()
            if line.strip():
                break
            if not line and self.proc.poll() is not None:
                raise ProcessSpawnError(
                    f"child exited rc={self.proc.returncode} before ready "
                    f"handshake: {self.argv!r}"
                )
        try:
            self.ready = json.loads(line)
        except (json.JSONDecodeError, ValueError) as exc:
            self.kill()
            raise ProcessSpawnError(
                f"unparseable ready handshake {line!r} from {self.argv!r}"
            ) from exc
        if not self.ready.get("ready"):
            self.kill()
            raise ProcessSpawnError(
                f"child declined ready handshake: {self.ready!r}"
            )
        # keep draining stdout so the child can't block on a full pipe
        # (the drain touches no shared mutable state, so it takes no lock)
        self._drain = threading.Thread(
            target=self._drain_stdout, name="proc-stdout-drain", daemon=True
        )
        self._drain.start()
        return self

    def _drain_stdout(self) -> None:
        assert self.proc is not None and self.proc.stdout is not None
        try:
            for _ in self.proc.stdout:
                pass
        except (OSError, ValueError):
            pass

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def returncode(self) -> int | None:
        return self.proc.returncode if self.proc is not None else None

    def terminate(self, grace_s: float = 10.0) -> int | None:
        """Graceful stop: SIGTERM, wait up to ``grace_s``, then SIGKILL.
        Returns the exit code (None if there was no process)."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.kill()
        return self.proc.wait()

    def kill(self) -> None:
        """Immediate SIGKILL — the chaos path and the grace-expired path."""
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGKILL)
            except OSError:
                pass
            self.proc.wait()


def respawn(
    handle: ProcessHandle,
    *,
    site: str,
    replica: int | None = None,
    reason: str | None = None,
    spawn: Callable[[], ProcessHandle] | None = None,
) -> ProcessHandle:
    """Replace a dead (or about-to-be-replaced) child with a fresh spawn
    of the same argv/env — the ``respawn`` rung of the degradation
    ladder, published BEFORE the replacement comes up so a respawn that
    itself dies still left evidence.  ``spawn`` overrides how the
    replacement is built (the fabric threads a port re-assignment in)."""
    old_pid = handle.pid
    rc = handle.returncode()
    obs.emit(
        "degraded", site=site, ladder="respawn", replica=replica,
        pid=old_pid, returncode=rc,
        error=(reason or f"process {old_pid} rc={rc}")[:200],
    )
    obs.counter("degraded")
    obs.counter("respawns")
    handle.kill()  # reap a half-dead child before replacing it
    if spawn is not None:
        return spawn()
    fresh = ProcessHandle(handle.argv, env=handle.env,
                          ready_timeout_s=handle.ready_timeout_s)
    return fresh.spawn()


def fabric_pgid_env() -> dict[str, str]:
    """Environment for fabric children: inherit, minus knobs that must
    not leak parent-scoped state into replicas (each replica gets its own
    chaos plan from the caller, not the parent's)."""
    env = dict(os.environ)
    env.pop("GRAFT_CHAOS", None)
    return env
