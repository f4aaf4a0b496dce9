"""Deterministic fault injection for the resilience executor.

A copy of the JAX package's ``resilience/chaos.py`` (stdlib, ``obs`` and
the port's ``resilience/elastic.py``), so the port never imports that
package.  Its code is held to the reference's, whole, by
``tests/test_torch_resilience.py``.

The failure modes a long run meets are transient device errors (a CUDA
out-of-memory, a busy driver), hung host<->device syncs, and outright
device loss.  None of them can be provoked on demand on real hardware, so
recovery paths would otherwise ship untested.  This shim injects all three
deterministically at *guarded call sites* (every host-sync / dispatch
boundary routed through ``resilience.executor``), so CPU tests and
``chip_smoke.py`` can prove end-to-end recovery.

Plan specification — the ``GRAFT_CHAOS`` env var or :func:`inject`::

    GRAFT_CHAOS = "<injection>[;<injection>...]"
    <injection> = "<site>:<kind>@<when>[:<param>]"

    site   exact site name as passed to executor.run_guarded (e.g.
           "pagerank_step", "tfidf_chunk_sync"), or "*" for every site
    kind   fail  - raise ChaosError (a *transient* device error: the
                   executor retries it with backoff)
           lost  - raise DeviceLostError (*persistent*: no retry; the
                   executor walks the caller's degradation rungs, if any,
                   then raises ResilienceExhausted)
           hang  - sleep <param> seconds (default 3600) before returning,
                   simulating a hung device_get; only a sync deadline
                   (GRAFT_SYNC_DEADLINE_S) interrupts it
           device_lost - kill ONE logical device: raise DeviceLostError
                   carrying ``.device = K`` on every matching guarded call
                   — exactly how a real dead card behaves: every touch
                   fails — until a rung acknowledges the loss
                   (``elastic.health().mark_lost(K)``), after which the
                   run no longer touches the card and the injection stops.
                   Spelled ``device_lost@dev:K`` (K = a ``torch.cuda``
                   device index).
           proc_kill - SIGKILL the *current process* at the site (the
                   chaos event is flushed to the trace first): a replica
                   dying mid-query or mid-hot-swap in the serving fabric.
                   Recovery belongs to a DIFFERENT process (the fabric
                   supervisor respawns; the router re-dispatches), so this
                   kind never returns.
           net_partition - raise PartitionError (a ChaosError subclass,
                   so still *transient* to the executor): the router's
                   view of an unreachable replica.  The fabric marks the
                   target suspect and retries the query on a sibling.
           net_hang - sleep <param> MILLISECONDS (default 500) before
                   returning — a slow/blackholed network hop, deliberately
                   in ms where ``hang`` is in seconds: network stalls are
                   bounded by request timeouts, not the sync watchdog.
    when   N     the Nth guarded call at this site (1-based), exactly once
           N+    every call from the Nth on
           %K    every Kth call (K, 2K, 3K, ...)
           dev   (device_lost only) every call while device <param> is
                 still considered healthy
    param  seconds for hang; MILLISECONDS for net_hang; the logical
           device index for device_lost

Examples::

    GRAFT_CHAOS="pagerank_step:fail@2"          # one transient mid-run blip
    GRAFT_CHAOS="tfidf_chunk_sync:lost@26"      # kill the 26th chunk drain
    GRAFT_CHAOS="*:fail@%5"                     # every 5th guarded call
                                                # fails once
    GRAFT_CHAOS="*:device_lost@dev:0"           # card 0 dies: every guarded
                                                # call raises until the loss
                                                # is acknowledged

Counters are per *actual* site name and live on the installed plan, so one
plan == one deterministic schedule.  Everything is thread-safe: guarded
calls may come from the streaming prefetch machinery.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import threading
import time

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs


class ChaosError(RuntimeError):
    """Injected *transient* device error (stands in for the retryable
    XlaRuntimeError family: UNAVAILABLE / DEADLINE_EXCEEDED / ...)."""


class PartitionError(ChaosError):
    """Injected network partition between router and replica (kind
    ``net_partition``).  A :class:`ChaosError` subclass on purpose: to the
    retry machinery a partition is transient (the link may heal), but the
    fabric router additionally marks the target replica *suspect* so the
    very next attempt routes to a sibling instead of the black hole."""


class DeviceLostError(RuntimeError):
    """Injected *persistent* device loss — retrying on the same device
    cannot help; only degradation or restart-from-snapshot can.

    ``device`` names the lost device (a ``torch.cuda`` device index)
    when the fault targets one device (kind ``device_lost``); None means
    the whole backend is gone (kind ``lost``)."""

    def __init__(self, message: str, device: int | None = None):
        super().__init__(message)
        self.device = device


@dataclasses.dataclass(frozen=True)
class Injection:
    site: str  # exact site name or "*"
    kind: str  # "fail" | "lost" | "hang" | "device_lost" | "proc_kill" | "net_partition" | "net_hang"
    when: str  # "N" | "N+" | "%K" | "dev"
    param: float  # seconds for hang, ms for net_hang, device for device_lost

    def matches(self, site: str, count: int) -> bool:
        if self.site != "*" and self.site != site:
            return False
        w = self.when
        if w == "dev":
            # device_lost: fires on every call; gated at injection time on
            # whether the target device is still considered healthy
            return True
        if w.startswith("%"):
            k = int(w[1:])
            return k > 0 and count % k == 0
        if w.endswith("+"):
            return count >= int(w[:-1])
        return count == int(w)


def parse_plan(spec: str) -> tuple[Injection, ...]:
    """Parse a GRAFT_CHAOS spec string; raises ValueError on bad syntax."""
    out: list[Injection] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad chaos injection {raw!r}: want site:kind@when[:param]")
        site, action = parts[0], parts[1]
        if "@" not in action:
            raise ValueError(f"bad chaos injection {raw!r}: missing @when")
        kind, when = action.split("@", 1)
        if kind not in ("fail", "lost", "hang", "device_lost",
                        "proc_kill", "net_partition", "net_hang"):
            raise ValueError(f"bad chaos kind {kind!r} in {raw!r}")
        if kind == "device_lost":
            # grammar: site:device_lost@dev:K — the device index rides in
            # the param slot, and "dev" is the only legal schedule token
            if when != "dev" or len(parts) != 3 or not parts[2].isdigit():
                raise ValueError(
                    f"bad chaos injection {raw!r}: device_lost is spelled "
                    "site:device_lost@dev:<device-index>"
                )
            out.append(Injection(site=site, kind=kind, when=when,
                                 param=float(int(parts[2]))))
            continue
        m = re.fullmatch(r"%(\d+)|(\d+)\+?", when)
        if m is None or int(m.group(1) or m.group(2)) < 1:
            raise ValueError(f"bad chaos schedule {when!r} in {raw!r}")
        if len(parts) == 3:
            param = float(parts[2])
        else:
            # hang defaults to "forever" (only a deadline interrupts it);
            # net_hang to 500 ms (a stall a request timeout should absorb)
            param = 500.0 if kind == "net_hang" else 3600.0
        out.append(Injection(site=site, kind=kind, when=when, param=param))
    return tuple(out)


class ChaosPlan:
    """An installed injection schedule with per-site call counters."""

    def __init__(self, injections: tuple[Injection, ...]):
        self.injections = injections
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def call_count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def on_call(self, site: str) -> None:
        """Record one guarded call at ``site`` and apply any matching
        injection (first match wins)."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
        for inj in self.injections:
            if not inj.matches(site, count):
                continue
            if inj.kind == "device_lost":
                # Fires only while the target device is still believed
                # healthy: once a rung acknowledges the loss
                # (resilience/elastic.py marks it dead and the run no
                # longer schedules onto it), the call succeeds again.
                # Lazy import: elastic imports this module at load time.
                from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import (
                    elastic,
                )

                dev = int(inj.param)
                if elastic.health().is_lost(dev):
                    continue
                obs.emit("chaos", site=site, fault=inj.kind, call=count,
                         device=dev)
                obs.counter("chaos_injections")
                raise DeviceLostError(
                    f"chaos: device {dev} lost at {site} call #{count}",
                    device=dev,
                )
            # published BEFORE the fault takes effect: the injection must be
            # on record even when it hangs or kills the run it fires in
            obs.emit("chaos", site=site, fault=inj.kind, call=count)
            obs.counter("chaos_injections")
            if inj.kind == "hang":
                time.sleep(inj.param)
                return
            if inj.kind == "net_hang":
                time.sleep(inj.param / 1000.0)
                return
            if inj.kind == "proc_kill":
                os.kill(os.getpid(), signal.SIGKILL)
                # unreachable in a real run; during tests os.kill may be
                # monkeypatched to observe the schedule without dying
                return
            if inj.kind == "net_partition":
                raise PartitionError(
                    f"chaos: partition at {site} call #{count}"
                )
            if inj.kind == "lost":
                raise DeviceLostError(
                    f"chaos: device lost at {site} call #{count}"
                )
            raise ChaosError(f"chaos: transient failure at {site} call #{count}")


# The active plan: an explicit inject() context overrides the env plan.
_lock = threading.Lock()
_installed: ChaosPlan | None = None
_env_cache: tuple[str | None, ChaosPlan | None] = (None, None)


def active() -> ChaosPlan | None:
    """The currently active plan: an :func:`inject` context if one is
    installed, else a (cached) plan parsed from ``GRAFT_CHAOS``."""
    global _env_cache
    with _lock:
        if _installed is not None:
            return _installed
        spec = os.environ.get("GRAFT_CHAOS") or None
        if spec != _env_cache[0]:
            plan = ChaosPlan(parse_plan(spec)) if spec else None
            _env_cache = (spec, plan)
        return _env_cache[1]


def on_call(site: str) -> None:
    """Hook for the executor: count this guarded call and maybe inject."""
    plan = active()
    if plan is not None:
        plan.on_call(site)


class inject:
    """Context manager installing a chaos plan for the enclosed block,
    overriding any GRAFT_CHAOS env plan.  Returns the plan so tests can
    read call counters afterwards."""

    def __init__(self, spec: str):
        self.plan = ChaosPlan(parse_plan(spec))
        self._prev: ChaosPlan | None = None

    def __enter__(self) -> ChaosPlan:
        global _installed
        with _lock:
            self._prev = _installed
            _installed = self.plan
        return self.plan

    def __exit__(self, *exc: object) -> None:
        global _installed
        with _lock:
            _installed = self._prev
