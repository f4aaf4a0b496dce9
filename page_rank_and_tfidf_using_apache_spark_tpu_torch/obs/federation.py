"""Fleet metrics federation: one observability plane over N replica
processes.

A copy of the JAX package's ``obs/federation.py`` (stdlib), so the port
never imports that package.  There each scrape is one guarded attempt of
its resilience executor; the port has no executor yet, so here a scrape is
a plain call bounded by the HTTP timeout, and a failed one is a stale
replica all the same.

Reference counterpart: Spark's metrics system — executors report to
one central sink, and both the UI and dynamic allocation read
the *aggregate*, not per-executor boards.  A serving fabric's replicas
each keep a :class:`obs.metrics.MetricsHub` behind their own exporter;
this module closes the gap:

- :class:`FleetHub` scrapes each registered replica's existing
  ``/snapshot.json`` on a background scraper thread (``fed-scraper``),
  one attempt a scrape, so partitions and hangs surface as
  ``fed_scrape_error`` events on this thread — never as backpressure on
  routing.
- Replica state merges *exactly*: the scrape reads the ``mergeable``
  section every hub snapshot now embeds and folds it into a fresh fleet
  :class:`MetricsHub` per read (counts/sums/min/max byte-exact vs a hub
  fed the union stream; quantiles within one bin).
- A replica that stops answering is marked **stale** — its age since
  the last good scrape is tracked, exported in the fleet snapshot and
  as a ``replica=``-labeled gauge — and its last-known state stays in
  the aggregate.  Partitioned replicas are never silently dropped, and
  the scraper never blocks the router's query path.

:class:`FleetHub` duck-types the hub surface :class:`obs.export.MetricsExporter`
serves (``snapshot()`` / ``prometheus()``), so the router publishes the
fleet board from its own ``/snapshot.json`` + ``/metrics`` with one
exporter and zero new endpoint code; ``/metrics`` carries per-replica
breakdown rows beside the fleet aggregate.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from typing import Any, Callable

from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import runtime as _rt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import MetricsHub

_DEFAULT_SCRAPE_S = 1.0


def scrape_period_from_env() -> float:
    """The GRAFT_FED_SCRAPE_S knob: seconds between fleet scrapes
    (default 1.0).  Not in ``utils/config.GRAFT_ENV_KNOBS`` while no entry
    point of the port builds a :class:`FleetHub`."""
    raw = os.environ.get("GRAFT_FED_SCRAPE_S")
    if raw is None or raw.strip() == "":
        return _DEFAULT_SCRAPE_S
    return float(raw)


def _prom_name(raw: str) -> str:
    return "graft_" + "".join(
        c if (c.isalnum() or c == "_") else "_" for c in raw
    )


class FleetHub:
    """Scrape-and-merge federation over replica metrics endpoints.

    ``register(replica, url)`` / ``deregister(replica)`` track the live
    fleet (the fabric calls these as replicas spawn and drain); the
    scraper thread pulls each target's ``/snapshot.json`` every
    ``scrape_s`` seconds.  ``snapshot()`` rebuilds a fresh fleet
    :class:`MetricsHub` from the latest per-replica mergeables on every
    read — re-merging fresh scrapes instead of accumulating into a
    long-lived hub is what keeps the merge one-shot-exact (no
    double-counting across scrape cycles)."""

    def __init__(self, *, window_s: float = 60.0, slots: int = 30,
                 latency_slo_s: float | None = None,
                 availability_target: float | None = None,
                 scrape_s: float | None = None,
                 stale_after_s: float | None = None,
                 timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 fetch: Callable[[str], dict[str, Any]] | None = None):
        self.window_s = float(window_s)
        self.slots = int(slots)
        self.latency_slo_s = latency_slo_s
        self.availability_target = availability_target
        self.scrape_s = float(scrape_s if scrape_s is not None
                              else scrape_period_from_env())
        # stale = three missed scrape periods by default: one lost scrape
        # is jitter, three is a partition.
        self.stale_after_s = float(stale_after_s if stale_after_s is not None
                                   else 3.0 * self.scrape_s)
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._fetch = fetch or self._http_fetch
        self._lock = threading.Lock()
        self._targets: dict[str, str] = {}
        self._mergeables: dict[str, dict[str, Any]] = {}
        self._replica_snaps: dict[str, dict[str, Any]] = {}
        self._first_seen: dict[str, float] = {}
        self._last_ok: dict[str, float] = {}
        self._scrapes = 0
        self._scrape_errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ membership

    def register(self, replica: str, url: str) -> None:
        with self._lock:
            self._targets[str(replica)] = url.rstrip("/")
            self._first_seen.setdefault(str(replica), self._clock())

    def deregister(self, replica: str) -> None:
        """Remove a drained replica from the fleet: its contribution
        leaves the aggregate with it (a *partitioned* replica, by
        contrast, stays registered and is labeled stale)."""
        r = str(replica)
        with self._lock:
            for d in (self._targets, self._mergeables, self._replica_snaps,
                      self._first_seen, self._last_ok):
                d.pop(r, None)

    def replicas(self) -> list[str]:
        with self._lock:
            return sorted(self._targets)

    # -------------------------------------------------------------- scraping

    def _http_fetch(self, url: str) -> dict[str, Any]:
        with urllib.request.urlopen(f"{url}/snapshot.json",
                                    timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def scrape_once(self) -> dict[str, bool]:
        """One scrape sweep over the current fleet; returns per-replica
        success.  Each target is one attempt bounded by the HTTP
        timeout — a hung endpoint costs this thread at most the
        timeout and the replica an increased staleness age, never a
        routing stall."""
        with self._lock:
            targets = dict(self._targets)
        ok: dict[str, bool] = {}
        for replica, url in sorted(targets.items()):
            self._scrapes += 1
            try:
                snap = self._fetch(url)
                mergeable = snap.get("mergeable")
                if not isinstance(mergeable, dict):
                    raise ValueError("snapshot has no mergeable section")
            except Exception as exc:  # noqa: BLE001 — any fault = stale, loop on
                self._scrape_errors += 1
                _rt.emit("fed_scrape_error", replica=replica,
                         error=f"{type(exc).__name__}: {exc}"[:200])
                ok[replica] = False
                continue
            with self._lock:
                if replica in self._targets:  # lost a churn race: drop it
                    self._mergeables[replica] = mergeable
                    self._replica_snaps[replica] = snap
                    self._last_ok[replica] = self._clock()
            ok[replica] = True
        return ok

    def _scrape_loop(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.scrape_s)

    def start(self) -> "FleetHub":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._scrape_loop, name="fed-scraper", daemon=True)
            self._thread.start()
            _rt.emit("fed_start", scrape_s=self.scrape_s,
                     stale_after_s=self.stale_after_s)
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "FleetHub":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    # ------------------------------------------------------------- staleness

    def staleness(self) -> dict[str, float]:
        """Seconds since each registered replica's last good scrape (age
        since registration while it has never answered)."""
        now = self._clock()
        with self._lock:
            return {
                r: now - self._last_ok.get(r, self._first_seen.get(r, now))
                for r in self._targets
            }

    # ----------------------------------------------------- the fleet board

    def _merged_hub(self) -> tuple[MetricsHub, dict[str, str]]:
        """A fresh hub holding the exact fold of every replica's latest
        mergeable.  Per-replica merge failures (layout drift from a
        mixed-version fleet) are recorded, not raised — one bad replica
        must not take down the router's snapshot endpoint."""
        with self._lock:
            members = sorted(self._targets)
            mergeables = {r: self._mergeables.get(r) for r in members}
        hub = MetricsHub(window_s=self.window_s, slots=self.slots,
                         latency_slo_s=self.latency_slo_s,
                         availability_target=self.availability_target,
                         clock=self._clock)
        errors: dict[str, str] = {}
        for r in members:
            m = mergeables.get(r)
            if m is None:
                continue  # registered but never scraped: stale, zero data
            try:
                hub.merge_mergeable(m)
            except Exception as exc:  # noqa: BLE001 — recorded, never fatal
                errors[r] = f"{type(exc).__name__}: {exc}"[:200]
        return hub, errors

    def snapshot(self) -> dict[str, Any]:
        """The fleet snapshot the router's ``/snapshot.json`` serves: a
        full merged-hub snapshot plus a ``fleet`` section with
        membership, per-replica staleness ages, the stale set, and a
        per-replica board (latency/requests/errors) for breakdown rows."""
        hub, merge_errors = self._merged_hub()
        ages = self.staleness()
        stale = sorted(r for r, age in ages.items()
                       if age > self.stale_after_s)
        hub.gauge("fed_replicas", float(len(ages)))
        hub.gauge("fed_stale_replicas", float(len(stale)))
        hub.gauge("fed_staleness_s_max",
                  round(max(ages.values()), 3) if ages else 0.0)
        snap = hub.snapshot()
        with self._lock:
            replica_snaps = dict(self._replica_snaps)
        per_replica: dict[str, Any] = {}
        for r in sorted(ages):
            rs = replica_snaps.get(r) or {}
            win = (rs.get("latency_s") or {}).get("window") or {}
            ctr = rs.get("counters") or {}
            per_replica[r] = {
                "stale": r in stale,
                "staleness_s": round(ages[r], 3),
                "p50_s": win.get("p50"),
                "p99_s": win.get("p99"),
                "requests": (ctr.get("serve.requests") or {}).get("total", 0),
                "errors": (ctr.get("serve.errors") or {}).get("total", 0),
            }
        snap["fleet"] = {
            "replicas": sorted(ages),
            "stale": stale,
            "stale_after_s": self.stale_after_s,
            "scrape_s": self.scrape_s,
            "staleness_s": {r: round(a, 3) for r, a in sorted(ages.items())},
            "scrapes": self._scrapes,
            "scrape_errors": self._scrape_errors,
            "merge_errors": merge_errors,
            "per_replica": per_replica,
        }
        return snap

    def prometheus(self) -> str:
        """The merged hub's exposition plus ``replica=``-labeled
        breakdown rows (per-replica quantiles, counters, staleness) so
        one scrape of the router shows the fleet AND its members."""
        hub, _ = self._merged_hub()
        ages = self.staleness()
        hub.gauge("fed_replicas", float(len(ages)))
        hub.gauge("fed_staleness_s_max",
                  round(max(ages.values()), 3) if ages else 0.0)
        lines = [hub.prometheus().rstrip("\n")]
        with self._lock:
            replica_snaps = dict(self._replica_snaps)
        for r in sorted(ages):
            lines.append(
                f'graft_fed_staleness_seconds{{replica="{r}"}} '
                f"{ages[r]:.6g}"
            )
            rs = replica_snaps.get(r)
            if not rs:
                continue
            win = (rs.get("latency_s") or {}).get("window") or {}
            for q in ("p50", "p90", "p95", "p99"):
                v = win.get(q)
                if v is not None:
                    lines.append(
                        f'graft_serve_latency_seconds{{window="rolling",'
                        f'quantile="0.{q[1:]}",replica="{r}"}} {v:.6g}'
                    )
            for name, c in (rs.get("counters") or {}).items():
                lines.append(
                    f'{_prom_name(name)}_total{{replica="{r}"}} '
                    f"{float(c.get('total', 0)):.6g}"
                )
        return "\n".join(lines) + "\n"
