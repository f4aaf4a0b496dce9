"""Multi-process serving fabric: a replica fleet behind a consistent-hash
router, scaled out past one process.

Counterpart of the JAX package's ``serving/fabric.py``, with its names,
its wire format (``/query``, ``/status``, ``/cache/peek``, ``/cache/fill``,
``/peers``), its ``FABRIC_FLOOR`` file and its guarded sites; each replica
serves on the device ``FabricConfig.device`` names (``cuda`` unless the
caller asks for the CPU).  ``tests/test_torch_fabric.py`` and
``tests/test_torch_drain_cache.py`` hold it to the reference.

In-process faults are survived below this module; a fleet adds what a
single process never meets — a replica process that dies and is replaced,
Spark's driver coordinating executor *processes*.  The immutable segment
artifacts and the atomic LATEST pointer already make cross-process index
sharing free — N replica processes read the SAME segment files — so this
module adds only the coordination:

- **Replica** (``python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.fabric
  --replica INDEX_DIR [--device cuda]``): one :class:`~.server.TfidfServer`
  process that loads the live segment set onto its device, serves
  ``POST /query`` over the obs/export HTTP endpoint (the same ``/healthz``
  the router health-checks), polls the manifest and hot-swaps
  independently, and keeps an idempotent request-id cache so a
  re-dispatched query is *replayed*, never re-executed.  On a card every
  replica is its own process with its own CUDA context and its own copy
  of the postings; kernels of different replicas time-slice the card.
- **Generation floor** (:func:`commit_floor` / :func:`read_floor`): the
  fleet's committed generation, durably written next to the manifest.
  ENFORCED, not advisory: a replica whose loaded generation is below the
  floor reports ``/healthz`` 503 and refuses queries — a replica
  restarted mid-rolling-swap cannot quietly serve a pre-floor artifact
  (``tools/crash_harness.py``'s ``floor`` scenario kills the commit at its
  write boundary).
- **Router** (:class:`ServingFabric`): consistent-hash query routing
  (``ring_slots`` vnodes per replica, so the per-replica LRU becomes a
  sharded distributed cache and at most ~1/N of keys remap when a
  replica leaves), health checking, and sibling retry of a failed
  replica's in-flight queries under the SAME request id — the soak's
  dropped=0 / double_served=0 audit extends across processes.
- **Supervisor**: respawns dead replicas through the declared ``respawn``
  ladder rung (:mod:`resilience.process`) and drives rolling restarts:
  wait for the fleet to reach generation G, commit the floor at G, then
  replace one replica at a time while siblings keep serving.

The fleet shares one observability plane:

- **Fleet federation**: the router owns a :class:`obs.federation.FleetHub`
  that scrapes every replica's ``/snapshot.json`` (guarded ``fed_scrape``
  site, staleness-labeled, never routing-blocking) and serves the exact
  fleet merge from the ROUTER's own ``/snapshot.json`` + ``/metrics``
  (``tools/slo_watch.py --fleet`` renders it).
- **Membership is dynamic**: replicas live in id-keyed maps and the hash
  ring is rebuilt on membership change — :meth:`ServingFabric.scale_up`
  spawns a NEW id (survivor-owned keys never remap), and
  :meth:`ServingFabric.scale_down` drains the newest id (out of the ring
  first, then SIGTERM; in-flight queries finish or re-dispatch typed).
- **Autoscaler**: a control loop that reads ONLY the fleet hub —
  availability/latency burn rate and queue-wait p99 scale up, sustained
  idle scales down — bounded by min/max, rate-limited by a cooldown, and
  hysteretic (the scale-down thresholds sit far below the scale-up ones,
  so one noisy window cannot flap the fleet).  Every decision is
  published as an ``autoscale`` event carrying its measured inputs.

And two cooperating robustness layers:

- **Drain by handoff, not retry**: with ``FabricConfig.handoff`` (default
  on where the platform has ``SO_REUSEPORT``) every replica id owns a
  FIXED port reserved by the router, and replica listeners join an
  ``SO_REUSEPORT`` group on it.  :meth:`ServingFabric.rolling_restart`
  spawns the successor FIRST (``--ready-at-floor``: its handshake only
  prints once it serves >= the committed floor on the shared port), then
  SIGTERMs the predecessor, which stops accepting, drains its in-flight
  requests to completion (non-daemon handler threads joined on close),
  stops its server and only then exits and frees its device memory — the
  router routes around the id from just before the TERM until the
  predecessor has exited, so no router connection meets the closing
  listener, and a roll under load needs ZERO sibling retries (the
  ``roll_retries`` audit key pins this).  The suspect/retry machinery
  stays as the UNPLANNED-failure path.
- **Sharded distributed result cache**: the consistent-hash ring owner
  of an affinity key is its cache authority.  A non-owner replica that
  misses its local LRU issues a bounded-deadline ``POST /cache/peek`` to
  the owner before computing, and fills the owner back with an
  idempotent-by-rid ``POST /cache/fill`` after computing.  Every peer
  interaction sits behind a per-peer circuit breaker (trip on
  consecutive timeouts, half-open probe; ``GRAFT_CACHE_*`` knobs) and
  falls back to local compute, so a slow/partitioned/dead peer can never
  add more than the peek deadline to p99 — graceful degradation to
  local-only LRUs.  The router broadcasts the id→port map over
  ``POST /peers`` on every membership change.

Process-level chaos rides the deterministic ``GRAFT_CHAOS`` grammar:
``replica_query:proc_kill@N`` SIGKILLs a replica mid-query (injected in
THAT replica's environment via ``FabricConfig.replica_chaos``),
``replica_swap:proc_kill@1`` kills it mid-hot-swap, and
``fabric_route:net_partition@N`` / ``fabric_route:net_hang@N:ms`` fault
the router→replica hop; ``drain_handoff`` (the successor spawn of a
handoff roll), ``cache_peek`` and ``cache_fill`` (the peer cache hops —
``net_partition``/``net_hang`` model a partitioned or slow peer) complete
the set.  All sites are guarded through
``resilience.executor.attempt_once`` — one chaos-hooked attempt each;
the recovery loop (sibling retry, supervisor respawn, breaker + local
fallback) lives HERE, which is exactly what attempt_once is for.

Divergences from the reference: the replica takes ``--device`` (default
``cuda``, as ``cli/serve.py``) and ``FabricConfig.device`` passes it to
every replica it spawns; a replica resolves the tuned profile of its own
device's backend (``utils/config.load_tuned_profile``), not of the
process's default backend.  Two more divergences, both in the drain
handoff: the router routes around a rolled id for its predecessor's drain
(the reference keeps it in rotation, and the kernel resets connections
queued at a closing listener of the group: a roll under load took a
sibling retry), and a replica polls for its SIGTERM (the reference's
bare ``wait()`` can sleep through a signal that lands on another thread).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import itertools
import json
import os
import queue
import signal
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Sequence

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.federation import FleetHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import (
    MetricsHub,
    TelemetrySink,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import (
    executor as rx,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import (
    process as procs,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    backend_name,
    resolve_device,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import percentile

# Guarded chaos/retry sites of the fabric (the reference's names; the
# tests and chip_smoke.py phase 17 fault each of them):
# the router→replica hop, the replica's hot-swap, the replica's query
# execution, the handoff successor spawn, and the two peer-cache hops.
ROUTE_SITE = "fabric_route"
SWAP_SITE = "replica_swap"
QUERY_SITE = "replica_query"
DRAIN_SITE = "drain_handoff"
PEEK_SITE = "cache_peek"
FILL_SITE = "cache_fill"

# The fleet's committed generation, next to LATEST in the index dir.
FLOOR_FILE = "FABRIC_FLOOR"


def _peer_knobs() -> "tuple[float, int, float]":
    """The declared peer-cache knobs (utils/config.py GRAFT_ENV_KNOBS +
    README env-knob table): peek deadline, breaker trip count, breaker
    half-open probe period."""
    deadline = float(os.environ.get("GRAFT_CACHE_PEEK_DEADLINE_S") or 0.25)
    trip = int(os.environ.get("GRAFT_CACHE_BREAKER_TRIP") or 3)
    probe = float(os.environ.get("GRAFT_CACHE_BREAKER_PROBE_S") or 2.0)
    return deadline, trip, probe


class FabricExhausted(RuntimeError):
    """A query ran out of sibling retries — every replica was dead,
    partitioned, or below the generation floor for the whole retry
    window.  The router-side analog of ResilienceExhausted."""


# --------------------------------------------------------------- floor


def commit_floor(index_dir: str, generation: int) -> None:
    """Durably commit the fleet's generation floor: no replica may serve
    a generation below this after the write lands.  Same atomic-write
    discipline as every other artifact (stage in a same-dir tmp, fsync,
    rename) — a SIGKILL at any boundary leaves the old floor or the new
    floor, never a torn file (``tools/crash_harness.py``'s 'floor'
    kill-point scenario sweeps exactly this function)."""
    doc = {"floor": int(generation), "committed_wall": time.time()}
    path = os.path.join(index_dir, FLOOR_FILE)
    fd, tmp = tempfile.mkstemp(dir=index_dir, suffix=".floor.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        ckpt.durable_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    obs.emit("fabric_floor", floor=int(generation))


def read_floor(index_dir: str) -> int:
    """The committed generation floor; 0 when none was ever committed
    (every generation is servable)."""
    try:
        with open(os.path.join(index_dir, FLOOR_FILE)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return 0
    return int(doc.get("floor", 0))


# --------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Fleet shape + routing/retry/respawn policy."""

    replicas: int = 2
    ring_slots: int = 64  # vnodes per replica on the hash ring
    top_k: int = 10
    max_batch: int | None = None  # None: replica resolves its own ladder
    scoring: str = "coo"
    poll_s: float = 0.3  # replica manifest/floor poll period
    health_period_s: float = 0.5  # router health-check + stats-fold period
    request_timeout_s: float = 10.0  # one router→replica HTTP attempt
    retry_limit: int = 40  # sibling re-dispatch attempts per query
    retry_pause_s: float = 0.25  # pause between re-dispatches (lets the
    # supervisor respawn a dead replica inside the retry window)
    ready_timeout_s: float = 120.0  # replica spawn→handshake deadline
    grace_s: float = 15.0  # rolling restart: SIGTERM→SIGKILL deadline
    respawn: bool = True  # supervisor replaces dead replicas
    replica_chaos: tuple = ()  # ((replica_idx, GRAFT_CHAOS spec), ...):
    # targeted replica-side injection — the spec lands in THAT replica's
    # environment only, so a proc_kill schedule is per-process-deterministic
    federation: bool = True  # router-side FleetHub + fleet exporter
    fleet_window_s: float = 60.0  # fleet hub window (MUST match the
    # replicas' default hub window — merge raises on mismatch)
    latency_slo_s: float | None = None  # fleet latency budget (None: off)
    availability_target: float | None = None  # fleet availability budget
    handoff: bool = True  # rolling restarts drain by SO_REUSEPORT socket
    # handoff (successor first on the SAME port, predecessor drains) —
    # zero roll-attributed retries; auto-off where the platform lacks
    # SO_REUSEPORT, falling back to the retry-carried roll
    peer_cache: bool = True  # owner-routed sharded result cache: the
    # router pushes the id→port map (POST /peers) so replicas peek the
    # ring owner before computing and fill it back after; off = the
    # local-only LRUs
    device: str = DEFAULT_DEVICE  # every replica's torch device (--device):
    # cuda unless the caller asks for the CPU; a replica that cannot reach
    # it fails its handshake
    cache_size: int | None = None  # per-replica result-LRU size override
    # (None: the replica's ServeConfig default; a smaller one makes
    # fleet-wide duplicate computes measurable)

    @staticmethod
    def from_env(**overrides) -> "FabricConfig":
        if "replicas" not in overrides:
            raw = os.environ.get("GRAFT_FABRIC_REPLICAS")
            if raw:
                overrides["replicas"] = int(raw)
        return FabricConfig(**overrides)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Autoscaler policy: bounds, cadence, and the up/down thresholds.

    Hysteresis is structural: scaling UP needs acute pressure (budget
    burn >= ``burn_up`` — budget consumed at twice the sustainable rate —
    or queue-wait p99 over ``queue_p99_up_s``), while scaling DOWN needs
    the opposite extreme *sustained* (offered rate under
    ``idle_rate_down`` AND burn under ``burn_down`` for ``idle_hold_s``
    straight).  The dead band between them plus the cooldown is what the
    flap count stays low on."""

    min_replicas: int = 1
    max_replicas: int = 4
    cooldown_s: float = 10.0  # min seconds between scale actions
    period_s: float = 1.0  # control-loop evaluation cadence
    burn_up: float = 2.0  # any budget burning >= 2x its rate: scale up
    queue_p99_up_s: float = 0.5  # queue-wait p99 over this: scale up
    burn_down: float = 0.5  # burn must be under this to call the fleet idle
    idle_rate_down: float = 0.5  # req/s under this counts as idle
    idle_hold_s: float = 5.0  # idle must hold this long before scale-down

    @staticmethod
    def from_env(**overrides) -> "AutoscaleConfig":
        env = {
            "min_replicas": os.environ.get("GRAFT_AUTOSCALE_MIN"),
            "max_replicas": os.environ.get("GRAFT_AUTOSCALE_MAX"),
            "cooldown_s": os.environ.get("GRAFT_AUTOSCALE_COOLDOWN_S"),
        }
        for key, raw in env.items():
            if raw and key not in overrides:
                overrides[key] = float(raw) if key.endswith("_s") else int(raw)
        return AutoscaleConfig(**overrides)


# --------------------------------------------------------------- ring


def _h(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class _Ring:
    """Consistent-hash ring: ``slots`` vnodes per replica.  A replica
    leaving removes only ITS vnodes — keys owned by survivors keep their
    owner (the ≤1/N remap property the stability test pins)."""

    def __init__(self, replica_ids: Sequence[int], slots: int):
        points: list[tuple[int, int]] = []
        for rid in replica_ids:
            for s in range(slots):
                points.append((_h(f"replica-{rid}#{s}"), rid))
        points.sort()
        self._points = points

    def route(self, key: str, *, exclude: "set[int] | None" = None) -> list[int]:
        """Replica preference order for ``key``: clockwise walk from the
        key's ring position, first occurrence of each replica; excluded
        (suspect) replicas move to the back rather than vanishing — with
        every replica suspect the caller still gets a candidate."""
        if not self._points:
            return []
        hv = _h(key)
        lo, hi = 0, len(self._points)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._points[mid][0] < hv:
                lo = mid + 1
            else:
                hi = mid
        order: list[int] = []
        for i in range(len(self._points)):
            rid = self._points[(lo + i) % len(self._points)][1]
            if rid not in order:
                order.append(rid)
        if exclude:
            order = ([r for r in order if r not in exclude]
                     + [r for r in order if r in exclude])
        return order


def affinity_key(terms: Sequence[str], ranker: str) -> str:
    """The routing key: canonicalized like the server's result-cache key
    (ranker + sorted unique terms), so the SAME logical query always
    lands on the SAME replica and the per-replica LRU shards cleanly."""
    return ranker + "|" + " ".join(sorted(set(terms)))


# --------------------------------------------------------------- breaker


class _Breaker:
    """Per-peer circuit breaker for the cache peek/fill hops (state is
    guarded by the owning replica's ``_peer_lock``; this class holds no
    lock of its own).

    closed → (``trip`` consecutive failures) → open → (``probe_s``
    elapsed) → half_open: exactly ONE probe flies, success closes,
    failure re-opens and re-arms the probe timer.  While open (or while
    the half-open probe is outstanding) ``allow`` answers False and the
    caller computes locally — a dead peer costs nothing per request."""

    def __init__(self, trip: int, probe_s: float):
        self.trip = max(1, int(trip))
        self.probe_s = float(probe_s)
        self.failures = 0
        self.state = "closed"
        self.opened_t = 0.0

    def allow(self, now: float) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open" and now - self.opened_t >= self.probe_s:
            self.state = "half_open"  # this caller IS the probe
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.trip:
            self.state = "open"
            self.opened_t = now


# --------------------------------------------------------------- replica


def _percentiles_ms(lat: "collections.deque[float]") -> tuple[Any, Any]:
    if not lat:
        return None, None
    xs = sorted(lat)
    return (round(percentile(xs, 0.50) * 1e3, 3),
            round(percentile(xs, 0.99) * 1e3, 3))


class _Replica:
    """The replica-process runtime: one TfidfServer + the floor-enforcing
    poll loop + the idempotent query surface."""

    def __init__(self, index_dir: str, *, replica_id: int, top_k: int,
                 max_batch: int | None, scoring: str, poll_s: float,
                 rid_cache: int = 4096, cache_size: "int | None" = None,
                 device: "str | None" = None):
        self.index_dir = index_dir
        # the server's device, resolved up front: a replica asked for a
        # card it cannot reach raises here, before its handshake
        self.device = resolve_device(device)
        self.replica_id = replica_id
        self.top_k = top_k
        self.max_batch = max_batch
        self.scoring = scoring
        self.poll_s = poll_s
        self.cache_size = cache_size
        self.srv = None  # TfidfServer once a servable generation loaded
        self.generation: int | None = None
        self.floor = read_floor(index_dir)
        # rid → cached response body: a re-dispatched request id replays
        # the SAME bytes instead of re-executing (the cross-process
        # double-serve guard); capped LRU
        self._rid_cache: collections.OrderedDict[str, tuple] = (
            collections.OrderedDict()
        )
        self._rid_cap = rid_cache
        self._lock = threading.Lock()  # floor/generation/rid-cache/latencies
        self._lat: collections.deque = collections.deque(maxlen=512)
        self._executions = 0
        self._replays = 0
        # Sharded-cache peer state, all under its OWN lock so
        # peer bookkeeping never contends with the serving hot path:
        # id→port map + authority ring pushed by the router (POST
        # /peers), one circuit breaker per peer, and the peer tallies.
        self._peer_lock = threading.Lock()
        self._peers: dict[int, int] = {}
        self._peer_ring: "_Ring | None" = None
        self._breakers: dict[int, _Breaker] = {}
        self._peer_stats: collections.Counter = collections.Counter()
        (self._peek_deadline_s, self._breaker_trip,
         self._breaker_probe_s) = _peer_knobs()
        # write-backs to the owner are asynchronous and best-effort: a
        # bounded queue drained by fabric-peer-fill; full = drop (the
        # owner just stays cold for that key)
        self._fill_q: "queue.Queue" = queue.Queue(maxsize=256)
        self._fill_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "_Replica":
        self._try_load()  # may come up unready (below floor / no manifest)
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="fabric-replica-poll", daemon=True
        )
        self._poll_thread.start()
        self._fill_thread = threading.Thread(
            target=self._fill_loop, name="fabric-peer-fill", daemon=True
        )
        self._fill_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._fill_q.put_nowait(None)  # fill-loop shutdown sentinel
        except queue.Full:
            pass  # daemon thread; pending fills are best-effort anyway
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=10.0)
            self._poll_thread = None
        if self._fill_thread is not None:
            self._fill_thread.join(timeout=5.0)
            self._fill_thread = None
        if self.srv is not None:
            self.srv.stop()

    def ready(self) -> bool:
        with self._lock:
            return (self.srv is not None and self.generation is not None
                    and self.generation >= self.floor)

    # ----------------------------------------------------------- load/swap

    def _serve_config(self):
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
            ServeConfig,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
            load_tuned_profile,
            tuned_config,
        )

        kwargs: dict = dict(top_k=self.top_k, max_batch=self.max_batch,
                            scoring=self.scoring)
        if self.cache_size is not None:
            kwargs["cache_size"] = self.cache_size
        # the profile of the backend this replica computes on, not the
        # process's default: a --device cpu replica on a machine with a
        # card must not pick up the card's knobs
        return tuned_config(ServeConfig,
                            load_tuned_profile(backend_name(self.device)),
                            **kwargs)

    def _try_load(self) -> None:
        """Initial load — refused outright while the newest committed
        manifest is below the floor: a replica restarted mid-rolling-swap
        must NOT serve the pre-floor artifact it can still see on disk;
        it stays unready and keeps polling until the fleet's generation
        catches up."""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            segments as sgm,
        )
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
            TfidfServer,
        )

        version = sgm.manifest_version(self.index_dir)
        with self._lock:
            floor = self.floor
        if version is None or version < floor:
            obs.emit("fabric_refuse", replica=self.replica_id,
                     version=version, floor=floor)
            return
        segset = sgm.load_segment_set(self.index_dir, mmap=True)
        srv = TfidfServer(segset, self._serve_config(),
                          device=self.device).start()
        with self._lock:
            self.srv = srv
            self.generation = segset.version

    def _poll_loop(self) -> None:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            segments as sgm,
        )

        while not self._stop.wait(self.poll_s):
            floor = read_floor(self.index_dir)
            with self._lock:
                if floor > self.floor:
                    self.floor = floor
                gen = self.generation
            if self.srv is None:
                try:
                    self._try_load()
                except Exception as exc:  # noqa: BLE001 — keep polling
                    obs.emit("fabric_load_error", replica=self.replica_id,
                             error=f"{type(exc).__name__}: {exc}"[:200])
                continue
            version = sgm.manifest_version(self.index_dir)
            if version is None or gen is None or version <= gen:
                continue
            try:
                # ONE chaos-hooked swap attempt (proc_kill here is the
                # kill-during-hot-swap scenario); a failed swap keeps the
                # old generation live and the next tick retries
                segset = rx.attempt_once(
                    lambda: sgm.load_segment_set(self.index_dir, mmap=True),
                    site=SWAP_SITE,
                )
                self.srv.refresh_segments(segset)
                with self._lock:
                    self.generation = segset.version
                obs.emit("fabric_swap", replica=self.replica_id,
                         generation=segset.version, floor=floor)
            except Exception as exc:  # noqa: BLE001 — swap again next tick
                obs.emit("fabric_swap_error", replica=self.replica_id,
                         error=f"{type(exc).__name__}: {exc}"[:200])

    # ------------------------------------------------------ sharded cache

    def _cache_owner(self, terms, ranker: str) -> "int | None":
        """The ring authority for this query's affinity key, or None when
        no peer topology has been pushed (single replica / peer cache
        off) — the caller then behaves exactly like a local-only LRU."""
        key = affinity_key(terms, ranker)
        with self._peer_lock:
            ring = self._peer_ring
            if ring is None:
                return None
            route = ring.route(key)
        return route[0] if route else None

    def _peer_post(self, port: int, path: str, doc: dict,
                   timeout: float) -> dict:
        """Blocking JSON POST to a sibling replica on localhost.  Lives
        outside the reader methods so their wire contract stays exactly
        one request-shaped dict literal each."""
        data = json.dumps(doc).encode("utf-8")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data, method="POST")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=timeout) as fh:
            return json.loads(fh.read().decode("utf-8"))

    def _breaker_for(self, owner: int) -> "_Breaker | None":
        with self._peer_lock:
            br = self._breakers.get(owner)
            if br is None:
                return None
            before = br.state
            allowed = br.allow(time.monotonic())
            if br.state != before:
                self._emit_breaker(owner, before, br.state)
            return br if allowed else None

    def _emit_breaker(self, owner: int, old: str, new: str) -> None:
        """Caller holds ``_peer_lock``."""
        self._peer_stats["breaker_transitions"] += 1
        if new == "open":
            self._peer_stats["breaker_trips"] += 1
        obs.counter("cache_breaker_transitions")
        obs.emit("cache_breaker", replica=self.replica_id, peer=owner,
                 old=old, new=new)

    def _record_peer_outcome(self, owner: int, *, ok: bool) -> None:
        with self._peer_lock:
            br = self._breakers.get(owner)
            if br is None:
                return
            before = br.state
            if ok:
                br.record_success()
            else:
                br.record_failure(time.monotonic())
            if br.state != before:
                self._emit_breaker(owner, before, br.state)

    def _peek_owner(self, owner: int, terms, ranker: str):
        """Bounded-deadline cache peek at the ring authority.

        The HTTP round-trip runs on a disposable worker thread joined for
        at most the peek deadline: a hung/partitioned peer (chaos
        ``net_hang``) costs this request exactly the deadline, never
        more, and the abandoned daemon worker is reaped when its socket
        timeout fires.  Any failure → breaker bookkeeping + None (caller
        computes locally — graceful degradation to a local-only LRU)."""
        if self._breaker_for(owner) is None:
            with self._peer_lock:
                self._peer_stats["peeks_skipped_open"] += 1
            return None
        with self._peer_lock:
            port = self._peers.get(owner)
        if port is None:
            return None
        doc = {"terms": list(terms), "ranker": ranker}
        cell: list = []

        def _worker() -> None:
            try:
                rx.attempt_once(
                    lambda: cell.append(
                        self._peer_post(port, "/cache/peek", doc,
                                        self._peek_deadline_s)),
                    site=PEEK_SITE,
                )
            except Exception as exc:  # noqa: BLE001 — captured for outcome
                cell.append(exc)

        t0 = time.perf_counter()
        worker = threading.Thread(target=_worker, name="fabric-peer-peek",
                                  daemon=True)
        worker.start()
        worker.join(self._peek_deadline_s)
        obs.histogram("cache_peek_s", time.perf_counter() - t0)
        out = cell[0] if cell else None
        if out is None or isinstance(out, Exception):
            # timeout, refused connection, chaos net_partition/net_hang —
            # all count against the peer's breaker
            obs.counter("cache_peek_timeouts")
            with self._peer_lock:
                self._peer_stats["peek_timeouts"] += 1
            self._record_peer_outcome(owner, ok=False)
            return None
        self._record_peer_outcome(owner, ok=True)
        with self._lock:
            gen = self.generation
        if out.get("hit") and out.get("generation") == gen:
            obs.counter("cache_peer_hits")
            with self._peer_lock:
                self._peer_stats["peer_hits"] += 1
            return ([float(s) for s in out["scores"]],
                    [int(d) for d in out["docs"]])
        obs.counter("cache_peer_misses")
        with self._peer_lock:
            self._peer_stats["peer_misses"] += 1
        return None

    def _enqueue_fill(self, owner: int, rid: str, terms, ranker: str,
                      scores, docs) -> None:
        with self._lock:
            gen = self.generation
        try:
            self._fill_q.put_nowait(
                (owner, rid, list(terms), ranker, scores, docs, gen))
        except queue.Full:
            with self._peer_lock:
                self._peer_stats["fills_dropped"] += 1

    def _fill_loop(self) -> None:
        while True:
            item = self._fill_q.get()
            if item is None or self._stop.is_set():
                return
            try:
                self._fill_owner(*item)
            except Exception:  # noqa: BLE001 — fills are best-effort
                obs.counter("cache_fill_errors")
                with self._peer_lock:
                    self._peer_stats["fill_errors"] += 1

    def _fill_owner(self, owner: int, rid: str, terms, ranker: str,
                    scores, docs, generation) -> None:
        """One asynchronous owner write-back (idempotent by rid)."""
        if self._breaker_for(owner) is None:
            with self._peer_lock:
                self._peer_stats["fills_skipped_open"] += 1
            return
        with self._peer_lock:
            port = self._peers.get(owner)
        if port is None:
            return
        doc = {"rid": rid, "terms": terms, "ranker": ranker,
               "scores": scores, "docs": docs, "generation": generation}
        try:
            resp = rx.attempt_once(
                lambda: self._peer_post(port, "/cache/fill", doc,
                                        self._peek_deadline_s),
                site=FILL_SITE,
            )
        except urllib.error.HTTPError:
            # typed rejection (e.g. 503 below-floor): the peer answered —
            # breaker stays healthy, the owner just stays cold
            self._record_peer_outcome(owner, ok=True)
            return
        except Exception:  # noqa: BLE001 — timeout/partition
            obs.counter("cache_fill_errors")
            with self._peer_lock:
                self._peer_stats["fill_errors"] += 1
            self._record_peer_outcome(owner, ok=False)
            return
        self._record_peer_outcome(owner, ok=True)
        if resp.get("stored"):
            obs.counter("cache_fills")
            with self._peer_lock:
                self._peer_stats["fills"] += 1

    def configure_peers(self, peers: "dict[int, int]", *,
                        slots: int = 64) -> None:
        """Install the fleet topology pushed by the router: id→port map
        and the cache-authority ring (all replica ids, self included, so
        every member routes a key to the SAME owner).  Existing breaker
        state survives a push — a roll must not reset trip history."""
        others = {i: p for i, p in peers.items() if i != self.replica_id}
        ids = sorted(set(peers) | {self.replica_id})
        with self._peer_lock:
            self._peers = others
            self._peer_ring = _Ring(ids, slots=slots) if len(ids) > 1 else None
            self._breakers = {
                i: self._breakers.get(i)
                or _Breaker(self._breaker_trip, self._breaker_probe_s)
                for i in others
            }
        obs.emit("cache_peers", replica=self.replica_id,
                 peers=sorted(others), slots=slots)

    # ----------------------------------------------------------- HTTP API

    def handle_query(self, body: bytes) -> tuple[int, str, str]:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
            ServerShutdown,
        )

        try:
            req = json.loads(body.decode("utf-8"))
            rid = str(req["rid"])
            terms = [str(t) for t in req["terms"]]
            ranker = str(req.get("ranker", "tfidf"))
        except (ValueError, KeyError, UnicodeDecodeError,
                TypeError, AttributeError) as exc:
            # TypeError/AttributeError: syntactically valid JSON of the
            # wrong SHAPE ([], null, a bare string) — a malformed message
            # must get a typed 400, never crash into the dispatcher's 500
            return (400, "application/json",
                    json.dumps({"error": f"bad request: {exc}"}))
        with self._lock:
            cached = self._rid_cache.get(rid)
            if cached is not None:
                self._rid_cache.move_to_end(rid)
                self._replays += 1
        if cached is not None:
            return cached  # idempotent replay: same bytes, no re-execution
        if not self.ready():
            with self._lock:
                gen, floor = self.generation, self.floor
            return (503, "application/json",
                    json.dumps({"error": "replica below generation floor",
                                "generation": gen, "floor": floor}))
        t0 = time.perf_counter()
        # Sharded-cache fast path: when another replica is the
        # ring authority for this key, consult the local LRU, then peek
        # the owner under a bounded deadline — and only then compute.
        # Every branch serves the SAME values (JSON round-trip exact), so
        # local hit / peer hit / fallback compute are byte-equal.
        owner = self._cache_owner(terms, ranker)
        served: "tuple[list, list] | None" = None
        if owner is not None and owner != self.replica_id:
            try:
                local = self.srv.cache_lookup(terms, ranker=ranker)
            except Exception:  # noqa: BLE001 — lookup is best-effort
                local = None
            if local is not None:
                served = ([float(s) for s in local[0]],
                          [int(d) for d in local[1]])
                with self._peer_lock:
                    self._peer_stats["nonowner_local_hits"] += 1
            else:
                served = self._peek_owner(owner, terms, ranker)
        if served is None:
            try:
                # ONE chaos-hooked execution (proc_kill here is the
                # replica-SIGKILL-mid-query scenario; the router's sibling
                # retry owns recovery)
                scores, docs = rx.attempt_once(
                    lambda: self.srv.query(terms, ranker=ranker),
                    site=QUERY_SITE,
                )
            except ServerShutdown as exc:
                return (503, "application/json",
                        json.dumps({"error": f"shutdown: {exc}"}))
            except ValueError as exc:  # unknown ranker / no BM25 weights
                return (400, "application/json",
                        json.dumps({"error": str(exc)}))
            served = ([float(s) for s in scores], [int(d) for d in docs])
            if owner is not None and owner != self.replica_id:
                # fill the authority back asynchronously (idempotent by
                # rid — a router re-dispatch fills once)
                self._enqueue_fill(owner, rid, terms, ranker,
                                   served[0], served[1])
        with self._lock:
            gen = self.generation
        resp = (200, "application/json", json.dumps({
            "rid": rid,
            "replica": self.replica_id,
            "generation": gen,
            "scores": served[0],
            "docs": served[1],
        }))
        with self._lock:
            self._executions += 1
            self._lat.append(time.perf_counter() - t0)
            self._rid_cache[rid] = resp
            while len(self._rid_cache) > self._rid_cap:
                self._rid_cache.popitem(last=False)
        return resp

    def handle_status(self, body: bytes) -> tuple[int, str, str]:
        with self._lock:
            gen, floor = self.generation, self.floor
            executions, replays = self._executions, self._replays
            p50, p99 = _percentiles_ms(self._lat)
        with self._peer_lock:
            peer = dict(self._peer_stats)
            breaker_open = sum(
                1 for b in self._breakers.values() if b.state != "closed")
        stats = dict(self.srv.stats()) if self.srv is not None else {}
        return (200, "application/json", json.dumps({
            "replica": self.replica_id,
            "pid": os.getpid(),
            "ready": self.ready(),
            "generation": gen,
            "floor": floor,
            "executions": executions,
            "replays": replays,
            "p50_ms": p50,
            "p99_ms": p99,
            "requests": int(stats.get("requests", 0)),
            "cache_hits": int(stats.get("cache_hits", 0)),
            "refreshes": int(stats.get("refreshes", 0)),
            "peer_hits": int(peer.get("peer_hits", 0)),
            "peer_misses": int(peer.get("peer_misses", 0)),
            "peek_timeouts": int(peer.get("peek_timeouts", 0)),
            "fills": int(peer.get("fills", 0)),
            "breaker_open": breaker_open,
            "peer_stores": int(stats.get("peer_stores", 0)),
        }))

    def handle_cache_peek(self, body: bytes) -> tuple[int, str, str]:
        """``POST /cache/peek`` — the cache-authority read path.  A pure
        lookup: a miss is a successful 200 with ``hit: false`` (the
        peeker falls back to computing), never an error; no side effects,
        so no rid and no idempotency machinery."""
        try:
            req = json.loads(body.decode("utf-8"))
            terms = [str(t) for t in req["terms"]]
            ranker = str(req.get("ranker", "tfidf"))
        except (ValueError, KeyError, UnicodeDecodeError,
                TypeError, AttributeError) as exc:
            return (400, "application/json",
                    json.dumps({"error": f"bad request: {exc}"}))
        with self._lock:
            gen = self.generation
        hit = None
        if self.srv is not None and self.ready():
            try:
                hit = self.srv.cache_lookup(terms, ranker=ranker)
            except Exception:  # noqa: BLE001 — lookup is best-effort
                hit = None
        if hit is None:
            return (200, "application/json",
                    json.dumps({"hit": False, "generation": gen}))
        return (200, "application/json", json.dumps({
            "hit": True,
            "generation": gen,
            "scores": [float(s) for s in hit[0]],
            "docs": [int(d) for d in hit[1]],
        }))

    def handle_cache_fill(self, body: bytes) -> tuple[int, str, str]:
        """``POST /cache/fill`` — the cache-authority write-back,
        idempotent by rid (a router re-dispatch of the originating query
        re-fills at most once: the replayed rid returns the SAME bytes
        without touching the cache again)."""
        try:
            req = json.loads(body.decode("utf-8"))
            rid = str(req["rid"])
            terms = [str(t) for t in req["terms"]]
            scores = [float(s) for s in req["scores"]]
            docs = [int(d) for d in req["docs"]]
            gen_in = int(req["generation"])
            ranker = str(req.get("ranker", "tfidf"))
        except (ValueError, KeyError, UnicodeDecodeError,
                TypeError, AttributeError) as exc:
            return (400, "application/json",
                    json.dumps({"error": f"bad request: {exc}"}))
        fill_key = "fill:" + rid  # namespaced: never collides with /query
        with self._lock:
            cached = self._rid_cache.get(fill_key)
            if cached is not None:
                self._rid_cache.move_to_end(fill_key)
                self._replays += 1
        if cached is not None:
            return cached
        if not self.ready():
            with self._lock:
                gen, floor = self.generation, self.floor
            return (503, "application/json",
                    json.dumps({"error": "replica below generation floor",
                                "generation": gen, "floor": floor}))
        with self._lock:
            gen = self.generation
        stored = False
        if gen_in == gen:
            # only same-generation fills are authoritative: a straggler
            # fill from before a hot-swap must not resurrect stale scores
            try:
                stored = bool(self.srv.cache_insert(
                    terms, scores, docs, ranker=ranker))
            except Exception:  # noqa: BLE001 — insert is best-effort
                stored = False
        resp = (200, "application/json", json.dumps({
            "stored": stored,
            "replica": self.replica_id,
            "generation": gen,
        }))
        with self._lock:
            self._rid_cache[fill_key] = resp
            while len(self._rid_cache) > self._rid_cap:
                self._rid_cache.popitem(last=False)
        return resp

    def handle_peers(self, body: bytes) -> tuple[int, str, str]:
        """``POST /peers`` — router pushes the fleet topology (id→port)
        after every membership change; idempotent by construction."""
        try:
            req = json.loads(body.decode("utf-8"))
            peers = {int(k): int(v) for k, v in req["peers"].items()}
            slots = int(req.get("slots", 64))
        except (ValueError, KeyError, UnicodeDecodeError,
                TypeError, AttributeError) as exc:
            return (400, "application/json",
                    json.dumps({"error": f"bad request: {exc}"}))
        self.configure_peers(peers, slots=slots)
        return (200, "application/json",
                json.dumps({"ok": True, "peers": len(peers)}))


def _await_signal(stop: threading.Event) -> None:
    """Return once a signal handler on the main thread has set ``stop``.

    The kernel may hand a process-directed SIGTERM to any thread, and
    CPython runs the handler on the main thread only when that thread next
    runs bytecode: a bare ``stop.wait()`` can sleep through it until the
    router's grace ends in SIGKILL, resetting whatever the replica had in
    flight.  Polling runs the handler within 0.1 s."""
    while not stop.wait(0.1):
        pass


def replica_main(argv: "list[str] | None" = None) -> int:
    """``--replica`` process entry: serve one replica until SIGTERM.

    Prints the one-line JSON ready handshake (port, pid, generation) on
    stdout once the HTTP surface is up — possibly *unready* below the
    floor; readiness is the router's business via /healthz.  Runs under
    ``obs.run`` so the replica writes its own trace and adopts
    ``GRAFT_TRACE_PARENT`` — the fleet stitches into one trace tree."""
    p = argparse.ArgumentParser(prog="fabric-replica")
    p.add_argument("index")
    p.add_argument("--replica-id", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--scoring", choices=["coo", "impacted"], default="coo")
    p.add_argument("--poll-s", type=float, default=0.3)
    p.add_argument("--metrics-window-s", type=float, default=60.0)
    p.add_argument("--latency-slo-s", type=float, default=None)
    p.add_argument("--availability-target", type=float, default=None)
    # --reuse-port: join the SO_REUSEPORT listener group on --port AND
    # drain in-flight requests on SIGTERM — the predecessor/successor
    # sides of the zero-downtime handoff.  --ready-at-floor
    # defers the stdout handshake until ready(): the router's spawn()
    # blocks on the handshake, so a handoff successor signals "healthy"
    # through the SAME mechanism that already guards against leaked
    # children.  --cache-size bounds the server LRU.
    p.add_argument("--reuse-port", action="store_true")
    p.add_argument("--ready-at-floor", action="store_true")
    p.add_argument("--cache-size", type=int, default=None)
    # the server's torch device, as cli/serve.py: cuda unless told
    # otherwise; no fallback — a replica that cannot reach the card exits
    # before its handshake
    p.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)

    stop = threading.Event()

    def _on_sigterm(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_sigterm)

    with obs.run(f"fabric-replica{args.replica_id}"):
        rep = _Replica(args.index, replica_id=args.replica_id,
                       top_k=args.top_k, max_batch=args.max_batch,
                       scoring=args.scoring, poll_s=args.poll_s,
                       cache_size=args.cache_size,
                       device=args.device).start()
        # the replica's OWN hub, not the lazy process default: windowed
        # to the fleet's merge window and carrying the router-declared
        # SLO budgets, so what this replica exports is federable and its
        # burn rate is measured where the requests are actually served
        hub = MetricsHub(window_s=args.metrics_window_s,
                         latency_slo_s=args.latency_slo_s,
                         availability_target=args.availability_target)
        sink = TelemetrySink(hub)
        obs.bus().attach(sink)
        exporter = obs.export.MetricsExporter(
            hub, port=args.port,
            routes={("POST", "/query"): rep.handle_query,
                    ("GET", "/status"): rep.handle_status,
                    ("POST", "/cache/peek"): rep.handle_cache_peek,
                    ("POST", "/cache/fill"): rep.handle_cache_fill,
                    ("POST", "/peers"): rep.handle_peers},
            ready=rep.ready,
            reuse_port=args.reuse_port, drain=args.reuse_port,
        ).start()
        # handoff successor: hold the handshake until this process could
        # actually serve — the router treats handshake == /healthz-green
        # and only then SIGTERMs the predecessor
        while args.ready_at_floor and not rep.ready() and not stop.is_set():
            time.sleep(args.poll_s)
        print(json.dumps({"ready": True, "port": exporter.port,
                          "pid": os.getpid(),
                          "generation": rep.generation}), flush=True)
        try:
            _await_signal(stop)
        finally:
            # graceful: stop accepting (HTTP down), then drain the server
            # — with --reuse-port the exporter BLOCKS here until every
            # in-flight handler thread has answered (the predecessor side
            # of the handoff: the kernel already steers new connections
            # to the successor, so draining loses nothing); without it,
            # still-pending futures fail typed (ServerShutdown) and the
            # router re-dispatches them on a sibling
            t_drain = time.perf_counter()
            obs.emit("fabric_drain_begin", replica=args.replica_id,
                     pid=os.getpid(), handoff=bool(args.reuse_port))
            exporter.stop()
            drain_s = time.perf_counter() - t_drain
            obs.histogram("fabric_drain_s", drain_s)
            obs.emit("fabric_drain_done", replica=args.replica_id,
                     pid=os.getpid(), drain_s=round(drain_s, 6))
            rep.stop()
            obs.bus().detach(sink)
    return 0


# --------------------------------------------------------------- router


class ServingFabric:
    """Router + supervisor over N replica processes (see module doc)."""

    def __init__(self, index_dir: str, cfg: FabricConfig = FabricConfig()):
        self.index_dir = index_dir
        self.cfg = cfg
        # Membership is DYNAMIC: id-keyed maps instead of
        # fixed-size lists, so scale_up/scale_down change the fleet while
        # the ring keeps survivor-owned keys in place (a newcomer gets a
        # fresh id; the newest id drains first).
        self._handles: dict[int, procs.ProcessHandle] = {}
        self._ports: dict[int, int] = {}
        self._next_id = cfg.replicas
        self._suspect: set[int] = set()
        self._restarting: set[int] = set()
        # ids mid-drain-handoff: the supervisor must NOT respawn a
        # predecessor that dies inside the handoff window (the swap
        # would orphan the respawn — two listeners on one port), but
        # unlike _restarting the id stays in routing rotation until its
        # predecessor's listener closes
        self._handoff_ids: set[int] = set()
        # router→replica hops in flight, by id (under _lock)
        self._inflight: collections.Counter = collections.Counter()
        self._down_since: dict[int, float] = {}
        self._ring = _Ring(range(cfg.replicas), cfg.ring_slots)
        self._lock = threading.Lock()  # membership/ports/suspects/audit/stats
        self._stats: collections.Counter = collections.Counter()
        self._audit: dict[str, int] = {}  # rid -> accepted deliveries
        # Drain-handoff state: per-id "anchor" sockets — bound
        # with SO_REUSEPORT but never listening — pin each replica's port
        # across respawns and rolls so a successor can join the listener
        # group on the SAME address while the predecessor drains.
        # _roll_active > 0 while rolling_restart runs: retries taken in
        # that window are roll-attributed (the handoff acceptance gate
        # requires that count to stay 0).
        self._anchors: dict[int, socket.socket] = {}
        self._roll_active = 0
        self._rid_seq = itertools.count()
        self._rid_prefix = f"f{os.getpid()}-{int(time.time() * 1e3) & 0xFFFFFF}"
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self._sup_thread: threading.Thread | None = None
        self._started = False
        # The fleet observability plane: scrape-and-merge hub + the
        # router's own metrics endpoint (both None when federation=False).
        self.fleet: FleetHub | None = None
        self._fleet_exporter = None
        if cfg.federation:
            self.fleet = FleetHub(
                window_s=cfg.fleet_window_s,
                latency_slo_s=cfg.latency_slo_s,
                availability_target=cfg.availability_target,
            )

    # ----------------------------------------------------------- lifecycle

    def _handoff_enabled(self) -> bool:
        """Drain handoff needs SO_REUSEPORT; without it (or with
        cfg.handoff off) rolls fall back to the retry-carried path."""
        return self.cfg.handoff and obs.export.reuse_port_supported()

    def _fixed_port(self, i: int) -> int:
        """The pinned port for replica ``i``, reserved by an anchor
        socket that joins the SO_REUSEPORT group but never listens (so
        the kernel steers zero connections to it).  Created on first use,
        held until the id leaves the fleet — respawns and handoff
        successors all bind the same address."""
        with self._lock:
            anchor = self._anchors.get(i)
            if anchor is None:
                anchor = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                anchor.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
                anchor.bind(("127.0.0.1", 0))
                self._anchors[i] = anchor
            return int(anchor.getsockname()[1])

    def _close_anchor(self, i: int) -> None:
        with self._lock:
            anchor = self._anchors.pop(i, None)
        if anchor is not None:
            try:
                anchor.close()
            except OSError:
                pass

    def _replica_argv(self, i: int) -> list[str]:
        if self._handoff_enabled():
            port_args = ["--port", str(self._fixed_port(i)), "--reuse-port"]
        else:
            port_args = ["--port", "0"]
        argv = [sys.executable, "-m",
                "page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.fabric",
                "--replica", self.index_dir,
                "--replica-id", str(i),
                *port_args,
                "--top-k", str(self.cfg.top_k),
                "--scoring", self.cfg.scoring,
                "--poll-s", str(self.cfg.poll_s),
                "--device", str(self.cfg.device)]
        if self.cfg.cache_size is not None:
            argv += ["--cache-size", str(self.cfg.cache_size)]
        if self.cfg.max_batch is not None:
            argv += ["--max-batch", str(self.cfg.max_batch)]
        if self.cfg.federation:
            # the replica hub must share the fleet's merge window (the
            # mergeable wire format rejects mismatched windows) and carry
            # the SAME SLO budgets — replica-side budgets are what make
            # the federated burn rate a real measured autoscale signal
            # instead of a constant zero
            argv += ["--metrics-window-s", str(self.cfg.fleet_window_s)]
            if self.cfg.latency_slo_s is not None:
                argv += ["--latency-slo-s", str(self.cfg.latency_slo_s)]
            if self.cfg.availability_target is not None:
                argv += ["--availability-target",
                         str(self.cfg.availability_target)]
        return argv

    def _replica_env(self, i: int) -> dict[str, str]:
        env = procs.fabric_pgid_env()  # parent chaos plan never leaks in
        for idx, spec in self.cfg.replica_chaos:
            if idx == i:
                env["GRAFT_CHAOS"] = spec
        return env

    def _spawn(self, i: int, *,
               ready_at_floor: bool = False) -> procs.ProcessHandle:
        argv = self._replica_argv(i)
        if ready_at_floor:
            # handoff successor: spawn() blocking on the handshake now
            # doubles as the /healthz wait — the handshake only prints
            # once the successor would answer ready
            argv = argv + ["--ready-at-floor"]
        handle = procs.ProcessHandle(
            argv, env=self._replica_env(i),
            ready_timeout_s=self.cfg.ready_timeout_s,
        ).spawn()
        obs.emit("fabric_spawn", replica=i, pid=handle.pid,
                 port=handle.ready.get("port"),
                 generation=handle.ready.get("generation"))
        return handle

    def _push_peers(self) -> None:
        """Push the fleet topology (id→port) to every replica so each
        can route cache authority; called after every membership change.
        Best-effort: a replica that misses a push just keeps its previous
        view until the next one."""
        if not self.cfg.peer_cache:
            return
        with self._lock:
            ports = dict(self._ports)
        doc = {"peers": {str(i): p for i, p in ports.items()},
               "slots": self.cfg.ring_slots}
        for i in sorted(ports):
            try:
                self._post_json(i, "/peers", doc, 2.0)
            except Exception:  # noqa: BLE001 — replica catches next push
                with self._lock:
                    self._stats["peer_push_errors"] += 1

    def _register_with_fleet(self, i: int, port: int) -> None:
        if self.fleet is not None:
            self.fleet.register(str(i), f"http://127.0.0.1:{port}")

    def start(self) -> "ServingFabric":
        if self._started:
            return self
        obs.emit("fabric_start", replicas=self.cfg.replicas,
                 ring_slots=self.cfg.ring_slots, index_dir=self.index_dir)
        for i in range(self.cfg.replicas):
            handle = self._spawn(i)
            port = int(handle.ready["port"])
            with self._lock:
                self._handles[i] = handle
                self._ports[i] = port
            self._register_with_fleet(i, port)
        self._push_peers()
        if self.fleet is not None:
            self.fleet.start()
            self._fleet_exporter = obs.export.MetricsExporter(
                self.fleet, port=0).start()
            obs.emit("fabric_fleet_export", url=self._fleet_exporter.url,
                     replicas=len(self._handles))
        self._started = True
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fabric-health", daemon=True
        )
        self._health_thread.start()
        self._sup_thread = threading.Thread(
            target=self._supervise_loop, name="fabric-supervisor", daemon=True
        )
        self._sup_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in (self._health_thread, self._sup_thread):
            if t is not None:
                t.join(timeout=10.0)
        self._health_thread = self._sup_thread = None
        if self._fleet_exporter is not None:
            self._fleet_exporter.stop()
            self._fleet_exporter = None
        if self.fleet is not None:
            self.fleet.stop()
        with self._lock:
            handles = list(self._handles.values())
        for handle in handles:
            handle.terminate(self.cfg.grace_s)
        with self._lock:
            anchors, self._anchors = dict(self._anchors), {}
        for anchor in anchors.values():
            try:
                anchor.close()
            except OSError:
                pass
        obs.emit("fabric_stop", **self.audit())
        self._started = False

    @property
    def fleet_url(self) -> str | None:
        """The router's own metrics endpoint (fleet /snapshot.json +
        /metrics), None until started or with federation off."""
        ex = self._fleet_exporter
        return None if ex is None else ex.url

    def __enter__(self) -> "ServingFabric":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    # ----------------------------------------------------------- plumbing

    def _url(self, i: int, path: str) -> str:
        with self._lock:
            port = self._ports.get(i)
        if port is None:  # drained between route and dispatch: retry path
            raise KeyError(f"replica {i} left the fleet")
        return f"http://127.0.0.1:{port}{path}"

    def replica_ids(self) -> list[int]:
        """The live fleet, sorted (membership snapshot under the lock)."""
        with self._lock:
            return sorted(self._handles)

    def _get_json(self, i: int, path: str, timeout: float) -> dict:
        with urllib.request.urlopen(self._url(i, path),
                                    timeout=timeout) as r:
            return json.loads(r.read().decode("utf-8"))

    def _post_json(self, i: int, path: str, doc: dict,
                   timeout: float) -> dict:
        req = urllib.request.Request(
            self._url(i, path), data=json.dumps(doc).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode("utf-8"))

    # ----------------------------------------------------------- queries

    def query(self, terms: Sequence[str], *, ranker: str = "tfidf",
              timeout: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Route one query; on replica failure re-dispatch to the next
        sibling on the ring under the SAME request id.  Raises
        :class:`FabricExhausted` past the retry budget — callers see a
        served answer or a typed refusal, never a silent drop."""
        rid = f"{self._rid_prefix}-{next(self._rid_seq)}"
        key = affinity_key(terms, ranker)
        with self._lock:
            self._stats["requests"] += 1
            self._audit[rid] = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        last_err: str | None = None
        for attempt in range(self.cfg.retry_limit):
            if deadline is not None and time.monotonic() > deadline:
                break
            target = self._pick_target(key, attempt)
            try:
                # one chaos-hooked hop: net_partition / net_hang / fail
                # at this site fault the router→replica link
                resp = rx.attempt_once(
                    lambda: self._post_json(
                        target, "/query",
                        {"rid": rid, "terms": list(terms), "ranker": ranker},
                        self.cfg.request_timeout_s,
                    ),
                    site=ROUTE_SITE,
                )
            except chaos.PartitionError as exc:
                self._mark_suspect(target, f"partition: {exc}")
                last_err = str(exc)
                continue
            except urllib.error.HTTPError as exc:
                if exc.code == 400:
                    body = exc.read().decode("utf-8", "replace")
                    try:
                        msg = json.loads(body).get("error", body)
                    except json.JSONDecodeError:
                        msg = body
                    raise ValueError(msg) from exc
                # 503 = below floor / shutting down: not suspect-worthy
                # on its own (the poll loop will catch it up) — just try
                # a sibling and come back later
                last_err = f"HTTP {exc.code}"
                with self._lock:
                    self._stats["retries"] += 1
                    if self._roll_active:
                        self._stats["roll_retries"] += 1
                time.sleep(self.cfg.retry_pause_s)
                continue
            except Exception as exc:  # noqa: BLE001 — dead/hung replica
                self._mark_suspect(target, f"{type(exc).__name__}: {exc}")
                last_err = f"{type(exc).__name__}: {exc}"
                with self._lock:
                    self._stats["retries"] += 1
                    if self._roll_active:
                        self._stats["roll_retries"] += 1
                time.sleep(self.cfg.retry_pause_s)
                continue
            finally:
                with self._lock:
                    self._inflight[target] -= 1
            with self._lock:
                self._audit[rid] += 1
                self._stats["delivered"] += 1
                self._suspect.discard(target)
            return (np.asarray(resp["scores"], dtype=np.float32),
                    np.asarray(resp["docs"], dtype=np.int32))
        with self._lock:
            self._stats["failed"] += 1
        raise FabricExhausted(
            f"query {rid} undeliverable after {self.cfg.retry_limit} "
            f"attempts (last: {last_err})"
        )

    def _pick_target(self, key: str, attempt: int) -> int:
        """The replica a query's ``attempt`` goes to, its hop counted in
        flight.  Where every candidate is an id routed around for its
        handoff predecessor's drain (a one-replica fleet mid-roll), wait
        for the drain instead of sending into the closing listener, at
        most one hop's timeout and the TERM's grace."""
        hold_until = time.monotonic() + self.cfg.request_timeout_s + self.cfg.grace_s
        while True:
            with self._lock:
                avoid = self._suspect | self._restarting
                order = self._ring.route(key, exclude=avoid)
                # rotate across the HEALTHY candidates (suspects sit at
                # the back of `order`): a hop that just partitioned must
                # not be the very next target; with the whole fleet
                # suspect, rotate over everyone — the supervisor may be
                # respawning them
                pool = [r for r in order if r not in avoid] or order
                draining = self._restarting & self._handoff_ids
                held = bool(pool) and set(pool) <= draining
                if not held or time.monotonic() >= hold_until:
                    target = pool[attempt % len(pool)]
                    # counted under the lock that read `avoid`: once a
                    # handoff has seen no hop in flight to an id it routes
                    # around, none starts (_handoff_replica)
                    self._inflight[target] += 1
                    return target
            time.sleep(0.005)

    def _mark_suspect(self, i: int, why: str) -> None:
        with self._lock:
            fresh = i not in self._suspect
            self._suspect.add(i)
        if fresh:
            obs.emit("fabric_suspect", replica=i, error=why[:200])

    # ----------------------------------------------------------- health

    def _health_loop(self) -> None:
        while not self._stop.wait(self.cfg.health_period_s):
            for i in self.replica_ids():
                with self._lock:
                    if i in self._restarting or i not in self._handles:
                        continue
                try:
                    status = self._get_json(i, "/status", timeout=2.0)
                    healthy = bool(status.get("ready"))
                except Exception:  # noqa: BLE001 — unreachable = unhealthy
                    status, healthy = None, False
                with self._lock:
                    was = i not in self._suspect
                    if healthy:
                        self._suspect.discard(i)
                    else:
                        self._suspect.add(i)
                if healthy != was:
                    obs.emit("fabric_health", replica=i, healthy=healthy)
                if status is not None:
                    # per-replica metrics fold: the fleet's numbers land
                    # in the ROUTER's trace + hub, one gauge per replica
                    obs.emit("fabric_replica_stats", replica=i,
                             requests=status.get("requests"),
                             executions=status.get("executions"),
                             replays=status.get("replays"),
                             p50_ms=status.get("p50_ms"),
                             p99_ms=status.get("p99_ms"),
                             generation=status.get("generation"),
                             floor=status.get("floor"),
                             cache_hits=status.get("cache_hits"),
                             peer_hits=status.get("peer_hits"),
                             peer_misses=status.get("peer_misses"),
                             peek_timeouts=status.get("peek_timeouts"),
                             fills=status.get("fills"),
                             breaker_open=status.get("breaker_open"),
                             peer_stores=status.get("peer_stores"))
                    obs.gauge(f"fabric_replica{i}_requests",
                              float(status.get("requests") or 0))

    # ----------------------------------------------------------- supervisor

    def _supervise_loop(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            for i in self.replica_ids():
                with self._lock:
                    if i in self._restarting or i in self._handoff_ids:
                        continue
                    handle = self._handles.get(i)
                if handle is None:  # drained since the snapshot
                    continue
                if handle.alive():
                    with self._lock:
                        self._down_since.pop(i, None)
                    continue
                if not self.cfg.respawn:
                    self._mark_suspect(i, "dead (respawn disabled)")
                    continue
                with self._lock:
                    t_down = self._down_since.setdefault(i, time.monotonic())
                try:
                    fresh = procs.respawn(
                        handle, site=ROUTE_SITE, replica=i,
                        spawn=lambda: self._spawn(i),
                    )
                except procs.ProcessSpawnError as exc:
                    self._mark_suspect(i, f"respawn failed: {exc}")
                    continue
                recovery_s = time.monotonic() - t_down
                port = int(fresh.ready["port"])
                with self._lock:
                    if i not in self._handles:  # drained mid-respawn
                        fresh.terminate(self.cfg.grace_s)
                        continue
                    self._handles[i] = fresh
                    self._ports[i] = port
                    self._suspect.discard(i)
                    self._down_since.pop(i, None)
                    self._stats["respawns"] += 1
                self._register_with_fleet(i, port)  # fresh ephemeral port
                obs.emit("fabric_respawn", replica=i, pid=fresh.pid,
                         port=fresh.ready.get("port"),
                         recovery_s=round(recovery_s, 3))
                self._push_peers()  # respawn may have moved the port

    # ----------------------------------------------------------- fleet ops

    def statuses(self, timeout: float = 2.0) -> list[dict | None]:
        out: list[dict | None] = []
        for i in self.replica_ids():
            try:
                out.append(self._get_json(i, "/status", timeout=timeout))
            except Exception:  # noqa: BLE001 — down replica = None
                out.append(None)
        return out

    def fleet_generation(self) -> int | None:
        """The fleet's servable generation: min over ready replicas
        (None when no replica is ready)."""
        gens = [s["generation"] for s in self.statuses()
                if s is not None and s.get("ready")]
        return min(gens) if gens else None

    def await_fleet_generation(self, generation: int,
                               timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            statuses = self.statuses()
            if all(s is not None and s.get("ready")
                   and (s.get("generation") or 0) >= generation
                   for s in statuses):
                return True
            time.sleep(self.cfg.poll_s)
        return False

    def rolling_restart(self, *, generation: int | None = None,
                        timeout: float = 120.0) -> None:
        """Roll the fleet one replica at a time under a committed floor:
        (1) wait until EVERY replica serves ≥ G, (2) durably commit the
        floor at G — from here no replica may come back below it —
        (3) replace each replica while its siblings keep serving.

        With handoff enabled a replica is replaced by spawning
        its successor into the SAME SO_REUSEPORT listener group FIRST,
        blocking until the successor's deferred handshake (== healthy at
        ≥ G), and only then TERMing the predecessor, which stops
        accepting and drains its in-flight requests to completion.  The
        id leaves the routing ring only for that drain, once every hop
        already sent to its port is answered, so no router connection
        meets the closing listener and the roll needs zero sibling
        retries.  Without SO_REUSEPORT (or with
        cfg.handoff off) the retry-carried path runs: TERM → respawn →
        wait-ready, with in-flight queries failing typed (ServerShutdown
        → HTTP 503) and re-dispatching to siblings under their original
        request ids."""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            segments as sgm,
        )

        G = generation
        if G is None:
            G = sgm.manifest_version(self.index_dir) or 0
        if not self.await_fleet_generation(G, timeout=timeout):
            raise TimeoutError(
                f"fleet never reached generation {G} within {timeout}s"
            )
        commit_floor(self.index_dir, G)
        live = self.replica_ids()
        handoff = self._handoff_enabled()
        obs.emit("fabric_roll_start", floor=G, replicas=len(live),
                 handoff=handoff)
        with self._lock:
            self._roll_active += 1
        try:
            for i in live:
                if handoff:
                    self._handoff_replica(i, G)
                else:
                    self._roll_replica_retry(i, G, timeout)
        finally:
            with self._lock:
                self._roll_active -= 1
        obs.emit("fabric_roll_done", floor=G, handoff=handoff)

    def _handoff_replica(self, i: int, G: int) -> None:
        """One zero-downtime replacement: successor first, drain second.

        Kill-point discipline: SIGKILL anywhere in this window leaves
        exactly one generation serving — before the spawn returns, the
        predecessor still owns the port (a dead half-spawned successor
        never printed its handshake, and ProcessHandle's spawn timeout
        reaps it); after the swap, the successor owns it and a killed
        predecessor just cuts its drain short (its in-flight requests
        fail typed into the sibling-retry path, same rid)."""
        with self._lock:
            old = self._handles.get(i)
            if old is None:  # drained while the roll was in flight
                return
            # suppress supervisor respawn for the window: a predecessor
            # SIGKILLed mid-handoff must be REPLACED by the swap below,
            # not raced by a second spawn onto the same port — unlike
            # _restarting the id stays in routing rotation until the
            # predecessor drains
            self._handoff_ids.add(i)
        routed_around = False
        t0 = time.monotonic()
        try:
            obs.emit("fabric_handoff", replica=i, phase="spawn", floor=G)
            # ONE chaos-hooked successor spawn (fail/proc_kill here is
            # the successor-dies-mid-handoff scenario): on failure the
            # predecessor is untouched and still serving — the roll
            # aborts with the fleet intact
            fresh = rx.attempt_once(
                lambda: self._spawn(i, ready_at_floor=True),
                site=DRAIN_SITE)
            obs.emit("fabric_handoff", replica=i, phase="successor_ready",
                     pid=fresh.pid, floor=G)
            with self._lock:
                if i not in self._handles:  # drained mid-handoff
                    fresh.terminate(self.cfg.grace_s)
                    return
                self._handles[i] = fresh
                # port unchanged (the anchor pins it) — no ring or fleet
                # registration churn
            self._register_with_fleet(i, int(fresh.ready["port"]))
            # the kernel spreads the port's connections over both
            # listeners, and the predecessor's close resets whatever it
            # has queued: route around the id (no query, no health probe)
            # from before the TERM until the predecessor has exited, and
            # TERM only once every hop already sent to the port is answered
            with self._lock:
                routed_around = i not in self._restarting
                self._restarting.add(i)
            self._await_no_hops(i)
            obs.emit("fabric_handoff", replica=i, phase="drain",
                     pid=old.pid)
            old.terminate(self.cfg.grace_s)  # SIGTERM → drain → exit
        finally:
            with self._lock:
                self._handoff_ids.discard(i)
                if routed_around:
                    self._restarting.discard(i)
        handoff_s = time.monotonic() - t0
        obs.histogram("fabric_handoff_s", handoff_s)
        with self._lock:
            self._stats["rolled"] += 1
        obs.emit("fabric_rolled", replica=i, floor=G, handoff=True,
                 restart_s=round(handoff_s, 3))
        self._push_peers()

    def _await_no_hops(self, i: int) -> None:
        """Until no router→replica hop to ``i`` is in flight, at most one
        hop's timeout."""
        deadline = time.monotonic() + self.cfg.request_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight[i]:
                    return
            time.sleep(0.005)

    def _roll_replica_retry(self, i: int, G: int, timeout: float) -> None:
        """The retry-carried replacement (no SO_REUSEPORT)."""
        with self._lock:
            old = self._handles.get(i)
            if old is None:  # drained while the roll was in flight
                return
            self._restarting.add(i)
            self._suspect.add(i)  # route around it immediately
        t0 = time.monotonic()
        old.terminate(self.cfg.grace_s)
        fresh = self._spawn(i)
        port = int(fresh.ready["port"])
        with self._lock:
            self._handles[i] = fresh
            self._ports[i] = port
        self._register_with_fleet(i, port)
        # back in rotation only once it serves ≥ the floor
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                s = self._get_json(i, "/status", timeout=2.0)
                if s.get("ready") and (s.get("generation") or 0) >= G:
                    break
            except Exception:  # noqa: BLE001 — still coming up
                pass
            time.sleep(self.cfg.poll_s)
        else:
            raise TimeoutError(
                f"replica {i} never reached floor {G} after restart"
            )
        with self._lock:
            self._restarting.discard(i)
            self._suspect.discard(i)
            self._stats["rolled"] += 1
        obs.emit("fabric_rolled", replica=i, floor=G, handoff=False,
                 restart_s=round(time.monotonic() - t0, 3))
        self._push_peers()

    def kill_replica(self, i: int) -> int | None:
        """SIGKILL replica ``i`` (the soak's chaos hook); returns the
        killed pid.  The supervisor detects and respawns it."""
        handle = self._handles[i]
        pid = handle.pid
        handle.kill()
        obs.emit("fabric_kill", replica=i, pid=pid)
        return pid

    # ----------------------------------------------------------- scaling

    def _rebuild_ring_locked(self) -> None:
        self._ring = _Ring(sorted(self._handles), self.cfg.ring_slots)

    def scale_up(self, n: int = 1) -> list[int]:
        """Add ``n`` replicas under FRESH ids: the ring only gains vnodes,
        so every key owned by a survivor keeps its owner (the churn
        stability property) and only ~1/N of keys move to each newcomer.
        Reuses the exact spawn/handshake machinery of start()/respawn."""
        added: list[int] = []
        for _ in range(max(0, n)):
            with self._lock:
                i = self._next_id
                self._next_id += 1
            handle = self._spawn(i)
            port = int(handle.ready["port"])
            with self._lock:
                self._handles[i] = handle
                self._ports[i] = port
                self._rebuild_ring_locked()
                self._stats["scale_ups"] += 1
            self._register_with_fleet(i, port)
            added.append(i)
        if added:
            self._push_peers()
        return added

    def scale_down(self, n: int = 1) -> list[int]:
        """Drain the ``n`` newest replicas, never below one: a draining
        replica leaves the ring FIRST (no new queries route to it), its
        in-flight queries finish or fail typed into the sibling-retry
        path (same rid — the dropped=0/double_served=0 audit holds across
        every scale event), and only then is the process TERMed."""
        removed: list[int] = []
        for _ in range(max(0, n)):
            with self._lock:
                ids = sorted(self._handles)
                if len(ids) <= 1:
                    break
                i = ids[-1]
                handle = self._handles.pop(i)
                self._ports.pop(i, None)
                self._suspect.discard(i)
                self._restarting.discard(i)
                self._down_since.pop(i, None)
                self._rebuild_ring_locked()
                self._stats["scale_downs"] += 1
            if self.fleet is not None:
                self.fleet.deregister(str(i))
            # with handoff enabled the TERM drains in-flight requests to
            # completion before exit (the replica already left the ring,
            # so no NEW queries land on it meanwhile)
            handle.terminate(self.cfg.grace_s)
            self._close_anchor(i)
            obs.emit("fabric_drain", replica=i, pid=handle.pid)
            removed.append(i)
        if removed:
            self._push_peers()
        return removed

    def scale_to(self, n: int) -> None:
        cur = len(self.replica_ids())
        if n > cur:
            self.scale_up(n - cur)
        elif n < cur:
            self.scale_down(cur - n)

    def audit(self) -> dict:
        """The router-side delivery audit: requests / delivered / failed
        (= dropped candidates) / retries / respawns, plus double_served =
        request ids with more than one accepted delivery (structurally 0:
        the retry loop stops at the first success, and replicas replay —
        not re-execute — a duplicate rid)."""
        with self._lock:
            # Counter semantics drop zero-valued keys; the audit's keys
            # are ALWAYS present so callers (and diffs) never KeyError
            out = {k: int(self._stats.get(k, 0))
                   for k in ("requests", "delivered", "retries", "failed",
                             "respawns", "rolled", "scale_ups",
                             "scale_downs", "roll_retries")}
            out["dropped"] = out["failed"]
            out["double_served"] = sum(
                1 for n in self._audit.values() if n > 1
            )
        return out


# ------------------------------------------------------------ autoscaler


class Autoscaler:
    """Burn-rate replica autoscaling — the ROADMAP fabric follow-on.

    Reads ONLY the fleet hub (the same aggregate an operator sees at the
    router's ``/snapshot.json``): availability/latency budget burn and
    queue-wait p99 are the scale-up signals, sustained idle the
    scale-down signal.  Actions go through the fabric's own
    scale_up/scale_down (the supervisor's spawn/drain machinery), bounded
    by ``[min_replicas, max_replicas]``, rate-limited by ``cooldown_s``
    and hysteretic by config (see :class:`AutoscaleConfig`).

    Every decision is published as an ``autoscale`` event carrying its
    measured inputs — burn rates, queue p99, offered rate, fleet size
    before/after and the triggering reason — so ``tools/trace_report.py``
    renders the scaling timeline; :meth:`stats` counts flaps (a direction
    reversal between consecutive actions)."""

    def __init__(self, fabric: ServingFabric,
                 cfg: AutoscaleConfig = AutoscaleConfig(), *,
                 clock=time.monotonic):
        if fabric.fleet is None:
            raise ValueError("Autoscaler needs a fabric with federation=True")
        self.fabric = fabric
        self.cfg = cfg
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_action_t: float | None = None
        self._idle_since: float | None = None
        self._decisions = 0
        self._ups = 0
        self._downs = 0
        self._flaps = 0
        self._last_dir: str | None = None

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fabric-autoscaler", daemon=True)
            self._thread.start()
            obs.emit("autoscale_start",
                     min_replicas=self.cfg.min_replicas,
                     max_replicas=self.cfg.max_replicas,
                     cooldown_s=self.cfg.cooldown_s)
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.period_s):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — a bad tick skips, never kills
                obs.emit("autoscale_error",
                         error=f"{type(exc).__name__}: {exc}"[:200])

    @staticmethod
    def _measure(snap: dict) -> dict:
        """The decision inputs, extracted once so the emitted event and
        the decision logic can never disagree on what was measured."""
        budgets = snap.get("budgets") or {}
        qwin = snap.get("queue_wait_s") or {}
        ctr = snap.get("counters") or {}
        q_p99 = qwin.get("p99")
        return {
            "burn_availability": (budgets.get("availability") or {}).get(
                "burn_rate", 0.0),
            "burn_latency": (budgets.get("latency") or {}).get(
                "burn_rate", 0.0),
            "queue_p99_ms": (None if q_p99 is None
                             else round(float(q_p99) * 1e3, 3)),
            "rate_per_s": (ctr.get("serve.requests") or {}).get(
                "rate_per_s", 0.0),
        }

    def tick(self, snap: "dict | None" = None) -> str:
        """One control-loop evaluation (injectable snapshot for tests and
        the CI forced-decision smoke); returns the action taken:
        ``"up"``, ``"down"``, or ``"hold"``."""
        fleet = self.fabric.fleet
        assert fleet is not None  # checked at construction
        if snap is None:
            snap = fleet.snapshot()
        m = self._measure(snap)
        n = len(self.fabric.replica_ids())
        now = self._clock()
        self._decisions += 1

        burn = max(float(m["burn_availability"]), float(m["burn_latency"]))
        q_hot = (m["queue_p99_ms"] is not None
                 and m["queue_p99_ms"] >= self.cfg.queue_p99_up_s * 1e3)
        pressure = burn >= self.cfg.burn_up or q_hot
        idle = (float(m["rate_per_s"]) <= self.cfg.idle_rate_down
                and burn < self.cfg.burn_down)
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        idle_held = (self._idle_since is not None
                     and now - self._idle_since >= self.cfg.idle_hold_s)
        cooling = (self._last_action_t is not None
                   and now - self._last_action_t < self.cfg.cooldown_s)

        action, reason = "hold", "steady"
        if pressure and cooling:
            reason = "cooldown"
        elif pressure and n >= self.cfg.max_replicas:
            reason = "at_max"
        elif pressure:
            action = "up"
            reason = "burn" if burn >= self.cfg.burn_up else "queue_p99"
        elif idle_held and cooling:
            reason = "cooldown"
        elif idle_held and n <= self.cfg.min_replicas:
            reason = "at_min"
        elif idle_held:
            action, reason = "down", "idle"

        if action == "hold":
            return action

        if action == "up":
            added = self.fabric.scale_up(1)
            self._ups += 1
        else:
            added = self.fabric.scale_down(1)
            self._downs += 1
            self._idle_since = None  # re-arm the idle hold after a drain
        self._last_action_t = now
        if self._last_dir is not None and self._last_dir != action:
            self._flaps += 1
        self._last_dir = action
        obs.emit("autoscale", action=action, reason=reason,
                 replicas_before=n, replicas_after=len(
                     self.fabric.replica_ids()),
                 changed=added, **m)
        return action

    def stats(self) -> dict:
        """Always-present decision tallies (the fleet soak's
        ``autoscale`` record reads these names)."""
        return {
            "decisions": self._decisions,
            "ups": self._ups,
            "downs": self._downs,
            "flaps": self._flaps,
        }


def main(argv: "list[str] | None" = None) -> int:
    """Module entry: ``--replica`` runs a replica process; the router is
    a library (ServingFabric) driven by the soak and chip_smoke.py."""
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "--replica":
        return replica_main(argv[1:])
    print("usage: fabric --replica INDEX_DIR [options]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
