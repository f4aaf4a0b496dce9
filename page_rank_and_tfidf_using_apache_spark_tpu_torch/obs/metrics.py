"""Rolling-window SLO instruments: bounded-memory streaming histograms,
windowed counters/rates, and error-budget trackers.

A copy of the JAX package's ``obs/metrics.py`` (stdlib and numpy), so the
port never imports that package.

Reference counterpart: the *live* Spark UI — stage/SLA numbers you can
read while the job runs — where the batch-era ``tools/trace_report.py``
only reconstructs them after death.  Everything here is:

- **O(bins), not O(events)** — a soak that serves requests for hours must
  not grow its telemetry with traffic.  :class:`StreamingHistogram` keeps
  one fixed geometric bin array (count/sum/min/max stay exact; quantiles
  are correct to within one bin, i.e. a relative error bounded by
  ``growth - 1``), and :class:`RollingHistogram` keeps ``slots`` such
  arrays in a time ring so p50/p95/p99 can be read *over the last window*
  at any moment.
- **Thread-safe** — observations arrive from the serve drain thread, the
  ingest pipeline's workers and the exporter's HTTP threads concurrently.
- **Fed by the bus, not by call sites** — :class:`TelemetrySink` attaches
  to the existing ``obs.EventBus`` and folds the events every long path
  already publishes (``serve_request``, ``metric``, ``retry``, ``chaos``,
  ...) into a :class:`MetricsHub`.  No publisher changed to make the
  telemetry live.

The pull side lives in :mod:`obs.export` (HTTP snapshot endpoint) and
``tools/slo_watch.py`` (terminal renderer); the soak harness
(:mod:`serving.soak`) scores its SLOs from a hub snapshot.

**Exact cross-process merge.**  Every instrument shares one
geometric bin layout, so fleet federation is *exact arithmetic*, not
estimation: ``to_mergeable()`` exports the raw state (bin counts, sums,
min/max, window tallies — JSON-safe, inf-free) and ``merge()`` folds a
peer's mergeable in.  Counts, sums and min/max merge byte-exactly;
quantiles read off the merged bins keep the same one-bin tolerance a
single process has (relative error <= ``growth - 1``).  The contract
that makes this sound — every process agreeing on metric names and bin
layout — is declared in ``analysis/registry.METRIC_SCHEMAS`` and
machine-checked by the ``metric-name-drift`` lint; a mismatched layout
raises at merge time rather than silently skewing fleet percentiles.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable

import numpy as np


class HistogramBins:
    """Shared geometric binning: ``n_bins`` fixed-width-in-log-space bins
    from ``lo`` to ``hi`` plus an underflow and an overflow slot.  A value
    maps to the bin whose ``[edge_i, edge_{i+1})`` range holds it, so any
    quantile read off the bin counts is within one bin of the exact
    sample quantile — a relative error of at most ``growth - 1``."""

    __slots__ = ("lo", "hi", "growth", "n_bins", "_log_lo", "_inv_log_g")

    def __init__(self, lo: float = 1e-6, hi: float = 1e6,
                 growth: float = 1.1):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(f"need 0 < lo < hi and growth > 1, got "
                             f"lo={lo} hi={hi} growth={growth}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self._log_lo = math.log(lo)
        self._inv_log_g = 1.0 / math.log(growth)
        self.n_bins = int(math.ceil((math.log(hi) - self._log_lo)
                                    * self._inv_log_g))

    @property
    def n_slots(self) -> int:
        """Total count-array length: n_bins + underflow + overflow."""
        return self.n_bins + 2

    def index(self, v: float) -> int:
        if not v > self.lo:  # <= lo, zero, negative, NaN -> underflow
            return 0
        if v >= self.hi:
            return self.n_bins + 1
        i = int((math.log(v) - self._log_lo) * self._inv_log_g)
        return min(max(i, 0), self.n_bins - 1) + 1

    def index_many(self, values: np.ndarray) -> np.ndarray:
        v = np.asarray(values, np.float64)  # graftlint: disable=dtype-drift (host-only telemetry math; never dispatched)
        out = np.zeros(v.shape, np.int64)
        pos = v > self.lo
        with np.errstate(divide="ignore", invalid="ignore"):
            i = ((np.log(np.where(pos, v, 1.0)) - self._log_lo)
                 * self._inv_log_g).astype(np.int64)
        out[pos] = np.clip(i[pos], 0, self.n_bins - 1) + 1
        out[v >= self.hi] = self.n_bins + 1
        return out

    def edge(self, i: int) -> float:
        return self.lo * self.growth ** i

    def value(self, slot: int, vmin: float, vmax: float) -> float:
        """Representative value of one slot (geometric bin midpoint),
        clamped into the exactly-tracked [vmin, vmax] observed range."""
        if slot <= 0:
            return vmin
        if slot >= self.n_bins + 1:
            return vmax
        mid = self.edge(slot - 1) * math.sqrt(self.growth)
        return min(max(mid, vmin), vmax)

    def quantile_from_counts(
        self, counts: np.ndarray, p: float, vmin: float, vmax: float
    ) -> float | None:
        """Nearest-rank quantile over a bin-count array (None when
        empty) — the same rank convention as ``utils.metrics.percentile``,
        resolved to bin granularity."""
        total = int(counts.sum())
        if total <= 0:
            return None
        rank = max(min(-(-int(p * 100) * total // 100), total), 1)
        cum = 0
        for slot, c in enumerate(counts):
            cum += int(c)
            if cum >= rank:
                return self.value(slot, vmin, vmax)
        return vmax


# Default bin layout for latency-flavored instruments: 1 microsecond to
# ~17 minutes at 10% relative resolution (~208 bins).
LATENCY_BINS = dict(lo=1e-6, hi=1e3, growth=1.1)


def _bins_sig(bins: HistogramBins) -> dict[str, float]:
    return {"lo": bins.lo, "hi": bins.hi, "growth": bins.growth}


def _require_same_bins(bins: HistogramBins, sig: dict[str, Any],
                       what: str) -> None:
    """Merge precondition: identical bin layout on both sides.  A layout
    mismatch is a fleet-config bug (metric-name-drift territory), and
    folding counts across different edges would silently corrupt every
    quantile — so it raises instead."""
    theirs = (float(sig["lo"]), float(sig["hi"]), float(sig["growth"]))
    ours = (bins.lo, bins.hi, bins.growth)
    if theirs != ours:
        raise ValueError(
            f"{what}.merge: bin layout mismatch "
            f"(ours lo/hi/growth={ours}, theirs={theirs})"
        )


class StreamingHistogram:
    """Cumulative fixed-bin histogram with online quantiles.

    Memory is O(bins) forever: count/sum/min/max are tracked exactly,
    per-event samples are never retained (the unbounded-memory risk the
    old run-end ``Aggregates`` carried), and quantiles are read from the
    bin counts to within one bin of the exact value."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e6,
                 growth: float = 1.1, *, bins: HistogramBins | None = None):
        self.bins = bins or HistogramBins(lo, hi, growth)
        self._lock = threading.Lock()
        self._counts = np.zeros(self.bins.n_slots, np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._counts[self.bins.index(v)] += 1

    def observe_many(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()  # graftlint: disable=dtype-drift (host-only telemetry math; never dispatched)
        if v.size == 0:
            return
        idx = self.bins.index_many(v)
        add = np.bincount(idx, minlength=self.bins.n_slots)
        with self._lock:
            self._count += int(v.size)
            self._sum += float(v.sum())
            self._min = min(self._min, float(v.min()))
            self._max = max(self._max, float(v.max()))
            self._counts += add

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, p: float) -> float | None:
        with self._lock:
            return self.bins.quantile_from_counts(
                self._counts, p, self._min, self._max
            )

    def approx_bytes(self) -> int:
        """Telemetry-state footprint — constant in the event count (the
        10^6-event regression test pins this)."""
        return int(self._counts.nbytes) + 64

    def to_mergeable(self) -> dict[str, Any]:
        """Raw exportable state: bin layout + counts + exact
        count/sum/min/max.  JSON-safe — min/max are None until the first
        observation (never ±inf on the wire)."""
        with self._lock:
            return {
                "kind": "streaming_histogram",
                "bins": _bins_sig(self.bins),
                "counts": self._counts.tolist(),
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
            }

    def merge(self, m: dict[str, Any]) -> None:
        """Fold a peer's :meth:`to_mergeable` in.  Count/sum/min/max and
        the bin counts merge exactly; quantiles of the merged state keep
        the one-bin tolerance.  One-shot: merging the same export twice
        double-counts (the federation layer re-merges *fresh* scrapes
        into a fresh hub instead)."""
        _require_same_bins(self.bins, m["bins"], "StreamingHistogram")
        add = np.asarray(m["counts"], np.int64)
        if add.shape != self._counts.shape:
            raise ValueError(
                f"StreamingHistogram.merge: {add.shape} vs "
                f"{self._counts.shape} slots"
            )
        with self._lock:
            self._counts += add
            self._count += int(m["count"])
            self._sum += float(m["sum"])
            if m.get("min") is not None:
                self._min = min(self._min, float(m["min"]))
            if m.get("max") is not None:
                self._max = max(self._max, float(m["max"]))

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            counts = self._counts.copy()
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        q = lambda p: self.bins.quantile_from_counts(counts, p, vmin, vmax)  # noqa: E731
        return {
            "count": count,
            "sum": total,
            "min": vmin if count else 0.0,
            "max": vmax if count else 0.0,
            "mean": total / count if count else 0.0,
            "p50": q(0.50) if count else 0.0,
            "p90": q(0.90) if count else 0.0,
            "p95": q(0.95) if count else 0.0,
            "p99": q(0.99) if count else 0.0,
        }


class RollingHistogram:
    """Windowed quantiles over a ring of per-slot bin-count rows.

    The window is ``window_s`` seconds split into ``slots`` equal slots;
    an observation lands in the slot owning its timestamp, and a snapshot
    merges only the slots still inside the window — so ``quantile(0.99)``
    is the p99 *of roughly the last window_s seconds*, readable at any
    moment of an arbitrarily long run.  Memory: O(slots * bins)."""

    def __init__(self, window_s: float = 60.0, slots: int = 30, *,
                 lo: float = 1e-6, hi: float = 1e6, growth: float = 1.1,
                 bins: HistogramBins | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0 or slots < 1:
            raise ValueError("window_s must be > 0 and slots >= 1")
        self.bins = bins or HistogramBins(lo, hi, growth)
        self.window_s = float(window_s)
        self.slots = int(slots)
        self.slot_s = self.window_s / self.slots
        self._clock = clock
        self._lock = threading.Lock()
        self._rows = np.zeros((self.slots, self.bins.n_slots), np.int64)
        self._row_ids = np.full(self.slots, -1, np.int64)  # absolute slot no
        self._min = math.inf  # lifetime extremes: clamp-only, exactness
        self._max = -math.inf  # lives in the cumulative instruments

    def _row_for(self, slot_no: int) -> np.ndarray:
        i = slot_no % self.slots
        if self._row_ids[i] != slot_no:
            self._rows[i].fill(0)
            self._row_ids[i] = slot_no
        return self._rows[i]

    def observe(self, value: float) -> None:
        v = float(value)
        now = self._clock()
        with self._lock:
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._row_for(int(now / self.slot_s))[self.bins.index(v)] += 1

    def _merged_locked(self) -> np.ndarray:
        cur = int(self._clock() / self.slot_s)
        live = (self._row_ids > cur - self.slots) & (self._row_ids <= cur)
        if not live.any():
            return np.zeros(self.bins.n_slots, np.int64)
        return self._rows[live].sum(axis=0)

    def quantile(self, p: float) -> float | None:
        with self._lock:
            return self.bins.quantile_from_counts(
                self._merged_locked(), p, self._min, self._max
            )

    def window_count(self) -> int:
        with self._lock:
            return int(self._merged_locked().sum())

    def to_mergeable(self) -> dict[str, Any]:
        """Exportable live window: the ring's row ids are keyed to this
        process's own monotonic clock, so raw rows do not transport —
        what crosses the wire is the *merged current window* plus the
        lifetime extremes."""
        with self._lock:
            merged = self._merged_locked()
            vmin, vmax = self._min, self._max
        return {
            "kind": "rolling_histogram",
            "bins": _bins_sig(self.bins),
            "window_s": self.window_s,
            "window_counts": merged.tolist(),
            "min": None if vmin == math.inf else vmin,
            "max": None if vmax == -math.inf else vmax,
        }

    def merge(self, m: dict[str, Any]) -> None:
        """Fold a peer's exported window into the slot owning *now*: the
        peer's last-window traffic lands at merge time, so a window read
        shortly after covers the union of both fleets' recent traffic
        (counts exact, quantiles within one bin).  One-shot — see
        :meth:`StreamingHistogram.merge`."""
        _require_same_bins(self.bins, m["bins"], "RollingHistogram")
        if float(m["window_s"]) != self.window_s:
            raise ValueError(
                f"RollingHistogram.merge: window_s mismatch "
                f"({m['window_s']} vs {self.window_s})"
            )
        add = np.asarray(m["window_counts"], np.int64)
        if add.shape != (self.bins.n_slots,):
            raise ValueError(
                f"RollingHistogram.merge: {add.shape} vs "
                f"({self.bins.n_slots},) slots"
            )
        now = self._clock()
        with self._lock:
            if m.get("min") is not None:
                self._min = min(self._min, float(m["min"]))
            if m.get("max") is not None:
                self._max = max(self._max, float(m["max"]))
            self._row_for(int(now / self.slot_s))[:] += add

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            merged = self._merged_locked()
            vmin, vmax = self._min, self._max
        count = int(merged.sum())
        q = lambda p: self.bins.quantile_from_counts(merged, p, vmin, vmax)  # noqa: E731
        return {
            "window_s": self.window_s,
            "count": count,
            "p50": q(0.50),
            "p90": q(0.90),
            "p95": q(0.95),
            "p99": q(0.99),
        }


class WindowedCounter:
    """Cumulative total plus a sliding-window sum/rate (ring of per-slot
    sums, O(slots) memory)."""

    def __init__(self, window_s: float = 60.0, slots: int = 30, *,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.slots = int(slots)
        self.slot_s = self.window_s / self.slots
        self._clock = clock
        self._lock = threading.Lock()
        self._sums = np.zeros(self.slots, np.float64)  # graftlint: disable=dtype-drift (host-only telemetry state; never dispatched)
        self._slot_ids = np.full(self.slots, -1, np.int64)
        self._total = 0.0
        self._t0: float | None = None

    def add(self, n: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._total += n
            slot_no = int(now / self.slot_s)
            i = slot_no % self.slots
            if self._slot_ids[i] != slot_no:
                self._sums[i] = 0.0
                self._slot_ids[i] = slot_no
            self._sums[i] += n

    def total(self) -> float:
        with self._lock:
            return self._total

    def _window_sum_locked(self) -> float:
        cur = int(self._clock() / self.slot_s)
        live = (self._slot_ids > cur - self.slots) & (self._slot_ids <= cur)
        return float(self._sums[live].sum())

    def window_sum(self) -> float:
        with self._lock:
            return self._window_sum_locked()

    def rate(self) -> float:
        """Events/sec over the window actually covered so far (a counter
        younger than the window divides by its age, not the window)."""
        now = self._clock()
        with self._lock:
            if self._t0 is None:
                return 0.0
            covered = max(min(now - self._t0, self.window_s), self.slot_s)
            return self._window_sum_locked() / covered

    def snapshot(self) -> dict[str, Any]:
        return {"total": self.total(), "rate_per_s": round(self.rate(), 4)}

    def to_mergeable(self) -> dict[str, Any]:
        """Exportable state: exact cumulative total, the live window sum,
        and how many seconds of window the counter has actually covered
        (so a merged rate divides by real coverage, not assumed age)."""
        now = self._clock()
        with self._lock:
            covered = (0.0 if self._t0 is None
                       else max(min(now - self._t0, self.window_s),
                                self.slot_s))
            return {
                "kind": "windowed_counter",
                "window_s": self.window_s,
                "total": self._total,
                "window_sum": self._window_sum_locked(),
                "covered_s": covered,
            }

    def merge(self, m: dict[str, Any]) -> None:
        """Fold a peer's export in: totals add exactly; the peer's window
        sum lands in the slot owning *now*; coverage extends ``_t0`` so
        the merged rate is over the widest window either side covered.
        One-shot — see :meth:`StreamingHistogram.merge`."""
        if float(m["window_s"]) != self.window_s:
            raise ValueError(
                f"WindowedCounter.merge: window_s mismatch "
                f"({m['window_s']} vs {self.window_s})"
            )
        now = self._clock()
        with self._lock:
            self._total += float(m["total"])
            covered = float(m.get("covered_s") or 0.0)
            if covered > 0.0:
                t0 = now - covered
                self._t0 = t0 if self._t0 is None else min(self._t0, t0)
            w = float(m["window_sum"])
            if w:
                slot_no = int(now / self.slot_s)
                i = slot_no % self.slots
                if self._slot_ids[i] != slot_no:
                    self._sums[i] = 0.0
                    self._slot_ids[i] = slot_no
                self._sums[i] += w


class ErrorBudget:
    """SLO target + error-budget accounting over a sliding window.

    ``target`` is the good-event fraction the SLO promises (0.999 =
    "99.9% of requests succeed / meet latency").  The budget is the
    allowed bad fraction ``1 - target``; ``consumed_frac`` is how much of
    the *cumulative* budget the run has burned, and ``burn_rate`` is the
    classic SRE multiplier — the windowed bad-fraction divided by the
    allowed fraction (1.0 = burning exactly the budget; 10 = ten times
    too fast)."""

    def __init__(self, target: float, *, window_s: float = 60.0,
                 slots: int = 30,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.target = float(target)
        self._all = WindowedCounter(window_s, slots, clock=clock)
        self._bad = WindowedCounter(window_s, slots, clock=clock)

    def observe(self, good: bool) -> None:
        self._all.add(1.0)
        if not good:
            self._bad.add(1.0)

    def snapshot(self) -> dict[str, Any]:
        total = self._all.total()
        bad = self._bad.total()
        allowed = (1.0 - self.target) * total
        if allowed > 0:
            consumed = bad / allowed
        else:
            consumed = 0.0 if bad == 0 else 1e9  # no traffic yet, or all-bad
        w_total = self._all.window_sum()
        w_bad = self._bad.window_sum()
        burn = ((w_bad / w_total) / (1.0 - self.target)) if w_total > 0 else 0.0
        return {
            "target": self.target,
            "total": int(total),
            "bad": int(bad),
            "allowed": round(allowed, 3),
            "consumed_frac": round(min(consumed, 1e9), 4),
            "window_bad": int(w_bad),
            "burn_rate": round(min(burn, 1e9), 4),
        }

    def to_mergeable(self) -> dict[str, Any]:
        return {
            "kind": "error_budget",
            "target": self.target,
            "all": self._all.to_mergeable(),
            "bad": self._bad.to_mergeable(),
        }

    def merge(self, m: dict[str, Any]) -> None:
        """Fold a peer's budget in.  Targets must agree — a fleet whose
        replicas promise different SLOs has no single budget to burn
        (and METRIC_SCHEMAS pins the fleet-wide target names)."""
        if float(m["target"]) != self.target:
            raise ValueError(
                f"ErrorBudget.merge: target mismatch "
                f"({m['target']} vs {self.target})"
            )
        self._all.merge(m["all"])
        self._bad.merge(m["bad"])


class MetricsHub:
    """The process's live SLO instrument board.

    Holds the rolling/streaming latency histograms, lazily-created
    windowed counters, gauges, and named error budgets; renders one JSON
    snapshot (:meth:`snapshot`) and one Prometheus-style text page
    (:meth:`prometheus`).  Fed by :class:`TelemetrySink` from the event
    bus — publishers need no new wiring."""

    def __init__(self, *, window_s: float = 60.0, slots: int = 30,
                 latency_slo_s: float | None = None,
                 availability_target: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self._clock = clock
        self._slots = int(slots)
        bins = HistogramBins(**LATENCY_BINS)
        self.latency = RollingHistogram(window_s, slots, bins=bins,
                                        clock=clock)
        self.latency_total = StreamingHistogram(bins=bins)
        self.queue_wait = RollingHistogram(window_s, slots, bins=bins,
                                           clock=clock)
        self.latency_slo_s = latency_slo_s
        self._lock = threading.Lock()
        self._counters: dict[str, WindowedCounter] = {}
        self._gauges: dict[str, float] = {}
        self.budgets: dict[str, ErrorBudget] = {}
        if availability_target is not None:
            self.budgets["availability"] = ErrorBudget(
                availability_target, window_s=window_s, slots=slots,
                clock=clock)
        if latency_slo_s is not None:
            # p99 target expressed as a budget: 1% of requests may exceed
            # the latency bound before the budget starts burning
            self.budgets["latency"] = ErrorBudget(
                0.99, window_s=window_s, slots=slots, clock=clock)

    # ------------------------------------------------------------- feeding

    def counter(self, name: str) -> WindowedCounter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = WindowedCounter(
                    self.window_s, self._slots, clock=self._clock)
            return c

    def count(self, name: str, n: float = 1.0) -> None:
        self.counter(name).add(n)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe_request(self, total_s: float, ok: bool,
                        queue_wait_s: float | None = None) -> None:
        """One served request: latency instruments see only successful
        requests (a failure's latency is time-to-fail, not service time);
        every request feeds the counters and budgets."""
        self.count("serve.requests")
        if ok:
            self.count("serve.ok")
            self.latency.observe(total_s)
            self.latency_total.observe(total_s)
            if queue_wait_s is not None:
                self.queue_wait.observe(queue_wait_s)
        else:
            self.count("serve.errors")
        budget = self.budgets.get("availability")
        if budget is not None:
            budget.observe(ok)
        budget = self.budgets.get("latency")
        if budget is not None:
            budget.observe(ok and total_s <= (self.latency_slo_s or math.inf))

    def ingest_event(self, event: dict[str, Any]) -> None:
        """Fold one bus event into the instruments (TelemetrySink's
        fan-in).  Unknown kinds are ignored — the hub only ever *reads*
        the existing event vocabulary."""
        kind = event.get("kind")
        if kind == "serve_request":
            self.observe_request(
                float(event.get("total_s") or 0.0),
                ok=not event.get("error"),
                queue_wait_s=event.get("queue_wait_s"),
            )
        elif kind == "chaos":
            self.count("chaos.injections")
            fault = event.get("fault")
            if fault in ("lost", "device_lost"):
                self.count("chaos.losses")
        elif kind in ("retry", "backoff", "degraded", "exhausted",
                      "watchdog", "checkpoint_save"):
            self.count(kind)
        elif kind == "metric":
            sub = event.get("event")
            if sub in ("chunk", "super_chunk"):
                self.count("ingest.chunks")
                self.count("ingest.tokens", float(event.get("tokens") or 0))
            elif sub == "ingest_overlap":
                self.gauge("h2d_overlap_frac",
                           float(event.get("h2d_overlap_frac") or 0.0))
        elif kind in ("serve_start", "soak_rebuild", "soak_swap",
                      "soak_loss_injected", "soak_recovered",
                      "soak_prior_refresh"):
            self.count(kind)

    # ------------------------------------------------------- federation

    def to_mergeable(self) -> dict[str, Any]:
        """The hub's full raw state for exact cross-process federation —
        embedded in every :meth:`snapshot` so any process's
        ``/snapshot.json`` is federable with no extra endpoint."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        budgets = dict(self.budgets)
        return {
            "window_s": self.window_s,
            "latency": self.latency.to_mergeable(),
            "latency_total": self.latency_total.to_mergeable(),
            "queue_wait": self.queue_wait.to_mergeable(),
            "counters": {k: c.to_mergeable()
                         for k, c in sorted(counters.items())},
            "gauges": gauges,
            "budgets": {k: b.to_mergeable()
                        for k, b in sorted(budgets.items())},
        }

    def merge_mergeable(self, m: dict[str, Any]) -> None:
        """Fold one process's :meth:`to_mergeable` export into this hub:
        histograms/counters/budgets merge exactly (missing counters and
        budgets are created on first sight); gauges are last-write-wins —
        the federation layer exports per-replica gauges under replica
        labels instead of pretending point-in-time values add."""
        self.latency.merge(m["latency"])
        self.latency_total.merge(m["latency_total"])
        self.queue_wait.merge(m["queue_wait"])
        for name, cm in m.get("counters", {}).items():
            self.counter(name).merge(cm)
        for name, v in m.get("gauges", {}).items():
            self.gauge(name, v)
        for name, bm in m.get("budgets", {}).items():
            with self._lock:
                b = self.budgets.get(name)
                if b is None:
                    b = self.budgets[name] = ErrorBudget(
                        float(bm["target"]), window_s=self.window_s,
                        slots=self._slots, clock=self._clock)
            b.merge(bm)

    # ------------------------------------------------------------ rendering

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        return {
            "at_wall": time.time(),
            "window_s": self.window_s,
            "latency_s": {
                "window": self.latency.snapshot(),
                "total": self.latency_total.snapshot(),
            },
            "queue_wait_s": self.queue_wait.snapshot(),
            "counters": {k: c.snapshot() for k, c in sorted(counters.items())},
            "gauges": gauges,
            "budgets": {k: b.snapshot() for k, b in sorted(self.budgets.items())},
            "mergeable": self.to_mergeable(),
        }

    def prometheus(self) -> str:
        """Prometheus text exposition (0.0.4 flavor) of the same state."""
        def _name(raw: str) -> str:
            return "graft_" + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in raw
            )

        lines: list[str] = []
        snap = self.snapshot()
        win = snap["latency_s"]["window"]
        for q in ("p50", "p90", "p95", "p99"):
            v = win.get(q)
            if v is not None:
                lines.append(
                    f'graft_serve_latency_seconds{{window="rolling",'
                    f'quantile="0.{q[1:]}"}} {v:.6g}'
                )
        tot = snap["latency_s"]["total"]
        lines.append(f"graft_serve_latency_seconds_count {tot['count']}")
        lines.append(f"graft_serve_latency_seconds_sum {tot['sum']:.6g}")
        for name, c in snap["counters"].items():
            lines.append(f"{_name(name)}_total {c['total']:.6g}")
            lines.append(f"{_name(name)}_rate {c['rate_per_s']:.6g}")
        for name, v in snap["gauges"].items():
            lines.append(f"{_name(name)} {v:.6g}")
        for name, b in snap["budgets"].items():
            lines.append(
                f'graft_slo_budget_consumed{{slo="{name}"}} '
                f"{b['consumed_frac']:.6g}"
            )
            lines.append(
                f'graft_slo_burn_rate{{slo="{name}"}} {b["burn_rate"]:.6g}'
            )
        return "\n".join(lines) + "\n"


class TelemetrySink:
    """EventBus sink adapter: attach to ``obs.bus()`` and every event the
    existing publishers emit feeds the hub — the zero-new-call-site-wiring
    contract of the live telemetry layer.  A raising sink would be
    detached by the bus; the hub's folds only touch its own locks."""

    def __init__(self, hub: MetricsHub):
        self.hub = hub

    def emit(self, event: dict[str, Any]) -> None:
        self.hub.ingest_event(event)

    def close(self) -> None:
        pass
