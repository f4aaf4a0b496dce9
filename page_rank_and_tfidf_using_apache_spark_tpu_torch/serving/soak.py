"""Soak harness: continuous ingest + live traffic + chaos, scored on SLOs.

Counterpart of the JAX package's ``serving/soak.py``, with its names and
its record.  Everything runs on the soak's device (``SoakConfig.device``:
``cuda`` unless the caller asks for the CPU) — the ingest stream, the
server, the PageRank prior (``run_pagerank`` under ``spmv_impl="segment"``,
which launches ``csrc/segment.cu`` on the card) — and the record's
``backend`` names that device's backend (``utils/device.backend_name``).
``tests/test_torch_soak.py`` holds it to the reference.

Everything the repo built separately runs AT THE SAME TIME:

- an **ingest thread** streams a growing synthetic corpus through the
  staged ``chunked_ingest`` pipeline (``run_tfidf_streaming``) and seals
  each accumulated delta as an immutable **segment** every
  ``rebuild_every_s`` (serving/segments.py ``seal_segment`` +
  ``commit_append``).  Committed documents are NEVER re-streamed: each
  chunk is processed exactly once, so arrivals == processed volume by
  construction;
- the supervisor **hot-swaps** each new manifest generation onto the
  RUNNING server (``TfidfServer.refresh_segments`` — warm first, swap
  under the cache lock, no restart, no request dropped), and a background
  :class:`~..serving.segments.SegmentMerger` compacts small segments under
  the existing retry ladder; ``commit_to_servable_s`` — seal commit →
  first query able to see the segment — is measured per swap and lands in
  the SLO record;
- **closed-loop clients** drive mixed ``tfidf`` / ``bm25`` / ``prior``
  traffic (the per-request PageRank blend) at a target aggregate QPS;
- a **prior-refresh thread** recomputes PageRank over the document graph
  and hot-swaps the prior operand on the running server
  (``TfidfServer.set_prior`` — cache invalidated);
- **deterministic chaos**: any ``GRAFT_CHAOS`` plan stays active
  throughout (transient faults retry invisibly), and at ``loss_at_s`` the
  harness composes in a persistent ``serve_dispatch:lost@1+`` — a
  whole-backend loss with no device index, which the port's executor
  never salvages, so every batch fails until the supervisor *recovers*:
  it notices client failures, lifts the dead-device plan (the
  replacement card), rebuilds a warm server from the last committed index
  version, swaps, and probes.  ``time_to_recover_s`` is the measured
  first-failure → first-served-again span.

Scoring is SLOs, not throughput: served p50/p95/p99 over the rolling
window (``obs.metrics`` instruments fed by the ``serve_request`` events
the server already publishes), availability and latency **error budgets**
with burn rates, recovery time, and the dropped / double-served
invariants.  One ``slo`` record is returned (and published as an ``slo``
event into the trace, where ``tools/trace_report`` renders it).  A live
:mod:`obs.export` endpoint serves the same window mid-run — the record
embeds a mid-run endpoint snapshot so the "inspectable while running"
claim is itself tested.

:func:`run_fleet_soak` runs the same SLO-scored scenario against the
multi-process fleet (``serving/fabric.py``): replica processes on the
soak's device, one SIGKILL and one rolling restart under load.

Env knobs (all declared in ``utils/config.GRAFT_ENV_KNOBS``):
``GRAFT_SOAK_DURATION_S``, ``GRAFT_SOAK_QPS``, ``GRAFT_SOAK_SLO_P99_MS``,
``GRAFT_SOAK_SLO_AVAILABILITY``, ``GRAFT_FABRIC_REPLICAS``,
``GRAFT_AUTOSCALE_COOLDOWN_S``, plus ``GRAFT_METRICS_PORT`` for the
endpoint.  The merger seals a merged segment's BM25 weights on the soak's
device too (``SegmentMerger``'s ``device``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import tempfile
import threading
import time
import urllib.request
from typing import Any, Iterator

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs, serving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (
    synthetic_powerlaw,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
    run_pagerank,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
    run_tfidf_streaming,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.export import (
    MetricsExporter,
    metrics_port_from_env,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import (
    MetricsHub,
    TelemetrySink,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
    segments as sgm,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    TUNABLE_DEFAULTS,
    Bm25Config,
    PageRankConfig,
    TfidfConfig,
    load_tuned_profile,
    tuned_config,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    backend_name,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import (
    MetricsRecorder,
    percentile,
)

_VOCAB_WORDS = 20_000


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    """One soak scenario.  The four starred knobs ride env variables so
    a caller can shape a run without code changes; everything else is a
    library-level parameter."""

    duration_s: float = 60.0  # * GRAFT_SOAK_DURATION_S
    qps: float = 30.0  # * GRAFT_SOAK_QPS — aggregate closed-loop target
    slo_p99_ms: float = 500.0  # * GRAFT_SOAK_SLO_P99_MS
    availability_target: float = 0.999  # * GRAFT_SOAK_SLO_AVAILABILITY
    clients: int = 3
    window_s: float = 60.0  # rolling SLO window
    rebuild_every_s: float = 12.0  # delta-segment seal/commit cadence
    chunk_interval_s: float = 0.5  # corpus arrival pacing
    prior_refresh_every_s: float = 8.0
    losses: int = 1  # injected device losses
    loss_at_s: float | None = None  # default duration/3
    request_timeout_s: float = 20.0
    retry_limit: int = 200  # per logical request (zero-dropped pressure)
    grace_s: float = 30.0  # post-deadline window to land in-flight retries
    seed: int = 7
    vocab_bits: int = 12
    docs_per_chunk: int = 24
    tokens_per_doc: int = 40
    chunk_tokens: int = 1 << 12
    bootstrap_chunks: int = 3
    top_k: int = 10
    max_batch: int = TUNABLE_DEFAULTS["max_batch"]
    prior_alpha: float = 0.25
    prior_iters: int = 5
    scoring: str = "coo"  # serving path (byte-equal either way).  The
    # soak's live set is tiny (thousands of docs), where the impacted
    # path's padded bucket floor costs more than the full postings do —
    # its win scales with corpus nnz.  "coo" here keeps the soak's p50
    # comparable across runs; flip to "impacted" to soak the latency path
    # itself.
    max_live_segments: int = 4  # merge policy: compact beyond this
    merge_interval_s: float = 2.0  # background merger cadence
    metrics_port: int | None = None  # None -> GRAFT_METRICS_PORT else 0
    device: str = DEFAULT_DEVICE  # the ingest stream's, the server's and
    # the prior's torch device: cuda unless the caller asks for the CPU

    def __post_init__(self) -> None:
        if self.duration_s <= 0 or self.qps <= 0 or self.clients < 1:
            raise ValueError("duration_s, qps and clients must be positive")
        if not 0.0 < self.availability_target < 1.0:
            raise ValueError("availability_target must be in (0, 1)")
        if self.losses < 0 or self.slo_p99_ms <= 0:
            raise ValueError("losses must be >= 0 and slo_p99_ms > 0")

    @classmethod
    def from_env(cls, **overrides: Any) -> "SoakConfig":
        """Bench/CI entry: the starred knobs from the environment, the
        rest defaulted (or overridden by the caller)."""
        env: dict[str, Any] = {}
        raw = os.environ.get("GRAFT_SOAK_DURATION_S")
        if raw:
            env["duration_s"] = float(raw)
        raw = os.environ.get("GRAFT_SOAK_QPS")
        if raw:
            env["qps"] = float(raw)
        raw = os.environ.get("GRAFT_SOAK_SLO_P99_MS")
        if raw:
            env["slo_p99_ms"] = float(raw)
        raw = os.environ.get("GRAFT_SOAK_SLO_AVAILABILITY")
        if raw:
            env["availability_target"] = float(raw)
        env.update(overrides)
        return cls(**env)


def _doc_chunks(cfg: SoakConfig) -> Iterator[list[str]]:
    """Endless deterministic Zipf corpus stream (documents
    over a shared power-law vocabulary so rebuilt indexes stay
    queryable by the clients' Zipf query generator)."""
    rng = np.random.default_rng(cfg.seed)
    while True:
        docs = []
        for _ in range(cfg.docs_per_chunk):
            n = max(int(rng.poisson(cfg.tokens_per_doc)), 4)
            ids = rng.zipf(1.3, n) % _VOCAB_WORDS
            docs.append(" ".join(f"w{i}" for i in ids))
        yield docs


def _prior_ranks(n_docs: int, seed: int, iters: int,
                 device: str | None = None) -> np.ndarray:
    """The refreshable PageRank prior: ranks over a synthetic document
    citation graph at the current corpus size, normalized to mean 1 so
    the blend scale stays comparable across refreshes.  Runs on
    ``device`` (``None`` is cuda) through the ``segment`` SpMV, the
    soak's one kernel."""
    n = max(int(n_docs), 2)
    g = synthetic_powerlaw(n, min(6 * n, n * (n - 1)), seed=seed)
    res = run_pagerank(
        g,
        PageRankConfig(iterations=iters, dangling="redistribute",
                       init="uniform", spmv_impl="segment"),
        device=device,
    )
    out = np.zeros(n, np.float32)
    out[np.asarray(g.node_ids)] = np.asarray(res.ranks, np.float32)
    mean = float(out.mean())
    return out / mean if mean > 0 else out


def _ms(v: float | None) -> float | None:
    return None if v is None else round(v * 1e3, 3)


class _Soak:
    """One soak run's mutable state.  The supervisor owns the calling
    thread; ingest / prior-refresh / client workers are daemon threads.
    Every cross-thread mutation happens under ``self._lock`` (the
    ``unsynced-thread-state`` audit surface); the server reference swap
    is a single atomic rebind readers pick up on their next request."""

    def __init__(self, cfg: SoakConfig, index_dir: str):
        self.cfg = cfg
        self.index_dir = index_dir
        self._lock = threading.Lock()
        self._stop = threading.Event()  # ingest + prior threads
        self._client_stop = threading.Event()
        self._failures: queue.Queue = queue.Queue()
        self._server: serving.TfidfServer | None = None
        self._chaos_ctx: chaos.inject | None = None
        self._outage = False
        self._outage_t0: float | None = None
        self._outage_first_fail: float | None = None
        self._recoveries: list[dict] = []
        self._unexpected: list[float] = []
        self._rebuilds = 0  # delta-segment seal commits (the reference's
        # record key)
        self._prior_refreshes = 0
        self._client_results: dict[int, list[dict]] = {}
        self._mid: dict | None = None
        self._mid_error: dict | None = None
        self._chunks_arrived = 0
        self._tokens_arrived = 0
        self._losses_fired = 0
        self._t0 = 0.0
        self._deadline = 0.0
        # ---- delta-segment state ----
        self._docs_total = 0  # doc_base of the NEXT sealed segment
        self._served_version = 0  # manifest generation the server serves
        self._commit_times: dict[int, float] = {}  # version -> commit t
        self._swaps: list[dict] = []  # per-refresh commit_to_servable_s
        self._build_intervals: list[tuple[float, float]] = []  # seal spans
        self._merger: sgm.SegmentMerger | None = None
        self.hub = MetricsHub(
            window_s=cfg.window_s,
            latency_slo_s=cfg.slo_p99_ms / 1e3,
            availability_target=cfg.availability_target,
        )

    def _stream_cfg(self) -> TfidfConfig:
        """THE ingest config: bootstrap and every rebuild must build
        under one identical config (one config hash) or the server would
        refuse — or worse, silently change semantics — mid-soak."""
        cfg = self.cfg
        # prefetch/pipeline_depth resolve through the knob ladder (tuned
        # profile for the soak device's backend, else TUNABLE_DEFAULTS) —
        # not re-stated here; pack_target stays pinned to the soak's chunk
        # size (resume discipline: packed chunk indices must be stable
        # across rebuilds)
        return tuned_config(
            TfidfConfig, load_tuned_profile(backend_name(cfg.device)),
            vocab_bits=cfg.vocab_bits, chunk_tokens=cfg.chunk_tokens,
            pack_target_tokens=cfg.chunk_tokens,
        )

    def _take_chunk(self, gen: Iterator[list[str]]) -> list[str]:
        """Pull one arriving doc chunk.  With delta segments each chunk
        is streamed exactly once, so arrivals equal processed volume —
        the counter stays as the record's ingest source of truth."""
        docs = next(gen)
        with self._lock:
            self._chunks_arrived += 1
            self._tokens_arrived += sum(len(d.split()) for d in docs)
        return docs

    # ------------------------------------------------------------ serving

    def _seal_delta(self, delta: list[list[str]], scfg: TfidfConfig) -> int | None:
        """Seal the accumulated delta docs as one immutable segment and
        commit it live (the ingest→servable path: seconds, no rebuild).
        Returns the committed manifest version, or None for an empty
        delta.  The seal's wall span is recorded for the ingest-vs-serve
        contention read-out."""
        t0 = time.perf_counter()
        with obs.span("soak.seal", chunks=len(delta)):
            out = run_tfidf_streaming(iter(delta), scfg,
                                      metrics=MetricsRecorder(),
                                      device=self.cfg.device)
            if out.n_docs < 1:
                return None
            with self._lock:
                base = self._docs_total
            # a neutral mean-1 prior placeholder; the prior-refresh
            # thread hot-swaps a real global PageRank blend on cadence
            ref = sgm.seal_segment(
                self.index_dir, out, scfg, doc_base=base,
                ranks=np.ones(out.n_docs, np.float32), bm25=Bm25Config(),
            )
            version = sgm.commit_append(self.index_dir, ref,
                                        scfg.config_hash())
            # the doc-id range is claimed only once the commit landed: a
            # failed seal/commit retries the SAME base, so the global id
            # space can never gap (a gap would wedge the merger's
            # contiguity check and shift every later prior slice)
            with self._lock:
                self._docs_total = base + out.n_docs
        now = time.perf_counter()
        with self._lock:
            self._rebuilds += 1
            self._commit_times[version] = now
            self._build_intervals.append((t0, now))
        obs.emit("soak_seal", version=version, segment=ref.name,
                 doc_base=base, n_docs=out.n_docs)
        return version

    def _build_server(self) -> serving.TfidfServer:
        """Load the committed segment set and stand up a fully-warmed
        replacement (compiles happen HERE, before any flip — the live
        server keeps serving).  Used at bootstrap and for device-loss
        recovery; routine commits ride refresh_segments instead."""
        segset = serving.load_segment_set(self.index_dir)
        scfg = serving.ServeConfig(
            top_k=self.cfg.top_k,
            max_batch=self.cfg.max_batch,
            queue_depth=max(64, 4 * self.cfg.max_batch),
            prior_alpha=self.cfg.prior_alpha,
            scoring=self.cfg.scoring,
        )
        srv = serving.TfidfServer(segset, scfg,
                                  device=self.cfg.device).start()
        with self._lock:
            self._served_version = segset.version
        return srv

    def _swap_server(self, reason: str) -> None:
        new = self._build_server()
        with self._lock:
            old, self._server = self._server, new
        obs.emit("soak_swap", reason=reason,
                 version=new.index.version, n_docs=new.index.n_docs)
        if old is not None:
            # leftover queued requests fail on stop; their clients retry
            # against the already-live replacement — served, not dropped
            old.stop()

    def _maybe_refresh(self) -> None:
        """Hot-swap the live server onto a newer committed manifest
        generation (a seal commit or a background merge) WITHOUT restart,
        measuring commit→servable per swap."""
        ver = sgm.manifest_version(self.index_dir)
        srv = self._server
        if ver is None or srv is None:
            return
        with self._lock:
            if ver == self._served_version:
                return
        segset = serving.load_segment_set(self.index_dir)
        srv.refresh_segments(segset)
        now = time.perf_counter()
        with self._lock:
            t_commit = self._commit_times.pop(segset.version, None)
            # generations the swap skipped past (burst of commits) are
            # served by this refresh too — drop their stale timestamps
            for v in [v for v in self._commit_times if v < segset.version]:
                self._commit_times.pop(v, None)
            self._served_version = segset.version
            self._swaps.append({
                "version": segset.version,
                "segments": len(segset.segments),
                # merges carry no recorded commit time (the merger owns
                # its own commit); seal commits measure end to end
                "commit_to_servable_s": (
                    round(now - t_commit, 3) if t_commit is not None
                    else None
                ),
            })
        obs.emit("soak_refresh", version=segset.version,
                 segments=len(segset.segments), n_docs=segset.n_docs)

    # ------------------------------------------------------------- chaos

    def _fire_loss(self, now_s: float) -> None:
        env_spec = os.environ.get("GRAFT_CHAOS") or ""
        spec = ";".join(
            s for s in (env_spec, "serve_dispatch:lost@1+") if s
        )
        ctx = chaos.inject(spec)
        ctx.__enter__()
        with self._lock:
            self._chaos_ctx = ctx
            self._outage = True
            self._outage_t0 = time.perf_counter()
            self._outage_first_fail = None
            self._losses_fired += 1
        obs.emit("soak_loss_injected", at_s=round(now_s, 3),
                 loss=self._losses_fired)

    def _recover(self, reason: str, anchor: float) -> None:
        """Replace the lost device: lift the dead-device chaos plan (the
        replacement chip), rebuild a warm server from the last committed
        index version, swap, and probe until a request is served again.
        The measured span is anchored at the FIRST observed failure —
        detection latency is part of the SLO, not an excuse."""
        with obs.span("soak.recover", reason=reason):
            with self._lock:
                ctx, self._chaos_ctx = self._chaos_ctx, None
            if ctx is not None:
                ctx.__exit__(None, None, None)
            self._swap_server(reason=f"recover:{reason}")
            srv = self._server
            assert srv is not None
            srv.query(["soak", "recovery", "probe"],
                      timeout=self.cfg.request_timeout_s)
        t_rec = time.perf_counter() - anchor
        with self._lock:
            self._outage = False
            self._recoveries.append({
                "at_s": round(time.perf_counter() - self._t0, 3),
                "reason": reason,
                "time_to_recover_s": round(t_rec, 3),
            })
        obs.emit("soak_recovered", reason=reason,
                 time_to_recover_s=round(t_rec, 3))
        # stale failure notifications from the outage window are handled
        while True:
            try:
                self._failures.get_nowait()
            except queue.Empty:
                break

    # ------------------------------------------------------------ threads

    def _ingest_loop(self, gen: Iterator[list[str]]) -> None:
        """Stream arrivals and seal each accumulated DELTA as a segment
        on cadence.  Nothing is ever re-streamed: ``pending`` holds only
        chunks that arrived since the last seal — the retired full-rebuild
        path re-ingested the whole accumulated corpus every version, which
        is also why its chunk accounting needed an arrivals-vs-reprocess
        split; here processed == arrived by construction."""
        cfg = self.cfg
        scfg = self._stream_cfg()
        pending: list[list[str]] = []
        next_seal = self._t0 + cfg.rebuild_every_s
        while not self._stop.is_set():
            pending.append(self._take_chunk(gen))
            if time.perf_counter() >= next_seal and pending:
                delta, pending = pending, []
                try:
                    self._seal_delta(delta, scfg)
                except Exception as exc:  # noqa: BLE001 — a failed seal
                    # must not kill ingest: the delta rejoins the queue
                    # and the next tick retries it
                    pending = delta + pending
                    obs.emit("soak_seal_failed",
                             error=f"{type(exc).__name__}: {exc}"[:160])
                next_seal = time.perf_counter() + cfg.rebuild_every_s
            else:
                self._stop.wait(cfg.chunk_interval_s)

    def _prior_loop(self) -> None:
        cfg = self.cfg
        k = 0
        while not self._stop.wait(cfg.prior_refresh_every_s):
            srv = self._server
            if srv is None:
                continue
            try:
                n = srv.index.n_docs
                ranks = _prior_ranks(n, cfg.seed + 1000 + k, cfg.prior_iters,
                                     cfg.device)
                srv.set_prior(ranks)
                with self._lock:
                    self._prior_refreshes += 1
                obs.emit("soak_prior_refresh", n_docs=n, refresh=k)
            except Exception as exc:  # noqa: BLE001 — the server may have
                # been swapped/stopped under us; the next tick hits the
                # replacement
                obs.emit("soak_prior_refresh_skipped",
                         error=f"{type(exc).__name__}: {exc}"[:160])
            k += 1

    def _client_loop(self, idx: int) -> None:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 997 + idx)
        interval = cfg.clients / cfg.qps
        next_t = time.perf_counter() + float(rng.uniform(0, interval))
        # registered up front and appended in place: a client still blocked
        # in fut.result() past the join timeout must not silently drop its
        # completed requests from the dropped/double-served audit
        results: list[dict] = []
        with self._lock:
            self._client_results[idx] = results
        while not self._client_stop.is_set():
            now = time.perf_counter()
            if now < next_t:
                self._client_stop.wait(min(next_t - now, 0.05))
                continue
            next_t = max(next_t + interval, now)  # no burst after stalls
            r = float(rng.random())
            ranker = "tfidf" if r < 0.5 else ("bm25" if r < 0.8 else "prior")
            terms = [f"w{int(rng.zipf(1.3)) % _VOCAB_WORDS}"
                     for _ in range(int(rng.integers(2, 5)))]
            rec: dict = {"ranker": ranker, "attempts": 0, "ok": False,
                         "abandoned": []}
            t_begin = time.perf_counter()
            hard_deadline = self._deadline + cfg.grace_s
            while True:
                rec["attempts"] += 1
                fut = None
                try:
                    srv = self._server
                    if srv is None:
                        raise RuntimeError("no live server")
                    fut = srv.submit(terms, ranker=ranker)
                    fut.result(cfg.request_timeout_s)
                    rec["ok"] = True
                    break
                except Exception as exc:  # noqa: BLE001 — every failure
                    # class retries: outage, swap race, queue drain
                    if fut is not None and not fut.done:
                        # timed out but still in flight: if the old server
                        # later resolves it AND the retry also lands, that
                        # is a double-serve — measured at merge time
                        rec["abandoned"].append(fut)
                    self._failures.put((time.perf_counter(), exc))
                    if (rec["attempts"] >= cfg.retry_limit
                            or time.perf_counter() >= hard_deadline):
                        break
                    time.sleep(0.15)
            rec["e2e_s"] = time.perf_counter() - t_begin
            # absolute span for the ingest-vs-serve contention read-out
            # (_score buckets requests by overlap with seal-build spans)
            rec["t_begin"] = t_begin
            rec["t_end"] = time.perf_counter()
            results.append(rec)

    # --------------------------------------------------------- supervisor

    def _maybe_mid_snapshot(self, exporter: MetricsExporter,
                            now_s: float) -> None:
        if self._mid is not None or self._outage:
            return
        if now_s < self.cfg.duration_s / 2:
            return
        direct = self.hub.snapshot()
        if (direct["latency_s"]["window"]["p99"] is None
                and now_s < 0.8 * self.cfg.duration_s):
            return  # no traffic in the window yet; try again shortly
        try:
            with urllib.request.urlopen(
                exporter.url + "/snapshot.json", timeout=5
            ) as resp:
                http = json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001 — endpoint death must not
            # kill the soak; remember the failure but keep RETRYING on
            # later ticks (a single timed-out fetch must not latch as the
            # round's mid snapshot while the endpoint is healthy)
            self._mid_error = {"at_s": round(now_s, 3),
                               "error": f"{type(exc).__name__}: {exc}"[:160]}
            return
        # The HTTP snapshot was computed BETWEEN two direct reads of the
        # same hub.  The rolling window can legitimately move inside that
        # bracket — a retried request (one deterministic ~50–75 ms
        # backoff) completing mid-fetch, or a ring slot expiring — and at
        # window counts where p99 is effectively the max, one such sample
        # flips the quantile.  Comparing the HTTP read against only the
        # PRE-fetch direct read then manufactures a phantom disagreement
        # between two different moments of one instrument.  Bracket it:
        # re-read after the fetch; while the window is still swinging (and
        # there is run left) retry on a later tick, else record the
        # bracket endpoint closest in time-content to the HTTP read.
        direct2 = self.hub.snapshot()
        d1 = direct["latency_s"]["window"]["p99"]
        d2 = direct2["latency_s"]["window"]["p99"]
        hp = http["latency_s"]["window"]["p99"]
        if (d1 is not None and d2 is not None and d1 != d2
                and now_s < 0.8 * self.cfg.duration_s
                and abs(d1 - d2) > 0.2 * max(d1, d2)):
            return  # window moved mid-measurement; try again shortly
        dbest = d1
        if hp is not None and d2 is not None and (
            d1 is None or abs(d2 - hp) <= abs(d1 - hp)
        ):
            dbest = d2
        self._mid = {
            "at_s": round(now_s, 3),
            "http_p99_ms": _ms(hp),
            "direct_p99_ms": _ms(dbest),
            "window_count": http["latency_s"]["window"]["count"],
        }

    def run(self) -> dict:
        cfg = self.cfg
        sink = TelemetrySink(self.hub)
        obs.bus().attach(sink)
        port = (cfg.metrics_port if cfg.metrics_port is not None
                else (metrics_port_from_env() or 0))
        exporter = MetricsExporter(self.hub, port=port).start()
        gen = _doc_chunks(cfg)
        try:
            # ---- bootstrap: first sealed segment + first warm server ----
            with obs.span("soak.bootstrap"):
                boot = [self._take_chunk(gen)
                        for _ in range(cfg.bootstrap_chunks)]
                scfg = self._stream_cfg()
                self._seal_delta(boot, scfg)
                self._server = self._build_server()
                ranks = _prior_ranks(self._server.index.n_docs, cfg.seed,
                                     cfg.prior_iters, cfg.device)
                self._server.set_prior(ranks)
            self._merger = sgm.SegmentMerger(
                self.index_dir, scfg,
                max_segments=cfg.max_live_segments,
                interval_s=cfg.merge_interval_s, device=cfg.device,
            ).start()
            self._t0 = time.perf_counter()
            self._deadline = self._t0 + cfg.duration_s
            obs.emit("soak_start", duration_s=cfg.duration_s, qps=cfg.qps,
                     clients=cfg.clients, port=exporter.port)

            loss_times = []
            if cfg.losses > 0:
                first = (cfg.loss_at_s if cfg.loss_at_s is not None
                         else cfg.duration_s / 3.0)
                first = min(first, 0.6 * cfg.duration_s)
                spacing = max(
                    (0.6 * cfg.duration_s - first) / max(cfg.losses - 1, 1),
                    5.0,
                )
                loss_times = [first + i * spacing for i in range(cfg.losses)]

            threads = [
                threading.Thread(target=self._ingest_loop,
                                 args=(gen,), name="soak-ingest",
                                 daemon=True),
                threading.Thread(target=self._prior_loop,
                                 name="soak-prior", daemon=True),
            ] + [
                threading.Thread(target=self._client_loop, args=(i,),
                                 name=f"soak-client-{i}", daemon=True)
                for i in range(cfg.clients)
            ]
            for t in threads:
                t.start()
            clients = threads[2:]

            # ---- the supervisor loop (runs through the grace window so
            # a loss injected late still recovers before scoring) ----
            while True:
                now = time.perf_counter()
                now_s = now - self._t0
                if now >= self._deadline:
                    self._client_stop.set()
                    if all(not c.is_alive() for c in clients):
                        break
                    if now >= self._deadline + cfg.grace_s + 5.0:
                        break  # clients wedged past grace: score what we have
                if loss_times and now_s >= loss_times[0] and not self._outage:
                    loss_times.pop(0)
                    self._fire_loss(now_s)
                try:
                    t_fail, _exc = self._failures.get(timeout=0.05)
                except queue.Empty:
                    t_fail = None
                if t_fail is not None:
                    if self._outage:
                        if self._outage_first_fail is None:
                            self._outage_first_fail = t_fail
                        # the loss has bitten: recover (detection latency
                        # included in the measured span)
                        self._recover("device_loss",
                                      anchor=self._outage_first_fail)
                    else:
                        self._unexpected.append(t_fail)
                        recent = [t for t in self._unexpected
                                  if now - t < 5.0]
                        self._unexpected = recent
                        if len(recent) >= 3:
                            self._unexpected = []
                            self._recover("unexpected", anchor=recent[0])
                if not self._outage:
                    # a newer committed manifest (seal or merge) hot-swaps
                    # onto the RUNNING server — no rebuild, no restart
                    try:
                        self._maybe_refresh()
                    except Exception as exc:  # noqa: BLE001 — a failed
                        # refresh leaves the previous set serving; the
                        # next supervisor tick retries the load/swap
                        obs.emit("soak_refresh_failed",
                                 error=f"{type(exc).__name__}: {exc}"[:160])
                self._maybe_mid_snapshot(exporter, now_s)

            actual_s = time.perf_counter() - self._t0
            self._stop.set()
            threads[0].join(timeout=60.0)
            threads[1].join(timeout=30.0)
            for c in clients:
                c.join(timeout=5.0)
            time.sleep(0.3)  # let abandoned futures settle before auditing
            return self._score(actual_s, exporter)
        finally:
            self._stop.set()
            self._client_stop.set()
            if self._merger is not None:
                self._merger.stop()
            with self._lock:
                ctx, self._chaos_ctx = self._chaos_ctx, None
            if ctx is not None:
                ctx.__exit__(None, None, None)
            srv, self._server = self._server, None
            if srv is not None:
                srv.stop()
            exporter.stop()
            obs.bus().detach(sink)

    # ------------------------------------------------------------- scoring

    def _score(self, actual_s: float, exporter: MetricsExporter) -> dict:
        with self._lock:
            per_client = dict(self._client_results)
            recoveries = list(self._recoveries)
            rebuilds = self._rebuilds
            prior_refreshes = self._prior_refreshes
            losses_fired = self._losses_fired
            chunks_arrived = self._chunks_arrived
            tokens_arrived = self._tokens_arrived
            mid = self._mid or self._mid_error
            swaps = list(self._swaps)
            build_ivs = list(self._build_intervals)
            served_version = self._served_version
        recs = [r for results in per_client.values() for r in results]
        dropped = 0
        double_served = 0
        mixed: dict[str, int] = {"tfidf": 0, "bm25": 0, "prior": 0}
        e2e_ok: list[float] = []
        attempts = 0
        for r in recs:
            attempts += r["attempts"]
            mixed[r["ranker"]] += 1
            served = int(r["ok"]) + sum(
                1 for f in r["abandoned"] if f.done and f.error is None
            )
            if served == 0:
                dropped += 1
            double_served += max(served - 1, 0)
            if r["ok"]:
                e2e_ok.append(r["e2e_s"])
        e2e_ok.sort()

        # ---- ingest-vs-serve contention: client e2e latency bucketed by
        # whether the request overlapped a seal-build span ----
        during: list[float] = []
        idle: list[float] = []
        for r in recs:
            if not r["ok"] or "t_begin" not in r:
                continue
            overlapped = any(r["t_begin"] < b and r["t_end"] > a
                             for a, b in build_ivs)
            (during if overlapped else idle).append(r["e2e_s"])
        during.sort()
        idle.sort()
        contention = {
            "during_ingest_requests": len(during),
            "during_ingest_p99_ms": _ms(percentile(during, 0.99)),
            "idle_requests": len(idle),
            "idle_p99_ms": _ms(percentile(idle, 0.99)),
            "ingest_busy_frac": round(
                sum(b - a for a, b in build_ivs) / max(actual_s, 1e-9), 4
            ),
        }
        c2s = [s["commit_to_servable_s"] for s in swaps
               if s.get("commit_to_servable_s") is not None]

        snap = self.hub.snapshot()
        win = snap["latency_s"]["window"]
        tot = snap["latency_s"]["total"]
        counters = snap["counters"]

        def _ctr(name: str) -> int:
            return int(counters.get(name, {}).get("total", 0))

        version = 0
        latest = serving_latest_version(self.index_dir)
        if latest is not None:
            version = latest
        record = {
            "duration_s": round(actual_s, 3),
            "requests": len(recs),
            "attempts": attempts,
            "qps": round(len(e2e_ok) / actual_s, 3) if actual_s > 0 else 0.0,
            "served_p50_ms": _ms(win["p50"]),
            "served_p95_ms": _ms(win["p95"]),
            "served_p99_ms": _ms(win["p99"]),
            "served_p99_cumulative_ms": (
                _ms(tot["p99"]) if tot["count"] else None
            ),
            "client_e2e_p99_ms": _ms(percentile(e2e_ok, 0.99)),
            "error_budget": snap["budgets"],
            "errors": _ctr("serve.errors"),
            "recovery": {
                "losses_injected": losses_fired,
                "recoveries": recoveries,
                "time_to_recover_s": (
                    max(r["time_to_recover_s"] for r in recoveries)
                    if recoveries else None
                ),
            },
            "dropped": dropped,
            "double_served": double_served,
            "ingest": {
                # arrivals == processed volume: the delta-segment path
                # streams each chunk exactly ONCE
                "chunks": chunks_arrived,
                "tokens": tokens_arrived,
                "mode": "segments",
                "rebuilds": rebuilds,  # delta-segment seal commits
                "merges": self._merger.merges if self._merger else 0,
                "live_segments": (
                    len(m.segments)
                    if (m := sgm.latest_manifest(self.index_dir)) else 0
                ),
                "prior_refreshes": prior_refreshes,
                "index_version": version,
                "served_version": served_version,
                # seal commit -> segment servable on the RUNNING server,
                # per hot-swap (seconds, not a rebuild)
                "commit_to_servable_s": {
                    "max": max(c2s) if c2s else None,
                    "mean": (round(sum(c2s) / len(c2s), 3)
                             if c2s else None),
                    "swaps": len(swaps),
                },
            },
            "contention": contention,
            "chaos_injections": _ctr("chaos.injections"),
            "chaos_losses": _ctr("chaos.losses"),
            "mixed_traffic": mixed,
            "slo_targets": {
                "p99_ms": self.cfg.slo_p99_ms,
                "availability": self.cfg.availability_target,
                "window_s": self.cfg.window_s,
            },
            "endpoint": {"port": exporter.port, "mid": mid},
            "backend": backend_name(self.cfg.device),
        }
        obs.emit("slo", **record)
        return record


def serving_latest_version(index_dir: str) -> int | None:
    """Version number behind the LATEST pointer — the manifest generation
    for a segmented directory, the array-dir version for a plain one
    (None when nothing has committed yet)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import (
        checkpoint as ckpt,
    )

    ver = sgm.manifest_version(index_dir)
    if ver is not None:
        return ver
    path = ckpt.latest_array_dir(index_dir)
    if path is None:
        return None
    return int(os.path.basename(path).lstrip("v"))


# ==========================================================================
# fleet soak: the same SLO-scored scenario run against the
# multi-PROCESS serving fabric instead of one in-process server
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class FleetSoakConfig:
    """One fleet-soak scenario: N replica processes behind the consistent-
    hash router, continuous delta-segment ingest (each replica hot-swaps
    via its own manifest poll loop), closed-loop clients through
    ``ServingFabric.query`` (sibling re-dispatch under the same request
    id), one replica SIGKILL mid-run, and one rolling restart under a
    committed generation floor — scored on the SAME SLO record shape as
    :func:`run_soak` so ``tools/trace_report`` / ``tools/trace_diff``
    work unchanged."""

    duration_s: float = 45.0  # * GRAFT_SOAK_DURATION_S
    qps: float = 12.0  # * GRAFT_SOAK_QPS — aggregate closed-loop target
    replicas: int = 2  # * GRAFT_FABRIC_REPLICAS
    slo_p99_ms: float = 2000.0  # * GRAFT_SOAK_SLO_P99_MS — cross-process
    # hop + retry ladder: looser than the in-process soak by design
    availability_target: float = 0.99  # * GRAFT_SOAK_SLO_AVAILABILITY
    clients: int = 2
    window_s: float = 120.0  # rolling SLO window
    rebuild_every_s: float = 10.0  # delta-segment seal/commit cadence
    chunk_interval_s: float = 0.5
    kill_at_s: float | None = None  # replica-0 SIGKILL; default duration/3
    roll_at_s: float | None = None  # rolling restart; default 2·duration/3
    request_timeout_s: float = 30.0  # client-side budget per logical query
    grace_s: float = 20.0
    seed: int = 11
    vocab_bits: int = 12
    docs_per_chunk: int = 24
    tokens_per_doc: int = 40
    chunk_tokens: int = 1 << 12
    bootstrap_chunks: int = 3
    top_k: int = 10
    scoring: str = "coo"
    retry_limit: int = 120  # router re-dispatch budget per request
    retry_pause_s: float = 0.25
    # --- stepped-load autoscale scenario ------------------------------
    # With ``autoscale=True`` the fleet starts at ONE replica and an
    # :class:`~.fabric.Autoscaler` (reading only the federated hub) owns
    # fleet size: clients stay quiet until ``step_at_s``, hammer at full
    # qps until ``idle_at_s``, then go quiet again — the burst's real
    # latencies burn the (deliberately tight) fleet latency budget and
    # scale 1→``replicas``; the idle tail drains the metrics window and
    # scales back down.  SIGKILL/rolling-restart default OFF here: the
    # scale events ARE the membership chaos being audited.
    autoscale: bool = False
    step_at_s: float | None = None  # burst start; default duration/4
    idle_at_s: float | None = None  # burst end; default 0.55 * duration
    cooldown_s: float = 4.0  # * GRAFT_AUTOSCALE_COOLDOWN_S via from_env
    fleet_window_s: float = 10.0  # fleet + replica metrics window —
    # short on purpose so the idle tail's rate/burn decay fits the soak
    autoscale_latency_slo_ms: float = 0.1  # fleet latency budget bound:
    # tighter than any real cross-process serve, so burst traffic burns
    # it hard and the scaler sees genuine measured pressure
    device: str = DEFAULT_DEVICE  # the replicas' and the ingest stream's
    # torch device: cuda unless the caller asks for the CPU

    def __post_init__(self) -> None:
        if self.duration_s <= 0 or self.qps <= 0 or self.clients < 1:
            raise ValueError("duration_s, qps and clients must be positive")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.autoscale and self.replicas < 2:
            raise ValueError("autoscale soak needs replicas >= 2 "
                             "(the scale-up target)")
        if not 0.0 < self.availability_target < 1.0:
            raise ValueError("availability_target must be in (0, 1)")

    @classmethod
    def from_env(cls, **overrides: Any) -> "FleetSoakConfig":
        env: dict[str, Any] = {}
        raw = os.environ.get("GRAFT_SOAK_DURATION_S")
        if raw:
            env["duration_s"] = float(raw)
        raw = os.environ.get("GRAFT_SOAK_QPS")
        if raw:
            env["qps"] = float(raw)
        raw = os.environ.get("GRAFT_FABRIC_REPLICAS")
        if raw:
            env["replicas"] = int(raw)
        raw = os.environ.get("GRAFT_SOAK_SLO_P99_MS")
        if raw:
            env["slo_p99_ms"] = float(raw)
        raw = os.environ.get("GRAFT_SOAK_SLO_AVAILABILITY")
        if raw:
            env["availability_target"] = float(raw)
        raw = os.environ.get("GRAFT_AUTOSCALE_COOLDOWN_S")
        if raw:
            env["cooldown_s"] = float(raw)
        env.update(overrides)
        return cls(**env)


class _FleetSoak:
    """One fleet-soak run.  The supervisor owns the calling thread and
    fires the chaos timeline (SIGKILL, rolling restart); the ingest and
    client workers are daemon threads.  Cross-thread counters live under
    ``self._lock``; the fabric's own state is behind its own lock."""

    def __init__(self, cfg: FleetSoakConfig, index_dir: str):
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            fabric as fab,
        )

        self.cfg = cfg
        self.index_dir = index_dir
        self._fab_mod = fab
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._client_stop = threading.Event()
        self.fabric: fab.ServingFabric | None = None
        self._client_results: dict[int, list[dict]] = {}
        self._chunks_arrived = 0
        self._tokens_arrived = 0
        self._seals = 0
        self._docs_total = 0
        self._t0 = 0.0
        # router-side delivery ledger, snapshotted by run() right before
        # fabric.stop() tears the fleet down
        self._last_audit: dict | None = None
        # stepped-load gate: clients only send while set (always set in
        # the classic scenario; run() steps it in autoscale mode)
        self._load_on = threading.Event()
        if not cfg.autoscale:
            self._load_on.set()
        self._scaler_stats: dict | None = None
        self._fleet_final: dict | None = None
        # sharded-cache tallies summed over the final /status sweep,
        # snapshotted with the audit before stop() tears the fleet down
        self._cache_final: dict | None = None
        self.hub = MetricsHub(
            window_s=cfg.window_s,
            latency_slo_s=cfg.slo_p99_ms / 1e3,
            availability_target=cfg.availability_target,
        )

    def _fleet_stream_cfg(self) -> TfidfConfig:
        cfg = self.cfg
        return tuned_config(
            TfidfConfig, load_tuned_profile(backend_name(cfg.device)),
            vocab_bits=cfg.vocab_bits, chunk_tokens=cfg.chunk_tokens,
            pack_target_tokens=cfg.chunk_tokens,
        )

    def _fleet_seal_delta(self, delta: list[list[str]],
                    scfg: TfidfConfig) -> int | None:
        """Seal the accumulated delta as one immutable segment and commit
        it.  Nobody swaps here: every REPLICA notices the new manifest
        generation on its own poll loop and hot-swaps independently —
        that decoupling is the point of the fabric."""
        out = run_tfidf_streaming(iter(delta), scfg,
                                  metrics=MetricsRecorder(),
                                  device=self.cfg.device)
        if out.n_docs < 1:
            return None
        with self._lock:
            base = self._docs_total
        ref = sgm.seal_segment(
            self.index_dir, out, scfg, doc_base=base,
            ranks=np.ones(out.n_docs, np.float32), bm25=Bm25Config(),
        )
        version = sgm.commit_append(self.index_dir, ref,
                                    scfg.config_hash())
        with self._lock:
            self._docs_total = base + out.n_docs
            self._seals += 1
        obs.emit("fleet_seal", version=version, segment=ref.name,
                 doc_base=base, n_docs=out.n_docs)
        return version

    def _fleet_ingest_loop(self, gen: Iterator[list[str]]) -> None:
        cfg = self.cfg
        scfg = self._fleet_stream_cfg()
        pending: list[list[str]] = []
        next_seal = time.perf_counter() + cfg.rebuild_every_s
        while not self._stop.is_set():
            docs = next(gen)
            with self._lock:
                self._chunks_arrived += 1
                self._tokens_arrived += sum(len(d.split()) for d in docs)
            pending.append(docs)
            if time.perf_counter() >= next_seal and pending:
                delta, pending = pending, []
                try:
                    self._fleet_seal_delta(delta, scfg)
                except Exception as exc:  # noqa: BLE001 — the delta
                    # rejoins the queue; the next tick retries it
                    pending = delta + pending
                    obs.emit("fleet_seal_failed",
                             error=f"{type(exc).__name__}: {exc}"[:160])
                next_seal = time.perf_counter() + cfg.rebuild_every_s
            else:
                self._stop.wait(cfg.chunk_interval_s)

    def _fleet_client_loop(self, idx: int) -> None:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1013 + idx)
        interval = cfg.clients / cfg.qps
        next_t = time.perf_counter() + float(rng.uniform(0, interval))
        results: list[dict] = []
        with self._lock:
            self._client_results[idx] = results
        while not self._client_stop.is_set():
            if not self._load_on.is_set():
                # stepped load: idle phase — and re-arm the pacing clock
                # so the burst starts at full qps, not with a backlog of
                # catch-up sends
                self._client_stop.wait(0.05)
                next_t = time.perf_counter() + float(
                    rng.uniform(0, interval))
                continue
            now = time.perf_counter()
            if now < next_t:
                self._client_stop.wait(min(next_t - now, 0.05))
                continue
            next_t = max(next_t + interval, now)
            ranker = "tfidf" if rng.random() < 0.7 else "bm25"
            terms = [f"w{int(rng.zipf(1.3)) % _VOCAB_WORDS}"
                     for _ in range(int(rng.integers(2, 5)))]
            rec: dict = {"ranker": ranker, "ok": False}
            t_begin = time.perf_counter()
            err: str | None = None
            try:
                fabric = self.fabric
                if fabric is None:
                    raise RuntimeError("no fabric")
                # the fabric retries internally: sibling re-dispatch
                # under the SAME request id, so a replica dying mid-query
                # is invisible here (or a typed FabricExhausted)
                fabric.query(terms, ranker=ranker,
                             timeout=cfg.request_timeout_s)
                rec["ok"] = True
            except Exception as exc:  # noqa: BLE001 — exhausted/refused
                err = f"{type(exc).__name__}: {exc}"[:160]
            rec["e2e_s"] = time.perf_counter() - t_begin
            # the ROUTER process is where fleet latency is observed:
            # feed the hub through the same serve_request event the
            # in-process server publishes (TelemetrySink contract)
            obs.emit("serve_request", total_s=rec["e2e_s"], error=err)
            results.append(rec)

    def run(self) -> dict:
        cfg = self.cfg
        sink = TelemetrySink(self.hub)
        obs.bus().attach(sink)
        gen = _doc_chunks(cfg)
        fab = self._fab_mod
        recoveries: list[dict] = []
        kills = 0
        roll: dict | None = None
        scaler: fab.Autoscaler | None = None
        try:
            with obs.span("fleet.bootstrap"):
                boot = [next(gen) for _ in range(cfg.bootstrap_chunks)]
                with self._lock:
                    self._chunks_arrived += cfg.bootstrap_chunks
                    self._tokens_arrived += sum(
                        len(d.split()) for c in boot for d in c
                    )
                self._fleet_seal_delta(boot, self._fleet_stream_cfg())
                fabric_cfg = fab.FabricConfig(
                    replicas=1 if cfg.autoscale else cfg.replicas,
                    top_k=cfg.top_k,
                    scoring=cfg.scoring,
                    retry_limit=cfg.retry_limit,
                    retry_pause_s=cfg.retry_pause_s,
                    grace_s=cfg.grace_s,
                    device=cfg.device,
                )
                if cfg.autoscale:
                    # the scaler reads ONLY the federated hub, so the
                    # fleet must carry real budgets: a tight latency SLO
                    # the burst will burn, the scenario's availability
                    # target, and a short window the idle tail can drain
                    fabric_cfg = dataclasses.replace(
                        fabric_cfg,
                        fleet_window_s=cfg.fleet_window_s,
                        latency_slo_s=cfg.autoscale_latency_slo_ms / 1e3,
                        availability_target=cfg.availability_target,
                    )
                self.fabric = fab.ServingFabric(
                    self.index_dir, fabric_cfg,
                ).start()
            if cfg.autoscale:
                scaler = fab.Autoscaler(self.fabric, fab.AutoscaleConfig(
                    min_replicas=1, max_replicas=cfg.replicas,
                    cooldown_s=cfg.cooldown_s, period_s=0.5,
                    idle_rate_down=0.5, idle_hold_s=2.0,
                )).start()
            self._t0 = time.perf_counter()
            deadline = self._t0 + cfg.duration_s
            # autoscale mode: scale events are the membership chaos; the
            # SIGKILL/rolling-restart timeline stays opt-in via explicit
            # kill_at_s / roll_at_s
            kill_at = (cfg.kill_at_s if cfg.kill_at_s is not None
                       else None if cfg.autoscale else cfg.duration_s / 3.0)
            roll_at = (cfg.roll_at_s if cfg.roll_at_s is not None
                       else None if cfg.autoscale
                       else 2.0 * cfg.duration_s / 3.0)
            step_at = ((cfg.step_at_s if cfg.step_at_s is not None
                        else cfg.duration_s / 4.0)
                       if cfg.autoscale else None)
            idle_at = ((cfg.idle_at_s if cfg.idle_at_s is not None
                        else 0.55 * cfg.duration_s)
                       if cfg.autoscale else None)
            obs.emit("fleet_soak_start", duration_s=cfg.duration_s,
                     qps=cfg.qps, replicas=cfg.replicas,
                     clients=cfg.clients)
            threads = [
                threading.Thread(target=self._fleet_ingest_loop, args=(gen,),
                                 name="fleet-ingest", daemon=True),
            ] + [
                threading.Thread(target=self._fleet_client_loop, args=(i,),
                                 name=f"fleet-client-{i}", daemon=True)
                for i in range(cfg.clients)
            ]
            for t in threads:
                t.start()
            clients = threads[1:]

            killed_pid: int | None = None
            t_kill: float | None = None
            victim = 0
            while time.perf_counter() < deadline:
                now_s = time.perf_counter() - self._t0
                if step_at is not None and now_s >= step_at:
                    step_at = None
                    self._load_on.set()
                    obs.emit("fleet_step", phase="burst",
                             at_s=round(now_s, 3))
                if idle_at is not None and now_s >= idle_at:
                    idle_at = None
                    self._load_on.clear()
                    obs.emit("fleet_step", phase="idle",
                             at_s=round(now_s, 3))
                if kill_at is not None and now_s >= kill_at:
                    kill_at = None
                    killed_pid = self.fabric.kill_replica(victim)
                    t_kill = time.perf_counter()
                    kills += 1
                if t_kill is not None:
                    # recovery = SIGKILL → the victim's REPLACEMENT is
                    # ready (detection latency included, as in run_soak)
                    s = self.fabric.statuses()[victim]
                    if (s is not None and s.get("ready")
                            and s.get("pid") != killed_pid):
                        recoveries.append({
                            "at_s": round(now_s, 3),
                            "reason": "proc_kill",
                            "time_to_recover_s": round(
                                time.perf_counter() - t_kill, 3),
                        })
                        t_kill = None
                if roll_at is not None and now_s >= roll_at:
                    roll_at = None
                    t_roll = time.perf_counter()
                    try:
                        # blocks in THIS thread; clients keep hammering
                        # the fleet from theirs throughout the roll
                        self.fabric.rolling_restart(timeout=60.0)
                        roll = {"ok": True, "roll_s": round(
                            time.perf_counter() - t_roll, 3)}
                    except Exception as exc:  # noqa: BLE001 — a failed
                        # roll is a scored outcome, not a crashed soak
                        roll = {"ok": False,
                                "error": f"{type(exc).__name__}: {exc}"[:160]}
                time.sleep(0.1)

            actual_s = time.perf_counter() - self._t0
            self._client_stop.set()
            for c in clients:
                c.join(timeout=cfg.request_timeout_s + cfg.grace_s)
            self._stop.set()
            threads[0].join(timeout=60.0)
            # snapshot the ledger (and the scaler's tallies + the fleet
            # board) BEFORE stop() tears the fleet down
            if scaler is not None:
                scaler.stop()
                self._scaler_stats = scaler.stats()
                if self.fabric.fleet is not None:
                    fs = self.fabric.fleet.snapshot()["fleet"]
                    self._fleet_final = {
                        "replicas": len(fs["replicas"]),
                        "stale": len(fs["stale"]),
                        "scrapes": fs["scrapes"],
                        "scrape_errors": fs["scrape_errors"],
                    }
            self._last_audit = self.fabric.audit()
            sts = [s for s in self.fabric.statuses() if s is not None]
            if sts:
                hits = sum(int(s.get("peer_hits") or 0) for s in sts)
                misses = sum(int(s.get("peer_misses") or 0) for s in sts)
                tos = sum(int(s.get("peek_timeouts") or 0) for s in sts)
                attempts = hits + misses + tos
                self._cache_final = {
                    "peer_hits": hits,
                    "peer_misses": misses,
                    "peek_timeouts": tos,
                    "peer_hit_rate": (round(hits / attempts, 4)
                                      if attempts else None),
                    "fills": sum(int(s.get("fills") or 0) for s in sts),
                    "peer_stores": sum(int(s.get("peer_stores") or 0)
                                       for s in sts),
                    "breakers_open": sum(int(s.get("breaker_open") or 0)
                                         for s in sts),
                }
            return self._score(actual_s, recoveries, kills, roll)
        finally:
            if scaler is not None:
                scaler.stop()
            self._stop.set()
            self._client_stop.set()
            fabric, self.fabric = self.fabric, None
            if fabric is not None:
                fabric.stop()
            obs.bus().detach(sink)

    def _score(self, actual_s: float, recoveries: list[dict],
               kills: int, roll: dict | None) -> dict:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import (
            fabric as fab,
        )

        with self._lock:
            per_client = dict(self._client_results)
            chunks_arrived = self._chunks_arrived
            tokens_arrived = self._tokens_arrived
            seals = self._seals
        recs = [r for results in per_client.values() for r in results]
        e2e_ok = sorted(r["e2e_s"] for r in recs if r["ok"])
        mixed: dict[str, int] = {"tfidf": 0, "bm25": 0, "prior": 0}
        for r in recs:
            mixed[r["ranker"]] += 1
        # the cross-PROCESS delivery audit: the router's request-id
        # ledger (a replica that died mid-query and its sibling retry
        # share one rid; replicas replay, never re-execute)
        audit = self._last_audit or {}
        snap = self.hub.snapshot()
        win = snap["latency_s"]["window"]
        counters = snap["counters"]
        record = {
            "duration_s": round(actual_s, 3),
            "requests": len(recs),
            "attempts": int(audit.get("requests", 0)
                            + audit.get("retries", 0)),
            "qps": round(len(e2e_ok) / actual_s, 3) if actual_s > 0 else 0.0,
            "served_p50_ms": _ms(win["p50"]),
            "served_p95_ms": _ms(win["p95"]),
            "served_p99_ms": _ms(win["p99"]),
            "client_e2e_p99_ms": _ms(percentile(e2e_ok, 0.99)),
            "error_budget": snap["budgets"],
            "errors": int(counters.get("serve.errors", {})
                          .get("total", 0)),
            "recovery": {
                "losses_injected": kills,
                "recoveries": recoveries,
                "time_to_recover_s": (
                    max(r["time_to_recover_s"] for r in recoveries)
                    if recoveries else None
                ),
            },
            "dropped": int(audit.get("dropped", 0)),
            "double_served": int(audit.get("double_served", 0)),
            "ingest": {
                "chunks": chunks_arrived,
                "tokens": tokens_arrived,
                "mode": "fleet-segments",
                "rebuilds": seals,
                "index_version": serving_latest_version(self.index_dir),
            },
            "fleet": {
                "replicas": self.cfg.replicas,
                "respawns": int(audit.get("respawns", 0)),
                "rolled": int(audit.get("rolled", 0)),
                "roll": roll,
                "floor": fab.read_floor(self.index_dir),
                "retries": int(audit.get("retries", 0)),
                # the handoff's zero-downtime claim, scored: retries the
                # router attributed to a drain window (0 = no client
                # ever saw a roll)
                "roll_retries": int(audit.get("roll_retries", 0)),
            },
            # sharded result cache: cross-replica hit rate
            # and breaker state over the run — None when the fleet never
            # exchanged a peek (single replica, or peer_cache off)
            "cache": self._cache_final,
            # autoscale scenario read-outs (None in the classic fleet
            # soak): the scaler's decision tallies, the router audit's
            # membership-change counts, and the final fleet board
            "autoscale": (
                None if self._scaler_stats is None else {
                    **self._scaler_stats,
                    "scale_ups": int(audit.get("scale_ups", 0)),
                    "scale_downs": int(audit.get("scale_downs", 0)),
                    "federation": self._fleet_final,
                }
            ),
            "mixed_traffic": mixed,
            "slo_targets": {
                "p99_ms": self.cfg.slo_p99_ms,
                "availability": self.cfg.availability_target,
                "window_s": self.cfg.window_s,
            },
            "backend": backend_name(self.cfg.device),
        }
        obs.emit("slo", **record)
        return record


def run_fleet_soak(cfg: FleetSoakConfig | None = None, *,
                   index_dir: str | None = None) -> dict:
    """Run one FLEET soak scenario — N replica processes behind the
    consistent-hash router, one SIGKILL and one rolling restart under
    load — and return its SLO record (also published as an ``slo`` event
    into any active trace, with a ``fleet`` sub-dict carrying the
    respawn/roll/floor read-outs)."""
    cfg = cfg or FleetSoakConfig.from_env()
    tmp = None
    if index_dir is None:
        tmp = tempfile.mkdtemp(prefix="fleet_idx_")
        index_dir = tmp
    try:
        with obs.span("fleet.run", duration_s=cfg.duration_s):
            return _FleetSoak(cfg, index_dir).run()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def run_soak(cfg: SoakConfig | None = None, *,
             index_dir: str | None = None) -> dict:
    """Run one production-soak scenario and return its SLO record (also
    published as an ``slo`` event into any active trace).  ``index_dir``
    keeps the committed index versions when given; by default they live
    in a temp directory deleted afterwards."""
    cfg = cfg or SoakConfig.from_env()
    tmp = None
    if index_dir is None:
        tmp = tempfile.mkdtemp(prefix="soak_idx_")
        index_dir = tmp
    try:
        with obs.span("soak.run", duration_s=cfg.duration_s):
            return _Soak(cfg, index_dir).run()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
