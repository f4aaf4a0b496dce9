"""Declared contracts of the port's static analysis: the literal half of
the JAX package's ``analysis/registry.py``, read by tiers 1, 4, 5 and 6.

Every table here is a literal that the analyzer parses lexically (it never
imports this module, or anything it scans); the port's tools import it to
share one source of truth.  The tables, in the reference's row formats:

- ``DONATED_CALLEES`` — callees that take or overwrite an argument's
  storage in place (tier 4, ``use-after-donate``);
- ``ARTIFACT_SCHEMAS`` and ``COMMIT_LOCKS`` — every on-disk artifact
  family's key space with its writers and readers, and the lock that
  serializes each read-modify-write commit (tier 5);
- ``WIRE_SCHEMAS`` — the router<->replica HTTP protocol of the serving
  fleet (tier 6, and ``tools/protocol_harness.py``);
- ``METRIC_SCHEMAS`` — every published metric name (tier 1,
  ``metric-name-drift``);
- ``TUNED_KNOBS`` — the autotuner's knob space (``tools/autotune.py``);
- ``ENTRY_POINTS`` — the steps the port dispatches, with their budgets and
  how to trace them (tiers 2 and 3, ``semantic.py``, ``cost.py``; the
  tuner reads the budgets of the entries it prunes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Callable, Sequence

_PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"

# ---------------------------------------------------------------------------
# In-place contract (tier 4).
#
# Each row is ``(callee leaf name as it appears at call sites, positional
# argnums whose storage the callee takes or overwrites, the registry entry
# names the convention serves)``.  Where the JAX package donates a buffer
# to a compiled program, the port updates it in place; a binding passed
# there holds the updated storage once the call returns, so tier 4's
# ``use-after-donate`` flags a later host-side read or re-dispatch of it
# unless the consuming statement rebinds it (``counts, carry =
# kernel(..., carry)``), and flags any such call inside a retry closure,
# whose retry would apply the update twice.
#
# - ``chunk_counts_carry`` (ops/tfidf.py) adds each chunk's document
#   frequencies to the streaming DF carry (argnum 3) in place;
# - ``consume`` (dataflow/ingest.StagingRing) hands a staged ring slot's
#   device copy (argnum 0) to the current stream: the binding returned is
#   the one to use, the staged one may still be landing.  It is no entry
#   point's step, so its row names none.
#
# The third field names the entries the convention serves.  Tier 4
# validates the table against ``ENTRY_POINTS`` in both directions (every
# entry declaring a non-empty ``donate`` is served by a row with its
# argnums; every named entry declares one), and tier 3 checks each
# declaration against the in-place writes of the traced step.  The
# PageRank, PPR, HITS and components runners swap buffers and write no
# input, so they declare ``donate=()`` and no row serves them, where the
# reference's ``runner`` and ``owned_runner`` rows serve its donated
# carries.  Parsed lexically — keep it a literal.
DONATED_CALLEES: tuple = (
    ("chunk_counts_carry", (3,), ("tfidf_chunk_ingest_carry",)),
    ("consume", (0,), ()),
)

# ---------------------------------------------------------------------------
# Persistence contracts (tier 5).
#
# ``ARTIFACT_SCHEMAS`` declares every on-disk artifact family the port
# commits and reloads — the serving index array-dir, the segment manifest,
# checkpoint metadata, the run manifest, the measured cost artifacts, the
# tuned profiles, the fleet's generation floor — as the JAX package's does:
# the lexical surface (which keys writers store, which keys readers load)
# and the declaration may not drift apart in either direction.
#
# Each row is ``(family, writers, readers, keys, aux_keys)``:
#
# - ``writers`` / ``readers`` are ``"<repo-relative path>::<function>"``
#   specs (``Class.method`` allowed for the function part; readers may
#   append ``::<receiver>`` to scope collection to one dict variable);
# - ``keys`` is the family's full declared key space: array members plus
#   META/JSON document keys;
# - ``aux_keys`` (a subset of ``keys``) marks deliberately write-only
#   forensic keys — evidence for humans/ops tooling that no scanned code
#   path loads back.
#
# The tier-5 ``schema-pair-drift`` check validates both directions.
# Parsed lexically — keep it a literal.
ARTIFACT_SCHEMAS: tuple = (
    ("index",
     (f"{_PKG}/serving/artifact.py::save_index",
      f"{_PKG}/serving/segments.py::seal_segment",
      f"{_PKG}/serving/segments.py::merge_segments"),
     (f"{_PKG}/serving/artifact.py::load_index",
      f"{_PKG}/serving/segments.py::load_segment_set",
      f"{_PKG}/serving/segments.py::merge_segments"),
     ("doc", "term", "weight", "idf", "df", "term_offsets", "count",
      "doc_lengths", "ranks", "bm25_weight",
      "format", "n_docs", "vocab_bits", "nnz", "has_ranks", "has_bm25",
      "bm25_config", "tfidf_config", "doc_base", "merged_from"),
     # corpus stats + provenance: ops-facing META evidence; the reader
     # side reconstructs them from SegmentRef/arrays instead
     ("nnz", "has_ranks", "has_bm25", "doc_base", "merged_from")),
    ("segment_manifest",
     (f"{_PKG}/serving/segments.py::_write_manifest",
      f"{_PKG}/serving/segments.py::SegmentRef.to_json"),
     (f"{_PKG}/serving/segments.py::latest_manifest",
      f"{_PKG}/serving/segments.py::_replaced_by",
      f"{_PKG}/serving/segments.py::SegmentRef.from_json"),
     ("version", "config_hash", "n_docs", "nnz", "replaced", "segments",
      "name", "doc_base"),
     ()),
    ("checkpoint_meta",
     (f"{_PKG}/utils/checkpoint.py::save_checkpoint",
      f"{_PKG}/utils/checkpoint.py::save_array_dir"),
     (f"{_PKG}/utils/checkpoint.py::load_checkpoint",
      f"{_PKG}/utils/checkpoint.py::load_array_dir"),
     ("step", "config_hash", "extra"),
     ()),
    ("run_manifest",
     (f"{_PKG}/obs/manifest.py::write_manifest",
      f"{_PKG}/obs/manifest.py::finalize_manifest",
      f"{_PKG}/obs/manifest.py::_device_snapshot"),
     # chip_smoke.py's checks read the manifest back; the repository's
     # stdlib reader tools/trace_report.py (stitch, render_human) reads it
     # too, but lies outside this package's scan surface
     ("chip_smoke.py::check_cli_trace::man",
      "chip_smoke.py::tuned_cli_phase::man"),
     ("name", "status", "pid", "argv", "python", "started_wall",
      "trace_path", "git_sha", "lint_clean", "knobs", "tuned_profile",
      "backend", "devices",
      "device_count", "finished_wall", "wall_secs", "events", "summary"),
     # the SIGKILL-forensics payload, written for humans reading the file,
     # and the identity keys only tools/trace_report.py loads back
     ("name", "pid", "git_sha", "argv", "python", "started_wall",
      "trace_path", "lint_clean", "knobs", "tuned_profile", "devices",
      "device_count", "finished_wall", "wall_secs", "events", "summary")),
    ("cost_artifact",
     (f"{_PKG}/utils/artifacts.py::write_artifact",),
     (f"{_PKG}/utils/artifacts.py::read_backend",),
     ("backend",),
     ()),
    # the autotuner's committed per-backend knob optimum:
    # written durably by the config layer (stage + durable_replace, same
    # provenance guard as the cost artifacts), loaded back through the one
    # knob-resolution ladder every runner uses.  git_sha/created_wall/
    # measured are sweep forensics — the loader carries them for manifests
    # but no code path branches on them.
    ("tuned_profile",
     (f"{_PKG}/utils/config.py::write_tuned_profile",),
     (f"{_PKG}/utils/config.py::load_tuned_profile::record",),
     ("backend", "knobs", "git_sha", "created_wall", "measured"),
     ()),
    # the serving fleet's committed generation floor: one JSON
    # doc next to the segment manifest, staged + durably replaced like
    # every other commit; committed_wall is rollout forensics only
    ("fabric_floor",
     (f"{_PKG}/serving/fabric.py::commit_floor",),
     (f"{_PKG}/serving/fabric.py::read_floor",),
     ("floor", "committed_wall"),
     ("committed_wall",)),
)

# ``COMMIT_LOCKS`` declares which lock serializes each on-disk protocol's
# read-modify-write commit step: ``(module, lock spelled as acquired,
# protected callee leaves)``.  The tier-5 ``commit-lock-drift`` check
# requires every lexical call to a protected callee in that module to sit
# under ``with <lock>``, and validates the declaration itself.  Parsed
# lexically — keep it a literal.
COMMIT_LOCKS: tuple = (
    # manifest generations are read-modify-write: an ingest append and a
    # background merge racing unserialized can resurrect replaced segments
    (f"{_PKG}/serving/segments.py", "_COMMIT_LOCK", ("_write_manifest",)),
)

# ---------------------------------------------------------------------------
# Wire-protocol contract (tier 6).
#
# ``WIRE_SCHEMAS`` declares the router<->replica HTTP protocol the serving
# fleet rides, every endpoint in the reference's row format and with the
# reference's codes and keys: the port's fleet speaks the same wire format.
#
# Each row is ``(endpoint, method, path, handler, readers, request_keys,
# response_keys, aux_response_keys, status_classes)``:
#
# - ``handler`` is a ``"<repo-relative path>::<function>[::<receiver>]"``
#   spec; the optional receiver scopes request-key *reads* to the parsed
#   request dict (``handle_query``'s ``req``);
# - ``readers`` are client-side specs (router/health-loop functions), each
#   optionally receiver-scoped the same way for response-key reads;
# - ``request_keys`` / ``response_keys`` are the full declared key spaces;
# - ``aux_response_keys`` (subset of ``response_keys``) marks evidence
#   keys written for harnesses/operators that no in-package reader loads;
# - ``status_classes`` pairs every status code the endpoint may emit with
#   the router-side class that handles it: ``success``, ``terminal``,
#   ``retryable`` (503-below-floor MUST be here) or ``suspect``.
#
# The tier-6 checks validate both directions, and
# ``tools/protocol_harness.py`` replays the enumerated message space at a
# live replica asserting every observed code is declared.  Parsed
# lexically — keep it a literal.
WIRE_SCHEMAS: tuple = (
    ("query", "POST", "/query",
     f"{_PKG}/serving/fabric.py::_Replica.handle_query::req",
     (f"{_PKG}/serving/fabric.py::ServingFabric.query",),
     ("rid", "terms", "ranker"),
     ("rid", "replica", "generation", "scores", "docs", "error", "floor"),
     # rid/replica/generation: harness- and operator-facing echo; floor:
     # the 503 body's catch-up diagnostic — the router acts on the CODE
     ("rid", "replica", "generation", "floor"),
     ((200, "success"), (400, "terminal"), (503, "retryable"))),
    ("status", "GET", "/status",
     f"{_PKG}/serving/fabric.py::_Replica.handle_status",
     (f"{_PKG}/serving/fabric.py::ServingFabric._health_loop::status",
      f"{_PKG}/serving/fabric.py::ServingFabric.fleet_generation::s",
      f"{_PKG}/serving/fabric.py::ServingFabric.await_fleet_generation::s",
      f"{_PKG}/serving/fabric.py::ServingFabric.rolling_restart::s"),
     (),
     ("replica", "pid", "ready", "generation", "floor", "executions",
      "replays", "p50_ms", "p99_ms", "requests", "cache_hits",
      "refreshes", "peer_hits", "peer_misses", "peek_timeouts", "fills",
      "breaker_open", "peer_stores"),
     # identity + cache forensics: ops-facing, no router branch reads them
     ("replica", "pid", "cache_hits", "refreshes"),
     ((200, "success"),)),
    # sharded-cache peer endpoints.  /cache/peek is a pure
    # read (a miss is a SUCCESS with hit=false — the peeker computes
    # locally; no rid, no side effects); /cache/fill is the idempotent
    # owner write-back (rid-deduped exactly like /query, 503 below the
    # floor so stale fills are refused retryably); /peers is the
    # router's topology push after every membership change.
    ("cache_peek", "POST", "/cache/peek",
     f"{_PKG}/serving/fabric.py::_Replica.handle_cache_peek::req",
     (f"{_PKG}/serving/fabric.py::_Replica._peek_owner::out",),
     ("terms", "ranker"),
     ("hit", "generation", "scores", "docs", "error"),
     # error: the 400 body's diagnostic — the peeker acts on the CODE
     ("error",),
     ((200, "success"), (400, "terminal"))),
    ("cache_fill", "POST", "/cache/fill",
     f"{_PKG}/serving/fabric.py::_Replica.handle_cache_fill::req",
     (f"{_PKG}/serving/fabric.py::_Replica._fill_owner::resp",),
     ("rid", "terms", "ranker", "scores", "docs", "generation"),
     ("stored", "replica", "generation", "error", "floor"),
     # replica/generation: operator-facing echo; error/floor: the
     # 400/503 bodies' diagnostics — the filler acts on the CODE
     ("replica", "generation", "error", "floor"),
     ((200, "success"), (400, "terminal"), (503, "retryable"))),
    ("peers", "POST", "/peers",
     f"{_PKG}/serving/fabric.py::_Replica.handle_peers::req",
     (f"{_PKG}/serving/fabric.py::ServingFabric._push_peers",),
     ("peers", "slots"),
     ("ok", "peers", "error"),
     # the push is fire-and-forget: the router acts on the CODE only
     ("ok", "peers", "error"),
     ((200, "success"), (400, "terminal"))),
    ("healthz", "GET", "/healthz",
     f"{_PKG}/obs/export.py::_dispatch",
     (),
     (), (), (),
     ((200, "success"), (503, "retryable"))),
    ("metrics", "GET", "/metrics",
     f"{_PKG}/obs/export.py::_dispatch",
     (),
     (), (), (),
     ((200, "success"),)),
    ("snapshot", "GET", "/snapshot.json",
     f"{_PKG}/obs/export.py::_dispatch",
     (),
     (), (), (),
     ((200, "success"),)),
    # router-side fleet endpoints: the router's own exporter
    # serves the SAME obs/export.py dispatcher over the FleetHub, so the
    # merged fleet snapshot/metrics reuse the dispatcher's declared code
    # surface; the scrape path is in-contract via its declared reader —
    # FleetHub's fetch consumes a replica's /snapshot.json (whose
    # "mergeable" payload is opaque raw hub state, not wire keys)
    ("fleet_snapshot", "GET", "/snapshot.json",
     f"{_PKG}/obs/export.py::_dispatch",
     (f"{_PKG}/obs/federation.py::FleetHub._http_fetch",),
     (), (), (),
     ((200, "success"),)),
    ("fleet_metrics", "GET", "/metrics",
     f"{_PKG}/obs/export.py::_dispatch",
     (),
     (), (), (),
     ((200, "success"),)),
    # the dispatcher's catch-alls: "/" is the healthz alias, 404 is the
    # out-of-contract rejection, 500 the handler-exception backstop — the
    # conformance harness allows exactly these beyond a row's own codes
    ("fallback", "GET", "/",
     f"{_PKG}/obs/export.py::_dispatch",
     (),
     (), (), (),
     ((200, "success"), (404, "terminal"), (500, "suspect"),
      (503, "retryable"))),
)

# ---------------------------------------------------------------------------
# Metric-name contract (tier 1).
#
# ``METRIC_SCHEMAS`` declares every metric name the port publishes — the
# run-aggregate namespace (``obs.counter/gauge/histogram``) and the
# live-SLO namespace (``MetricsHub`` counters/gauges/budgets) — with the
# JAX package's names: the port's telemetry is read by the same tools.
#
# Each row is ``(name, kind, unit, sites)``: ``name`` may contain ``*`` for
# template-published families; ``kind`` is ``counter`` / ``gauge`` /
# ``histogram`` / ``slo``; ``unit`` is documentation; ``sites`` are the
# repo-relative modules that publish the name.  ``metric-name-drift``
# validates both directions.  Parsed lexically — keep it a literal.
METRIC_SCHEMAS: tuple = (
    # ---- run-aggregate namespace (obs.counter/gauge/histogram)
    ("degraded", "counter", "count",
     (f"{_PKG}/dataflow/fixpoint.py", f"{_PKG}/models/tfidf.py",
      f"{_PKG}/resilience/elastic.py", f"{_PKG}/resilience/executor.py",
      f"{_PKG}/resilience/process.py", f"{_PKG}/obs/metrics.py")),
    ("*.segment_secs", "histogram", "seconds",
     (f"{_PKG}/dataflow/fixpoint.py",)),
    ("h2d_overlap_frac", "gauge", "fraction",
     (f"{_PKG}/dataflow/ingest.py", f"{_PKG}/obs/metrics.py")),
    ("tfidf.chunks", "counter", "count", (f"{_PKG}/models/tfidf.py",)),
    ("tfidf.chunk_secs", "histogram", "seconds",
     (f"{_PKG}/models/tfidf.py",)),
    ("pagerank.comm_bytes_per_step", "gauge", "bytes",
     (f"{_PKG}/parallel/pagerank_sharded.py",)),
    ("chaos_injections", "counter", "count",
     (f"{_PKG}/resilience/chaos.py",)),
    ("watchdog_fires", "counter", "count",
     (f"{_PKG}/resilience/executor.py",)),
    ("retries", "counter", "count", (f"{_PKG}/resilience/executor.py",)),
    ("backoff_secs", "histogram", "seconds",
     (f"{_PKG}/resilience/executor.py",)),
    ("exhausted", "counter", "count",
     (f"{_PKG}/resilience/executor.py", f"{_PKG}/obs/metrics.py")),
    ("respawns", "counter", "count", (f"{_PKG}/resilience/process.py",)),
    ("fabric_replica*_requests", "gauge", "requests",
     (f"{_PKG}/serving/fabric.py",)),
    # sharded-cache + drain-handoff instruments
    ("cache_peer_hits", "counter", "count",
     (f"{_PKG}/serving/fabric.py",)),
    ("cache_peer_misses", "counter", "count",
     (f"{_PKG}/serving/fabric.py",)),
    ("cache_peek_timeouts", "counter", "count",
     (f"{_PKG}/serving/fabric.py",)),
    ("cache_fills", "counter", "count",
     (f"{_PKG}/serving/fabric.py",)),
    ("cache_fill_errors", "counter", "count",
     (f"{_PKG}/serving/fabric.py",)),
    ("cache_breaker_transitions", "counter", "count",
     (f"{_PKG}/serving/fabric.py",)),
    ("cache_peek_s", "histogram", "seconds",
     (f"{_PKG}/serving/fabric.py",)),
    ("fabric_drain_s", "histogram", "seconds",
     (f"{_PKG}/serving/fabric.py",)),
    ("fabric_handoff_s", "histogram", "seconds",
     (f"{_PKG}/serving/fabric.py",)),
    ("segment_commits", "counter", "count",
     (f"{_PKG}/serving/segments.py",)),
    ("segment_orphan_gcs", "counter", "count",
     (f"{_PKG}/serving/segments.py",)),
    ("segment_merges", "counter", "count",
     (f"{_PKG}/serving/segments.py",)),
    ("segment_merge_failures", "counter", "count",
     (f"{_PKG}/serving/segments.py",)),
    ("serve.cache_misses", "counter", "count",
     (f"{_PKG}/serving/server.py",)),
    ("serve.cache_hits", "counter", "count",
     (f"{_PKG}/serving/server.py",)),
    ("serve.batch_errors", "counter", "count",
     (f"{_PKG}/serving/server.py",)),
    ("serve.query_truncated", "counter", "count",
     (f"{_PKG}/serving/server.py",)),
    ("serve.latency_s", "histogram", "seconds",
     (f"{_PKG}/serving/server.py",)),
    ("serve.queue_wait_s", "histogram", "seconds",
     (f"{_PKG}/serving/server.py",)),
    ("checkpoint_saves", "counter", "count",
     (f"{_PKG}/utils/checkpoint.py",)),
    ("artifact_saves", "counter", "count",
     (f"{_PKG}/utils/checkpoint.py",)),
    # ---- live-SLO namespace (MetricsHub; federated exactly)
    ("serve.requests", "counter", "requests", (f"{_PKG}/obs/metrics.py",)),
    ("serve.ok", "counter", "requests", (f"{_PKG}/obs/metrics.py",)),
    ("serve.errors", "counter", "requests", (f"{_PKG}/obs/metrics.py",)),
    ("chaos.injections", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("chaos.losses", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    # event-kind passthrough counters (ingest_event's kind sets): the
    # publish call is `self.count(kind)`, so the names live in the kind
    # tuples, not in call literals
    ("retry", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("backoff", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("watchdog", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("checkpoint_save", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("serve_start", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("soak_rebuild", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("soak_swap", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("soak_loss_injected", "counter", "count",
     (f"{_PKG}/obs/metrics.py",)),
    ("soak_recovered", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("soak_prior_refresh", "counter", "count",
     (f"{_PKG}/obs/metrics.py",)),
    ("ingest.chunks", "counter", "count", (f"{_PKG}/obs/metrics.py",)),
    ("ingest.tokens", "counter", "tokens", (f"{_PKG}/obs/metrics.py",)),
    # fleet-federation gauges (router-side FleetHub)
    ("fed_replicas", "gauge", "count", (f"{_PKG}/obs/federation.py",)),
    ("fed_stale_replicas", "gauge", "count",
     (f"{_PKG}/obs/federation.py",)),
    ("fed_staleness_s_max", "gauge", "seconds",
     (f"{_PKG}/obs/federation.py",)),
    # error budgets (MetricsHub.budgets keys; ErrorBudget instruments)
    ("availability", "slo", "fraction", (f"{_PKG}/obs/metrics.py",)),
    ("latency", "slo", "fraction", (f"{_PKG}/obs/metrics.py",)),
)

# ---------------------------------------------------------------------------
# Autotuning search-space contract.
#
# ``TUNED_KNOBS`` declares the knob space ``tools/autotune.py`` sweeps:
# ``(knob name, candidate domain, affected entry points)``, the JAX
# package's rows.  Every name must appear in ``utils/config.py``'s
# TUNABLE_DEFAULTS; the default is always an implicit member of the
# domain.  Keep it a literal (plain int/float domain values).
TUNED_KNOBS: tuple = (
    # hybrid SpMV dense-head layout: candidates outside the entry's
    # pad_frac ceiling (0.25) on the probe graph are pruned statically
    ("head_coverage", (0.25, 0.5, 0.75),
     ("pagerank_step_hybrid",)),
    ("head_row_width", (64, 128, 256),
     ("pagerank_step_hybrid",)),
    # sort_shuffle bucket padding: wider buckets shrink the reduction but
    # pay pad; the bucket pad fraction is computable without tracing
    ("shuffle_bucket_width", (4, 8, 16),
     ("pagerank_step_sort_shuffle",)),
    # owned-strategy replicated hub-head cap (boundary pad ceiling 0.30)
    ("owned_max_head", (1024, 4096, 8192),
     ("pagerank_sharded_owned",)),
    # staged ingest depths: scheduling-only (results bit-identical), so
    # no pad model prunes them — they ride to measurement unless the
    # paired pack target was already discarded
    ("prefetch", (0, 2, 4),
     ("tfidf_chunk_ingest_carry",)),
    ("pipeline_depth", (0, 2, 4),
     ("tfidf_chunk_ingest_carry",)),
    # streaming chunk re-packing target: 0 (caller chunking as-is) and
    # non-pow2 targets strand pad under the carried grow_chunk_cap pow2
    # policy — provably over the 0.20 drain/carry ceiling, pruned unmeasured
    ("pack_target_tokens", (0, 24000, 100000, 131072, 262144),
     ("tfidf_chunk_drain", "tfidf_chunk_ingest_carry")),
    # serving batch cap (query-batch pad ceiling 0.30)
    ("max_batch", (4, 8, 16),
     ("tfidf_score_query_batch",)),
    # impacted-list scoring bucket layout (impacted pad ceiling 0.62)
    ("impact_bucket_width", (4, 8, 16),
     ("tfidf_score_impacted_batch",)),
    ("impact_warm_buckets", (4096, 8192, 16384),
     ("tfidf_score_impacted_batch",)),
)

# ---------------------------------------------------------------------------
# Entry points (tiers 2 and 3).
#
# Each :class:`EntryPoint` names one step the port dispatches — a PageRank
# step per SpMV impl (single-device and sharded), the TF-IDF batch
# pipeline, the streaming and sharded chunk steps, the finalize pass, the
# scorers, the graph workloads — under the reference's names and budgets,
# with how to trace it (``analysis/trace.py``): fake tensors on the card's
# device, made from the specs of structures the port builds for real at a
# small size; one step, where the entry is a loop (the step
# ``dataflow/fixpoint.iterate`` runs).  Tier 2 (``semantic.py``) and tier
# 3 (``cost.py``) check each under its declared shape matrix.
#
# Declaring a new entry point: write a ``_build_<name>()`` returning a
# :class:`Traceable` (the function, one ``(label, args)`` variant per
# point of the shape matrix the caller's real padding policy produces, and
# the public function findings point at); append an ``EntryPoint`` with
# the budgets the step is designed to meet; ``python -m
# page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis --tier 2``
# must stay clean.  torch and the package's modules are imported inside
# the builders, so the lexical tiers, which import nothing they scan, and
# the tools that read the tables here pay for no torch import.

# Raw per-chunk token counts of the streaming ingest entries, run through
# the real padding policy (``models.tfidf.grow_chunk_cap``): the reference's
# matrix.
CHUNK_TOKEN_MATRIX = (9_000, 120_000, 97_531, 131_072)
# Raw micro-batch sizes of the serving drain loop, through
# ``serving.server.batch_cap`` at the cap below, and raw per-batch bucket
# counts of the impacted planner, through the carried ``grow_chunk_cap``.
SERVE_BATCH_MATRIX = (1, 2, 3, 5, 7, 8, 11, 16)
SERVE_MAX_BATCH = 16
IMPACT_BUCKET_MATRIX = (23, 40, 150, 900, 64)


@dataclasses.dataclass(frozen=True)
class Traceable:
    """What the analyzer traces for one entry point."""

    fn: Callable  # callable accepting one variant's args
    variants: Sequence[tuple[str, tuple]]  # (label, args) per matrix point
    anchor: Callable | None = None  # public fn findings point at (else fn)
    # The donation check's surface: the callable whose in-place writes to
    # its inputs are compared with ``EntryPoint.donate`` (None = ``fn``),
    # and its keyword arguments.
    donate_fn: Callable | None = None
    donate_kwargs: dict | None = None


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One registered entry point plus the budgets it must meet."""

    name: str
    module: str  # repo-relative path of the module under contract
    build: Callable[[], Traceable]
    # Other repo-relative modules the contract depends on (the shape policy
    # a shape matrix runs through, the mesh and its collectives...): a
    # --changed-only run re-traces this entry when any of them changed.
    watch: tuple[str, ...] = ()
    max_compiles: int = 1  # distinct trace signatures the matrix may yield
    transfer_budget: int = 0  # host reads and host-bound moves per step
    axes: tuple[str, ...] = ()  # declared mesh axes (sharded entries)
    collective_budget: int | None = None  # collectives per step (None = ungated)
    allow_64bit: bool = False  # opt out of the implicit-promotion gate
    suppress: frozenset = frozenset()  # semantic + cost rule ids to skip
    # Minimum static FLOP/byte intensity per step (worst variant), the
    # reference's floors.  Gating only while the port's cost artifact
    # carries a gpu stamp; advisory otherwise.  None = ungated.
    intensity_floor: float | None = None
    # Static padding-waste budget: ``pad_plan()`` returns (label, pad_frac)
    # plan points evaluated without dispatching; the worst must stay <=
    # pad_frac_ceiling.
    pad_plan: Callable[[], Sequence[tuple[str, float]]] | None = None
    pad_frac_ceiling: float | None = None
    # In-place contract: positional argnums whose tensors the step writes
    # in place (the reference's donated argnums).  None = unchecked; () =
    # must write no input.
    donate: tuple[int, ...] | None = None


# ``--tier all`` runs two analyzers over the same registry in one process;
# building an entry (graph synthesis, partitions per shrink-chain size) is
# the expensive part, and a Traceable is immutable, so build once a
# process.  Failures are not cached: a broken entry raises in every tier.
_BUILD_CACHE: "dict[EntryPoint, Traceable]" = {}


def build_traceable(ep: "EntryPoint") -> "Traceable":
    t = _BUILD_CACHE.get(ep)
    if t is None:
        with quiet_telemetry():
            t = _BUILD_CACHE[ep] = ep.build()
    return t


@contextlib.contextmanager
def quiet_telemetry():
    """The builders and plans run the port's host code, whose metrics
    records (partitions, cap bumps) are run telemetry: muted for a lint
    pass."""
    log = logging.getLogger("pr_tfidf_torch")
    was_disabled, log.disabled = log.disabled, True
    try:
        yield
    finally:
        log.disabled = was_disabled


def _f32(shape):
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec

    return spec(shape)


def _i32(shape):
    import torch

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec

    return spec(shape, torch.int32)


def _bool(shape):
    import torch

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec

    return spec(shape, torch.bool)


def _trace_graph():
    """The registry's trace graph, the reference's: 64 nodes and 256 edges
    drawn with seed 1 (63 nodes and 187 edges once ids are compacted)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw

    return synthetic_powerlaw(64, 256, seed=1)


def _device_graph_spec(layout: str | None = None):
    """``(n, DeviceGraph spec)``: ``put_graph`` on the CPU over the trace
    graph, with its plans (and the impl's static layout, without the raw
    edge arrays, as ``models.pagerank.put_graph_for`` builds it), every
    tensor replaced by its spec."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec_of
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops

    graph = _trace_graph()
    dg = ops.put_graph(graph, layout=layout, keep_edge_arrays=layout is None, device="cpu")
    return graph.n_nodes, spec_of(dg)


def _pagerank_cfg(**kw):
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    return PageRankConfig(iterations=4, dangling="redistribute", init="uniform", **kw)


# ----------------------------------------------------------------- pagerank


def _pagerank_traceable(label: str, anchor_name: str, layout: str | None = None,
                        **cfg) -> Traceable:
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk

    n, dg = _device_graph_spec(layout)
    run = ops.make_pagerank_runner(n, _pagerank_cfg(**cfg))
    anchor = getattr(ops, anchor_name, None) or getattr(pk, anchor_name)
    return Traceable(fn=run, variants=[(label, (dg, _f32((n,)), _f32((n,))))], anchor=anchor)


def _build_pagerank_scan() -> Traceable:
    return _pagerank_traceable("n64", "pagerank_step")


def _build_pagerank_while_cumsum() -> Traceable:
    return _pagerank_traceable("n64-tol", "make_pagerank_runner", tol=1e-6,
                               spmv_impl="cumsum")


def _build_pagerank_pallas() -> Traceable:
    return _pagerank_traceable("n64-pallas", "spmv_pallas", spmv_impl="pallas")


def _build_pagerank_hybrid() -> Traceable:
    return _pagerank_traceable("n64-hybrid", "spmv_hybrid", "hybrid", spmv_impl="hybrid")


def _build_pagerank_sort_shuffle() -> Traceable:
    return _pagerank_traceable("n64-shuffle", "spmv_sort_shuffle", "sort_shuffle",
                               spmv_impl="sort_shuffle")


def _build_pagerank_rowsum_pallas() -> Traceable:
    """The hybrid head's row-sum kernel on its own, at the reference's
    shape."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk

    return Traceable(fn=pk.rowsum_kernel, variants=[("r2048xw128", (_f32((2048, 128)),))],
                     anchor=pk.rowsum_kernel)


def _shrink_chain(d0: int) -> list[int]:
    """The slot counts the elastic rung can rebuild onto from ``d0``: d0,
    d0/2, ..., 1 (``resilience/elastic.py``).  Every sharded entry traces
    each, as the reference's does."""
    chain = []
    d = d0
    while d >= 1:
        chain.append(d)
        d //= 2
    return chain


# The reference's sharded entries trace min(4, devices) slots; the port's
# mesh takes any number of slots of one device.
SHARD_SLOTS = 4


def _sharded_pagerank_traceable(strategy: str) -> Traceable:
    """The sharded step at each shrink-chain slot count: the partition, the
    slots' arrays and the state the sharded driver builds (``_ShardedExec``
    on a mesh of CPU slots), as specs; the runner's mesh names the axis
    its collectives report."""
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec_of
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import pagerank_sharded as ps
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
        NODES_AXIS,
        mesh_for,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    graph = _trace_graph()
    cfg = _pagerank_cfg()
    runners: dict = {}
    variants: list = []
    for d in _shrink_chain(SHARD_SLOTS):
        ex = ps._ShardedExec(graph, cfg, mesh_for(d, NODES_AXIS, "cpu"), strategy,
                             MetricsRecorder())
        runners[d] = ex.make_runner(cfg)
        state0 = ex.put_ranks(np.full(graph.n_nodes, 1.0 / graph.n_nodes, np.float32))
        variants.append((f"{strategy}-d{d}", spec_of((state0, ex.dev, ex.e_vec))))

    def dispatch(state0, dev, e):
        # one runner a slot count: the slots' arrays name which
        return runners[len(dev)](state0, dev, e)

    if strategy == "owned":
        # smallest first, as the reference orders its owned chain
        variants.reverse()
    return Traceable(fn=dispatch, variants=variants, anchor=ps.make_sharded_runner)


def _build_pagerank_sharded_edges() -> Traceable:
    return _sharded_pagerank_traceable("edges")


def _build_pagerank_sharded_hybrid() -> Traceable:
    return _sharded_pagerank_traceable("hybrid")


def _build_pagerank_sharded_nodes_balanced() -> Traceable:
    return _sharded_pagerank_traceable("nodes_balanced")


def _build_pagerank_sharded_src() -> Traceable:
    return _sharded_pagerank_traceable("src")


def _build_pagerank_sharded_owned() -> Traceable:
    return _sharded_pagerank_traceable("owned")


def _sharded_pad_plan(strategy: str):
    """Static padding-waste plan points of a sharded entry: ``pad_frac`` of
    the partition plan (``parallel.pagerank_sharded.plan_partition``, no
    arrays placed) on the trace graph, one point a shrink-chain count."""

    def plan() -> list[tuple[str, float]]:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
            plan_partition,
        )

        graph = _trace_graph()
        return [(f"{strategy}-d{d}", plan_partition(graph, d, strategy=strategy).pad_frac)
                for d in _shrink_chain(SHARD_SLOTS)]

    return plan


def _owned_pad_plan():
    """Both gauges of the owned plan a shrink-chain count: the edge-slot
    ``pad_frac`` and, past one slot, the boundary buffers' pad fraction."""

    def plan() -> list[tuple[str, float]]:
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
            plan_partition,
        )

        graph = _trace_graph()
        points: list[tuple[str, float]] = []
        for d in _shrink_chain(SHARD_SLOTS):
            p = plan_partition(graph, d, strategy="owned")
            points.append((f"owned-d{d}", p.pad_frac))
            if d > 1:
                points.append((f"owned-d{d}-boundary", p.owned.boundary_pad_frac))
        return points

    return plan


def _owned_pair_traceable(kind: str) -> Traceable:
    """The owned HITS or components step at each shrink-chain count: the
    (forward, reverse) shards, the slots' operands and the state the
    sharded driver places, as specs."""
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec_of
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.partition import OwnedArray
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import workloads_sharded as ws
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
        NODES_AXIS,
        mesh_for,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        ComponentsConfig,
        HitsConfig,
    )

    graph = _trace_graph()
    n = graph.n_nodes
    runners: dict = {}
    variants: list = []
    for d in _shrink_chain(SHARD_SLOTS):
        mesh = mesh_for(d, NODES_AXIS, "cpu")
        sf, sr = ws.build_owned_pair(graph, d, "float32")
        dev = ws._device_put_pair(sf, sr, mesh)
        layout = OwnedArray.from_shard(sf, mesh=mesh)
        if kind == "hits":
            runners[d] = ws.make_hits_sharded_runner(sf, sr, HitsConfig(iterations=4, tol=0.0),
                                                     mesh)
            init = layout.put(np.full(n, 1.0 / n, np.float32), np.float32).tail
            state0 = (init, init)
        else:
            runners[d] = ws.make_components_sharded_runner(
                sf, sr, ComponentsConfig(iterations=8), mesh)
            state0 = layout.put(np.arange(n, dtype=np.int32), np.int32).tail
        variants.append((f"{kind}-owned-d{d}", spec_of((state0, dev))))

    def dispatch(state0, dev):
        return runners[len(dev)](state0, dev)

    anchor = (ws.make_hits_sharded_runner if kind == "hits"
              else ws.make_components_sharded_runner)
    return Traceable(fn=dispatch, variants=variants, anchor=anchor)


def _build_hits_sharded_owned() -> Traceable:
    return _owned_pair_traceable("hits")


def _build_components_sharded_owned() -> Traceable:
    return _owned_pair_traceable("cc")


# -------------------------------------------------------------------- tfidf


def _build_tfidf_batch() -> Traceable:
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import IdfMode, TfMode

    cap, n_docs, vocab = 4096, 16, 1 << 10
    fn = functools.partial(ops.tfidf_pipeline, n_docs=n_docs, vocab=vocab,
                           tf_mode=TfMode.FREQ, idf_mode=IdfMode.SMOOTH, l2_normalize=True)
    return Traceable(fn=fn, variants=[("batch4k", (_i32((cap,)), _i32((cap,)),
                                                   _i32((n_docs,))))],
                     anchor=ops.tfidf_pipeline)


def _chunk_caps() -> list[int]:
    """The caps the declared raw-token matrix takes through the real
    streaming policy: distinct caps are distinct shapes of the step."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import grow_chunk_cap
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    metrics = MetricsRecorder()
    cap = 0
    caps: list[int] = []
    for raw in CHUNK_TOKEN_MATRIX:
        cap, _ = grow_chunk_cap(raw, cap, metrics)
        caps.append(cap)
    return caps


def _build_tfidf_chunk_drain() -> Traceable:
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    variants = [(f"tokens{raw}", (_i32((cap,)), _i32((cap,)), _bool((cap,))))
                for raw, cap in zip(CHUNK_TOKEN_MATRIX, _chunk_caps())]
    return Traceable(fn=functools.partial(ops.chunk_counts, vocab=1 << 10), variants=variants,
                     anchor=ops.chunk_counts)


def _build_tfidf_chunk_ingest_carry() -> Traceable:
    """The streaming step with its device DF carry, updated in place."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    vocab = 1 << 10
    variants = [(f"tokens{raw}", (_i32((cap,)), _i32((cap,)), _bool((cap,)), _f32((vocab,))))
                for raw, cap in zip(CHUNK_TOKEN_MATRIX, _chunk_caps())]
    return Traceable(fn=functools.partial(ops.chunk_counts_carry, vocab=vocab),
                     variants=variants, anchor=ops.chunk_counts_carry)


def _chunk_pad_plan() -> "list[tuple[str, float]]":
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import stream_pad_plan

    return stream_pad_plan(CHUNK_TOKEN_MATRIX)


def _build_tfidf_sharded_ingest() -> Traceable:
    """The sharded chunk step: one ``[cap]`` chunk a slot, the DF psum."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import tfidf_sharded as ts
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        mesh_for,
    )

    cap, vocab = 2048, 1 << 10
    kernels: dict = {}
    variants: list = []
    for d in _shrink_chain(SHARD_SLOTS):
        kernels[d] = ts.make_sharded_counts_kernel(mesh_for(d, DATA_AXIS, "cpu"), vocab)
        variants.append((f"d{d}-cap{cap}", ([_i32((cap,))] * d, [_i32((cap,))] * d,
                                            [_bool((cap,))] * d)))

    def dispatch(doc_ids, term_ids, valid):
        return kernels[len(doc_ids)](doc_ids, term_ids, valid)

    return Traceable(fn=dispatch, variants=variants, anchor=ts.make_sharded_counts_kernel)


def _build_tfidf_finalize() -> Traceable:
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfMode

    nnz, n_docs = 4096, 16
    fn = functools.partial(ops.finalize_weights, n_docs=n_docs, tf_mode=TfMode.FREQ,
                           l2_normalize=True)
    return Traceable(fn=fn, variants=[("nnz4k", (_i32((nnz,)), _f32((nnz,)), _i32((n_docs,)),
                                                 _f32((nnz,))))],
                     anchor=ops.finalize_weights)


def _build_tfidf_score_query() -> Traceable:
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    cap, n_docs, vocab, k = 2048, 32, 1 << 10, 8
    result = ops.TfidfResult(doc=_i32((cap,)), term=_i32((cap,)), weight=_f32((cap,)),
                             idf=_f32((vocab,)), df=_f32((vocab,)), count=_f32((cap,)))
    fn = functools.partial(ops.score_query, n_docs=n_docs, k=k)
    return Traceable(fn=fn, variants=[("top8", (result, _f32((vocab,))))],
                     anchor=ops.score_query)


def _serve_pad_plan() -> "list[tuple[str, float]]":
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import serve_pad_plan

    return serve_pad_plan(SERVE_BATCH_MATRIX, SERVE_MAX_BATCH)


def _build_tfidf_score_query_batch() -> Traceable:
    """The serving path's batched scorer: one shape a padded batch cap."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import batch_cap
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    cap, n_docs, vocab, k, q = 2048, 32, 1 << 10, 8, 16
    metrics = MetricsRecorder()
    variants = []
    for b in SERVE_BATCH_MATRIX:
        bc = batch_cap(b, SERVE_MAX_BATCH, metrics)
        variants.append((f"batch{b}", (_i32((cap,)), _i32((cap,)), _f32((cap,)), _f32((cap,)),
                                       _i32((bc, q)), _f32((bc, q)), _f32((bc, q)),
                                       _f32((n_docs,)))))
    fn = functools.partial(ops.score_query_batch, n_docs=n_docs, vocab=vocab, k=k,
                           use_prior=True)
    return Traceable(fn=fn, variants=variants, anchor=ops.score_query_batch)


def _impacted_pad_plan() -> "list[tuple[str, float]]":
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
        impacted_pad_plan,
    )

    return impacted_pad_plan(IMPACT_BUCKET_MATRIX)


def _build_tfidf_score_impacted_batch() -> Traceable:
    """The latency-shaped scorer: one shape a (padded batch cap, carried
    bucket cap) point of the declared matrices."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import grow_chunk_cap
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
        IMPACT_MIN_BUCKET_BITS,
        batch_cap,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    nnz, n_docs, k, w, q = 2048, 32, 8, 8, 16
    metrics = MetricsRecorder()
    bcap = 0
    bcaps = []
    for raw in IMPACT_BUCKET_MATRIX:
        bcap, _ = grow_chunk_cap(max(raw, 1), bcap, metrics, min_bits=IMPACT_MIN_BUCKET_BITS)
        bcaps.append(bcap)
    variants = []
    seen: set = set()
    for b, bc in zip(SERVE_BATCH_MATRIX,
                     bcaps + bcaps[: max(0, len(SERVE_BATCH_MATRIX) - len(bcaps))]):
        cap = batch_cap(b, SERVE_MAX_BATCH, metrics)
        if (cap, bc) in seen:
            continue
        seen.add((cap, bc))
        variants.append((f"b{cap}-c{bc}", (
            _i32((cap,)),  # batch marker: its length is the padded batch
            _i32((nnz,)), _f32((nnz,)),
            _i32((bc,)), _i32((bc,)), _i32((bc,)), _f32((bc,)),
            _f32((n_docs,)), _i32((bc,)))))
    fn = functools.partial(ops.score_impacted_batch, query_terms=q, n_docs=n_docs,
                           bucket_width=w, k=k, use_prior=True)

    def dispatch(marker, doc, weight, bs, bl, br, bqw, prior, slot):
        return fn(doc, weight, bs, bl, br, bqw, prior, bucket_slot=slot,
                  batch=marker.shape[0])

    return Traceable(fn=dispatch, variants=variants, anchor=ops.score_impacted_batch)


def _build_tfidf_topk_merge() -> Traceable:
    """The per-segment top-k merge: one shape a live-segment count."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as ops

    b, k = 8, 8
    variants = []
    for s in (2, 3):
        variants.append((f"s{s}", (tuple(_f32((b, k)) for _ in range(s)),
                                   tuple(_i32((b, k)) for _ in range(s)),
                                   tuple(range(0, 32 * s, 32)))))
    return Traceable(fn=functools.partial(ops.topk_merge, k=k), variants=variants,
                     anchor=ops.topk_merge)


# ---------------------------------------------------- dataflow workloads


def _build_ppr_batch() -> Traceable:
    """Batched personalized PageRank: the [B, n] rank step."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr

    n, dg = _device_graph_spec()
    b = 4
    run = ppr.make_ppr_batch_runner(n, _pagerank_cfg())
    return Traceable(fn=run, variants=[("b4-n64", (dg, _f32((b, n)), _f32((b, n))))],
                     anchor=ppr.make_ppr_batch_runner)


def _build_hits() -> Traceable:
    """HITS: both segmented passes and the max normalisations, [2, n] carry."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.trace import spec_of
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import hits
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import HitsConfig

    graph = _trace_graph()
    n = graph.n_nodes
    hg = spec_of(hits.put_hits_graph(graph, "float32", "cpu"))
    run = hits.make_hits_runner(n, HitsConfig(iterations=4, tol=0.0))
    return Traceable(fn=run, variants=[("n64", (hg, _f32((2, n))))], anchor=hits.hits_step)


def _build_components() -> Traceable:
    """Connected components: one min-label round, int32 labels."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import components
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import ComponentsConfig

    n, dg = _device_graph_spec()
    run = components.make_components_runner(n, ComponentsConfig(iterations=8))
    return Traceable(fn=run, variants=[("n64", (dg, _i32((n,))))],
                     anchor=components.label_step)


def _build_bm25_weights() -> Traceable:
    """BM25 re-weighting of the postings COO: two gathers and elementwise
    math."""
    import functools

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import bm25

    nnz, n_docs, vocab = 4096, 16, 1 << 10
    fn = functools.partial(bm25.bm25_weights, n_docs=n_docs, k1=1.5, b=0.75)
    return Traceable(fn=fn, variants=[("nnz4k", (_i32((nnz,)), _i32((nnz,)), _f32((nnz,)),
                                                 _i32((n_docs,)), _f32((vocab,))))],
                     anchor=bm25.bm25_weights)


# ------------------------------------------------------------- the registry

_SHARDED_WATCH = (
    f"{_PKG}/ops/pagerank.py",
    f"{_PKG}/ops/segment_kernels.py",
    f"{_PKG}/dataflow/fixpoint.py",
    f"{_PKG}/parallel/mesh.py",
    f"{_PKG}/parallel/collectives.py",
)

ENTRY_POINTS: tuple = (
    EntryPoint(
        name="pagerank_step",
        module=f"{_PKG}/ops/pagerank.py",
        build=_build_pagerank_scan,
        watch=(f"{_PKG}/dataflow/fixpoint.py", f"{_PKG}/ops/segment_kernels.py"),
        # the runner swaps rank buffers: the step writes no input, where
        # the reference donates the carry (argnum 1)
        donate=(),
        intensity_floor=0.05,
    ),
    EntryPoint(
        name="pagerank_step_tol_cumsum",
        module=f"{_PKG}/ops/pagerank.py",
        build=_build_pagerank_while_cumsum,
        watch=(f"{_PKG}/dataflow/fixpoint.py", f"{_PKG}/ops/pallas_kernels.py"),
        donate=(),
        intensity_floor=0.045,
    ),
    EntryPoint(
        name="pagerank_step_pallas",
        module=f"{_PKG}/ops/pallas_kernels.py",
        build=_build_pagerank_pallas,
        watch=(f"{_PKG}/ops/pagerank.py", f"{_PKG}/dataflow/fixpoint.py"),
        donate=(),
        intensity_floor=0.04,
    ),
    EntryPoint(
        name="pagerank_step_hybrid",
        module=f"{_PKG}/ops/pagerank.py",
        build=_build_pagerank_hybrid,
        watch=(f"{_PKG}/dataflow/fixpoint.py", f"{_PKG}/ops/pallas_kernels.py",
               f"{_PKG}/ops/segment_kernels.py"),
        donate=(),
        intensity_floor=0.05,
    ),
    EntryPoint(
        name="pagerank_step_sort_shuffle",
        module=f"{_PKG}/ops/pagerank.py",
        build=_build_pagerank_sort_shuffle,
        watch=(f"{_PKG}/dataflow/fixpoint.py", f"{_PKG}/ops/segment_kernels.py"),
        donate=(),
        intensity_floor=0.05,
    ),
    EntryPoint(
        name="pagerank_rowsum_pallas",
        module=f"{_PKG}/ops/pallas_kernels.py",
        build=_build_pagerank_rowsum_pallas,
        watch=(f"{_PKG}/ops/pagerank.py",),
        intensity_floor=0.045,
    ),
    EntryPoint(
        name="pagerank_sharded_edges",
        module=f"{_PKG}/parallel/pagerank_sharded.py",
        build=_build_pagerank_sharded_edges,
        watch=_SHARDED_WATCH,
        axes=("nodes",),
        # one psum a step: the contributions' combine
        collective_budget=1,
        # one shape a slot count on the shrink chain (4, 2, 1)
        max_compiles=3,
        pad_plan=_sharded_pad_plan("edges"),
        pad_frac_ceiling=0.05,
        intensity_floor=0.035,
    ),
    EntryPoint(
        name="pagerank_sharded_nodes_balanced",
        module=f"{_PKG}/parallel/pagerank_sharded.py",
        build=_build_pagerank_sharded_nodes_balanced,
        watch=_SHARDED_WATCH,
        axes=("nodes",),
        # all_gather of the weighted ranks + psum of the dangling mass (+
        # the delta's psum, which the port's loop runs outside the step)
        collective_budget=3,
        max_compiles=3,
        pad_plan=_sharded_pad_plan("nodes_balanced"),
        pad_frac_ceiling=0.25,
        intensity_floor=0.035,
    ),
    EntryPoint(
        name="pagerank_sharded_hybrid",
        module=f"{_PKG}/parallel/pagerank_sharded.py",
        build=_build_pagerank_sharded_hybrid,
        watch=_SHARDED_WATCH + (f"{_PKG}/ops/pallas_kernels.py",),
        axes=("nodes",),
        # one psum combines head and tail partials
        collective_budget=1,
        max_compiles=3,
        pad_plan=_sharded_pad_plan("hybrid"),
        pad_frac_ceiling=0.25,
        intensity_floor=0.04,
    ),
    EntryPoint(
        name="pagerank_sharded_owned",
        module=f"{_PKG}/parallel/pagerank_sharded.py",
        build=_build_pagerank_sharded_owned,
        watch=_SHARDED_WATCH + (f"{_PKG}/ops/boundary.py",),
        axes=("nodes",),
        # log2(D) ppermute rounds of the boundary butterfly + one psum: 3
        # at D = 4
        collective_budget=3,
        max_compiles=3,
        pad_plan=_owned_pad_plan(),
        pad_frac_ceiling=0.30,
        # the step writes fresh per-slot lists; the reference donates its
        # 4-leaf carry (argnum 0)
        donate=(),
        intensity_floor=0.03,
    ),
    EntryPoint(
        name="pagerank_sharded_src",
        module=f"{_PKG}/parallel/pagerank_sharded.py",
        build=_build_pagerank_sharded_src,
        watch=_SHARDED_WATCH,
        axes=("nodes",),
        # reduce-scatter exchange + psum of the dangling mass (+ the
        # delta's psum, outside the port's step)
        collective_budget=3,
        max_compiles=3,
        pad_plan=_sharded_pad_plan("src"),
        pad_frac_ceiling=0.25,
        intensity_floor=0.03,
    ),
    EntryPoint(
        name="hits_sharded_owned",
        module=f"{_PKG}/parallel/workloads_sharded.py",
        build=_build_hits_sharded_owned,
        watch=(f"{_PKG}/ops/boundary.py", f"{_PKG}/dataflow/fixpoint.py",
               f"{_PKG}/parallel/collectives.py"),
        axes=("nodes",),
        # two butterflies (2·log2(D) ppermutes) + two pmax norms (+ the
        # convergence psum, outside the port's step): 7 at D = 4
        collective_budget=7,
        max_compiles=3,
        intensity_floor=0.03,
    ),
    EntryPoint(
        name="components_sharded_owned",
        module=f"{_PKG}/parallel/workloads_sharded.py",
        build=_build_components_sharded_owned,
        watch=(f"{_PKG}/ops/boundary.py", f"{_PKG}/dataflow/fixpoint.py",
               f"{_PKG}/parallel/collectives.py", f"{_PKG}/dataflow/combine.py"),
        axes=("nodes",),
        # two butterflies (+ the changed-count psum, outside the step)
        collective_budget=5,
        max_compiles=3,
        intensity_floor=0.01,
    ),
    EntryPoint(
        name="tfidf_batch_pipeline",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_batch,
        intensity_floor=0.09,
    ),
    EntryPoint(
        name="tfidf_chunk_drain",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_chunk_drain,
        watch=(f"{_PKG}/models/tfidf.py", f"{_PKG}/dataflow/ingest.py"),
        # the doubling cap may take a few shapes over a stream; the
        # declared matrix must collapse to <= 3
        max_compiles=3,
        pad_plan=_chunk_pad_plan,
        pad_frac_ceiling=0.20,
        intensity_floor=0.25,
    ),
    EntryPoint(
        name="tfidf_chunk_ingest_carry",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_chunk_ingest_carry,
        watch=(f"{_PKG}/models/tfidf.py", f"{_PKG}/dataflow/ingest.py"),
        max_compiles=3,
        pad_plan=_chunk_pad_plan,
        pad_frac_ceiling=0.20,
        # the device DF carry (argnum 3) is updated in place every chunk,
        # where the reference donates it
        donate=(3,),
        intensity_floor=0.25,
    ),
    EntryPoint(
        name="tfidf_sharded_ingest",
        module=f"{_PKG}/parallel/tfidf_sharded.py",
        build=_build_tfidf_sharded_ingest,
        watch=(f"{_PKG}/ops/tfidf.py", f"{_PKG}/parallel/mesh.py",
               f"{_PKG}/parallel/collectives.py", f"{_PKG}/dataflow/ingest.py"),
        axes=("data",),
        # the DF psum, the ingest step's one reduceByKey
        collective_budget=1,
        max_compiles=3,
        intensity_floor=0.15,
    ),
    EntryPoint(
        name="tfidf_finalize",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_finalize,
        intensity_floor=0.045,
    ),
    EntryPoint(
        name="tfidf_score_query",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_score_query,
        intensity_floor=0.04,
    ),
    EntryPoint(
        name="dataflow_ppr_batch",
        module=f"{_PKG}/dataflow/ppr.py",
        build=_build_ppr_batch,
        watch=(f"{_PKG}/ops/pagerank.py", f"{_PKG}/dataflow/fixpoint.py"),
        donate=(),
        intensity_floor=0.06,
    ),
    EntryPoint(
        name="dataflow_hits",
        module=f"{_PKG}/dataflow/hits.py",
        build=_build_hits,
        watch=(f"{_PKG}/dataflow/combine.py", f"{_PKG}/dataflow/fixpoint.py",
               f"{_PKG}/ops/segment_kernels.py"),
        donate=(),
        intensity_floor=0.04,
    ),
    EntryPoint(
        name="dataflow_components",
        module=f"{_PKG}/dataflow/components.py",
        build=_build_components,
        watch=(f"{_PKG}/dataflow/combine.py", f"{_PKG}/dataflow/fixpoint.py"),
        donate=(),
        intensity_floor=0.04,
    ),
    EntryPoint(
        name="dataflow_bm25_weights",
        module=f"{_PKG}/dataflow/bm25.py",
        build=_build_bm25_weights,
        intensity_floor=0.10,
    ),
    EntryPoint(
        name="tfidf_score_query_batch",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_score_query_batch,
        watch=(f"{_PKG}/serving/server.py", f"{_PKG}/models/tfidf.py",
               f"{_PKG}/dataflow/ingest.py"),
        # one shape a padded batch cap: {1, 2, 4, 8, 16} at max_batch 16
        max_compiles=5,
        pad_plan=_serve_pad_plan,
        pad_frac_ceiling=0.30,
        intensity_floor=0.04,
    ),
    EntryPoint(
        name="tfidf_score_impacted_batch",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_score_impacted_batch,
        watch=(f"{_PKG}/serving/server.py", f"{_PKG}/serving/artifact.py",
               f"{_PKG}/serving/segments.py", f"{_PKG}/models/tfidf.py",
               f"{_PKG}/dataflow/ingest.py"),
        # one shape a (padded batch cap, carried bucket cap) point
        max_compiles=8,
        pad_plan=_impacted_pad_plan,
        pad_frac_ceiling=0.62,
        # every operand (postings, weight table, prior) serves the next
        # batch: the scorer writes none
        donate=(),
        intensity_floor=0.03,
    ),
    EntryPoint(
        name="tfidf_topk_merge",
        module=f"{_PKG}/ops/tfidf.py",
        build=_build_tfidf_topk_merge,
        watch=(f"{_PKG}/serving/server.py",),
        # one shape a live-segment count at the warmed batch cap
        max_compiles=2,
        donate=(),
        intensity_floor=0.03,
    ),
)
