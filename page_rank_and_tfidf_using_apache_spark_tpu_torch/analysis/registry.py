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
- ``TUNED_KNOBS`` — the autotuner's knob space (``tools/autotune.py``).

The reference's jit entry points (``EntryPoint``, ``ENTRY_POINTS`` and
their traceable builders), which its trace-based tiers 2 and 3 read, have
no counterpart here yet: those tiers are not ported.
"""

from __future__ import annotations

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
#   the one to use, the staged one may still be landing.
#
# The third field is empty: the entry points it would name (and the
# reference's cross-check of this table against their declared donations)
# belong to the trace-based tiers, which are not ported.  Parsed lexically
# — keep it a literal.
DONATED_CALLEES: tuple = (
    ("chunk_counts_carry", (3,), ()),
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
