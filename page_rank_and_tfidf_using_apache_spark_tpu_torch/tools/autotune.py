"""Cost-model-pruned knob sweep: the port's counterpart of the JAX
package's ``tools/autotune.py``, measured on the card.

1. **Enumerate**: the full cartesian grid per knob *group* (knobs that
   interact are swept together; independent groups multiply nothing).
2. **Prune**: every grid point is evaluated against the static budgets of
   the entry points it shapes — ``stream_pad_plan``/``serve_pad_plan`` pad
   fractions, the impacted path's padding and the sharded planner's
   (``parallel.pagerank_sharded.plan_partition`` at ``MESH_DEVICES``
   slots, for the ``hybrid`` and ``owned`` groups) vs the entry's
   ``pad_frac_ceiling``, and a bucket-padding intensity model vs its
   ``intensity_floor``.  A point that violates a budget is discarded
   **unmeasured**.
3. **Measure**: each group's ``TUNABLE_DEFAULTS`` point (pruned or not:
   it is what a run without a profile uses), then its survivors, run the
   port's own entry points (the streaming ingest, the ``hybrid``/
   ``sort_shuffle`` PageRank runs, the ``owned`` sharded PageRank on
   ``MESH_DEVICES`` slots of the device, the warm serving batch path) on
   the resolved device, under the ``GRAFT_TUNE_BUDGET_S`` wall-clock budget
   (the ingest stream in the TF-IDF CLI's default chunks of 1,024
   documents, ``INGEST_CHUNK_DOCS``).
   The fastest point is timed against the defaults again in turns
   (``CONFIRM_ORDER``) and replaces them only when every one of its runs
   beats every run of the defaults.  A group the budget leaves unmeasured
   keeps its defaults, flagged ``fallback`` in the profile's ``measured``
   evidence.
4. **Commit**: ``utils/config.write_tuned_profile`` publishes the port
   package's ``tuned_profile_<backend>.json`` — stamped with the backend of
   the device the sweep ran on (``"gpu"`` on the card, with the card's name and
   power limit in ``measured``), guarded by ``check_overwrite``, staged and
   published with ``durable_replace``.  The CLIs resolve it through
   ``utils/config.load_tuned_profile`` / ``tuned_config`` (flag > env >
   profile > TUNABLE_DEFAULTS).

The knob space (``TUNED_KNOBS``) and the budgets of the entries the prune
reads (``ENTRY_BUDGETS``, from their ``ENTRY_POINTS`` rows) live in the
port's ``analysis/registry.py``, with the JAX package's values, which
``tests/test_torch_autotune.py`` holds equal to the reference.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.autotune --dry-run
    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.autotune
    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.autotune \\
        --json --out /tmp/p.json --budget-s 30
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import shutil
import sys
import tempfile
import time

# the knob space: (name, candidate domain, entry points it shapes)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import (
    ENTRY_POINTS,
    TUNED_KNOBS,
)

# Knob groups: knobs inside one group interact (their product is swept);
# groups are independent (their winners compose).  Every TUNED_KNOBS name
# must appear in exactly one group — enumerate_grid() enforces it.
GROUPS: tuple = (
    # measured in this order under the wall-clock budget: the two groups
    # that map straight onto streaming tokens/s and warm serving queries/s
    # go first; the PageRank shape knobs follow
    ("ingest", ("pack_target_tokens", "prefetch", "pipeline_depth")),
    ("serve", ("max_batch", "impact_bucket_width", "impact_warm_buckets")),
    ("hybrid", ("head_coverage", "head_row_width")),
    ("shuffle", ("shuffle_bucket_width",)),
    ("owned", ("owned_max_head",)),
)

# Sharded-plan probes (the owned/hybrid groups) cost pad fractions at this
# many slots, the reference's MESH_DEVICES; the owned group's measured run
# takes this many slots of the sweep's device.
MESH_DEVICES = 4

# Calibration anchor for the sort_shuffle intensity model: the JAX
# package's static model measures 0.072 FLOP/byte at the default bucket
# width.  Other widths scale by dispatched-slot ratio.
SHUFFLE_BASE_INTENSITY = 0.072
SHUFFLE_BASE_WIDTH = 8

# A group's fastest point is timed again against its TUNABLE_DEFAULTS point
# in these turns (W: the winner, D: the defaults) and replaces the defaults
# only when every W run beats every D run: with five of each, a point no
# faster than the defaults does so once in 252 sweeps.  One timed run a
# point at probe scale is mostly launch overhead on the card and can pick
# by noise.
CONFIRM_ORDER = "DWWDWDDWWD"

# The ingest group streams as the TF-IDF CLI does by default (--chunk-docs
# 1024), over four such chunks.  The reference streams 768 documents in
# chunks of 48, where re-packing merges the whole corpus into one dispatch:
# a win that reversed on a 19,000-document stream of 512-document chunks
# on the card, where the packer's host pass costs more than it saves.
INGEST_DOCS, INGEST_CHUNK_DOCS = 4096, 1024

# The entry points whose budgets the prune reads, and those budgets, from
# their registry rows.
PRUNED_ENTRIES = ("pagerank_sharded_hybrid", "pagerank_sharded_owned",
                  "pagerank_step_sort_shuffle", "tfidf_chunk_ingest_carry",
                  "tfidf_score_query_batch", "tfidf_score_impacted_batch")
ENTRY_BUDGETS: dict = {
    ep.name: {"pad_frac_ceiling": ep.pad_frac_ceiling, "intensity_floor": ep.intensity_floor}
    for ep in ENTRY_POINTS if ep.name in PRUNED_ENTRIES
}


def _entry_budgets() -> dict:
    return {name: dict(b) for name, b in ENTRY_BUDGETS.items()}


def _knob_domains() -> dict:
    return {name: tuple(domain) for name, domain, _ in TUNED_KNOBS}


def enumerate_grid(domains: dict) -> dict:
    """Full cartesian candidate grid, grouped: {group: [point dict, ...]}.
    Raises if the GROUPS partition and the knob set drift."""
    grouped = {name for _, knobs in GROUPS for name in knobs}
    missing = set(domains) - grouped
    extra = grouped - set(domains)
    if missing or extra:
        raise ValueError(
            f"GROUPS/TUNED_KNOBS drift: unswept knobs {sorted(missing)}, "
            f"unknown knobs {sorted(extra)}"
        )
    grid = {}
    for group, knobs in GROUPS:
        points = []
        for values in itertools.product(*(domains[k] for k in knobs)):
            points.append(dict(zip(knobs, values)))
        grid[group] = points
    return grid


# ---------------------------------------------------------------------------
# Probe workloads: the JAX tool's deterministic stand-ins (power-law graph,
# ragged log-normal documents, Zipf-ish serving batches and posting runs),
# from the same seeds, so a prune decision is the reference's.
# ---------------------------------------------------------------------------


def build_probes() -> dict:
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (
        synthetic_powerlaw,
    )

    rng = np.random.default_rng(0)
    graph = synthetic_powerlaw(20_000, 160_000, seed=0)
    # ragged documents: mostly short, a heavy tail
    doc_tokens = np.clip(
        rng.lognormal(5.0, 1.1, size=2048), 16, 6000
    ).astype(int)
    # serving arrivals: bursty micro-batches (1..max), hot small head
    batch_sizes = [int(b) for b in
                   np.clip(rng.zipf(1.4, size=192), 1, 16)]
    # impacted posting-run matrix, latency mode: 4-query micro-batches of
    # 4 terms each, posting runs of 20 docs.  Deliberately constant: the
    # width signal lives in intra-bucket padding against the
    # 2**IMPACT_MIN_BUCKET_BITS floor.
    run_lengths = [[20] * 16 for _ in range(64)]
    return {
        "graph": graph,
        "doc_tokens": [int(t) for t in doc_tokens],
        "chunk_docs": 48,
        "batch_sizes": batch_sizes,
        "run_lengths": run_lengths,
    }


def pack_counts(doc_tokens, target: int, chunk_docs: int) -> list:
    """Raw per-chunk token counts the streaming ingest would dispatch:
    ``target == 0`` keeps the caller's fixed-doc-count chunking;
    ``target > 0`` greedily re-packs whole documents to ~target tokens per
    chunk — the host-side mirror of ``dataflow.ingest.pack_doc_chunks``
    (documents never split)."""
    if target <= 0:
        return [sum(doc_tokens[i:i + chunk_docs])
                for i in range(0, len(doc_tokens), chunk_docs)]
    counts, acc = [], 0
    for t in doc_tokens:
        if acc and acc + t > target:
            counts.append(acc)
            acc = 0
        acc += t
    if acc:
        counts.append(acc)
    return counts


def shuffle_padded_slots(indegrees, width: int) -> int:
    """Dispatched slots of the sort_shuffle bucket layout at this width:
    every destination row's edges padded up to a multiple of the bucket."""
    return int(sum(((int(d) + width - 1) // width) * width
                   for d in indegrees if d))


def impacted_static_pad(run_lengths, width: int, min_bits: int = 6) -> float:
    """Whole-workload pad fraction of the impacted path at bucket width
    ``width``: intra-bucket padding (runs padded to the width) plus the
    carried pow2 bucket-cap padding (``serving.server.impacted_pad_plan``'s
    policy, floor ``2**min_bits``), as a fraction of dispatched slots."""
    cap = 0
    total_raw = 0
    total_slots = 0
    for runs in run_lengths:
        n_buckets = sum((r + width - 1) // width for r in runs)
        need = max(n_buckets, 1 << min_bits)
        cap = max(cap, 1 << math.ceil(math.log2(need)))
        total_raw += sum(runs)
        total_slots += cap * width
    return (total_slots - total_raw) / max(total_slots, 1)


# ---------------------------------------------------------------------------
# Static pruning — one evaluator per group.  Each returns a list of
# violation records [{"entry", "metric", "value", "budget"}]; an empty
# list means the point survives to measurement.
# ---------------------------------------------------------------------------


def _viol(entry, metric, value, budget):
    return {"entry": entry, "metric": metric,
            "value": round(float(value), 4), "budget": budget}


def static_violations(group: str, point: dict, probes: dict,
                      budgets: dict) -> list:
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        stream_pad_plan,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
        plan_partition,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
        serve_pad_plan,
    )

    out = []
    if group == "hybrid":
        entry = "pagerank_sharded_hybrid"
        ceiling = budgets[entry]["pad_frac_ceiling"]
        plan = plan_partition(
            probes["graph"], MESH_DEVICES, strategy="hybrid",
            head_coverage=point["head_coverage"],
            head_row_width=point["head_row_width"],
        )
        if ceiling is not None and plan.pad_frac > ceiling:
            out.append(_viol(entry, "pad_frac", plan.pad_frac, ceiling))
    elif group == "owned":
        entry = "pagerank_sharded_owned"
        ceiling = budgets[entry]["pad_frac_ceiling"]
        plan = plan_partition(
            probes["graph"], MESH_DEVICES, strategy="owned",
            owned_max_head=point["owned_max_head"],
        )
        if ceiling is not None and plan.pad_frac > ceiling:
            out.append(_viol(entry, "pad_frac", plan.pad_frac, ceiling))
    elif group == "shuffle":
        entry = "pagerank_step_sort_shuffle"
        floor = budgets[entry]["intensity_floor"]
        indeg = np.diff(probes["graph"].csr_indptr())
        base = shuffle_padded_slots(indeg, SHUFFLE_BASE_WIDTH)
        slots = shuffle_padded_slots(indeg, point["shuffle_bucket_width"])
        intensity = SHUFFLE_BASE_INTENSITY * base / max(slots, 1)
        if floor is not None and intensity < floor:
            out.append(_viol(entry, "intensity", intensity, floor))
    elif group == "ingest":
        entry = "tfidf_chunk_ingest_carry"
        ceiling = budgets[entry]["pad_frac_ceiling"]
        counts = pack_counts(probes["doc_tokens"],
                             point["pack_target_tokens"],
                             probes["chunk_docs"])
        (_, pad_frac), = stream_pad_plan(counts)
        if ceiling is not None and pad_frac > ceiling:
            out.append(_viol(entry, "pad_frac", pad_frac, ceiling))
    elif group == "serve":
        entry = "tfidf_score_query_batch"
        ceiling = budgets[entry]["pad_frac_ceiling"]
        (_, pad_frac), = serve_pad_plan(probes["batch_sizes"],
                                        point["max_batch"])
        if ceiling is not None and pad_frac > ceiling:
            out.append(_viol(entry, "pad_frac", pad_frac, ceiling))
        entry = "tfidf_score_impacted_batch"
        ceiling = budgets[entry]["pad_frac_ceiling"]
        pad = impacted_static_pad(probes["run_lengths"],
                                  point["impact_bucket_width"])
        if ceiling is not None and pad > ceiling:
            out.append(_viol(entry, "pad_frac", pad, ceiling))
    else:  # pragma: no cover - enumerate_grid guards group names
        raise ValueError(f"unknown tuning group {group!r}")
    return out


def prune(grid: dict, probes: dict, budgets: dict) -> dict:
    """Run the static cost model over the whole grid.  Returns the plan:
    {group: {"survivors": [point], "pruned": [{"point", "violations"}]}}
    plus top-level raw/pruned/survivor counts and the prune fraction."""
    plan: dict = {"groups": {}}
    raw = pruned_n = 0
    for group, points in grid.items():
        survivors, pruned = [], []
        for point in points:
            violations = static_violations(group, point, probes, budgets)
            if violations:
                pruned.append({"point": point, "violations": violations})
            else:
                survivors.append(point)
        plan["groups"][group] = {"survivors": survivors, "pruned": pruned}
        raw += len(points)
        pruned_n += len(pruned)
    plan["raw_points"] = raw
    plan["pruned_points"] = pruned_n
    plan["survivor_points"] = raw - pruned_n
    plan["prune_frac"] = pruned_n / max(raw, 1)
    return plan


def _static_rank(group: str, point: dict, probes: dict) -> float:
    """Measuring order: the point's worst static pad fraction (lower =
    cheaper to dispatch).  Never used to *reject* — only to order the
    survivors."""
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        stream_pad_plan,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
        plan_partition,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
        serve_pad_plan,
    )

    if group == "hybrid":
        return plan_partition(probes["graph"], MESH_DEVICES,
                              strategy="hybrid",
                              head_coverage=point["head_coverage"],
                              head_row_width=point["head_row_width"]).pad_frac
    if group == "owned":
        return plan_partition(probes["graph"], MESH_DEVICES,
                              strategy="owned",
                              owned_max_head=point["owned_max_head"]).pad_frac
    if group == "shuffle":
        indeg = np.diff(probes["graph"].csr_indptr())
        slots = shuffle_padded_slots(indeg, point["shuffle_bucket_width"])
        return slots / max(probes["graph"].n_edges, 1)
    if group == "ingest":
        counts = pack_counts(probes["doc_tokens"],
                             point["pack_target_tokens"],
                             probes["chunk_docs"])
        return stream_pad_plan(counts)[0][1]
    if group == "serve":
        (_, qpad), = serve_pad_plan(probes["batch_sizes"],
                                    point["max_batch"])
        return max(qpad, impacted_static_pad(
            probes["run_lengths"], point["impact_bucket_width"]))
    raise ValueError(f"unknown tuning group {group!r}")


# ---------------------------------------------------------------------------
# Measured sweep: each survivor runs the port's entry point (run_pagerank,
# the streaming ingest, the warm TfidfServer batch loop) on a probe
# workload on the resolved device, wall-clocked, one warm run first.  Every
# timed call ends in a host pull of its result (run_pagerank's ranks, the
# stream's finalize, the server's result()), so the clock stops after the
# device has finished.  Lower seconds = better.
# ---------------------------------------------------------------------------


def _bench_corpus(n_docs: int = 768, seed: int = 0) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(np.clip(rng.lognormal(4.6, 0.9), 8, 1200))
        docs.append(" ".join(f"w{rng.zipf(1.3) % 20_000}" for _ in range(n)))
    return docs


def _measure_pagerank(point: dict, impl: str, graph, device) -> float:
    """Seconds of one 4-iteration ``run_pagerank`` (its device graph and
    layout build included), after a warm run; the result pull ends it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
        run_pagerank,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        PageRankConfig, tuned_config,
    )

    cfg = tuned_config(PageRankConfig, None, iterations=4, spmv_impl=impl,
                       **point)
    run_pagerank(graph, cfg, device=device)  # warm: builds outside the clock
    t0 = time.perf_counter()
    run_pagerank(graph, cfg, device=device)
    return time.perf_counter() - t0


def _measure_owned(point: dict, graph, device) -> float:
    """Seconds of one 4-iteration ``run_pagerank_sharded`` under ``owned``
    on ``MESH_DEVICES`` slots of ``device`` (its partition and placement
    included), after a warm run; the result pull ends it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        pagerank_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import make_mesh
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        PageRankConfig, tuned_config,
    )

    cfg = tuned_config(PageRankConfig, None, iterations=4, **point)
    mesh = make_mesh(MESH_DEVICES, devices=[device] * MESH_DEVICES)
    pagerank_sharded.run_pagerank_sharded(graph, cfg, mesh=mesh, strategy="owned")
    t0 = time.perf_counter()
    pagerank_sharded.run_pagerank_sharded(graph, cfg, mesh=mesh, strategy="owned")
    return time.perf_counter() - t0


def _measure_ingest(point: dict, docs: list, device) -> float:
    """Seconds of one streaming TF-IDF run over ``docs`` in chunks of
    ``INGEST_CHUNK_DOCS``, after a warm run; the finalize's pull ends it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.text import (
        iter_corpus_chunks,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        run_tfidf_streaming,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        TfidfConfig, tuned_config,
    )

    cfg = tuned_config(TfidfConfig, None, vocab_bits=14, **point)

    def once():
        t0 = time.perf_counter()
        run_tfidf_streaming(iter_corpus_chunks(iter(docs), INGEST_CHUNK_DOCS), cfg,
                            device=device)
        return time.perf_counter() - t0

    once()  # warm
    return once()


def _measure_serve(point: dict, index, queries: list, device) -> float:
    """Seconds to answer ``queries`` through a warm impacted server, every
    request submitted at once; each ``result()`` waits for its pull."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving

    scfg = serving.ServeConfig(
        top_k=10, scoring="impacted",
        queue_depth=max(64, 2 * point["max_batch"]), **point)
    with serving.TfidfServer(index, scfg, device=device) as srv:
        warm = [srv.submit([f"warmonly{i}"]) for i in range(2 * scfg.max_batch)]
        for p in warm:
            p.result(120.0)
        t0 = time.perf_counter()
        pend = [srv.submit(q) for q in queries]
        for p in pend:
            p.result(120.0)
        return time.perf_counter() - t0


def _build_serve_probe(tmp_dir: str, device):
    import numpy as np

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
        run_tfidf,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        TfidfConfig,
    )

    docs = _bench_corpus(n_docs=384, seed=1)
    out = run_tfidf(docs, TfidfConfig(vocab_bits=13), device=device)
    serving.save_index(tmp_dir, out, TfidfConfig(vocab_bits=13))
    index = serving.load_index(tmp_dir)
    rng = np.random.default_rng(2)
    queries = [[f"w{rng.zipf(1.3) % 20_000}"
                for _ in range(int(rng.integers(2, 5)))]
               for _ in range(128)]
    return index, queries


def _measure_signature(group: str, point: dict) -> tuple:
    """Points that dispatch identical work share one measurement.  On the
    probe index the impacted warmup's carried cap never approaches the
    smallest ``impact_warm_buckets`` candidate, so warm-bucket variants
    are shape-identical at this scale."""
    if group == "serve":
        return (point["max_batch"], point["impact_bucket_width"],
                min(point["impact_warm_buckets"], 1024))
    return tuple(sorted(point.items()))


def _default_point(group: str) -> dict:
    """The group's ``TUNABLE_DEFAULTS`` point: what a run without a profile
    uses, so the point every other one has to beat."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        TUNABLE_DEFAULTS,
    )

    return {k: TUNABLE_DEFAULTS[k] for k in dict(GROUPS)[group]}


def measure_survivors(plan: dict, probes: dict, budget_s: float,
                      log=print, device=None) -> tuple:
    """Wall-clock each group on ``device`` (``cuda`` unless the caller asks
    for the CPU): its ``TUNABLE_DEFAULTS`` point first (measured even where
    the static prune drops it: it is what runs without a profile), then the
    survivors.  A knob leaves its default only when the fastest point then
    beats the default again in turns (``CONFIRM_ORDER``), every one of its
    runs faster than every run of the default; otherwise the group keeps
    its defaults.  Returns (knobs, evidence): every declared knob gets a
    value (a confirmed winner, else the default; the default, flagged
    ``fallback``, where the budget expired before the group produced a
    number)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        TUNABLE_DEFAULTS,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(device)
    deadline = time.monotonic() + budget_s
    inputs: dict = {}  # the ingest corpus and the serve index, built once
    knobs: dict = {}
    evidence: dict = {"budget_s": budget_s, "groups": {}}

    def expired():
        return time.monotonic() >= deadline

    def measure(group, point):
        if group in ("hybrid", "shuffle"):
            # measure on the SAME graph the static prune costed — a
            # winner picked at one scale need not hold at another
            impl = "hybrid" if group == "hybrid" else "sort_shuffle"
            return _measure_pagerank(point, impl, probes["graph"], device)
        if group == "owned":
            return _measure_owned(point, probes["graph"], device)
        if group == "ingest":
            if "docs" not in inputs:
                inputs["docs"] = _bench_corpus(INGEST_DOCS)
            return _measure_ingest(point, inputs["docs"], device)
        if group == "serve":
            if "serve" not in inputs:
                inputs["serve_dir"] = tempfile.mkdtemp(prefix="autotune_idx_")
                inputs["serve"] = _build_serve_probe(inputs["serve_dir"], device)
            return _measure_serve(point, *inputs["serve"], device)
        raise ValueError(group)  # pragma: no cover

    try:
        for group, _ in GROUPS:
            default = _default_point(group)
            gev = {"measured": [], "fallback": False}
            best = best_secs = None
            survivors = sorted(
                plan["groups"][group]["survivors"],
                key=lambda p: _static_rank(group, p, probes))
            sig_cache: dict = {}
            for point in [default, *(p for p in survivors if p != default)]:
                if expired():
                    break
                tag = {"default": True} if point is default else {}
                sig = _measure_signature(group, point)
                if sig in sig_cache:
                    gev["measured"].append({"point": point,
                                            "secs": round(sig_cache[sig], 4),
                                            "shared": True, **tag})
                    continue
                try:
                    secs = measure(group, point)
                except Exception as exc:  # noqa: BLE001 - one bad point
                    # must not kill the sweep; record it and move on
                    gev["measured"].append(
                        {"point": point, **tag,
                         "error": f"{type(exc).__name__}: {exc}"})
                    continue
                sig_cache[sig] = secs
                gev["measured"].append({"point": point,
                                        "secs": round(secs, 4), **tag})
                if best_secs is None or secs < best_secs:
                    best, best_secs = point, secs
                log(f"[autotune] {group} {point} -> {secs:.3f}s")
            if best is not None:
                # shape-identical variants shared the winning measurement:
                # among them, prefer the point closest to the defaults
                best_sig = _measure_signature(group, best)
                ties = [m["point"] for m in gev["measured"]
                        if "secs" in m
                        and _measure_signature(group, m["point"]) == best_sig]
                best = min(ties or [best], key=lambda p: sum(
                    1 for k, v in p.items() if TUNABLE_DEFAULTS.get(k) != v))
                if best != default and not _confirm(group, best, default, gev,
                                                    measure, expired, log):
                    best = default
                    best_secs = sig_cache.get(_measure_signature(group, default))
            if best is None:
                # budget expired (or every measurement failed) before this
                # group produced a number:
                # keep the defaults, flagged so the evidence says "not
                # measured"
                best = default
                gev["fallback"] = True
            gev["winner"] = best
            gev["winner_secs"] = best_secs
            knobs.update(best)
            evidence["groups"][group] = gev
    finally:
        if "serve_dir" in inputs:
            shutil.rmtree(inputs["serve_dir"], ignore_errors=True)
    return knobs, evidence


def _confirm(group, winner, default, gev, measure, expired, log) -> bool:
    """Time ``winner`` (W) against ``default`` (D) again in turns
    (``CONFIRM_ORDER``) and record the runs in ``gev["confirm"]``.  True
    when every run of the winner beats every run of the default; False
    (the group keeps its defaults) otherwise, and when the budget expires
    or a run fails before the turns are done."""
    runs: dict = {"D": [], "W": []}
    error = None
    for side in CONFIRM_ORDER:
        if expired():
            break
        try:
            runs[side].append(measure(group, winner if side == "W" else default))
        except Exception as exc:  # noqa: BLE001 - an unresolved confirm
            error = f"{type(exc).__name__}: {exc}"  # keeps the default
            break
    done = len(runs["D"]) + len(runs["W"]) == len(CONFIRM_ORDER)
    kept = done and max(runs["W"]) < min(runs["D"])
    gev["confirm"] = {"order": CONFIRM_ORDER, "default": runs["D"], "winner": runs["W"],
                      "kept": "winner" if kept else "default",
                      **({"error": error} if error else {})}
    log(f"[autotune] {group} {winner} against the defaults {default}: "
        f"W {[round(x, 4) for x in runs['W']]} D {[round(x, 4) for x in runs['D']]} -> "
        f"{gev['confirm']['kept']}")
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Cost-model-pruned knob sweep; commits "
                    "the port's tuned_profile_<backend>.json")
    ap.add_argument("--dry-run", action="store_true",
                    help="enumerate + prune only: print the plan (raw/"
                         "pruned/survivor counts per group), measure "
                         "nothing, write nothing")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output on stdout")
    ap.add_argument("--backend", default=None,
                    help="stamp/write for this backend (default: the "
                         "backend of --device; under --dry-run, "
                         "utils.config.default_backend()); a sweep refuses "
                         "a backend other than its device's")
    ap.add_argument("--out", default=None,
                    help="profile path (default: the committed "
                         "tuned_profile_<backend>.json in the port's package "
                         "directory)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="measured-sweep wall-clock budget in seconds "
                         "(default: $GRAFT_TUNE_BUDGET_S, then 60)")
    ap.add_argument("--force", action="store_true",
                    help="allow overwriting a profile measured on an "
                         "accelerator from a sweep on another backend "
                         "(utils/artifacts.py guard)")
    ap.add_argument("--device", default=None,
                    help="torch device the sweep runs on (default: cuda)")
    args = ap.parse_args(argv)

    budget_s = args.budget_s
    if budget_s is None:
        budget_s = float(os.environ.get("GRAFT_TUNE_BUDGET_S", "60") or 60)

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import device_stamp
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import artifacts, config
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
        backend_name,
        resolve_device,
    )

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    domains = _knob_domains()
    budgets = _entry_budgets()
    probes = build_probes()
    grid = enumerate_grid(domains)
    plan = prune(grid, probes, budgets)
    log(f"[autotune] grid: {plan['raw_points']} raw points, "
        f"{plan['pruned_points']} pruned by the static cost model "
        f"({plan['prune_frac']:.0%}), {plan['survivor_points']} to measure")

    if args.dry_run:
        backend = args.backend or config.default_backend()
        doc = {"backend": backend, "plan": plan, "dry_run": True}
        print(json.dumps(doc, indent=None if args.json else 2,
                         sort_keys=True))
        return 0

    device = resolve_device(args.device)
    backend = backend_name(device)
    if args.backend is not None and args.backend != backend:
        print(f"error: --backend {args.backend!r} but the sweep runs on "
              f"{device} (backend {backend!r}); a profile is stamped with "
              "the backend it was measured on", file=sys.stderr)
        return 2
    out_path = args.out or config.profile_path(backend)
    try:
        # fail FAST, before the sweep spends its budget, if the commit
        # would overwrite an accelerator-stamped profile
        artifacts.check_overwrite(out_path, backend, force=args.force)
    except artifacts.ProvenanceError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    stamp = device_stamp(device)

    t0 = time.monotonic()
    knobs, evidence = measure_survivors(plan, probes, budget_s, log=log,
                                        device=device)
    evidence.update(stamp)
    evidence["sweep_secs"] = round(time.monotonic() - t0, 2)
    evidence["prune"] = {
        "raw_points": plan["raw_points"],
        "pruned_points": plan["pruned_points"],
        "prune_frac": round(plan["prune_frac"], 4),
    }

    missing = set(domains) - set(knobs)
    if missing:  # pragma: no cover - GROUPS partition guard upstream
        raise RuntimeError(f"sweep left knobs untuned: {sorted(missing)}")

    record = config.write_tuned_profile(
        out_path, backend, knobs, measured=evidence, force=args.force)
    log(f"[autotune] committed {out_path} (backend={backend})")
    if args.json:
        print(json.dumps({"path": out_path, "record": record, "plan": {
            "raw_points": plan["raw_points"],
            "pruned_points": plan["pruned_points"],
            "prune_frac": plan["prune_frac"],
        }}, sort_keys=True))
    else:
        print(json.dumps(record["knobs"], indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
