"""The multi-device dry run and the owned-scale sweep, on the port: the
counterparts of ``__graft_entry__.dryrun_multichip`` and
``_owned_scale_sweep`` (``__graft_entry__.py:43-184``).

:func:`dryrun_multichip` runs every shard strategy on the reference's tiny
graph (``synthetic_powerlaw(64, 256, seed=0)``, 2 iterations, personalized
on nodes 1 and 5) and the sharded TF-IDF over one mesh of ``n_devices``
slots, then :func:`owned_scale_sweep`: Zipf graphs at 1x, 4x and 10x
web-Google's node count through the ``owned`` strategy.  The sweep reads
the reference's knobs with its defaults, so both sweeps run the same
points: ``BENCH_OWNED_SCALES`` ("1,4,10"; empty skips the sweep),
``BENCH_OWNED_BASE_NODES`` (875000), ``BENCH_OWNED_AVG_DEG`` (5.83) and
``BENCH_OWNED_HBM_BYTES`` (256 MiB).  It asserts what the reference
asserts: where the sweep spans at least 4x in n, per-step comm bytes grow
sublinearly in n (the fitted exponent is below 1), the top scale's
replicated state exceeds half the budget and ``auto_select_strategy``
picks ``owned``.

The mesh (:func:`dryrun_mesh`) is one slot a card where ``device`` is
``cuda`` and that many cards are visible, else ``n_devices`` slots of the
one device (``cuda:0``, or the CPU when the caller asks for it): the
D-shard layout on one card, as ``chip_smoke.py`` phase 16 builds it.  The
reference forces the CPU for its dry run; the port runs where it is told.

Each scale point is also held to one device: the ``owned`` ranks beside a
one-device ``run_pagerank`` of the same graph and config, in float32, where
no entry's bits may differ (``owned`` adds the head's per-slot partial sums
and the dangling mass across the slots in float64 and rounds once, as one
device rounds each row and the mass), and in float64, where the L1 must
stay within ``F64_L1`` (the sharded paths' bar against one device).  The
reference's ``owned`` does not hold float32 bits: it adds float32 partials
across its devices.  Each point's record carries its graph build,
partition and put seconds, iterations/s, the rank sum, the bytes the
float64 head psum moves a step beside the reference's
``comm_bytes_per_step`` model, and
``torch.cuda.max_memory_allocated`` over the float32 ``owned`` run (and
what the card held before it) beside ``replicated_state_bytes``.  The host's Zipf build dominates the sweep's
time; a caller may build the points' graphs ahead (:func:`sweep_points`,
:func:`sweep_graph`) and hand them in (``graph_at``).

Usage, from the repository root::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.dryrun [N] \\
        [--device cuda|cpu] [--out FILE]

``N`` defaults to the reference's 8.  It prints the reference's lines, then
one JSON line stamped with the backend, the card's name and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import tools
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.chaos_scenarios import check
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device

STRATEGIES = ("edges", "nodes", "nodes_balanced", "src", "src_ring", "hybrid", "owned")
# float64 owned against one device: the sharded paths' bar (chip_smoke.py
# 16b, the owned smoke of tools/ci_smokes.py)
F64_L1 = 1e-9


def tiny_graph():
    """The reference dry run's graph (``__graft_entry__._tiny_graph``)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw

    return synthetic_powerlaw(64, 256, seed=0)


def dryrun_mesh(n_devices: int, device=None):
    """``(mesh, layout)``: one slot a card for a ``cuda`` device without an
    index when ``n_devices`` cards are visible, else ``n_devices`` slots of
    the one device (``cuda`` means ``cuda:0``).  ``layout`` says which."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import NODES_AXIS, make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
        layout = f"one slot a card on {n_devices} cards"
    else:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        devices = [dev] * n_devices
        layout = f"{n_devices} slots of {dev}"
    return make_mesh(n_devices, NODES_AXIS, devices=devices), layout


def _cards(mesh) -> list:
    return sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)


def bits_differ(a: np.ndarray, b: np.ndarray) -> int:
    """Entries of two float arrays of one shape and dtype whose bits differ."""
    u = np.dtype(f"u{a.dtype.itemsize}")
    return int(np.count_nonzero(a.view(u) != b.view(u)))


def sweep_scales() -> list:
    """``BENCH_OWNED_SCALES`` as the reference parses it: sorted, blank
    segments skipped."""
    return sorted(float(s) for s in os.environ.get("BENCH_OWNED_SCALES", "1,4,10").split(",")
                  if s.strip())


def sweep_points() -> list:
    """The sweep's ``(scale, n, e)`` points, from the reference's knobs."""
    base_n = int(os.environ.get("BENCH_OWNED_BASE_NODES", "875000"))
    avg_deg = float(os.environ.get("BENCH_OWNED_AVG_DEG", "5.83"))
    return [(s, int(base_n * s), int(base_n * s * avg_deg)) for s in sweep_scales()]


def sweep_graph(n: int, e: int):
    """One point's graph: the reference sweep's generator and seed."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_zipf

    return synthetic_zipf(n, e, seed=7, src_exponent=1.5)


def built_here(n: int, e: int) -> tuple:
    """``(graph, build seconds)`` of one point, built in this process."""
    t0 = time.perf_counter()
    g = sweep_graph(n, e)
    return g, time.perf_counter() - t0


def sweep_verdict(pts: list, avg_deg: float, n_devices: int, budget: int,
                  choice: str) -> dict:
    """The reference's verdict on the sweep's ``(n, comm_bytes_per_step)``
    points (``__graft_entry__.py:164-184``): the fitted comm-bytes exponent,
    the top scale's replicated state against half the budget, and
    ``choice``, ``auto_select_strategy`` at the top scale.  Prints the
    reference's line; where the sweep spans at least 4x in n, raises
    ``AssertionError`` unless the exponent is below 1, the replicated state
    does not fit and the choice is ``owned``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
        replicated_state_bytes,
    )

    ln = np.log([float(p[0]) for p in pts])
    lc = np.log([float(max(p[1], 1)) for p in pts])
    expo = float(np.polyfit(ln, lc, 1)[0])
    replicated = replicated_state_bytes(pts[-1][0], int(pts[-1][0] * avg_deg), n_devices)
    does_not_fit = replicated > budget / 2
    print(f"owned-scale sweep: comm-bytes exponent {expo:.3f} "
          f"(sublinear: {expo < 1.0}); top scale replicated state "
          f"{replicated} B > budget/2 "
          f"{budget // 2} B: {does_not_fit}; auto_select -> {choice}")
    # the reference's guard: the fit only outruns the pow2 boundary-buffer
    # quantization when the sweep spans >= 4x in n
    if pts[-1][0] >= 4 * pts[0][0]:
        check(expo < 1.0, f"comm bytes not sublinear: {pts}")
        check(does_not_fit and choice == "owned", (replicated, budget, choice))
    return {"comm_bytes_exponent": expo, "top_replicated_state_bytes": replicated,
            "budget_bytes": budget, "replicated_fits": not does_not_fit,
            "auto_select": choice}


def owned_scale_sweep(mesh, n_devices: int, graph_at=built_here) -> dict | None:
    """The owned-scale sweep over ``mesh`` (see the module docstring), each
    point's graph and its build seconds from ``graph_at(n, e)``.  Returns
    ``{"points": [...], **sweep_verdict(...)}``, or None when
    ``BENCH_OWNED_SCALES`` is empty."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        auto_select_strategy,
        run_pagerank_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
        replicated_state_bytes,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    points = sweep_points()
    if not points:
        print("owned-scale sweep: skipped (BENCH_OWNED_SCALES empty)")
        return None
    avg_deg = float(os.environ.get("BENCH_OWNED_AVG_DEG", "5.83"))
    budget = int(os.environ.get("BENCH_OWNED_HBM_BYTES", str(256 << 20)))
    cfg = PageRankConfig(iterations=2, dangling="redistribute", init="uniform",
                         dtype="float32")
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    one_device = mesh.devices[0]
    cards = _cards(mesh)
    records, top = [], None
    for s, n, e in points:
        g, build_secs = graph_at(n, e)
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        before = max((torch.cuda.memory_allocated(c) for c in cards), default=None)
        m = MetricsRecorder()
        res = run_pagerank_sharded(g, cfg, mesh=mesh, strategy="owned", metrics=m)
        peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=None)
        part = next(r for r in m.records if r.get("event") == "partition")
        rate = next(r["iters_per_sec"] for r in reversed(m.records) if "iters_per_sec" in r)
        check(bool(np.isfinite(res.ranks).all()), f"owned-scale {s:g}x: ranks not finite")
        total = float(res.ranks.sum())
        check(0.99 < total < 1.01, f"owned-scale {s:g}x: ranks sum to {total}")
        print(f"owned-scale {s:g}x on {n_devices} devices: n={n} e={e} "
              f"comm_bytes_per_step={part['comm_bytes_per_step']} "
              f"(sum={res.ranks.sum():.4f})")
        one = run_pagerank(g, cfg, device=one_device).ranks
        differ = bits_differ(res.ranks, one)
        l1_32 = float(np.abs(res.ranks.astype(np.float64) - one).sum())
        r64 = run_pagerank_sharded(g, cfg64, mesh=mesh, strategy="owned").ranks
        l1_64 = float(np.abs(r64 - run_pagerank(g, cfg64, device=one_device).ranks).sum())
        rec = {"scale": s, "n": n, "e": e,
               "comm_bytes_per_step": int(part["comm_bytes_per_step"]),
               "head_psum_bytes_per_step": int(part["head_psum_bytes_per_step"]),
               "build_secs": build_secs, "partition_secs": part["secs"],
               "put_secs": part["put_secs"], "iters_per_sec": rate, "rank_sum": total,
               "max_memory_allocated": peak, "memory_allocated_before": before,
               "replicated_state_bytes": replicated_state_bytes(n, e, n_devices),
               "f32_entries_differ_from_one_device": differ, "f32_l1_vs_one_device": l1_32,
               "f64_l1_vs_one_device": l1_64}
        print(f"owned-scale {s:g}x held to one device ({one_device}): float32 {differ} of {n} "
              f"entries differ in bits, L1 {l1_32:.3g}; float64 L1 {l1_64:.3g} "
              f"(bar {F64_L1:g}); the float64 head psum moves "
              f"{rec['head_psum_bytes_per_step']} B a step; "
              f"build {build_secs:.2f} s, partition {part['secs']:.2f} s, "
              f"put {part['put_secs']:.2f} s, {rate:.2f} iterations/s, "
              f"max_memory_allocated {peak} B ({before} B held before the run) beside "
              f"replicated_state_bytes {rec['replicated_state_bytes']} B")
        check(differ == 0, f"owned-scale {s:g}x: float32 {differ} of {n} entries differ in "
                           "bits from one device")
        check(l1_64 <= F64_L1, f"owned-scale {s:g}x: float64 L1 {l1_64} from one device "
                               f"> {F64_L1:g}")
        records.append(rec)
        top = g
    if len(records) < 2:
        return {"points": records}
    choice = auto_select_strategy(top, n_devices, hbm_bytes=budget)
    pts = [(p["n"], p["comm_bytes_per_step"]) for p in records]
    return {"points": records, **sweep_verdict(pts, avg_deg, n_devices, budget, choice)}


def dryrun_multichip(n_devices: int, *, device=None, graph_at=built_here) -> dict:
    """Every shard strategy and the sharded TF-IDF on ``n_devices`` slots
    (:func:`dryrun_mesh` over ``device``: ``cuda`` unless the caller asks
    for the CPU), then :func:`owned_scale_sweep` over ``graph_at``.  Prints
    the reference's lines; returns the record the CLI prints."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (
        run_pagerank_sharded,
        run_tfidf_sharded,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        PageRankConfig,
        TfidfConfig,
    )

    mesh, layout = dryrun_mesh(n_devices, device)
    print(f"dryrun mesh: {layout}")
    graph = tiny_graph()
    cfg = PageRankConfig(iterations=2, dangling="redistribute", init="uniform",
                         personalize=(1, 5))
    sums = {}
    for strategy in STRATEGIES:
        res = run_pagerank_sharded(graph, cfg, mesh=mesh, strategy=strategy)
        check(res.ranks.shape == (graph.n_nodes,), f"{strategy}: shape {res.ranks.shape}")
        check(bool(np.isfinite(res.ranks).all()), f"{strategy}: ranks not finite")
        sums[strategy] = float(res.ranks.sum())
        print(f"dryrun pagerank[{strategy}] on {n_devices} devices: ok "
              f"(sum={res.ranks.sum():.6f})")

    tcfg = TfidfConfig(vocab_bits=10)
    docs = [f"alpha beta w{i} w{i % 3}" for i in range(4 * n_devices)]
    chunks = [docs[i: i + 2] for i in range(0, len(docs), 2)]
    out = run_tfidf_sharded(iter(chunks), tcfg, mesh=mesh)
    check(out.n_docs == len(docs), f"tfidf: {out.n_docs} docs of {len(docs)}")
    print(f"dryrun tfidf sharded on {n_devices} devices: ok (nnz={out.nnz})")

    return {"n_devices": n_devices, "layout": layout, "strategies": sums,
            "tfidf": {"n_docs": out.n_docs, "nnz": out.nnz},
            "owned_scale": owned_scale_sweep(mesh, n_devices, graph_at)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun", description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8,
                    help="slots of the mesh (default 8, the reference's)")
    tools.add_common_args(ap)
    args = ap.parse_args(argv)
    started = tools.start(args)
    if started is None:
        return 3
    device, backend, stamp = started
    payload = dryrun_multichip(args.n_devices, device=device)
    return tools.emit(args, payload, backend, stamp)


if __name__ == "__main__":
    sys.exit(main())
