#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU and check what comes out.

Usage (from the repository root, on a machine with one NVIDIA H100 and the
CUDA toolkit under /usr/local/cuda or $CUDA_HOME)::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA kernel of the port from ``csrc/`` (``nvcc``, all
   sources at once) and print the build seconds;
3. every kernel against its plain PyTorch version on the card, over a
   sweep of shapes and at the shapes the main path gives it, with kernel,
   plain, library-call and lower-bound times;
4. the main path, ``run_pagerank`` at web-Google scale (875K nodes, 5.1M
   edges, 20 iterations), through the ``segment``, ``pallas`` and
   ``hybrid`` SpMV impls, checked against an f64 run and counting kernel
   launches; every impl is also held against a dense f64 power iteration
   on a small graph;
5. the port's CLI once, at the same scale, with its output file checked;
6. one JSON line describing every kernel, then the result line.

Without a CUDA device, or without the port's package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core float32 / float64 rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

# Tolerances of a kernel against its plain version on the same input.
# cumsum: |kernel - plain| <= rtol * (running sum of |x|); the two sum in
# different orders, and in float32 that is the prefix-sum accuracy class
# of the JAX package's spmv_cumsum (about 2e-4 relative per SpMV).
# rowsum: |kernel - plain| <= rtol * (row sum of |x|).
CUMSUM_RTOL = {torch.float32: 2e-4, torch.float64: 1e-12}
ROWSUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}

N_NODES, N_EDGES, SEED, ITERS = 875_000, 5_100_000, 7, 20
MAIN_IMPLS = ("segment", "pallas", "hybrid")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int = 21) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, CUDA events
    around each, with the 50 MB L2 cache flushed before each call.  A spin
    kernel ahead of the start event keeps the device busy while the host
    enqueues the call, so the events bracket device time and not the
    host's launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(200_000)  # ~0.1 ms of clock cycles
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_cumsum(pk, x: torch.Tensor, label: str) -> dict:
    got = pk.cumsum_kernel(x)
    want = pk.cumsum_plain(x)
    torch.cuda.synchronize()
    check(got.shape == x.shape and got.dtype == x.dtype, f"cumsum {label} shape/dtype")
    err_abs = float((got - want).abs().max()) if x.numel() else 0.0
    scale = torch.cumsum(x.abs(), 0).clamp_min(torch.finfo(x.dtype).tiny)
    err_rel = float(((got - want).abs() / scale).max()) if x.numel() else 0.0
    rtol = CUMSUM_RTOL[x.dtype]
    check(bool(torch.isfinite(got).all()) and err_rel <= rtol,
          f"cumsum {label}: error {err_rel:.3g} of the running sum of |x| > {rtol}")
    n, size = x.numel(), x.element_size()
    b, by = bound_ms(2 * n * size, n, x.dtype)
    row = {"ms": time_ms(lambda: pk.cumsum_kernel(x)),
           "plain_ms": time_ms(lambda: pk.cumsum_plain(x)),
           "library_ms": time_ms(lambda: torch.cumsum(x, 0)),
           "bound_ms": b, "bound_by": by, "max_abs_err": err_abs}
    print(f"cumsum {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {b:.4f} ms ({by}), "
          f"max_abs_err {err_abs:.3g}, rel {err_rel:.3g} (tol {rtol})")
    return row


def measure_rowsum(pk, rows: torch.Tensor, label: str) -> dict:
    got = pk.rowsum_kernel(rows)
    want = pk.rowsum_plain(rows)
    torch.cuda.synchronize()
    check(got.shape == (rows.shape[0],), f"rowsum {label} shape")
    err_abs = float((got - want).abs().max())
    scale = rows.abs().sum(dim=1).clamp_min(torch.finfo(rows.dtype).tiny)
    err_rel = float(((got - want).abs() / scale).max())
    rtol = ROWSUM_RTOL[rows.dtype]
    check(bool(torch.isfinite(got).all()) and err_rel <= rtol,
          f"rowsum {label}: error {err_rel:.3g} of the row sum of |x| > {rtol}")
    r, w = rows.shape
    size = rows.element_size()
    b, by = bound_ms(r * w * size + r * size, r * (w - 1), rows.dtype)
    ones = torch.ones(w, dtype=rows.dtype, device=rows.device)
    row = {"ms": time_ms(lambda: pk.rowsum_kernel(rows)),
           "plain_ms": time_ms(lambda: pk.rowsum_plain(rows)),
           "library_ms": time_ms(lambda: torch.mv(rows, ones)),
           "bound_ms": b, "bound_by": by, "max_abs_err": err_abs}
    print(f"rowsum {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {b:.4f} ms ({by}), "
          f"max_abs_err {err_abs:.3g}, rel {err_rel:.3g} (tol {rtol})")
    return row


def profile_loop(runner, dg, ranks0, e) -> tuple[float, list]:
    """Device time (ms) of one run of the iteration loop under
    ``torch.profiler``, and its kernels and copies by device time.  Only
    device-side events count: a host op's device total repeats its
    kernels', and so does the profiler's own ``ProfilerStep`` range.  The
    first profiled run is a warm-up the profiler discards: a trace that
    starts with the loop misses its first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(2):
            float(runner(dg, ranks0, e)[2])
            prof.step()
    check(len(traces) == 1, f"profiler delivered {len(traces)} traces, wanted 1")
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in traces[0]
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and not ev.key.startswith("ProfilerStep")]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def dense_pagerank(graph, iterations: int, damping: float = 0.85) -> np.ndarray:
    """f64 power iteration on a dense matrix: the reference for the small
    graph (dangling=redistribute, init=uniform, uniform restart)."""
    n = graph.n_nodes
    a = np.zeros((n, n))
    np.add.at(a, (graph.dst, graph.src), 1.0 / graph.out_degree[graph.src])
    dangling = graph.out_degree == 0
    r = np.full(n, 1.0 / n)
    for _ in range(iterations):
        r = (1.0 - damping) / n + damping * (a @ r + r[dangling].sum() / n)
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs one CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as cli
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
        put_graph_for,
        run_pagerank,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        SPMV_IMPLS,
        PageRankConfig,
    )

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build every kernel from csrc/, all sources at once
    t0 = time.perf_counter()
    built = _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall; "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    for name, info in built.items():
        print(f"--- nvcc {name}.cu ---\n{info['log'].strip()}", file=sys.stderr)

    t0 = time.perf_counter()
    graph = synthetic_powerlaw(N_NODES, N_EDGES, seed=SEED)
    hl = ops.build_hybrid_layout(graph)
    print(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges, hybrid head "
          f"{hl.head_src.shape[0]} rows x {hl.head_src.shape[1]} "
          f"({hl.head_edges} edges); host build {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions on the card
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.float64):
        for e in (0, 1, 31, 1024, 1025, N_EDGES):
            x = torch.from_numpy(rng.standard_normal(e)).to("cuda", dtype)
            measure_cumsum(pk, x, f"E={e} {dtype}")
        for w in (8, 16, 32, 64, 128):
            for r in (1, 1023, 1025, hl.head_src.shape[0]):
                rows = torch.from_numpy(rng.random((r, w))).to("cuda", dtype)
                measure_rowsum(pk, rows, f"R={r} W={w} {dtype}")

    # the main path's own inputs: per-edge values w[src] at uniform ranks,
    # and the hybrid head's gathered rows
    inv = torch.from_numpy(graph.inv_out_strength("float32")).to("cuda")
    weighted = inv / graph.n_nodes
    per_edge = weighted[torch.from_numpy(graph.src).to("cuda")]
    w_ext = torch.cat([weighted, weighted.new_zeros(1)])
    head_rows = w_ext[torch.from_numpy(hl.head_src).to("cuda")]
    main_rows = {
        "cumsum": measure_cumsum(pk, per_edge, f"main path E={per_edge.shape[0]}"),
        "rowsum": measure_rowsum(pk, head_rows, f"main path R={head_rows.shape[0]} "
                                                f"W={head_rows.shape[1]}"),
    }

    # 4a. every impl against a dense f64 power iteration on a small graph
    small = synthetic_powerlaw(300, 1500, seed=3)
    want = dense_pagerank(small, ITERS)
    for impl in SPMV_IMPLS:
        got = run_pagerank(small, PageRankConfig(
            iterations=ITERS, dangling="redistribute", init="uniform",
            dtype="float64", spmv_impl=impl), device="cuda").ranks
        err = float(np.abs(got - want).max())
        print(f"small graph {impl}: max abs error {err:.3g} vs dense f64")
        check(err <= 1e-12, f"small graph {impl}: {err} > 1e-12")

    # 4b. the main path at full width
    base = dict(iterations=ITERS, dangling="redistribute", init="uniform")
    ref = run_pagerank(graph, PageRankConfig(**base, dtype="float64"), device="cuda").ranks
    launches = {}
    ranks_by_impl = {}
    loop_ms = {}
    for impl in MAIN_IMPLS:
        cfg = PageRankConfig(**base, dtype="float32", spmv_impl=impl)
        run_pagerank(graph, cfg, device="cuda")  # warm-up, not counted
        pk.reset_launches()
        res = run_pagerank(graph, cfg, device="cuda")
        counts = dict(pk.LAUNCHES)
        ranks = res.ranks
        ranks_by_impl[impl] = ranks
        step = res.metrics.records[-1]
        put = next(r for r in res.metrics.records if r.get("event") == "put_graph")
        total = float(ranks.sum(dtype=np.float64))
        l1 = float(np.abs(ranks.astype(np.float64) - ref).sum())
        rates = [step["iters_per_sec"]] + [
            run_pagerank(graph, cfg, device="cuda").metrics.records[-1]["iters_per_sec"]
            for _ in range(4)]
        print(f"main path {impl}: {np.median(rates):.2f} iterations/s median of 5 runs "
              f"(min {min(rates):.2f}, max {max(rates):.2f}; counted run "
              f"{step['secs'] * 1e3:.2f} ms for {res.iterations}), put_graph "
              f"{put['preprocess_secs']:.2f} s, sum {total:.9f}, L1 vs f64 segment "
              f"{l1:.3g}, launches {counts}")
        check(ranks.shape == (graph.n_nodes,) and bool(np.isfinite(ranks).all()),
              f"{impl}: ranks not finite or wrong shape")
        check(res.iterations == ITERS, f"{impl}: ran {res.iterations} iterations")
        check(abs(total - 1.0) <= 1e-3, f"{impl}: ranks sum to {total}")
        check(l1 <= 1e-3, f"{impl}: L1 {l1} vs f64 segment > 1e-3")
        launches[impl] = counts
        loop_ms[impl] = ITERS / float(np.median(rates)) * 1e3
    check(launches["pallas"]["cumsum"] >= ITERS,
          f"pallas run launched cumsum {launches['pallas']['cumsum']} times")
    check(launches["hybrid"]["rowsum"] >= ITERS,
          f"hybrid run launched rowsum {launches['hybrid']['rowsum']} times")

    # 4c. where the loop's time goes: device time by kernel, and the share
    # of the unprofiled loop wall time the device was busy
    for impl in MAIN_IMPLS:
        cfg = PageRankConfig(**base, dtype="float32", spmv_impl=impl)
        dg = put_graph_for(graph, cfg, "cuda")
        e = torch.from_numpy(ops.restart_vector(graph.n_nodes, cfg)).to("cuda")
        r0 = torch.from_numpy(ops.init_ranks(graph.n_nodes, cfg)).to("cuda")
        device_ms, rows = profile_loop(ops.make_pagerank_runner(graph.n_nodes, cfg), dg, r0, e)
        print(f"profile {impl}: device {device_ms:.3f} ms of a {loop_ms[impl]:.3f} ms loop "
              f"(busy {device_ms / loop_ms[impl]:.3f}); top kernels, ms per run: "
              + "; ".join(f"{k[:60]} {t:.3f} x{c}" for k, t, c in rows[:8]))

    # 5. the CLI once, at the same scale
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.tsv")
        rc = cli.main([f"synthetic:{N_NODES},{N_EDGES},{SEED}", str(ITERS),
                       "--spmv-impl", "pallas", "--dangling", "redistribute",
                       "--init", "uniform", "--device", "cuda", "--output", out])
        check(rc == 0, f"CLI exited {rc}")
        table = np.loadtxt(out, dtype=np.float64, delimiter="\t", ndmin=2)
    ids, vals = table[:, 0].astype(np.int64), table[:, 1]
    rows = np.searchsorted(graph.node_ids, ids)  # original id -> row
    check(bool(np.all(graph.node_ids[np.minimum(rows, graph.n_nodes - 1)] == ids)),
          "CLI output names ids that are not in the graph")
    expect = ranks_by_impl["pallas"][rows]
    cli_err = float(np.abs(vals - expect).max())
    print(f"cli: {len(ids)} lines, sum {vals.sum():.9f}, max abs diff vs the "
          f"pallas run {cli_err:.3g}")
    check(len(ids) == graph.n_nodes and len(set(ids.tolist())) == graph.n_nodes,
          "CLI output does not list every node once")
    check(bool(np.all(np.diff(vals) <= 0)), "CLI output not in descending rank order")
    check(cli_err <= 1e-9 * float(expect.max()), "CLI ranks differ from the pallas run")

    # 6. the kernels line, then the result line
    meta = {
        "cumsum": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/cumsum.cu",
                   "page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py:78",
                   launches["pallas"]["cumsum"]),
        "rowsum": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/rowsum.cu",
                   "page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py:118",
                   launches["hybrid"]["rowsum"]),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": n, **main_rows[name]}
        for name, (src, replaces, n) in meta.items()
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
