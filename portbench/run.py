"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's graph on the card from the seed, copies it to the
host once and hands it to the program's ``io.graph.from_edges``, then
warms up with the cell's own calls (the first run in a checkout builds the
program's CUDA libraries there).  The window then drives the cell's entry
back to back, one client in a closed loop, for ``--seconds``; the
end-to-end metrics come from the host clock around each call.  With
``--trace 1`` the window runs under ``torch.profiler`` and the per-layer
metrics and a breakdown are reported instead.

Once the window has closed, a sample of the window's answers, drawn from
the seed, is held to the plain reference (``reference.py``) at float64,
and each number compared is printed beside its limit, as the last lines of
standard error and under ``checks``, last in the result.  The result is
the last line of standard output, one JSON object.

Exit codes: 0 with a result; 2 without a card or with fewer cards than
the cell asks for; 3 when ``jax``, ``jaxlib``, ``flax`` or the JAX package
were loaded; 1 on any other failure.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Top-level module names the process may not hold: the JAX package beside
# the program, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "page_rank_and_tfidf_using_apache_spark_tpu")

# Caches a run may fill, at fixed paths inside the checkout (git-ignored).
CACHE_DIR = ".portbench_cache"


def info(**kv) -> None:
    """One earlier line of standard output: what the run saw, not a result."""
    print(json.dumps(kv), flush=True)


def card_line() -> dict:
    """The card's name, power limit and clocks as ``nvidia-smi`` reads them."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not available: {exc}"}
    return dict(zip(fields.split(","), (s.strip() for s in out.splitlines()[0].split(","))))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def quiet_program_env() -> None:
    """The program's ``GRAFT_*`` knobs (fault plans, trace sinks, profiles)
    are cleared so every run is the same; its per-record log to standard
    error is held to warnings."""
    for key in [k for k in os.environ if k.startswith("GRAFT_")]:
        del os.environ[key]
    os.environ["GRAFT_LOG_LEVEL"] = "WARNING"


def fixed_caches(root: Path) -> None:
    """Point every kernel cache a run may fill at a fixed directory inside
    the checkout, so only its first run builds; the program's own CUDA
    libraries build into its package's ``_build/``, also inside it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = root / CACHE_DIR / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def _cpu_s() -> tuple[float, float]:
    """This process's user and system CPU seconds: the program's host work
    a call, beside its wall time."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime


def _finite(x: float) -> float:
    """JSON holds no infinity: a reading that is not a finite number is
    written as the largest double."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else sys.float_info.max


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None, control=None) -> dict:
    """One run of the cell ``workload``; returns the result object.

    ``control``, where given, is ``make(src, dst, n, device)``, called once
    with the raw edge arrays; what it returns is called in the program's
    place with the arguments of an entry's ``call`` (the lower-precision
    control of the comparison, ``control.py``).  A call's batch is None
    (a uniform restart) or its queries' source ids, and the reference
    answers the same."""
    import numpy as np
    import torch

    from portbench import checks, devtrace, graphgen, layers, reference, spec

    t0 = T0 if t0 is None else t0
    root = Path(root)
    cell = spec.load(root, workload)
    entry = spec.entry(root, cell.traffic["entry"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import from_edges
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    if on_card:
        torch.zeros(1, device=dev)  # the CUDA context
        info(card=card_line(), torch=torch.__version__, cuda=torch.version.cuda)
    t_init = time.perf_counter()

    g = cell.config["graph"]
    edges = graphgen.generate(g["nodes"], g["edges"], seed=seed, device=dev,
                              **{k: g[k] for k in ("out_exponent", "in_exponent", "max_out_degree",
                                                   "max_in_degree", "dangling_share")})
    info(graph=graphgen.stats(edges))
    src_np, dst_np = edges.src.cpu().numpy(), edges.dst.cpu().numpy()
    n, e = edges.n, int(src_np.shape[0])
    del edges
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_gen = time.perf_counter()

    graph = from_edges(src_np, dst_np, compact_ids=False)
    if (graph.n_nodes, graph.n_edges) != (n, e):
        raise RuntimeError(f"the program's graph has {graph.n_nodes} nodes and "
                           f"{graph.n_edges} edges, the generator's {n} and {e}")
    t_ingest = time.perf_counter()

    cfg = PageRankConfig(iterations=int(cell.traffic["iterations"]), **cell.config["pagerank"])
    calls = entry.Calls(seed, cell.traffic, n)
    call = entry.call if control is None else control(src_np, dst_np, n, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    call(graph, cfg, calls.warmup(), dev)
    if on_card:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    t_warm = time.perf_counter()
    setup_s = t_warm - t0
    info(setup={"imports_and_cuda_init_s": t_init - t0, "generate_s": t_gen - t_init,
                "from_edges_s": t_ingest - t_gen, "warmup_s": t_warm - t_ingest,
                "setup_s": setup_s})

    # the window: one client, calls back to back
    keep = int(cell.traffic["compare_calls"])
    pick = np.random.default_rng([int(seed), 3])
    sample: list[tuple[int, object, np.ndarray]] = []
    done: list[layers.Call] = []
    attempted = failed = 0
    cpu0 = _cpu_s()
    with devtrace.profiled(trace) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            start = time.perf_counter()
            end = start
            deadline = start + seconds
            while time.perf_counter() < deadline:
                batch = calls.next()
                attempted += 1
                c0 = time.perf_counter()
                try:
                    with torch.profiler.record_function("portbench.call"):
                        out, got = call(graph, cfg, batch, dev)
                except Exception as exc:  # noqa: BLE001 — a failed call is counted, and the run goes on
                    failed += 1
                    print(f"call {attempted - 1} failed: {type(exc).__name__}: {exc}",
                          file=sys.stderr)
                    end = time.perf_counter()
                    continue
                end = time.perf_counter()
                done.append(layers.Call(end - c0, int(got["iterations"]), int(got["queries"]),
                                        list(got["records"])))
                # reservoir sample of the answers, drawn from the seed
                slot = len(sample) if len(sample) < keep else int(pick.integers(0, len(done)))
                if slot < keep:
                    kept = (attempted - 1, batch, out)
                    if slot == len(sample):
                        sample.append(kept)
                    else:
                        sample[slot] = kept
    window_s = end - start
    cpu = [b - a for a, b in zip(cpu0, _cpu_s())]
    summary = devtrace.summarize(devtrace.events(prof)) if prof is not None else None
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ctx = layers.Context(calls=done, window_s=window_s, setup_s=setup_s, nodes=n, edges=e,
                         config=cell.config, trace=summary)
    info(window={"calls": len(done), "attempted": attempted, "failed": failed,
                 "window_s": window_s, "compared_calls": sorted(s[0] for s in sample),
                 "put_graph_ms": layers.put_graph_ms(ctx), "loop_ms": layers.loop_ms(ctx),
                 "call_ms": [1e3 * c.latency_s for c in done[:8]],
                 "per_call": {k: v / max(1, attempted) for k, v in
                              zip(("user_s", "system_s"), cpu)}})

    # the comparison, once the window has closed and the program's state is freed
    del graph
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    pr = cell.config["pagerank"]
    ref_graph = reference.build(src_np, dst_np, n, dev)
    worst, refs = None, {}
    for _, batch, out in sample:
        key = json.dumps(batch)
        if key not in refs:  # only the newest is held: a call of PageRank asks one question
            refs = {key: reference.pagerank(
                ref_graph, reference.restart_matrix(n, batch, dev), iterations=cfg.iterations,
                damping=pr["damping"], dangling=pr["dangling"], init=pr["init"])}
        worst = checks.worst(worst, checks.readings(out, refs[key]))
    del ref_graph, refs
    ok, table = checks.judge(worst, cell.limits or {})
    correct = ok and failed == 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": cell.chips if on_card else 1,
                   "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = devtrace.breakdown(summary)
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in table.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    quiet_program_env()
    fixed_caches(root)

    import torch

    from portbench import spec

    cell = spec.load(root, args.workload)
    if cell.limits is None:
        print(f"no limits file for {args.workload}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
