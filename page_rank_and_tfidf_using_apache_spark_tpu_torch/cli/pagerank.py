"""PageRank CLI — the reference's ``spark-submit pagerank.py <edges>
<iters>`` entry point, positional args first, every reconstructed-semantics
ambiguity an explicit flag.  Runs on ``cuda`` unless ``--device`` says
otherwise.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.pagerank \
        edges.txt 20 --output ranks.txt --dangling redistribute
    python -m ...cli.pagerank edges.txt 20 --checkpoint-dir ck \
        --checkpoint-every 5 [--resume]

The flags are the JAX CLI's.  Every tunable knob resolves as the flag,
then the tuned profile of the device's backend (``--tuned-profile``, else
``$GRAFT_TUNED_PROFILE``, else the port's committed
``tuned_profile_<backend>.json``; ``off`` disables it), then
``TUNABLE_DEFAULTS``.  ``--mesh N`` runs the sharded path
(``parallel.pagerank_sharded``) over a mesh of N slots, partitioned by
``--shard-strategy``: the visible cards, or N CPU slots under ``--device
cpu``; more slots than visible cards raises.
"""

from __future__ import annotations

import argparse
import json
import sys

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (
    load_snap,
    save_ranks,
    synthetic_powerlaw,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import manifest
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
    STRATEGIES,
    run_pagerank_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    SPMV_IMPLS,
    PageRankConfig,
    tuned_config,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
    backend_name,
    resolve_device,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.profiling import trace

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pagerank",
        description="PageRank over a SNAP-format edge list, in PyTorch on one GPU.",
    )
    p.add_argument("input", help="SNAP edge-list file, or 'synthetic:N,E[,seed]'")
    p.add_argument("iterations", nargs="?", type=int, default=20)
    p.add_argument("--output", help="write '<node>\\t<rank>' lines here")
    p.add_argument("--top-k", type=int, default=None, help="only save the top-k ranks")
    p.add_argument("--damping", type=float, default=0.85)
    p.add_argument("--tol", type=float, default=0.0, help="early-stop L1 tolerance")
    p.add_argument("--dangling", choices=["drop", "redistribute"], default="drop")
    p.add_argument("--init", choices=["one", "uniform"], default="one")
    p.add_argument("--spark-exact", action="store_true",
                   help="bit-exact canonical Spark example semantics")
    p.add_argument("--personalize", type=int, nargs="+", default=None,
                   metavar="NODE",
                   help="personalized PageRank source node(s), as ORIGINAL "
                        "ids from the input file")
    p.add_argument("--spmv-impl", choices=list(SPMV_IMPLS), default="segment")
    p.add_argument("--head-coverage", type=float, default=None,
                   help="hybrid impl: edge-coverage threshold of the dense "
                        "high-in-degree head (default: tuned profile, then "
                        "TUNABLE_DEFAULTS)")
    p.add_argument("--head-row-width", type=int, default=None,
                   help="hybrid impl: dense row width (adapts down on small "
                        "graphs; default: tuned profile, then "
                        "TUNABLE_DEFAULTS)")
    p.add_argument("--tuned-profile", default=None, metavar="PATH",
                   help="tuned-profile artifact to resolve unset knobs "
                        "from ('off' disables profile loading; default: "
                        "$GRAFT_TUNED_PROFILE, then the port's committed "
                        "tuned_profile_<backend>.json)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="iterations between checkpoints (0 = none; only "
                        "without --tol)")
    p.add_argument("--resume", action="store_true",
                   help="start from the newest checkpoint under "
                        "--checkpoint-dir")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--metrics-json", help="dump structured metrics JSON here")
    p.add_argument("--profile-dir",
                   help="torch.profiler Chrome trace output dir (host and card)")
    p.add_argument("--trace-dir", default=None,
                   help="obs run-telemetry dir: write <name>.<pid>.trace.jsonl"
                        " + manifest here (default: $GRAFT_TRACE_DIR)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over a mesh of this many slots (the visible "
                        "cards; CPU slots under --device cpu); 0 = single "
                        "device")
    p.add_argument("--shard-strategy",
                   choices=["auto", *STRATEGIES],
                   default="auto",
                   help="graph partition under --mesh: auto (by the per-slot "
                        "memory budget and degree shape) / balanced edge "
                        "slices / node blocks / edge-balanced node blocks "
                        "(power-law) / source-block push with reduce-scatter "
                        "(or explicit ppermute-ring) exchange / degree-aware "
                        "hybrid (dense head rows + tail edge slices) / owned "
                        "slices with a boundary exchange")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # The traced run covers the whole command: manifest at startup, every
    # span and metric event flushed per-event to the JSONL trace, run-end
    # summary at exit (no-op without --trace-dir/GRAFT_TRACE_DIR).
    # knob resolution ladder: explicit flag > tuned profile of the
    # requested device's backend (same-backend only, ProvenanceError
    # otherwise) > TUNABLE_DEFAULTS; the manifest records the profile, or
    # why it was refused
    profile, snapshot, refused = manifest.resolve_tuned_profile(
        backend_name(args.device), args.tuned_profile)
    with manifest.recording_profile(snapshot), obs.run("pagerank", trace_dir=args.trace_dir):
        if refused is not None:
            raise refused
        return _main(args, profile)


def _main(args, profile) -> int:
    device = resolve_device(args.device)
    metrics = MetricsRecorder()

    with Timer() as t_load:
        if args.input.startswith("synthetic:"):
            parts = args.input.split(":", 1)[1].split(",")
            n, e = int(parts[0]), int(parts[1])
            seed = int(parts[2]) if len(parts) > 2 else 0
            graph = synthetic_powerlaw(n, e, seed=seed)
        else:
            graph = load_snap(args.input)
    metrics.record(event="load", nodes=graph.n_nodes, edges=graph.n_edges,
                   secs=t_load.elapsed)

    cfg = tuned_config(
        PageRankConfig, profile,
        iterations=args.iterations,
        damping=args.damping,
        tol=args.tol,
        dangling=args.dangling,
        init=args.init,
        spark_exact=args.spark_exact,
        personalize=tuple(args.personalize) if args.personalize else None,
        spmv_impl=args.spmv_impl,
        head_coverage=args.head_coverage,
        head_row_width=args.head_row_width,
        dtype=args.dtype,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )
    with trace(args.profile_dir):
        if args.mesh:
            result = run_pagerank_sharded(
                graph, cfg, n_devices=args.mesh, strategy=args.shard_strategy,
                metrics=metrics, resume=args.resume, device=device,
            )
        else:
            result = run_pagerank(graph, cfg, metrics=metrics, resume=args.resume,
                                  device=device)

    if args.output:
        save_ranks(args.output, graph, result.ranks, top_k=args.top_k)
    else:
        order = result.ranks.argsort()[::-1][: args.top_k or 10]
        for i in order:
            print(f"{graph.node_ids[i]}\t{result.ranks[i]:.10g}")

    summary = {
        "nodes": graph.n_nodes, "edges": graph.n_edges,
        "iterations": result.iterations, "l1_delta": result.l1_delta,
    }
    print(json.dumps(summary), file=sys.stderr)
    if args.metrics_json:
        metrics.dump(args.metrics_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
