"""PageRank CLI — the reference's ``spark-submit pagerank.py <edges>
<iters>`` entry point, positional args first, every reconstructed-semantics
ambiguity an explicit flag.  Runs on ``cuda`` unless ``--device`` says
otherwise.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.pagerank \
        edges.txt 20 --output ranks.txt --dangling redistribute
"""

from __future__ import annotations

import argparse
import json
import sys

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (
    load_snap,
    save_ranks,
    synthetic_powerlaw,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    SPMV_IMPLS,
    PageRankConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer


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
                        "high-in-degree head (default: TUNABLE_DEFAULTS)")
    p.add_argument("--head-row-width", type=int, default=None,
                   help="hybrid impl: dense row width (adapts down on small "
                        "graphs; default: TUNABLE_DEFAULTS)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--metrics-json", help="dump structured metrics JSON here")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
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

    # knob resolution: explicit flag, else the field default
    # (TUNABLE_DEFAULTS); an unset flag is None and is left out
    knobs = {"head_coverage": args.head_coverage,
             "head_row_width": args.head_row_width}
    cfg = PageRankConfig(
        iterations=args.iterations,
        damping=args.damping,
        tol=args.tol,
        dangling=args.dangling,
        init=args.init,
        spark_exact=args.spark_exact,
        personalize=tuple(args.personalize) if args.personalize else None,
        spmv_impl=args.spmv_impl,
        dtype=args.dtype,
        **{k: v for k, v in knobs.items() if v is not None},
    )
    result = run_pagerank(graph, cfg, metrics=metrics, device=args.device)

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
