"""Graph-workloads CLI: batched personalized PageRank, HITS, connected
components.  Runs on ``cuda`` unless ``--device`` says otherwise.

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.workloads \
        ppr edges.txt --queries 1,2 7 9,12 --iterations 50 --tol 1e-8
    python -m ...cli.workloads hits edges.txt --top-k 10
    python -m ...cli.workloads cc synthetic:10000,40000
    python -m ...cli.workloads hits edges.txt --tol 0 --iterations 100 \
        --checkpoint-dir ck --checkpoint-every 20 [--resume]

The flags and output lines are the JAX CLI's, plus ``--device`` and the
checkpoint flags, which run through the same segment driver as
``cli.pagerank``'s: a run splits into checkpointed segments only at
``--tol 0``.
"""

from __future__ import annotations

import argparse
import json
import sys

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (
    load_snap,
    synthetic_powerlaw,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    SPMV_IMPLS,
    ComponentsConfig,
    HitsConfig,
    PageRankConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer


def _load_graph(spec: str):
    if spec.startswith("synthetic:"):
        parts = spec.split(":", 1)[1].split(",")
        n, e = int(parts[0]), int(parts[1])
        seed = int(parts[2]) if len(parts) > 2 else 0
        return synthetic_powerlaw(n, e, seed=seed)
    return load_snap(spec)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="workloads",
        description="dataflow-core graph workloads: ppr / hits / cc, in PyTorch on one GPU.",
    )
    sub = p.add_subparsers(dest="workload", required=True)

    ppr = sub.add_parser("ppr", help="batched personalized PageRank")
    ppr.add_argument("input", help="SNAP edge list or 'synthetic:N,E[,seed]'")
    ppr.add_argument("--queries", nargs="+", required=True, metavar="IDS",
                     help="one personalization set per query, as "
                          "comma-separated ORIGINAL node ids (e.g. "
                          "'--queries 1,2 7' = two queries)")
    ppr.add_argument("--iterations", type=int, default=50)
    ppr.add_argument("--tol", type=float, default=1e-8)
    ppr.add_argument("--damping", type=float, default=0.85)
    ppr.add_argument("--spmv-impl", default="segment", choices=list(SPMV_IMPLS))
    ppr.add_argument("--dtype", default="float32")
    ppr.add_argument("--top-k", type=int, default=10)

    hits = sub.add_parser("hits", help="HITS hubs/authorities")
    hits.add_argument("input")
    hits.add_argument("--iterations", type=int, default=100)
    hits.add_argument("--tol", type=float, default=1e-8)
    hits.add_argument("--dtype", default="float32")
    hits.add_argument("--top-k", type=int, default=10)

    cc = sub.add_parser("cc", help="connected components (label propagation)")
    cc.add_argument("input")
    cc.add_argument("--iterations", type=int, default=200)
    cc.add_argument("--output", help="write '<node>\\t<component>' lines here")

    for s in (ppr, hits, cc):
        s.add_argument("--metrics-json")
        s.add_argument("--trace-dir", default=None)
        s.add_argument("--device", default=None,
                       help="torch device to run on (default: cuda; 'cpu' runs "
                            "the kernels' plain versions)")
        s.add_argument("--checkpoint-dir", default=None)
        s.add_argument("--checkpoint-every", type=int, default=0,
                       help="iterations between checkpoints (0 = none); a run "
                            "splits only at --tol 0, so cc, which stops on "
                            "a count of changed labels, never does")
        s.add_argument("--resume", action="store_true",
                       help="start from the newest checkpoint under "
                            "--checkpoint-dir")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    with obs.run(f"workload_{args.workload}", trace_dir=args.trace_dir):
        return _main(args)


def _main(args) -> int:
    metrics = MetricsRecorder()
    with Timer() as t_load:
        graph = _load_graph(args.input)
    metrics.record(event="load", nodes=graph.n_nodes, edges=graph.n_edges,
                   secs=t_load.elapsed)
    run_kw = dict(metrics=metrics, resume=args.resume, device=args.device)
    ckpt_kw = dict(checkpoint_every=args.checkpoint_every,
                   checkpoint_dir=args.checkpoint_dir)

    if args.workload == "ppr":
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import (
            run_ppr_batch,
        )

        queries = [[int(x) for x in q.split(",") if x] for q in args.queries]
        cfg = PageRankConfig(
            iterations=args.iterations, tol=args.tol, damping=args.damping,
            dangling="redistribute", init="uniform",
            spmv_impl=args.spmv_impl, dtype=args.dtype, **ckpt_kw,
        )
        res = run_ppr_batch(graph, cfg, queries, **run_kw)
        for qi in range(len(queries)):
            order = res.ranks[qi].argsort()[::-1][: args.top_k]
            for i in order:
                print(f"{qi}\t{graph.node_ids[i]}\t{res.ranks[qi][i]:.10g}")
        summary = {"queries": len(queries), "iterations": res.iterations,
                   "l1_delta": res.l1_delta}
    elif args.workload == "hits":
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import (
            run_hits,
        )

        res = run_hits(graph, HitsConfig(iterations=args.iterations, tol=args.tol,
                                         dtype=args.dtype, **ckpt_kw), **run_kw)
        for name, vec in (("hub", res.hubs), ("auth", res.authorities)):
            order = vec.argsort()[::-1][: args.top_k]
            for i in order:
                print(f"{name}\t{graph.node_ids[i]}\t{vec[i]:.10g}")
        summary = {"iterations": res.iterations, "l1_delta": res.l1_delta}
    else:  # cc
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import (
            run_components,
        )

        res = run_components(
            graph, ComponentsConfig(iterations=args.iterations, **ckpt_kw), **run_kw,
        )
        if not res.converged:
            print(f"warning: label propagation hit the {args.iterations}-"
                  "round cap before the fixpoint — the component split is "
                  "an over-segmentation; rerun with more --iterations",
                  file=sys.stderr)
        if args.output:
            with open(args.output, "w") as f:
                for i, lab in enumerate(res.labels):
                    f.write(f"{graph.node_ids[i]}\t{graph.node_ids[lab]}\n")
        summary = {"n_components": res.n_components,
                   "iterations": res.iterations,
                   "converged": res.converged}

    summary.update(nodes=graph.n_nodes, edges=graph.n_edges)
    print(json.dumps(summary), file=sys.stderr)
    if args.metrics_json:
        metrics.dump(args.metrics_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
