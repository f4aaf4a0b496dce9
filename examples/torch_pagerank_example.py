"""End-to-end PageRank via the PyTorch port's library API (no CLI).

The port's counterpart of ``examples/pagerank_example.py``, with its flow:
build the graph, iterate, inspect ranks, then the personalized variant
(BASELINE.json:10).  Runs on ``cuda`` unless given ``--device cpu``.

Run from the repo root:
    python examples/torch_pagerank_example.py [edges.txt] [--device cpu]
Without an input file a synthetic power-law graph stands in.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from page_rank_and_tfidf_using_apache_spark_tpu_torch.api import pagerank  # noqa: E402
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (  # noqa: E402
    load_snap,
    synthetic_powerlaw,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("edges", nargs="?", help="a SNAP edge list (default: synthetic)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    graph = (
        load_snap(args.edges) if args.edges
        else synthetic_powerlaw(10_000, 80_000, seed=0)
    )
    print(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges")

    # Textbook semantics (networkx parity): mass-preserving, 1/N init.
    res = pagerank(graph, iterations=50, tol=1e-9, dangling="redistribute",
                   init="uniform", device=args.device)
    top = res.ranks.argsort()[::-1][:5]
    print(f"converged after {res.iterations} iters (l1_delta={res.l1_delta:.2e})")
    for i in top:
        print(f"  node {graph.node_ids[i]}: {res.ranks[i]:.6f}")

    # Personalized: restart onto a source set (original node ids, as they
    # appear in the edge file) instead of the uniform vector.
    seed_nodes = (int(graph.node_ids[top[0]]),)
    ppr = pagerank(graph, iterations=50, tol=1e-9, dangling="redistribute",
                   init="uniform", personalize=seed_nodes, device=args.device)
    print(f"personalized on {seed_nodes}: top neighbor "
          f"{graph.node_ids[ppr.ranks.argsort()[::-1][1]]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
