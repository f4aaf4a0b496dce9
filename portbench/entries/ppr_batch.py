"""Entry ``dataflow.ppr.run_ppr_batch``: a batch of single-source personalized
PageRank queries a call, as a query batcher sends them.

The sources are drawn uniformly over all nodes, with repeats, ``batch`` a
call, as the repository's ``bench.py`` draws its PPR batch, from a stream
of the seed, so the i-th call of every run of one seed asks the same
queries.  The warm-up draws from a
stream of its own.  A call's batch is its queries, one list of source ids
each, as the reference's ``restart_matrix`` takes them.
"""

from __future__ import annotations

import numpy as np


class Calls:
    def __init__(self, seed: int, traffic: dict, n: int):
        self.n = int(n)
        self.size = int(traffic["batch"])
        self.rng = np.random.default_rng([int(seed), 1])
        self.warm = np.random.default_rng([int(seed), 2])

    def _draw(self, rng) -> list[list[int]]:
        return [[int(s)] for s in rng.integers(0, self.n, size=self.size)]

    def warmup(self):
        return self._draw(self.warm)

    def next(self):
        return self._draw(self.rng)


def call(graph, cfg, batch, device):
    """Run one call; returns ``(ranks [B, n], info)``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch

    res = run_ppr_batch(graph, cfg, batch, device=device)
    return res.ranks, {"iterations": res.iterations, "queries": len(batch),
                       "records": res.metrics.records}
