"""Entry ``api.pagerank``: one whole ranking job a call.

A host ``Graph`` goes in and the host ranks come out; every call puts the
graph on the device, runs the iterations and pulls the ranks back.  Every
call answers the same question: the graph's PageRank, a uniform restart.
"""

from __future__ import annotations


class Calls:
    """The traffic's calls: none takes arguments beyond the graph, so each
    call's batch is None, a uniform restart."""

    def __init__(self, seed: int, traffic: dict, n: int):
        del seed, traffic, n

    def warmup(self):
        return None

    def next(self):
        return None


def call(graph, cfg, batch, device):
    """Run one call; returns ``(ranks [1, n], info)``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import api

    res = api.pagerank(graph, cfg, device=device)
    return res.ranks[None, :], {"iterations": res.iterations, "queries": 1,
                                "records": res.metrics.records}
