"""Library API: PageRank behind one call.

Counterpart of the JAX package's ``api.pagerank``; the CLI (``cli/``) is
a thin argv wrapper over the same driver.
"""

from __future__ import annotations

import dataclasses

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
    PageRankResult,
    run_pagerank,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig


def pagerank(
    graph: Graph,
    cfg: PageRankConfig | None = None,
    *,
    device: str | torch.device | None = None,
    **kwargs,
) -> PageRankResult:
    """Run PageRank on a :class:`Graph`, on ``cuda`` unless ``device`` says
    otherwise.

    ``pagerank(g)`` reproduces the reference defaults: 20 iterations,
    damping 0.85, ranks initialized to 1.0, dangling mass dropped.
    Keyword args construct/override the config:
    ``pagerank(g, iterations=50, dangling="redistribute")``.
    """
    if cfg is None:
        cfg = PageRankConfig(**kwargs)
    elif kwargs:
        cfg = dataclasses.replace(cfg, **kwargs)
    return run_pagerank(graph, cfg, device=device)
