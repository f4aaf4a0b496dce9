"""Library API: PageRank and TF-IDF behind one call each.

Counterpart of the JAX package's ``api.pagerank`` and ``api.tfidf``; the
CLIs (``cli/``) are thin argv wrappers over the same drivers.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
    PageRankResult,
    run_pagerank,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import (
    TfidfOutput,
    run_tfidf,
    run_tfidf_streaming,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    PageRankConfig,
    TfidfConfig,
)


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


def tfidf(
    docs: Sequence[str] | Iterable[Sequence[str]],
    cfg: TfidfConfig | None = None,
    *,
    streaming: bool = False,
    device: str | torch.device | None = None,
    **kwargs,
) -> TfidfOutput:
    """Compute TF-IDF over a corpus, on ``cuda`` unless ``device`` says
    otherwise.

    ``docs`` is a sequence of document strings (batch) or, with
    ``streaming=True``, an iterable of document chunks.  Defaults match the
    20-Newsgroups configuration: unigrams, hashed vocab 2^18, raw TF,
    classic ``log(N/df)`` IDF.  Keyword args construct/override the config:
    ``tfidf(docs, idf_mode="smooth", l2_normalize=True)``.
    """
    if cfg is None:
        cfg = TfidfConfig(**kwargs)
    elif kwargs:
        cfg = dataclasses.replace(cfg, **kwargs)
    if streaming:
        return run_tfidf_streaming(docs, cfg, device=device)
    return run_tfidf(docs, cfg, device=device)
