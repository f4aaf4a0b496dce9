"""Host-side helpers for the PageRank model driver."""

from __future__ import annotations

import dataclasses

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig


def resolve_personalize(graph, cfg: PageRankConfig) -> PageRankConfig:
    """Map ``cfg.personalize`` from ORIGINAL node ids (what the user knows
    from the edge file) to compacted row indices (what restart_vector
    needs).  ``node_ids`` is sorted (np.unique), so the lookup is a
    searchsorted."""
    if cfg.personalize is None:
        return cfg
    ids = np.asarray(cfg.personalize, dtype=np.int64)
    pos = np.searchsorted(graph.node_ids, ids)
    ok = (pos < graph.n_nodes) & (graph.node_ids[np.minimum(pos, graph.n_nodes - 1)] == ids)
    if not ok.all():
        missing = ids[~ok].tolist()
        raise ValueError(f"personalize node ids not present in the graph: {missing}")
    return dataclasses.replace(cfg, personalize=tuple(int(p) for p in pos))
