"""Host-side helpers for the PageRank model driver: personalize-id
resolution and checkpoint resume.

Counterpart of the JAX package's ``models/driver.py``.  The segment loop
lives in ``dataflow/fixpoint.py`` and is re-exported here, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import (  # noqa: F401 — re-exported API
    resume_state,
    run_segments,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder


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


def resume_from_checkpoint(
    cfg: PageRankConfig, metrics: MetricsRecorder, ranks_np: np.ndarray, *, n: int
) -> int:
    """Load the latest checkpoint into the first ``n`` rows of ``ranks_np``
    (in place, in its dtype) and return the start iteration; 0 where
    there is no checkpoint.  Checkpoints store exactly the ``n`` ranks, so
    another size means another graph and raises ("different graph")."""
    return resume_state(cfg, metrics, ranks_np[:n])
