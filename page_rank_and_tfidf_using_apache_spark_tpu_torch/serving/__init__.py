"""serving/: the online query path.

Counterpart of the JAX package's ``serving/``, in PyTorch on one device:

- :mod:`serving.artifact` — a versioned, mmap-loadable index (postings,
  IDF/DF tables, BM25 weights, an optional PageRank prior, CSC-by-term
  offsets) in the JAX package's format, so a server starts without
  re-ingesting the corpus, whichever package built the index;
- :mod:`serving.segments` — delta segments under a versioned manifest,
  re-weighted under index-wide statistics at load, and the background
  merge (a copy of the JAX package's module);
- :mod:`serving.server` — a long-lived server that puts the postings on
  the device once, drains a bounded request queue into padded
  micro-batches, scores them over every posting (``coo``) or over the
  query terms' posting runs alone (``impacted``), merges the segments'
  top-k on the device, and fronts it all with a hot-query LRU cache;
- :mod:`serving.fabric` — the fleet: replica processes behind a
  consistent-hash router, the respawn rung, the generation floor, drain
  by socket handoff and the peer cache (``FabricConfig``,
  ``ServingFabric``, ``commit_floor``, ``read_floor``);
- :mod:`serving.soak` — the soaks: ingest, serving, the PageRank prior and
  a device loss at once, scored on SLOs (``SoakConfig``, ``run_soak``;
  ``run_fleet_soak`` over the fleet).

``fabric`` and ``soak`` load on first use of their names, as in the JAX
package, so plain serving users do not pay for their imports.

Both scorers add each document's products in one fixed order
(``ops/tfidf.py``), so a served result equals the one-shot
``ops.tfidf.score_query`` bit for bit, on the CPU and on the card.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.artifact import (
    INDEX_FORMAT,
    ServableIndex,
    build_term_offsets,
    load_index,
    save_index,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.segments import (
    SegmentMerger,
    SegmentSet,
    commit_append,
    load_segment_set,
    seal_segment,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import (
    RANKERS,
    ServeConfig,
    ServerShutdown,
    TfidfServer,
    batch_cap,
    impacted_pad_plan,
    serve_pad_plan,
)

__all__ = [
    "INDEX_FORMAT",
    "RANKERS",
    "FabricConfig",
    "SegmentMerger",
    "SegmentSet",
    "ServableIndex",
    "ServeConfig",
    "ServerShutdown",
    "ServingFabric",
    "SoakConfig",
    "TfidfServer",
    "batch_cap",
    "build_term_offsets",
    "commit_append",
    "commit_floor",
    "impacted_pad_plan",
    "load_index",
    "load_segment_set",
    "read_floor",
    "run_soak",
    "save_index",
    "seal_segment",
    "serve_pad_plan",
]


def __getattr__(name: str):
    # serving.soak pulls in the ingest and PageRank side, serving.fabric
    # the subprocess and HTTP plumbing: both load on first use
    if name in ("SoakConfig", "run_soak"):
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import soak

        return getattr(soak, name)
    if name in ("FabricConfig", "ServingFabric", "commit_floor", "read_floor"):
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

        return getattr(fabric, name)
    raise AttributeError(name)
