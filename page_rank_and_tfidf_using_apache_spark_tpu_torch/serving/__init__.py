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
  top-k on the device, and fronts it all with a hot-query LRU cache.

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
    "SegmentMerger",
    "SegmentSet",
    "ServableIndex",
    "ServeConfig",
    "ServerShutdown",
    "TfidfServer",
    "batch_cap",
    "build_term_offsets",
    "commit_append",
    "impacted_pad_plan",
    "load_index",
    "load_segment_set",
    "save_index",
    "seal_segment",
    "serve_pad_plan",
]
