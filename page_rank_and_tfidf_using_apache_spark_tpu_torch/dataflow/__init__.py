"""dataflow/: the RDD-analog core under every workload of the port.

Counterpart of the JAX package's ``dataflow/``:

=====================  ====================================================
Spark RDD operation    dataflow primitive
=====================  ====================================================
``reduceByKey(op)``    :func:`combine.segment_combine` (add/min/max) and
                       :func:`combine.graph_combine` (the SpMV impls)
``broadcast`` + join   :func:`combine.broadcast_join`
driver ``for`` loop    :func:`fixpoint.iterate` + :func:`fixpoint.run_segments`
                       (checkpointed segments) under
                       :func:`fixpoint.run_single_chip_fixpoint`
``textFile`` ingest    :func:`ingest.chunked_ingest`
=====================  ====================================================

PageRank and streaming TF-IDF run over these; so do batched personalized
PageRank (:mod:`ppr`), HITS (:mod:`hits`), connected components
(:mod:`components`) and BM25 (:mod:`bm25`).  The JAX package's
``partition.PartitionedArray`` serves only its sharded runners and comes
with multi-GPU (ROADMAP Queue 1 item 11).
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.combine import (
    broadcast_join,
    graph_combine,
    segment_combine,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import (
    iterate,
    run_segments,
    run_single_chip_fixpoint,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ingest import (
    chunked_ingest,
    grow_chunk_cap,
    prefetched,
)

__all__ = [
    "broadcast_join",
    "chunked_ingest",
    "graph_combine",
    "grow_chunk_cap",
    "iterate",
    "prefetched",
    "run_segments",
    "run_single_chip_fixpoint",
    "segment_combine",
]
