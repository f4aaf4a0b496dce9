"""parallel/: the sharded runners over a mesh of device slots.

Counterpart of the JAX package's ``parallel/``, with its names:

- ``mesh.py``         :class:`~.mesh.Mesh` of slots (a logical id, a
                      ``torch.device`` and an owning process each; a device
                      may repeat), :func:`make_mesh`, :func:`replicated`,
                      :func:`sharded_along`, :func:`init_distributed`
- ``collectives.py``  ``psum``, ``all_gather``, ``reduce_scatter``,
                      ``ppermute_ring``, ``ring_reduce_scatter``, ``pmax``,
                      ``butterfly_all_gather`` over per-slot tensor lists
- ``pagerank_sharded.py``  every PageRank shard strategy, ``auto``, the
                      checkpoint segments and the elastic mesh shrink
- ``tfidf_sharded.py``     data-parallel streaming TF-IDF
- ``workloads_sharded.py`` HITS and components on owned slices, PPR with
                      its query axis sharded

One process drives every slot, as the reference's single ``shard_map``
program drives its mesh; ``parallel/mesh.py`` says why.  After
:func:`init_distributed` in every process a mesh's slots may span the
processes: each runs the same call over its own slots, and every result
is bit-equal to the one-process mesh of the same slots.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    NODES_AXIS,
    init_distributed,
    make_mesh,
    replicated,
    sharded_along,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.pagerank_sharded import (
    ShardedGraph,
    auto_select_strategy,
    partition_graph,
    run_pagerank_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.tfidf_sharded import (
    run_tfidf_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.workloads_sharded import (
    run_components_sharded,
    run_hits_sharded,
    run_ppr_sharded,
)

__all__ = [
    "DATA_AXIS",
    "NODES_AXIS",
    "init_distributed",
    "make_mesh",
    "replicated",
    "sharded_along",
    "ShardedGraph",
    "auto_select_strategy",
    "partition_graph",
    "run_pagerank_sharded",
    "run_tfidf_sharded",
    "run_components_sharded",
    "run_hits_sharded",
    "run_ppr_sharded",
]
