"""PyTorch/CUDA port of the PageRank and TF-IDF framework, for NVIDIA H100s.

The JAX package ``page_rank_and_tfidf_using_apache_spark_tpu`` beside this
one is the reference; this package imports nothing of it and no JAX.  It
covers single-device PageRank, every SpMV impl in PyTorch, with the TPU
kernels written by hand in CUDA C++ for ``sm_90a`` (``csrc/``, built with
``nvcc`` on first use), and batch TF-IDF in plain PyTorch, whose host
ingest runs in C++ (``native/``, built with ``g++`` on first use), and
their sharded forms over a mesh of device slots (``parallel/``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

Layout mirrors the JAX package:

- ``io/``        host-side ingest: SNAP edge lists → dst-sorted edge arrays;
                 corpora → hashed (doc, term) token arrays
- ``ops/``       the PageRank step, the SpMV impls, the kernel wrappers; the
                 TF-IDF pipeline and query scoring
- ``csrc/``      the CUDA kernels
- ``native/``    the C++ host kernels: edge parse, edge sort, tokenizer
- ``dataflow/``  the fixpoint loop, the ingest pipeline, the partitioned
                 collections of the sharded runners
- ``parallel/``  the mesh of device slots, its collectives and the sharded
                 PageRank, TF-IDF and graph workloads
- ``models/``    the PageRank and batch TF-IDF drivers
- ``resilience/`` fault injection and the retry executor every host sync
                 and dispatch runs under
- ``utils/``     config, metrics, device resolution, the native bindings
- ``cli/``       the ``pagerank <edges> <iters>`` and ``tfidf <corpus>``
                 command lines
- ``convert.py`` the JAX package's graph state, ranks and TF-IDF results,
                 as this package's
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    PageRankConfig,
    TfidfConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.api import pagerank, tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import (
    ResilienceExhausted,
)

__version__ = "0.1.0"

__all__ = ["PageRankConfig", "ResilienceExhausted", "TfidfConfig", "pagerank", "tfidf",
           "__version__"]
