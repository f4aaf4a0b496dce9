"""PyTorch/CUDA port of the PageRank framework, for one NVIDIA H100.

The JAX package ``page_rank_and_tfidf_using_apache_spark_tpu`` beside this
one is the reference; this package imports nothing of it and no JAX.  It
covers single-device PageRank: every SpMV impl in PyTorch, with the two
TPU kernels of that path written by hand in CUDA C++ for ``sm_90a``
(``csrc/``, built with ``nvcc`` on first use).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

Layout mirrors the JAX package:

- ``io/``        host-side ingest: SNAP edge lists → dst-sorted edge arrays
- ``ops/``       the PageRank step, the SpMV impls, the kernel wrappers
- ``csrc/``      the CUDA kernels
- ``dataflow/``  the fixpoint loop
- ``models/``    the PageRank driver
- ``utils/``     config, metrics, device resolution
- ``cli/``       the ``pagerank <edges> <iters>`` command line
- ``convert.py`` the JAX package's graph state and ranks, as this package's
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.api import pagerank

__version__ = "0.1.0"

__all__ = ["PageRankConfig", "pagerank", "__version__"]
