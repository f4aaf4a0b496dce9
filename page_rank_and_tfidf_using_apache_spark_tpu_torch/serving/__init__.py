"""serving/: the servable index.

Counterpart of the JAX package's ``serving/``.  Only the artifact is
ported so far: :func:`save_index` writes a TF-IDF build as a versioned,
mmap-loadable index directory (the JAX package's format), and
:func:`load_index` reads one back, whichever package wrote it.  The
batched scorers, index segments and the server come later.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.artifact import (
    INDEX_FORMAT,
    ServableIndex,
    build_term_offsets,
    load_index,
    save_index,
)

__all__ = ["INDEX_FORMAT", "ServableIndex", "build_term_offsets", "load_index", "save_index"]
