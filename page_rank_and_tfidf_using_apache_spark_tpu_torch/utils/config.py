"""PageRank configuration: a frozen dataclass mirroring the CLI flags.

Counterpart of the JAX package's ``utils/config.py`` (``PageRankConfig``,
``DanglingMode``, ``RankInit``, the PageRank keys of ``TUNABLE_DEFAULTS``
and ``config_hash``), copied so the port never imports that package.
Field names, defaults and validation are held equal to the JAX package by
``tests/test_torch_graph.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Any

# The PageRank performance knobs and their hand-picked defaults.  No tuned
# profile exists for CUDA yet, so a knob resolves as explicit value, then
# this table.
TUNABLE_DEFAULTS: dict = {
    # hybrid SpMV dense-head layout (ops/pagerank.py, PageRankConfig)
    "head_coverage": 0.5,
    "head_row_width": 128,
    # sort_shuffle bucket padding (ops/pagerank.py build_shuffle_layout)
    "shuffle_bucket_width": 8,
    # strategy="owned" replicated hub-head cap (sharded path, not ported)
    "owned_max_head": 4096,
}

SPMV_IMPLS = ("segment", "bcoo", "cumsum", "cumsum_mxu", "hybrid",
              "sort_shuffle", "pallas")


class DanglingMode(str, enum.Enum):
    """What happens to rank mass at nodes with no out-links.

    ``DROP`` is the canonical Spark example (dangling nodes never appear
    as a ``links`` key, so their mass vanishes each iteration);
    ``REDISTRIBUTE`` is the textbook/networkx behaviour: dangling mass is
    spread over the restart distribution, keeping ``sum(ranks)`` constant.
    """

    DROP = "drop"
    REDISTRIBUTE = "redistribute"


class RankInit(str, enum.Enum):
    """Initial rank value. The canonical Spark example uses 1.0 per node
    (so ranks sum to N); ``UNIFORM`` is 1/N (ranks sum to 1)."""

    ONE = "one"
    UNIFORM = "uniform"


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    """Configuration for a PageRank run.

    Mirrors the reference CLI shape ``pagerank <edges> <iters>`` plus
    explicit flags for every reconstructed-semantics choice.
    """

    iterations: int = 20
    damping: float = 0.85
    # Convergence: if tol > 0, stop early when the L1 delta between
    # successive rank vectors falls below tol (one host sync per step).
    tol: float = 0.0
    dangling: DanglingMode = DanglingMode.DROP
    init: RankInit = RankInit.ONE
    # Exact emulation of the canonical Spark example's shrinking key-set
    # semantics (nodes absent from the join drop out).  Only meaningful
    # with dangling=DROP, init=ONE.
    spark_exact: bool = False
    # Personalized PageRank: restart concentrated on these node ids instead
    # of uniform. None => standard PageRank.
    personalize: tuple[int, ...] | None = None
    # Sparse matvec implementation, one of SPMV_IMPLS; "pallas" runs the
    # hand-written prefix-sum kernel and "hybrid" the row-sum kernel.
    spmv_impl: str = "segment"
    # spmv_impl="hybrid" layout knobs: the head is the smallest top-k
    # in-degree set covering ~head_coverage of all edges (every member's
    # in-degree >= the dense row width, which adapts down from
    # head_row_width on small graphs).
    head_coverage: float = TUNABLE_DEFAULTS["head_coverage"]
    head_row_width: int = TUNABLE_DEFAULTS["head_row_width"]
    # spmv_impl="sort_shuffle": bucket width each destination's edge run is
    # padded to.
    shuffle_bucket_width: int = TUNABLE_DEFAULTS["shuffle_bucket_width"]
    # Sharded strategy="owned" head cap; kept so configs (and their
    # hashes) round-trip with the JAX package.
    owned_max_head: int = TUNABLE_DEFAULTS["owned_max_head"]
    dtype: str = "float32"
    # Checkpoint every k iterations (0 = off) into checkpoint_dir.
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None

    def __post_init__(self) -> None:
        if self.iterations < 0:
            raise ValueError(f"iterations must be >= 0, got {self.iterations}")
        if not 0.0 <= self.damping <= 1.0:
            raise ValueError(f"damping must be in [0, 1], got {self.damping}")
        # Accept plain strings for enum fields (CLI / JSON round-trips) —
        # coerce BEFORE any enum-identity validation below.
        object.__setattr__(self, "dangling", DanglingMode(self.dangling))
        object.__setattr__(self, "init", RankInit(self.init))
        if self.spark_exact and self.dangling is not DanglingMode.DROP:
            raise ValueError("spark_exact requires dangling=drop")
        if self.spark_exact and self.personalize is not None:
            raise ValueError("spark_exact cannot be personalized")
        if self.spmv_impl not in SPMV_IMPLS:
            raise ValueError(f"unknown spmv_impl {self.spmv_impl!r}")
        if not 0.0 < self.head_coverage <= 1.0:
            raise ValueError(
                f"head_coverage must be in (0, 1], got {self.head_coverage}"
            )
        if self.head_row_width < 8 or self.shuffle_bucket_width < 2:
            raise ValueError(
                "head_row_width must be >= 8 and shuffle_bucket_width >= 2, "
                f"got {self.head_row_width}/{self.shuffle_bucket_width}"
            )
        if self.owned_max_head < 0:
            raise ValueError(
                f"owned_max_head must be >= 0, got {self.owned_max_head}"
            )
        if self.spark_exact and self.spmv_impl not in ("segment", "bcoo"):
            # spark_exact's presence test counts unit contributions through
            # the SpMV; a float32 prefix sum stops resolving +1.0 past 2^24
            # accumulated mass, silently zeroing live nodes at large-graph
            # scale.  spark_exact is a parity mode — keep it on exact impls.
            raise ValueError("spark_exact requires spmv_impl='segment' or 'bcoo'")
        if self.personalize is not None:
            object.__setattr__(self, "personalize", tuple(int(x) for x in self.personalize))

    def config_hash(self) -> str:
        """Hash of the *semantic* fields only: run length, tolerance, and
        checkpoint placement are operational."""
        return _hash_config(self, exclude={"iterations", "tol", "checkpoint_every", "checkpoint_dir"})


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def _hash_config(cfg: Any, exclude: set[str] = frozenset()) -> str:
    """Stable short hash tagging metrics as belonging to one semantic
    configuration; equal to the JAX package's for equal configs."""
    d = {k: v for k, v in _to_jsonable(cfg).items() if k not in exclude}
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]
