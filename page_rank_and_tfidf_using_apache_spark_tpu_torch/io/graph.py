"""Host-side graph ingest: SNAP edge lists → destination-sorted edge arrays.

Counterpart of the JAX package's ``io/graph.py``, copied so the port never
imports that package.  Parse once on host into flat numpy arrays, dedup
with one vectorized sort, and keep the graph as **destination-sorted edge
arrays**: the per-iteration ``reduceByKey`` of the Spark reference becomes
a reduction over contiguous destination segments.  The synthetic
generators draw from ``numpy.random.default_rng`` exactly as the JAX
package does, so both packages build byte-identical graphs from one seed
(``tests/test_torch_graph.py``).

The edge-file parse and the (dst, src) dedup sort run in C++
(``utils/native.py``) where the library loads, else in numpy
(``str.split`` and ``np.lexsort``), which gives the same bits; each graph
records in ``native_steps`` which steps ran natively.

SNAP format: ``#``-prefixed comment header lines, whitespace-separated
integer ``src dst`` pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph in destination-sorted edge-array form.

    Node ids are compacted to ``[0, n_nodes)``; ``node_ids[i]`` maps row
    ``i`` back to the original id from the input file (identity when the
    input was already compact).

    Invariants: ``dst`` is non-decreasing; ``(src, dst)`` pairs are unique
    (the reference's ``distinct()``); ``out_degree[v] == #edges with
    src == v``; dangling nodes are exactly ``out_degree == 0``.
    """

    n_nodes: int
    src: np.ndarray  # int32 [n_edges], sorted by (dst, src)
    dst: np.ndarray  # int32 [n_edges], non-decreasing
    out_degree: np.ndarray  # int32 [n_nodes]
    node_ids: np.ndarray  # original ids, [n_nodes]
    # Optional per-edge weights aligned with src/dst, strictly positive
    # (enforced by from_edges).  None = unweighted.
    weight: np.ndarray | None = None
    # The host steps that ran in C++: "parse" (load_snap), "sort"
    # (from_edges); the others ran in numpy.
    native_steps: tuple[str, ...] = ()

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def out_strength(self) -> np.ndarray:
        """float64 [n_nodes] sum of outgoing edge weights (== out_degree
        for an unweighted graph); the normalizer of the weighted SpMV."""
        cached = getattr(self, "_out_strength", None)
        if cached is None:
            if self.weight is None:
                cached = self.out_degree.astype(np.float64)
            else:
                cached = np.bincount(
                    self.src, weights=self.weight, minlength=self.n_nodes
                )
            object.__setattr__(self, "_out_strength", cached)
        return cached

    def inv_out_strength(self, dtype) -> np.ndarray:
        """``1 / out_strength`` (0 at dangling nodes), divided in float64
        and cast to ``dtype`` after."""
        s = self.out_strength()
        with np.errstate(divide="ignore"):
            return np.where(
                s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0
            ).astype(dtype)

    def csr_indptr(self) -> np.ndarray:
        """int64 [n_nodes+1] CSR row pointers into the dst-sorted edge
        array (cached)."""
        cached = getattr(self, "_indptr", None)
        if cached is None:
            cached = np.searchsorted(self.dst, np.arange(self.n_nodes + 1)).astype(np.int64)
            object.__setattr__(self, "_indptr", cached)
        return cached

    def __repr__(self) -> str:  # keep pytest output readable
        return f"Graph(n_nodes={self.n_nodes}, n_edges={self.n_edges})"


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    weight: np.ndarray | None = None,
    dedup: bool = True,
    drop_self_loops: bool = False,
    compact_ids: bool = True,
) -> Graph:
    """Build a :class:`Graph` from raw (src, dst) id arrays.

    ``dedup=True`` reproduces the reference's ``distinct()``; self-loops are
    kept by default.  ``weight`` (all entries > 0) rides along per edge;
    duplicate (src, dst) pairs SUM their weights under dedup.
    """
    src = np.asarray(src).ravel()
    dst = np.asarray(dst).ravel()
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if weight is not None:
        weight = np.asarray(weight, np.float64).ravel()
        if weight.shape != src.shape:
            raise ValueError(
                f"weight shape {weight.shape} != edge shape {src.shape}"
            )
        if weight.size and not (weight > 0).all():
            raise ValueError("edge weights must be strictly positive")
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if weight is not None:
            weight = weight[keep]

    if compact_ids:
        node_ids, inverse = np.unique(np.concatenate([src, dst]), return_inverse=True)
        src = inverse[: src.shape[0]]
        dst = inverse[src.shape[0] :]
        n = int(node_ids.shape[0])
    else:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1) if src.size else 0
        if n > (1 << 31):
            raise ValueError(
                f"compact_ids=False with max id {n - 1}: the O(n) rank/degree "
                "vectors would not fit; use compact_ids=True"
            )
        node_ids = np.arange(n, dtype=np.int64)

    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    # Sort (dst major, src minor): both the dedup order and the final
    # destination-sorted layout every SpMV impl relies on.  The C++ radix
    # sort takes unweighted graphs; the lexsort gives the same bits.
    sorted_pair = (
        native.sort_dedup_edges(src, dst, dedup=dedup)
        if src.size and n <= (1 << 31) and weight is None else None
    )
    if sorted_pair is not None:
        src, dst = sorted_pair
    else:
        order = np.lexsort((src, dst))
        src, dst = src[order], dst[order]
        if weight is not None:
            weight = weight[order]
        if dedup and src.size:
            keep = np.empty(src.shape, dtype=bool)
            keep[0] = True
            keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
            if weight is not None:
                # duplicate pairs are contiguous after the lexsort: one
                # reduceat sums each group's weights
                weight = np.add.reduceat(weight, np.flatnonzero(keep))
            src, dst = src[keep], dst[keep]

    out_degree = np.bincount(src, minlength=n).astype(np.int32)
    return Graph(
        n_nodes=n,
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        out_degree=out_degree,
        node_ids=node_ids,
        weight=weight,
        native_steps=("sort",) if sorted_pair is not None else (),
    )


def parse_snap_text(text: str | bytes, **kwargs) -> Graph:
    """Parse SNAP edge-list text (``#`` comments, whitespace-separated int
    pairs)."""
    if isinstance(text, bytes):
        text = text.decode("utf-8", errors="replace")
    data_lines = [ln for ln in text.splitlines() if ln and not ln.lstrip().startswith("#")]
    if not data_lines:
        return from_edges(np.empty(0, np.int64), np.empty(0, np.int64), **kwargs)
    flat = " ".join(data_lines).split()
    arr = np.array(flat, dtype=np.int64)
    if arr.size % 2 != 0:
        raise ValueError(f"edge list has odd token count {arr.size}; not (src, dst) pairs")
    pairs = arr.reshape(-1, 2)
    return from_edges(pairs[:, 0], pairs[:, 1], **kwargs)


def load_snap(path: str, **kwargs) -> Graph:
    """Load a SNAP-format edge-list file, parsed in C++ where the native
    library loads, else by :func:`parse_snap_text`."""
    pairs = native.parse_edge_file(path)
    if pairs is not None:
        g = from_edges(pairs[:, 0], pairs[:, 1], **kwargs)
        return dataclasses.replace(g, native_steps=("parse", *g.native_steps))
    with open(path, "rb") as f:
        return parse_snap_text(f.read(), **kwargs)


def save_ranks(path: str, graph: Graph, ranks: np.ndarray, *, top_k: int | None = None) -> None:
    """Write ``<original_node_id>\\t<rank>`` lines, highest rank first."""
    order = np.argsort(-ranks, kind="stable")
    if top_k is not None:
        order = order[:top_k]
    with open(path, "w") as f:
        for i in order:
            f.write(f"{graph.node_ids[i]}\t{ranks[i]:.10g}\n")


def synthetic_powerlaw(
    n_nodes: int,
    n_edges: int,
    *,
    seed: int = 0,
    zipf_a: float = 1.5,
) -> Graph:
    """Synthetic graph with a power-law in-degree distribution: sources
    uniform, destinations Zipf-distributed over a random permutation so
    "celebrity" nodes exist; duplicates collapse under dedup, so the edge
    count lands a few percent under ``n_edges``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges, dtype=np.int64)
    z = rng.zipf(zipf_a, size=n_edges) - 1
    z = np.minimum(z, n_nodes - 1)
    perm = rng.permutation(n_nodes)
    dst = perm[z]
    return from_edges(src, dst)


def synthetic_zipf(
    n_nodes: int,
    n_edges: int,
    *,
    seed: int = 0,
    exponent: float = 1.5,
    src_exponent: float | None = None,
) -> Graph:
    """Seeded Zipf graph with exactly ``n_nodes`` nodes and exactly
    ``n_edges`` unique edges.  Destinations are Zipf(``exponent``) over a
    random permutation; sources are uniform, or Zipf(``src_exponent``)
    over an independent permutation.  Top-up rounds oversample until the
    deduped pool reaches the target, then a seeded uniform subsample trims
    to it."""
    if n_nodes < 2:
        raise ValueError(f"synthetic_zipf needs n_nodes >= 2, got {n_nodes}")
    if n_edges < 2:
        raise ValueError(f"synthetic_zipf needs n_edges >= 2, got {n_edges}")
    if n_edges > n_nodes * (n_nodes - 1):
        raise ValueError(
            f"target {n_edges} edges exceeds the simple-digraph capacity "
            f"of {n_nodes} nodes"
        )
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_nodes)
    perm_s = rng.permutation(n_nodes) if src_exponent is not None else None
    # Hub sources (the top source ranks) link uniformly; only tail sources
    # link preferentially, or (hub src × hub dst) pairs collide so often
    # that the top-up loop crawls.
    src_hub_ranks = 1024
    # Pin ids 0 and n_nodes-1 so the node count is exact without id
    # compaction renumbering anything.
    keys = {np.int64(0) * n_nodes + (n_nodes - 1),
            np.int64(n_nodes - 1) * n_nodes + 0}
    pool = np.fromiter(keys, np.int64)
    accept = 1.0  # unique yield of the previous round, sizes the next
    while pool.size < n_edges:
        want = max(n_edges - pool.size, 1024)
        batch = int(min(want / max(accept, 0.05) * 1.25, 4 * n_edges)) + 64
        z = np.minimum(rng.zipf(exponent, size=batch) - 1, n_nodes - 1)
        dst = perm[z]
        if perm_s is None:
            src = rng.integers(0, n_nodes, size=batch, dtype=np.int64)
        else:
            zs = np.minimum(rng.zipf(src_exponent, size=batch) - 1,
                            n_nodes - 1)
            src = perm_s[zs]
            hub = zs < src_hub_ranks
            dst[hub] = rng.integers(0, n_nodes, size=int(hub.sum()),
                                    dtype=np.int64)
        before = pool.size
        pool = np.unique(np.concatenate([pool, src * n_nodes + dst]))
        accept = max((pool.size - before) / batch, 0.01)
    if pool.size > n_edges:
        # keep the two pinned endpoint edges; trim the rest uniformly
        pinned = np.isin(pool, np.fromiter(keys, np.int64))
        rest = np.flatnonzero(~pinned)
        take = rng.choice(rest, n_edges - int(pinned.sum()), replace=False)
        pool = np.concatenate([pool[pinned], pool[take]])
    src = pool // n_nodes
    dst = pool % n_nodes
    g = from_edges(src, dst, dedup=False, compact_ids=False)
    if g.n_nodes != n_nodes or g.n_edges != n_edges:
        raise AssertionError(
            f"synthetic_zipf built {g.n_nodes}/{g.n_edges}, "
            f"wanted {n_nodes}/{n_edges}"
        )
    return g
