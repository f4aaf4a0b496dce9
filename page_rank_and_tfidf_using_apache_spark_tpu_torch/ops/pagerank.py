"""PageRank numeric core in PyTorch: layouts, the SpMV impls, the step, the runners.

Counterpart of the JAX package's ``ops/pagerank.py``.  Each iteration is one
sparse matvec plus an axpy — ``contribs = Aᵀ · (ranks / outdeg)``;
``ranks' = base + d·(contribs [+ dangling])`` — over destination-sorted
edges.  The static layouts (``plan_hybrid_head``, ``build_hybrid_layout``,
``build_shuffle_layout``) are host numpy code copied from the JAX package;
:func:`put_graph` on the card copies the host graph's own arrays and
derives the rest there (``ops/put_kernels.py``, ``csrc/put.cu``);
the seven SpMV impls run on the hand-written kernels of ``csrc/``: every
segmented sum on ``csrc/segment.cu`` (``ops/segment_kernels.py``), every
prefix sum on ``csrc/cumsum.cu``, the ``pallas`` SpMV on ``csrc/spmv.cu`` and
the ``hybrid`` head's row reduction on ``csrc/rowsum.cu``
(``ops/pallas_kernels.py``); ``bcoo`` is the library's sparse product.
Each of those kernels adds in an order fixed by the shapes, so two runs of
any impl but ``bcoo`` give the same bits on the card.

The dangling mass is a float64 sum (:func:`dangling_mass`) rounded to the
run's dtype once, as ``segment.cu`` sums each row.  The sharded strategies
``owned``, ``nodes`` and ``nodes_balanced`` (``parallel/pagerank_sharded.py``)
add their slots' shares of these sums in float64 too, and so give a
float32 run the bits of this one-device ``segment`` run.

Index tensors stay int32 on the device, as in the JAX package; PyTorch's
indexing and ``index_select`` take them as they are.

Semantics flags:
- ``dangling=drop``        mass at out-degree-0 nodes vanishes.
- ``dangling=redistribute`` dangling mass re-spread over the restart
                           distribution (keeps ``sum(ranks)`` invariant).
- ``spark_exact``          additionally reproduces the canonical Spark
                           example's shrinking key-set.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.fixpoint import iterate
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import put_kernels as pt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    TUNABLE_DEFAULTS,
    DanglingMode,
    PageRankConfig,
    RankInit,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import h2d

# Puts since the last reset_launches(), by where their derived fields and
# plans were built: "card" (a CUDA device) or "host".
DERIVED_ON: dict[str, int] = {"card": 0, "host": 0}


def reset_launches() -> None:
    """Zeroes ``DERIVED_ON`` with the kernel modules' launch and plan
    counts."""
    for module in (sk, pk, pt):
        module.reset_launches()
    for k in DERIVED_ON:
        DERIVED_ON[k] = 0


class HybridLayout(NamedTuple):
    """Degree-aware head/tail split of the dst-sorted edge array.

    The **head** is the top-k in-degree destinations covering roughly
    ``coverage`` of all edges; each head node's in-edges are chunked into
    fixed-width rows of ``head_src``, reduced per iteration by the row-sum
    kernel.  The **tail** keeps the sorted-segment layout.  Sentinel
    source id ``n`` points at the zero slot of the extended weight vector,
    so padding needs no mask."""

    head_ids: torch.Tensor  # int32 [H] head node ids (in-degree descending)
    head_src: torch.Tensor  # int32 [R, W] per-row edge sources (sentinel n)
    head_row_node: torch.Tensor  # int32 [R] row -> head slot, non-decreasing
    tail_src: torch.Tensor  # int32 [Et]
    tail_dst: torch.Tensor  # int32 [Et], non-decreasing
    tail_indptr: torch.Tensor  # int32 [N+1] CSR pointers over the tail edges
    head_w: torch.Tensor | None = None  # f [R, W] edge weights (0 at sentinels)
    tail_w: torch.Tensor | None = None  # f [Et] edge weights
    head_row_ptr: torch.Tensor | None = None  # int32 [H+1] CSR pointers over head_row_node
    head_row_plan: sk.SegmentPlan | None = None  # the segment kernel's plan of head_row_ptr


class ShuffleLayout(NamedTuple):
    """The dst-sorted edge array padded so every destination's run occupies
    whole fixed-width buckets; sentinel source id ``n`` reads the zero slot
    of the extended weight vector."""

    bucket_src: torch.Tensor  # int32 [NB, B] per-bucket edge sources
    bucket_node: torch.Tensor  # int32 [NB] bucket -> dst node, non-decreasing
    bucket_w: torch.Tensor | None = None  # f [NB, B] edge weights (0 at pads)
    bucket_ptr: torch.Tensor | None = None  # int32 [N+1] CSR pointers over bucket_node
    bucket_plan: sk.SegmentPlan | None = None  # the segment kernel's plan of bucket_ptr


class DeviceGraph(NamedTuple):
    """Device-resident graph state, built once and reused every iteration."""

    src: torch.Tensor  # int32 [E], edge sources, dst-sorted order
    dst: torch.Tensor  # int32 [E], non-decreasing
    inv_outdeg: torch.Tensor  # f[N], 1/out_degree (1/out_strength weighted), 0 at dangling
    # f64[N], 1.0 where out_degree == 0, in float64 whatever the run's
    # dtype: its product with the ranks is the float64 vector the dangling
    # mass is summed over, with no cast of its own (:func:`dangling_mass`)
    dangling: torch.Tensor
    has_outlinks: torch.Tensor  # f[N], 1.0 where out_degree > 0
    indptr: torch.Tensor | None = None  # int32 [N+1], CSR row pointers into dst
    hybrid: HybridLayout | None = None  # spmv_impl='hybrid' static layout
    shuffle: ShuffleLayout | None = None  # spmv_impl='sort_shuffle' layout
    # Per-edge weights in dst-sorted order (weighted PageRank): the SpMV
    # contribution becomes ``w(u,v) * rank[u] / strength[u]``.
    edge_weight: torch.Tensor | None = None
    # The kernels' plans of indptr (segment, spark_exact; pallas), built
    # with it, once per graph.
    segment_plan: sk.SegmentPlan | None = None
    spmv_plan: pk.SpmvPlan | None = None


def _pow2_floor(x: int) -> int:
    return 1 << max(int(x).bit_length() - 1, 0)


def plan_hybrid_head(
    in_degree: np.ndarray,
    n_edges: int,
    *,
    coverage: float = 0.5,
    row_width: int = 128,
) -> tuple[np.ndarray, int]:
    """Returns ``(head_order, W)``: node ids in in-degree-descending order
    truncated to the head, and the effective row width.  The head is the
    smallest top-k covering ``coverage`` of all edges, where every member
    has in-degree >= W.  W adapts downward to the largest power of two <=
    the max in-degree so small graphs still exercise the dense path."""
    if n_edges == 0 or in_degree.size == 0:
        return np.zeros(0, np.int64), max(8, row_width)
    w = max(8, min(row_width, _pow2_floor(int(in_degree.max()))))
    order = np.argsort(-in_degree, kind="stable")
    deg_sorted = in_degree[order]
    k_deg = int(np.searchsorted(-deg_sorted, -w, side="right"))
    if k_deg == 0:
        return np.zeros(0, np.int64), w
    cum = np.cumsum(deg_sorted[:k_deg], dtype=np.int64)
    k_cov = int(np.searchsorted(cum, coverage * n_edges, side="left")) + 1
    k = min(k_deg, k_cov)
    return order[:k].astype(np.int64), w


class HybridHostLayout(NamedTuple):
    """Numpy form of :class:`HybridLayout` plus its padding accounting."""

    head_ids: np.ndarray
    head_src: np.ndarray
    head_row_node: np.ndarray
    tail_src: np.ndarray
    tail_dst: np.ndarray
    tail_indptr: np.ndarray
    head_edges: int
    pad_slots: int  # sentinel slots in the dense rows
    head_w: np.ndarray | None = None  # [R, W] weights (0 at sentinels)
    tail_w: np.ndarray | None = None  # [Et] weights


def build_hybrid_layout(
    graph: Graph, *, coverage: float = 0.5, row_width: int = 128
) -> HybridHostLayout:
    """One-time host pass: degree sort -> head/tail split -> dense row
    blocking.  O(E) after the cached csr_indptr; fully vectorized."""
    n = graph.n_nodes
    ip = graph.csr_indptr()
    indeg = np.diff(ip)
    head_ids, w = plan_hybrid_head(
        indeg, graph.n_edges, coverage=coverage, row_width=row_width
    )
    in_head = np.zeros(n + 1, bool)
    in_head[head_ids] = True

    # dense head rows: each head node's in-edge run chunked into whole
    # rows of width w, the last row padded with the sentinel id n.
    deg = indeg[head_ids] if head_ids.size else np.zeros(0, np.int64)
    rows_per = -(-deg // w)
    r = int(rows_per.sum())
    head_src = np.full((r, w), n, np.int32)
    weighted = graph.weight is not None
    head_w = np.zeros((r, w), np.float64) if weighted else None
    head_row_node = np.repeat(
        np.arange(head_ids.size, dtype=np.int64), rows_per
    ).astype(np.int32)
    if head_ids.size:
        row_start = np.concatenate([[0], np.cumsum(rows_per)])
        run_start = np.concatenate([[0], np.cumsum(deg)])
        offs = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(
            run_start[:-1], deg
        )
        e_idx = np.repeat(ip[head_ids], deg) + offs
        rows = np.repeat(row_start[:-1], deg) + offs // w
        head_src[rows, offs % w] = graph.src[e_idx]
        if weighted:
            head_w[rows, offs % w] = graph.weight[e_idx]

    keep = ~in_head[graph.dst]
    tail_src = graph.src[keep].astype(np.int32)
    tail_dst = graph.dst[keep].astype(np.int32)
    tail_indptr = np.searchsorted(tail_dst, np.arange(n + 1)).astype(np.int32)
    head_edges = int(graph.n_edges - tail_src.size)
    return HybridHostLayout(
        head_ids=head_ids.astype(np.int32),
        head_src=head_src,
        head_row_node=head_row_node,
        tail_src=tail_src,
        tail_dst=tail_dst,
        tail_indptr=tail_indptr,
        head_edges=head_edges,
        pad_slots=r * w - head_edges,
        head_w=head_w,
        tail_w=graph.weight[keep] if weighted else None,
    )


def build_shuffle_layout(
    graph: Graph, *,
    bucket_width: int = TUNABLE_DEFAULTS["shuffle_bucket_width"],
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """One-time host pass for the sort-based static shuffle: pad every
    destination's edge run to whole buckets of width ``bucket_width``.
    Returns ``(bucket_src [NB, B], bucket_node [NB], bucket_w [NB, B] |
    None)``; ``bucket_w`` is 0 at pad slots."""
    n, e, b = graph.n_nodes, graph.n_edges, bucket_width
    ip = graph.csr_indptr()
    indeg = np.diff(ip)
    buckets_per = -(-indeg // b)
    nb = int(buckets_per.sum())
    bucket_src = np.full((nb, b), n, np.int32)
    bucket_w = np.zeros((nb, b), np.float64) if graph.weight is not None else None
    bucket_node = np.repeat(
        np.arange(n, dtype=np.int64), buckets_per
    ).astype(np.int32)
    if e:
        # per-edge (row, col) inside its node's bucket block
        offs = np.arange(e, dtype=np.int64) - np.repeat(ip[:-1], indeg)
        bucket_start = np.concatenate([[0], np.cumsum(buckets_per)])
        row = np.repeat(bucket_start[:-1], indeg) + offs // b
        bucket_src[row, offs % b] = graph.src
        if bucket_w is not None:
            bucket_w[row, offs % b] = graph.weight
    return bucket_src, bucket_node, bucket_w


def segment_pointers(ids: np.ndarray, n: int) -> np.ndarray:
    """int32 ``[n+1]`` CSR pointers over the sorted segment ids ``ids``:
    ``ptr[r]`` is the position of the first id ``>= r``."""
    return np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)


# The device graph indexes edges, CSR pointers and the segmented sum's
# merge path (a row end or an edge an item, n + E items) with 32-bit ints.
INT32_LIMIT = 2 ** 31 - 1


def check_int32_counts(n_nodes: int, n_edges: int) -> None:
    """Raise ``ValueError`` where the merge-path length ``n_nodes +
    n_edges``, and so any larger count of edges, passes
    :data:`INT32_LIMIT`: the put's int32 pointers and the int32 tile
    coordinates of ``segment_plan`` would overflow."""
    if n_nodes + n_edges > INT32_LIMIT:
        raise ValueError(
            f"a graph of {n_nodes} nodes and {n_edges} edges (n + E = {n_nodes + n_edges}) "
            f"passes the int32 limit {INT32_LIMIT} of the device graph's pointers and "
            "merge-path tile coordinates")


def put_graph(
    graph: Graph,
    dtype: str = "float32",
    *,
    layout: str | None = None,
    head_coverage: float = TUNABLE_DEFAULTS["head_coverage"],
    head_row_width: int = TUNABLE_DEFAULTS["head_row_width"],
    bucket_width: int = TUNABLE_DEFAULTS["shuffle_bucket_width"],
    keep_edge_arrays: bool = True,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> DeviceGraph:
    """Host Graph → tensors on ``device``.

    On a CUDA device the put copies only what the host graph holds: the
    edge sources, the cached int64 CSR pointers and the node normaliser
    (the int32 out-degree, or the cached float64 out-strength of a weighted
    graph), then a weighted graph's edge weights; ``dst``, the int32 pointers,
    ``inv_outdeg``, ``dangling``, ``has_outlinks`` and both kernel plans
    are derived on the card (``ops/put_kernels.py``), after the last copy,
    on the current stream, bit-equal to the numpy builders.  Anywhere else
    (the CPU) each field is built on the host and copied: those builders
    are the plain versions the card's are held to.  ``DERIVED_ON`` counts
    the puts by where their fields were built.

    ``layout`` additionally builds the static SpMV layout an impl needs:
    ``"hybrid"`` or ``"sort_shuffle"`` (see :func:`layout_for_impl`), on
    the host.  ``keep_edge_arrays=False`` uploads zero-length
    ``src``/``dst``/``indptr`` placeholders instead of the raw edge arrays,
    which the layout impls never read.  The layouts' CSR pointers over
    ``head_row_node`` and ``bucket_node``, which the segmented-sum kernel
    reads, are built here, once per graph, and so are the kernels' plans
    of all three pointer arrays (from the pointers on ``device``).

    Each copy is a ``device.h2d`` span (``utils.device.h2d``), each plan
    build an ``ops.segment_plan`` or ``ops.spmv_plan`` span; with
    ``stats`` (a dict) the copies' seconds and bytes are summed into its
    ``h2d_secs`` and ``h2d_bytes``, the plans' seconds into its
    ``plan_secs``, ``derived_on`` is ``"card"`` or ``"host"``, and
    ``device_bytes`` is what the put holds on ``device``
    (:func:`device_graph_bytes` of the graph it returns).

    A graph past the int32 limit (:func:`check_int32_counts`) raises
    ``ValueError`` before any copy."""
    if not keep_edge_arrays and layout is None:
        raise ValueError("keep_edge_arrays=False requires a static layout")
    check_int32_counts(graph.n_nodes, graph.n_edges)

    def put(a: np.ndarray, cast: str | None = None) -> torch.Tensor:
        return h2d(np.ascontiguousarray(a if cast is None else a.astype(cast)), device, stats)

    on_card = torch.device(device).type == "cuda"
    DERIVED_ON["card" if on_card else "host"] += 1
    if stats is not None:
        stats["derived_on"] = "card" if on_card else "host"
    empty = np.zeros(0, np.int32)
    weighted = graph.weight is not None
    hybrid = None
    shuffle = None
    if layout == "hybrid":
        hl = build_hybrid_layout(
            graph, coverage=head_coverage, row_width=head_row_width
        )
        head_ptr = put(segment_pointers(hl.head_row_node, hl.head_ids.shape[0]))
        hybrid = HybridLayout(
            head_ids=put(hl.head_ids),
            head_src=put(hl.head_src),
            head_row_node=put(hl.head_row_node),
            tail_src=put(hl.tail_src),
            tail_dst=put(hl.tail_dst),
            tail_indptr=put(hl.tail_indptr),
            head_w=put(hl.head_w, dtype) if hl.head_w is not None else None,
            tail_w=put(hl.tail_w, dtype) if hl.tail_w is not None else None,
            head_row_ptr=head_ptr,
            head_row_plan=sk.segment_plan(head_ptr, e=hl.head_row_node.shape[0], stats=stats),
        )
    elif layout == "sort_shuffle":
        bucket_src, bucket_node, bucket_w = build_shuffle_layout(
            graph, bucket_width=bucket_width
        )
        bucket_ptr = put(segment_pointers(bucket_node, graph.n_nodes))
        shuffle = ShuffleLayout(
            bucket_src=put(bucket_src),
            bucket_node=put(bucket_node),
            bucket_w=put(bucket_w, dtype) if bucket_w is not None else None,
            bucket_ptr=bucket_ptr,
            bucket_plan=sk.segment_plan(bucket_ptr, e=bucket_node.shape[0], stats=stats),
        )
    elif layout is not None:
        raise ValueError(f"unknown graph layout {layout!r}")
    edge_weight = None
    if on_card:
        e = graph.n_edges
        src = put(graph.src if keep_edge_arrays else empty)
        ptr64 = put(graph.csr_indptr()) if keep_edge_arrays else None
        norm = put(graph.out_strength() if weighted else graph.out_degree)
        if weighted and keep_edge_arrays:
            edge_weight = put(graph.weight, dtype)
        # the copies above have ended; the derivation follows on the stream
        inv_outdeg, dangling, has_outlinks = pt.node_vectors_kernel(norm, getattr(torch, dtype))
        if ptr64 is None:  # zero-length placeholders, as src
            dst = indptr = src
            segment_plan = spmv_plan = None
        else:
            indptr = ptr64.to(torch.int32)  # below 2^31: check_int32_counts
            spmv_plan = pk.spmv_plan(indptr, e=e, stats=stats)
            segment_plan = sk.segment_plan(indptr, e=e, stats=stats)
            dst = pt.expand_dst_kernel(indptr, e, spmv_plan.rows, pk.TILE)
    else:
        host_ptr = graph.csr_indptr() if keep_edge_arrays else None
        src = put(graph.src if keep_edge_arrays else empty)
        dst = put(graph.dst if keep_edge_arrays else empty)
        # weighted graphs normalize by out-strength, unweighted by out-degree
        inv_outdeg = put(graph.inv_out_strength(dtype))
        dangling = put(graph.out_degree == 0, "float64")
        has_outlinks = put(graph.out_degree > 0, dtype)
        indptr = put(empty if host_ptr is None else host_ptr, "int32")
        if weighted and keep_edge_arrays:
            edge_weight = put(graph.weight, dtype)
        segment_plan = spmv_plan = None
        if host_ptr is not None:
            segment_plan = sk.segment_plan(host_ptr, device=device, stats=stats)
            spmv_plan = pk.spmv_plan(host_ptr, device=device, stats=stats)
    dg = DeviceGraph(
        src=src, dst=dst, inv_outdeg=inv_outdeg, dangling=dangling,
        has_outlinks=has_outlinks, indptr=indptr, hybrid=hybrid, shuffle=shuffle,
        edge_weight=edge_weight, segment_plan=segment_plan, spmv_plan=spmv_plan,
    )
    if stats is not None:
        stats["device_bytes"] = device_graph_bytes(dg)
    return dg


def device_graph_bytes(dg: DeviceGraph) -> int:
    """The bytes of every tensor ``dg`` holds, its layouts' and plans'
    included, a tensor held under two fields counted once."""
    held: dict[int, int] = {}

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            held[id(x)] = x.nbytes
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(dg)
    return sum(held.values())


def layout_for_impl(impl: str) -> str | None:
    """Which static layout ``put_graph`` must build for an spmv impl."""
    return {"hybrid": "hybrid", "sort_shuffle": "sort_shuffle"}.get(impl)


def restart_vector(n: int, cfg: PageRankConfig) -> np.ndarray:
    """The teleport distribution e: uniform for standard PageRank, an
    indicator over the source set for personalized PageRank."""
    dtype = cfg.dtype
    if cfg.personalize is None:
        return np.full(n, 1.0 / n, dtype=dtype)
    e = np.zeros(n, dtype=dtype)
    idx = np.asarray(cfg.personalize, dtype=np.int64)
    if idx.size == 0:
        raise ValueError("personalize must name at least one node")
    if (idx < 0).any() or (idx >= n).any():
        raise ValueError(f"personalize node ids out of range [0, {n})")
    # np.add.at so duplicate ids accumulate — e must always sum to 1.
    np.add.at(e, idx, 1.0 / idx.size)
    return e


def init_ranks(n: int, cfg: PageRankConfig) -> np.ndarray:
    if cfg.init is RankInit.ONE:
        return np.ones(n, dtype=cfg.dtype)
    return np.full(n, 1.0 / n, dtype=cfg.dtype)


def _edge_values(dg: DeviceGraph, weighted_ranks: torch.Tensor) -> torch.Tensor:
    """Per-edge contribution ``weighted_ranks[src] (* w(src, dst))``."""
    per_edge = weighted_ranks[dg.src]
    if dg.edge_weight is not None:
        per_edge = per_edge * dg.edge_weight
    return per_edge


def spmv_segment(dg: DeviceGraph, weighted_ranks: torch.Tensor, n: int) -> torch.Tensor:
    """contribs[v] = Σ_{(u,v)∈E} w(u,v)·weighted_ranks[u] as one segmented
    reduction over the dst-sorted edges' CSR pointers: the gather, the
    product and the sum in one call of the segmented-sum kernel
    (``segment_kernels.segment_sum_kernel``, float32 summed in float64)."""
    if dg.indptr is None:
        raise ValueError("spmv_impl='segment' needs DeviceGraph.indptr (use put_graph)")
    return sk.segment_sum_kernel(weighted_ranks, dg.indptr, n, src=dg.src,
                                 edge_weight=dg.edge_weight, plan=dg.segment_plan)


def spmv_bcoo(dg: DeviceGraph, weighted_ranks: torch.Tensor, n: int) -> torch.Tensor:
    """Same contraction as a library sparse matrix-vector product: the
    adjacency as a ``torch.sparse_csr_tensor`` over the dst-sorted edges."""
    if dg.indptr is None:
        raise ValueError("spmv_impl='bcoo' needs DeviceGraph.indptr (use put_graph)")
    data = (
        dg.edge_weight if dg.edge_weight is not None
        else torch.ones(dg.src.shape[0], dtype=weighted_ranks.dtype,
                        device=weighted_ranks.device)
    )
    mat = torch.sparse_csr_tensor(dg.indptr, dg.src, data, size=(n, n),
                                  check_invariants=False)
    return torch.mv(mat, weighted_ranks)


def cumsum_diff_spmv(per_edge, indptr, cumsum_fn=pk.cumsum_kernel) -> torch.Tensor:
    """Prefix-sum segmented reduction: ``out[v] = c[indptr[v+1]] -
    c[indptr[v]]`` with ``c`` the prefix sum of ``per_edge`` behind a
    leading zero.  ``cumsum_fn`` is the prefix-sum primitive: by default
    the deterministic scan kernel (``csrc/cumsum.cu``; ``torch.cumsum`` on
    the CPU).  ``spmv_impl='pallas'`` runs all of this in one fused kernel,
    with this composite over ``torch.cumsum`` as its plain version."""
    c0 = torch.cat([per_edge.new_zeros(1), cumsum_fn(per_edge)])
    return c0[indptr[1:]] - c0[indptr[:-1]]


def cumsum_blocked(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Inclusive prefix sum as one ``[M, B] @ [B, B]`` upper-triangular
    matrix product (row-wise cumsum of an ``[M, B]`` reshape) plus a
    B×-smaller recursive carry.  Error is the blocked-summation order, no
    worse than the sequential scan's."""
    n = x.shape[0]
    if n <= 4 * block:  # the carry is a strided column: the scan kernel takes it contiguous
        return pk.cumsum_kernel(x.contiguous())
    m = -(-n // block)
    xp = torch.cat([x, x.new_zeros(m * block - n)]).reshape(m, block)
    # T[k, j] = 1 for k <= j: row-cumsum via one matrix product.  TF32 stays
    # off so a float32 product keeps float32 inputs (PyTorch's default;
    # set here because the sum's accuracy depends on it), as the JAX
    # package's Precision.HIGHEST does.
    torch.backends.cuda.matmul.allow_tf32 = False
    tri = torch.triu(torch.ones(block, block, dtype=x.dtype, device=x.device))
    rows = torch.matmul(xp, tri)
    row_tot = rows[:, -1]
    carry = cumsum_blocked(row_tot, block) - row_tot  # exclusive row carry
    return (rows + carry[:, None]).reshape(-1)[:n]


def spmv_cumsum(dg: DeviceGraph, weighted_ranks: torch.Tensor, n: int) -> torch.Tensor:
    """Prefix-sum SpMV through the scan kernel (``csrc/cumsum.cu``).
    Accuracy cost in float32: the prefix sum accumulates to the full vector
    mass before differencing, so the per-SpMV error is larger than
    segment's; in float64 both are exact to 1e-12."""
    if dg.indptr is None:
        raise ValueError("spmv_impl='cumsum' needs DeviceGraph.indptr (use put_graph)")
    return cumsum_diff_spmv(_edge_values(dg, weighted_ranks), dg.indptr)


def spmv_cumsum_mxu(dg: DeviceGraph, weighted_ranks: torch.Tensor, n: int) -> torch.Tensor:
    """The prefix-sum SpMV with the matmul-blocked cumsum
    (:func:`cumsum_blocked`) as the scan primitive."""
    if dg.indptr is None:
        raise ValueError("spmv_impl='cumsum_mxu' needs DeviceGraph.indptr (use put_graph)")
    return cumsum_diff_spmv(_edge_values(dg, weighted_ranks), dg.indptr,
                            cumsum_fn=cumsum_blocked)


def spmv_hybrid(dg: DeviceGraph, weighted_ranks: torch.Tensor, n: int) -> torch.Tensor:
    """Degree-aware hybrid SpMV: the high-in-degree head as a dense
    ``[R, W]`` gather reduced by the row-sum kernel, the tail through the
    prefix-sum/monotone-diff path over its own CSR pointers, combined with
    the H head totals written at ``head_ids``.  The tail holds none of a
    head node's edges, so its sum there is exactly 0 and the write gives the
    bits of the reference's add, with no float ``index_add_`` on the card.
    The head's rows sum into their nodes through the segmented-sum
    kernel over ``head_row_ptr``."""
    hl = dg.hybrid
    if hl is None or hl.head_row_ptr is None:
        raise ValueError("spmv_impl='hybrid' needs put_graph(layout='hybrid')")
    if hl.tail_src.shape[0]:
        per_tail = weighted_ranks[hl.tail_src]
        if hl.tail_w is not None:
            per_tail = per_tail * hl.tail_w
        contribs = cumsum_diff_spmv(per_tail, hl.tail_indptr)
    else:
        contribs = weighted_ranks.new_zeros(n)
    h = hl.head_ids.shape[0]
    if h:
        # sentinel id n reads the appended zero
        w_ext = torch.cat([weighted_ranks, weighted_ranks.new_zeros(1)])
        rows = w_ext[hl.head_src]
        if hl.head_w is not None:
            rows = rows * hl.head_w  # sentinel slots carry weight 0
        row_sums = pk.rowsum_kernel(rows)
        head = sk.segment_sum_kernel(row_sums, hl.head_row_ptr, h, plan=hl.head_row_plan)
        contribs[hl.head_ids] = head
    return contribs


def spmv_sort_shuffle(
    dg: DeviceGraph, weighted_ranks: torch.Tensor, n: int
) -> torch.Tensor:
    """Sort-based static-shuffle SpMV: a ``reshape -> reduce`` over the
    bucket matrix plus a bucket-granular segmented sum (the segmented-sum
    kernel over ``bucket_ptr``)."""
    sl = dg.shuffle
    if sl is None or sl.bucket_ptr is None:
        raise ValueError(
            "spmv_impl='sort_shuffle' needs put_graph(layout='sort_shuffle')"
        )
    if sl.bucket_src.shape[0] == 0:
        return weighted_ranks.new_zeros(n)
    w_ext = torch.cat([weighted_ranks, weighted_ranks.new_zeros(1)])
    vals = w_ext[sl.bucket_src]
    if sl.bucket_w is not None:
        vals = vals * sl.bucket_w  # pad slots carry weight 0
    return sk.segment_sum_kernel(vals.sum(dim=1), sl.bucket_ptr, n, plan=sl.bucket_plan)


def spmv(dg: DeviceGraph, weighted: torch.Tensor, n: int, impl: str) -> torch.Tensor:
    """The one SpMV dispatch point: route a weighted gather+combine
    through the impl the graph's static layout was built for."""
    if impl == "segment":
        return spmv_segment(dg, weighted, n)
    if impl == "bcoo":
        return spmv_bcoo(dg, weighted, n)
    if impl == "cumsum":
        return spmv_cumsum(dg, weighted, n)
    if impl == "cumsum_mxu":
        return spmv_cumsum_mxu(dg, weighted, n)
    if impl == "hybrid":
        return spmv_hybrid(dg, weighted, n)
    if impl == "sort_shuffle":
        return spmv_sort_shuffle(dg, weighted, n)
    if impl == "pallas":
        if dg.indptr is None:
            raise ValueError("spmv_impl='pallas' needs DeviceGraph.indptr (use put_graph)")
        return pk.spmv_pallas(dg.src, dg.indptr, weighted, n=n,
                              edge_weight=dg.edge_weight, plan=dg.spmv_plan)
    raise ValueError(f"unknown spmv impl {impl!r}")


def dangling_mass(ranks: torch.Tensor, dangling: torch.Tensor) -> torch.Tensor:  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, float64 sums by design: the dangling mass is a float64 sum rounded once)
    """``Σ ranks·dangling`` over the last axis (a 0-d tensor for one rank
    vector, ``[B]`` for ``B`` rows) as a float64 sum, for the caller to
    round to the ranks' dtype once.

    The terms are ranks, around ``1/n`` or ``1``: in float64 their sum is
    exact (or within one float64 ulp), so rounding it once gives the same
    bits however the terms are split, over slots or a reduction's tree.
    A float32 sum rounds at every addition, and one changed rounding of
    this scalar, which is added to every entry, moves nearly every entry.
    ``dangling`` is the 0/1 mask; in float64, as ``put_graph`` and the
    sharded strategies' slots keep it, the product comes out in float64 in
    one kernel and the sum needs no cast."""
    return torch.sum(ranks * dangling, dim=-1, dtype=torch.float64)


def pagerank_step(
    ranks: torch.Tensor,
    dg: DeviceGraph,
    e: torch.Tensor,
    *,
    n: int,
    damping: float,
    dangling: DanglingMode,
    total_mass: float,
    impl: str = "segment",
) -> torch.Tensor:
    """One power-iteration step.

    ``total_mass`` is the invariant rank-vector sum: ``n`` under init=ONE,
    ``1.0`` under init=UNIFORM.  The restart distribution ``e`` sums to 1;
    both the restart and the redistributed dangling mass are spread
    according to it, so under dangling=redistribute ``sum(ranks) ==
    total_mass`` holds every step.  The mass is a float64 0-d tensor: in
    its product with ``e`` it is rounded to ``e``'s dtype first (type
    promotion keeps the dimensioned operand's dtype), the one rounding,
    with no kernel of its own.
    """
    weighted = ranks * dg.inv_outdeg
    contribs = spmv(dg, weighted, n, impl)
    if dangling is DanglingMode.REDISTRIBUTE:
        contribs = contribs + dangling_mass(ranks, dg.dangling) * e
    base = (1.0 - damping) * total_mass * e
    return base + damping * contribs


def pagerank_step_batch(
    ranks: torch.Tensor,
    dg: DeviceGraph,
    e: torch.Tensor,
    *,
    n: int,
    damping: float,
    dangling: DanglingMode,
    total_mass: float,
    impl: str = "segment",
) -> torch.Tensor:
    """:func:`pagerank_step` over ``B`` rank vectors at once: ``ranks`` and
    the teleport matrix ``e`` are ``[B, n]``, one row a query.  The JAX
    package maps the step over the rows with ``vmap``; here the SpMV runs
    row by row through :func:`spmv`, so the impl's 1-D kernel and the
    graph's plans serve every row (B launches a step), and the dangling
    mass is a per-row float64 sum rounded once, so a row keeps the bits of
    a one-query run."""
    weighted = ranks * dg.inv_outdeg
    contribs = torch.stack([spmv(dg, weighted[b], n, impl) for b in range(ranks.shape[0])])
    if dangling is DanglingMode.REDISTRIBUTE:
        mass = dangling_mass(ranks, dg.dangling).to(ranks.dtype)
        contribs = contribs + mass.unsqueeze(-1) * e
    base = (1.0 - damping) * total_mass * e
    return base + damping * contribs


class SparkExactState(NamedTuple):
    """Carry for exact canonical-Spark-example emulation: the rank table's
    key set shrinks to nodes that received contributions."""

    ranks: torch.Tensor  # f[N]; value only meaningful where present == 1
    present: torch.Tensor  # f[N]; 1.0 if node currently in the rank table


def spark_exact_step(
    state: SparkExactState, dg: DeviceGraph, *, n: int, damping: float, impl: str = "segment"
) -> SparkExactState:
    weighted = state.ranks * state.present * dg.inv_outdeg
    contribs = spmv(dg, weighted, n, impl)
    # A node re-enters the table iff some present source with out-links
    # points at it (join emits ≥1 record for it).
    received = spmv(dg, state.present * dg.has_outlinks, n, impl)
    present = (received > 0).to(state.ranks.dtype)
    ranks = present * ((1.0 - damping) + damping * contribs)
    return SparkExactState(ranks=ranks, present=present)


def make_pagerank_runner(n: int, cfg: PageRankConfig):
    """Returns ``run(dg, ranks0, e) -> (ranks, iters_done, final_delta)``,
    the whole iteration loop (:func:`dataflow.fixpoint.iterate`).

    Where the JAX runner donates ``ranks0``, this one swaps buffers: each
    step writes a new rank vector and drops the previous one, which
    PyTorch's caching allocator hands to the next step, so two node-sized
    vectors are live at a time.  ``ranks0`` itself is left unchanged."""
    damping = cfg.damping
    impl = cfg.spmv_impl
    dangling = cfg.dangling
    total_mass = float(n) if cfg.init is RankInit.ONE else 1.0

    def run(dg: DeviceGraph, ranks0: torch.Tensor, e: torch.Tensor):
        return iterate(
            lambda ranks: pagerank_step(
                ranks, dg, e, n=n, damping=damping, dangling=dangling,
                total_mass=total_mass, impl=impl,
            ),
            ranks0, iterations=cfg.iterations, tol=cfg.tol,
        )

    return run


def make_spark_exact_runner(n: int, cfg: PageRankConfig):
    """Runner for spark_exact mode (always fixed iterations, like the
    reference's ``for i in range(iters)`` driver loop)."""

    def run(dg: DeviceGraph, ranks0: torch.Tensor, e: torch.Tensor):
        del e  # spark_exact is never personalized
        state0 = SparkExactState(ranks=ranks0, present=dg.has_outlinks)
        state, iters, last = iterate(
            lambda s: spark_exact_step(
                s, dg, n=n, damping=cfg.damping, impl=cfg.spmv_impl
            ),
            state0,
            iterations=cfg.iterations,
            delta_fn=lambda new, old: torch.sum(torch.abs(new.ranks - old.ranks)),
        )
        return state.ranks, iters, last

    return run
