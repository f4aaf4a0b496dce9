"""Sharded PageRank: the graph partitioned once on the host, a shard a mesh
slot, every step's cross-slot combine one collective.

Counterpart of the JAX package's ``parallel/pagerank_sharded.py``, with its
seven strategies, its partition planner and arrays, its refusals, its
checkpoint segments and resume, and its elastic mesh shrink.  Where the
reference runs one ``shard_map`` program over a ``jax.sharding.Mesh``, the
port runs each strategy's step as a loop over the mesh's slots
(``parallel/mesh.py``), each slot's work on its own device through the
port's kernels, with the collectives of ``parallel/collectives.py``
between them, inside the port's ``dataflow.fixpoint.iterate``.

Strategies (the reference's module docstring has the full reasoning):

- ``edges``: each slot owns an equal contiguous slice of the dst-sorted
  edge array; replicated ranks; one ``psum`` of the full-size partials.
- ``nodes``: each slot owns a node block (its rank shard and in-edges);
  ``all_gather`` of the weighted ranks, a ``psum`` of the dangling mass.
- ``nodes_balanced``: ``nodes`` at equal in-edge splits (min-max optimal,
  node count capped at 2x the even block).
- ``src`` / ``src_ring``: the push layout, each slot owning a source
  block; one ``reduce_scatter`` (or its ``ppermute`` ring) combines and
  re-shards the per-destination partials.
- ``hybrid``: replicated ranks; the power-law head as dense rows
  (``rowsum.cu``) split evenly over the slots, the tail as equal edge
  slices; one ``psum``.
- ``owned``: owned rank slices plus a small replicated hub head; per step
  the boundary butterfly and ONE ``psum`` (``ops/boundary.py``).
- ``auto``: by the per-slot memory budget and the degree shape
  (:func:`auto_select_strategy`).

Every segmented sum of the steps runs on ``csrc/segment.cu``
(``ops.segment_kernels.segment_sum_kernel``, gathering the source values
through ``src`` in the same launch) over per-slot CSR pointers and their
plans, built once when the graph is placed; ``cumsum``/``cumsum_mxu`` run
the prefix-sum difference over ``csrc/cumsum.cu``; the ``hybrid`` head's
rows sum on ``csrc/rowsum.cu``.  Where the reference builds per-slot
pointers only for the prefix-sum impls, the port builds them for every
strategy and impl, with the padding edges (coefficient 0) in each slot's
last row; the ``hybrid`` head sums each slot's real rows into their head
nodes and writes only those nodes, where the reference scatter-adds every
row, its padding rows' 0.0 into node 0 included.  Partition arrays stay
int32.

Every sum whose terms are split over slots, or that decides the dangling
mass added to every entry, is taken in float64 and rounded to the run's
dtype once (``ops.pagerank.dangling_mass``; ``owned``'s head partials come
out of ``segment.cu`` in float64).  So a fixed-count float32 run of
``owned``, ``nodes`` or ``nodes_balanced``, whose rows each sum on one
slot or in that float64 psum, has the bits of a one-device
``run_pagerank`` under ``segment`` at every slot count, and across an
elastic shrink.  ``edges``, ``hybrid``, ``src`` and ``src_ring`` still add
whole float32 partial vectors over the slots (float64 would double the
bytes of their exchange), so their float32 bits depend on the slot count.

The per-slot memory budget of ``auto`` is half of each slot's share of
its device's memory (``torch.cuda.get_device_properties().total_memory``,
or the host's physical memory for a ``cpu`` slot), where the reference
assumes 8 GiB a chip.

``spark_exact`` is a single-device parity mode and raises here, as do the
impls other than ``segment``/``cumsum``/``cumsum_mxu``, ``owned`` under
another impl, a weighted ``hybrid`` and ``owned`` over a slot count that
is not a power of two.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dataflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.partition import (
    OwnedArray,
    PartitionedArray,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import driver
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import PageRankResult
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import boundary as ob
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
    NODES_AXIS,
    Mesh,
    mesh_for,
    rebuild_mesh,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    TUNABLE_DEFAULTS,
    DanglingMode,
    PageRankConfig,
    RankInit,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer

STRATEGIES = ("edges", "nodes", "nodes_balanced", "src", "src_ring", "hybrid", "owned")


def _device_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def default_hbm_bytes(devices=None) -> int:
    """The per-slot working budget of :func:`auto_select_strategy`: half of
    the smallest share of a device's memory that one slot gets (slots of
    one device share it).  ``devices``: the slots' devices (default: the
    visible cards, else the host)."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    devices = [torch.device(d) for d in devices]
    share = min(_device_bytes(d) // sum(1 for e in devices if e == d) for d in devices)
    return share // 2


def replicated_state_bytes(
    n_nodes: int, n_edges: int, n_devices: int, dtype: str = "float32"
) -> int:
    """The per-slot footprint of a REPLICATED-rank strategy: ~6 node
    vectors live at once (ranks, new ranks, contribs, inv_outdeg,
    dangling, e) plus this slot's edge slice (src/dst int32 + the
    coefficient mask)."""
    item = np.dtype(dtype).itemsize
    node_state = 6 * n_nodes * item
    edge_state = int(n_edges / max(n_devices, 1) * (8 + item))
    return int(node_state + edge_state)


def auto_select_strategy(
    graph: Graph,
    n_devices: int,
    *,
    dtype: str = "float32",
    hbm_bytes: int | None = None,
    head_coverage: float = TUNABLE_DEFAULTS["head_coverage"],
    head_row_width: int = TUNABLE_DEFAULTS["head_row_width"],
    devices=None,
) -> str:
    """Pick a shard strategy by per-slot memory footprint, as the reference
    does: ``owned`` (``nodes_balanced`` on a slot count that is not a power
    of two) once the replicated node state stops fitting in half the
    budget; else ``hybrid`` where the graph has a dense-worthy power-law
    head covering a quarter of its edges and no weights; else ``edges``.
    ``hbm_bytes`` defaults to ``$PR_TFIDF_HBM_BYTES``, then
    :func:`default_hbm_bytes` over ``devices``."""
    if hbm_bytes is None:
        env = os.environ.get("PR_TFIDF_HBM_BYTES")
        hbm_bytes = int(env) if env else default_hbm_bytes(devices)
    replicated = replicated_state_bytes(
        graph.n_nodes, graph.n_edges, n_devices, dtype
    )
    # every exit publishes ONE strategy_decision event with the inputs
    inputs = dict(
        devices=n_devices,
        nodes=graph.n_nodes, edges=graph.n_edges,
        replicated_state_bytes=replicated,
        hbm_bytes=int(hbm_bytes),
    )
    if replicated > hbm_bytes / 2:
        pow2 = n_devices >= 1 and n_devices & (n_devices - 1) == 0
        obs.emit("strategy_decision",
                 chosen="owned" if pow2 else "nodes_balanced",
                 reason="replicated node state exceeds half the per-slot "
                        "memory budget", **inputs)
        return "owned" if pow2 else "nodes_balanced"
    indeg = np.diff(graph.csr_indptr())
    # the head at the knobs the partition will materialize with
    head_ids, _w = ops.plan_hybrid_head(
        indeg, graph.n_edges, coverage=head_coverage,
        row_width=head_row_width,
    )
    head_edges = int(indeg[head_ids].sum()) if head_ids.size else 0
    inputs.update(head_nodes=int(head_ids.size), head_edges=head_edges,
                  head_edge_frac=round(head_edges / max(graph.n_edges, 1), 4))
    if (head_ids.size and head_edges >= graph.n_edges // 4
            and graph.weight is None):
        obs.emit("strategy_decision", chosen="hybrid",
                 reason="replicated state fits and the power-law head "
                        "covers >=25% of edges", **inputs)
        return "hybrid"
    obs.emit("strategy_decision", chosen="edges",
             reason="replicated state fits; no dense-worthy degree head",
             **inputs)
    return "edges"


class PartitionPlan(NamedTuple):
    """Planning output of a shard strategy: split boundaries, padded sizes
    and the padding-waste fraction, without a single per-slot array.
    :func:`partition_graph` builds its arrays from this plan."""

    strategy: str
    n: int  # real node count
    n_pad: int  # D * block
    block: int  # nodes per slot block
    e_dev: int  # edge slots per slot (padded width; tail-only for hybrid)
    pad_frac: float  # fraction of padded edge slots (load-imbalance gauge)
    bounds_nodes: np.ndarray | None = None  # [D+1] node-block boundaries
    ebounds: np.ndarray | None = None  # [D+1] edge-range boundaries (nodes*)
    per: np.ndarray | None = None  # [D] real edges per slot ('src*')
    # 'hybrid' only: (head node count, dense row width, total dense rows,
    # dense rows per slot)
    head: tuple[int, int, int, int] | None = None
    # 'owned' only: the full boundary-exchange plan
    owned: ob.OwnedPlan | None = None
    # array entries each slot sends per iteration under this plan
    comm_entries_per_step: int | None = None


def _comm_entries(strategy: str, d: int, n_pad: int, block: int,
                  owned_plan: "ob.OwnedPlan | None" = None) -> int:
    """Static per-step exchange, in array entries sent per slot per
    iteration (ring-scheduled collectives: allreduce ~2 passes,
    gather/scatter ~1)."""
    if d <= 1:
        return 0
    if strategy == "owned":
        assert owned_plan is not None
        return owned_plan.comm_entries_per_step()
    if strategy in ("edges", "hybrid"):  # dense [n_pad] psum
        return 2 * n_pad * (d - 1) // d
    # nodes*/src*: all_gather / reduce-scatter of the block axis, plus
    # two scalar psums (dangling mass + delta)
    return (d - 1) * block + 4


def _publish_plan(plan: PartitionPlan, n_devices: int) -> PartitionPlan:
    """Log the chosen partition plan as ONE obs event (no-op outside a
    traced run)."""
    plan = plan._replace(
        comm_entries_per_step=_comm_entries(
            plan.strategy, n_devices, plan.n_pad, plan.block, plan.owned
        )
    )
    ow = plan.owned
    obs.emit(
        "partition_plan", strategy=plan.strategy, devices=n_devices,
        n=plan.n, n_pad=plan.n_pad, block=plan.block, e_dev=plan.e_dev,
        pad_frac=round(float(plan.pad_frac), 6),
        head=(list(plan.head) if plan.head is not None else None),
        comm_entries_per_step=plan.comm_entries_per_step,
        **(
            dict(
                owned_head=ow.h, owned_h_pad=ow.h_pad, owned_b_pad=ow.b_pad,
                boundary_total=int(ow.boundary_counts.sum()),
                boundary_pad_frac=round(float(ow.boundary_pad_frac), 6),
            )
            if ow is not None else {}
        ),
    )
    return plan


def plan_partition(
    graph: Graph,
    n_devices: int,
    *,
    strategy: str = "edges",
    head_coverage: float = TUNABLE_DEFAULTS["head_coverage"],
    head_row_width: int = TUNABLE_DEFAULTS["head_row_width"],
    owned_max_head: int = TUNABLE_DEFAULTS["owned_max_head"],
) -> PartitionPlan:
    """Plan a partition without building it: boundaries, padded widths and
    ``pad_frac`` only, O(E) host work.  :func:`partition_graph`
    materializes exactly this plan."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown shard strategy {strategy!r}")
    d = n_devices
    n = graph.n_nodes
    e = graph.n_edges

    if strategy == "owned":
        op = ob.plan_owned(graph, d, coverage=head_coverage,
                           max_head=owned_max_head)
        return _publish_plan(
            PartitionPlan(strategy, n, op.n_pad, op.block, op.e_dev,
                          op.pad_frac, owned=op),
            d,
        )

    if strategy == "hybrid":
        # head rows and tail edges both split at row/edge granularity;
        # pad_frac counts all dispatched slots against the real edges
        block = max(1, math.ceil(n / d))
        indeg = np.diff(graph.csr_indptr())
        head_ids, w = ops.plan_hybrid_head(
            indeg, e, coverage=head_coverage, row_width=head_row_width
        )
        head_deg = indeg[head_ids]
        rows = int((-(-head_deg // w)).sum()) if head_ids.size else 0
        rows_dev = math.ceil(rows / d) if rows else 0
        e_tail = e - int(head_deg.sum())
        e_dev = max(1, math.ceil(e_tail / d))
        slots = d * (e_dev + rows_dev * w)
        pad_frac = (slots - e) / max(slots, 1)
        return _publish_plan(
            PartitionPlan(strategy, n, block * d, block, e_dev, pad_frac,
                          head=(int(head_ids.size), int(w), rows, rows_dev)),
            d,
        )

    if strategy in ("src", "src_ring"):
        block = max(1, math.ceil(n / d))
        n_pad = block * d
        per = np.bincount(graph.src // block, minlength=d)
        e_dev = max(1, int(per.max()))
        pad_frac = (d * e_dev - e) / max(d * e_dev, 1)
        return _publish_plan(
            PartitionPlan(strategy, n, n_pad, block, e_dev, pad_frac,
                          per=per),
            d,
        )

    if strategy == "edges":
        block = max(1, math.ceil(n / d))
        e_dev = max(1, math.ceil(e / d))
        cap = e_dev * d
        pad_frac = (cap - e) / max(cap, 1)
        return _publish_plan(
            PartitionPlan(strategy, n, block * d, block, e_dev, pad_frac), d
        )

    if strategy == "nodes":
        block = max(1, math.ceil(n / d))
        bounds_nodes = np.minimum(np.arange(0, d + 1) * block, n)
    else:  # nodes_balanced: the optimal min-max contiguous split, capped
        cap = 2 * max(1, math.ceil(n / d))
        indptr = graph.csr_indptr()

        def fill(width: int) -> np.ndarray | None:
            """Greedy max-fill at the given padded width; None = the n
            nodes do not fit on d slots at this width."""
            bounds = np.zeros(d + 1, np.int64)
            b = 0
            for i in range(d):
                hi = int(np.searchsorted(
                    indptr, indptr[b] + width, side="right")) - 1
                hi = min(max(hi, b), b + cap, n)
                bounds[i + 1] = hi
                b = hi
            return bounds if b >= n else None

        lo_w = max(1, math.ceil(e / d))
        hi_w = max(e, 1)
        bounds_nodes = fill(hi_w)
        assert bounds_nodes is not None  # d * cap >= 2n always covers n
        while lo_w < hi_w:
            mid = (lo_w + hi_w) // 2
            bm = fill(mid)
            if bm is None:
                lo_w = mid + 1
            else:
                hi_w, bounds_nodes = mid, bm
        block = max(1, int(np.diff(bounds_nodes).max()))
    ebounds = np.searchsorted(graph.dst, bounds_nodes)
    e_dev = max(1, int(np.diff(ebounds).max()))
    pad_frac = (d * e_dev - e) / max(d * e_dev, 1)
    return _publish_plan(
        PartitionPlan(strategy, n, block * d, block, e_dev, pad_frac,
                      bounds_nodes=bounds_nodes, ebounds=ebounds),
        d,
    )


class ShardedGraph(NamedTuple):
    """Host-side partitioned graph layout, ready to place on the slots.

    ``src`` is global node ids (block-local under ``src*``); ``dst`` is
    block-local under the node strategies and global under ``edges``.
    ``valid`` carries each edge's coefficient (1.0 or its weight; 0 at the
    padding).  ``local_indptr`` holds each slot's CSR pointers into its
    dst-sorted edge slice, ``[D, S+1]`` with S = n_pad (``edges``, ``src*``,
    ``hybrid``'s tail) or block (node strategies); the padding edges sit in
    the last row's segment, so ``local_indptr[:, -1] == e_dev``."""

    strategy: str
    n: int  # real node count
    n_pad: int  # D * block
    block: int  # nodes per slot block
    src: np.ndarray  # int32 [D, E_dev]
    dst: np.ndarray  # int32 [D, E_dev]
    valid: np.ndarray  # f [D, E_dev]
    inv_outdeg: np.ndarray  # f [n_pad]
    dangling: np.ndarray  # f [n_pad] (padding rows are NOT dangling: 0)
    pad_frac: float
    node_map: np.ndarray  # int64 [n]: global node id -> padded slot
    local_indptr: np.ndarray  # int32 [D, S+1]
    # 'hybrid' only: this slot's dense head rows; sentinel source id n_pad
    # reads the zero slot of the step's extended weight vector
    head_src: np.ndarray | None = None  # int32 [D, R_dev, W]
    head_node: np.ndarray | None = None  # int32 [D, R_dev] global dst ids
    # 'owned' only: the materialized boundary-exchange layout
    owned: ob.OwnedShard | None = None
    # 'hybrid' only: the real (non-padding) head rows of each slot
    head_rows: np.ndarray | None = None  # int64 [D]


def _row_pointers(dst2: np.ndarray, segments: int) -> np.ndarray:
    """int32 ``[D, segments+1]`` CSR pointers of each row of the
    non-decreasing ``dst2`` ``[D, E_dev]``, padding included (it sits at
    the largest id, in the last segment)."""
    grid = np.arange(segments + 1)
    return np.stack([np.searchsorted(row, grid) for row in dst2]).astype(np.int32)


def partition_graph(
    graph: Graph,
    n_devices: int,
    *,
    strategy: str = "edges",
    dtype: str = "float32",
    need_local_indptr: bool = True,
    head_coverage: float = TUNABLE_DEFAULTS["head_coverage"],
    head_row_width: int = TUNABLE_DEFAULTS["head_row_width"],
    owned_max_head: int = TUNABLE_DEFAULTS["owned_max_head"],
) -> ShardedGraph:
    """Partition once on the host (the reference partitions on every
    shuffle).  Every split boundary, padded width and ``pad_frac`` comes
    from :func:`plan_partition`.

    ``need_local_indptr=False`` stores a ``(D, 1)`` placeholder instead of
    the per-slot pointers, for host-side planning: every step of the port
    reads them.  A weighted graph rides in the ``valid`` coefficients
    (``owned`` in its own); ``hybrid`` refuses one."""
    plan = plan_partition(graph, n_devices, strategy=strategy,
                          head_coverage=head_coverage,
                          head_row_width=head_row_width,
                          owned_max_head=owned_max_head)
    d = n_devices
    n = graph.n_nodes
    e = graph.n_edges
    block, n_pad, e_dev, pad_frac = (
        plan.block, plan.n_pad, plan.e_dev, plan.pad_frac
    )

    def pointers(dst2: np.ndarray, segments: int) -> np.ndarray:
        if not need_local_indptr:
            return np.zeros((d, 1), np.int32)
        return _row_pointers(dst2, segments)

    if strategy == "owned":
        shard = ob.build_owned_shard(graph, plan.owned, dtype)
        ph = np.zeros((d, 1), np.int32)  # the edge fields' placeholders
        return ShardedGraph(
            strategy, n, plan.n_pad, plan.block,
            src=ph, dst=ph, valid=np.zeros((d, 1), dtype),
            inv_outdeg=shard.inv_tail, dangling=shard.dang_tail,
            pad_frac=pad_frac, node_map=np.arange(n, dtype=np.int64),
            local_indptr=ph, owned=shard,
        )

    weighted = graph.weight is not None
    if weighted and strategy == "hybrid":
        raise NotImplementedError(
            "sharded strategy 'hybrid' has no weighted-edge form (the "
            "dense head rows carry no weight matrix); use 'owned', "
            "'edges' or a node strategy for weighted graphs"
        )
    ew = graph.weight if weighted else None

    inv_g = graph.inv_out_strength(dtype)
    dang_g = (graph.out_degree == 0).astype(dtype)

    if strategy == "hybrid":
        # the global hybrid layout (the single-device impl's head policy),
        # its dense rows dealt in equal contiguous row blocks, the tail as
        # equal contiguous dst-sorted edge slices
        hl = ops.build_hybrid_layout(
            graph, coverage=head_coverage, row_width=head_row_width
        )
        head_k, w, rows, rows_dev = plan.head
        assert hl.head_src.shape == (rows, w)  # plan IS the layout
        hsrc_g = hl.head_src.astype(np.int32).copy()
        hsrc_g[hsrc_g == n] = n_pad  # the sentinel: the step's zero slot
        hnode_g = hl.head_ids[hl.head_row_node].astype(np.int32)
        head_src = np.full((d, max(rows_dev, 1), max(w, 1)), n_pad, np.int32)
        head_node = np.zeros((d, max(rows_dev, 1)), np.int32)
        head_rows = np.zeros(d, np.int64)
        for i in range(d):
            lo, hi = min(i * rows_dev, rows), min((i + 1) * rows_dev, rows)
            head_src[i, : hi - lo, :w] = hsrc_g[lo:hi]
            head_node[i, : hi - lo] = hnode_g[lo:hi]
            head_rows[i] = hi - lo
        e_tail = hl.tail_src.shape[0]
        cap_t = e_dev * d
        src = np.zeros(cap_t, np.int32)
        dst = np.full(cap_t, n_pad - 1, np.int32)
        valid = np.zeros(cap_t, dtype)
        src[:e_tail] = hl.tail_src
        dst[:e_tail] = hl.tail_dst
        valid[:e_tail] = 1.0
        inv = np.zeros(n_pad, dtype)
        inv[:n] = inv_g
        dangling = np.zeros(n_pad, dtype)
        dangling[:n] = dang_g
        dst2 = dst.reshape(d, e_dev)
        return ShardedGraph(
            strategy, n, n_pad, block,
            src.reshape(d, e_dev), dst2,
            valid.reshape(d, e_dev), inv, dangling, pad_frac,
            np.arange(n, dtype=np.int64), pointers(dst2, n_pad),
            head_src=head_src, head_node=head_node, head_rows=head_rows,
        )

    if strategy in ("src", "src_ring"):
        # push layout: slot i owns source block i and its nodes' out-edges
        owner = graph.src // block
        order = np.lexsort((graph.dst, owner))  # by slot, then dst-sorted
        src_o = graph.src[order]
        dst_o = graph.dst[order]
        ew_o = ew[order] if weighted else None
        per = plan.per
        starts = np.concatenate([[0], np.cumsum(per)])
        src_l = np.zeros((d, e_dev), np.int32)
        dst2 = np.full((d, e_dev), n_pad - 1, np.int32)  # pad keeps dst sorted
        valid = np.zeros((d, e_dev), dtype)
        for i in range(d):
            lo, hi = starts[i], starts[i + 1]
            k = hi - lo
            src_l[i, :k] = src_o[lo:hi] - i * block  # block-local sources
            dst2[i, :k] = dst_o[lo:hi]
            valid[i, :k] = ew_o[lo:hi] if weighted else 1.0
        inv = np.zeros(n_pad, dtype)
        inv[:n] = inv_g
        dangling = np.zeros(n_pad, dtype)
        dangling[:n] = dang_g
        return ShardedGraph(strategy, n, n_pad, block, src_l, dst2, valid,
                            inv, dangling, pad_frac,
                            np.arange(n, dtype=np.int64), pointers(dst2, n_pad))

    if strategy == "edges":
        cap = e_dev * d
        src = np.full(cap, 0, np.int32)
        dst = np.full(cap, n_pad - 1, np.int32)  # keeps dst sorted per slice tail
        valid = np.zeros(cap, dtype)
        src[:e] = graph.src
        dst[:e] = graph.dst
        valid[:e] = ew if weighted else 1.0
        inv = np.zeros(n_pad, dtype)
        inv[:n] = inv_g
        dangling = np.zeros(n_pad, dtype)
        dangling[:n] = dang_g
        dst2 = dst.reshape(d, e_dev)
        return ShardedGraph(strategy, n, n_pad, block,
                            src.reshape(d, e_dev), dst2,
                            valid.reshape(d, e_dev), inv, dangling, pad_frac,
                            np.arange(n, dtype=np.int64), pointers(dst2, n_pad))

    # node strategies: slot i owns global nodes [b_i, b_{i+1}), their rank
    # shard and their in-edges (contiguous in the dst-sorted edge array)
    bounds_nodes = plan.bounds_nodes
    node_map = np.empty(n, np.int64)
    for i in range(d):
        lo, hi = bounds_nodes[i], bounds_nodes[i + 1]
        node_map[lo:hi] = i * block + np.arange(hi - lo)

    ebounds = plan.ebounds
    src = np.zeros((d, e_dev), np.int32)
    dst_local = np.full((d, e_dev), block - 1, np.int32)
    valid = np.zeros((d, e_dev), dtype)
    src_mapped = node_map[graph.src].astype(np.int32)
    for i in range(d):
        lo, hi = ebounds[i], ebounds[i + 1]
        k = hi - lo
        src[i, :k] = src_mapped[lo:hi]
        dst_local[i, :k] = graph.dst[lo:hi] - bounds_nodes[i]
        valid[i, :k] = ew[lo:hi] if weighted else 1.0
    inv = np.zeros(n_pad, dtype)
    inv[node_map] = inv_g
    dangling = np.zeros(n_pad, dtype)
    dangling[node_map] = dang_g
    return ShardedGraph(strategy, n, n_pad, block, src, dst_local, valid,
                        inv, dangling, pad_frac, node_map,
                        pointers(dst_local, block))


def _to_padded(sg: ShardedGraph, global_vec: np.ndarray, dtype: str) -> np.ndarray:
    out = np.zeros(sg.n_pad, dtype)
    out[sg.node_map] = global_vec
    return out


def _restart_padded(sg: ShardedGraph, cfg: PageRankConfig) -> np.ndarray:
    return _to_padded(sg, ops.restart_vector(sg.n, cfg), cfg.dtype)


class SlotArrays(NamedTuple):
    """One slot's share of a placed :class:`ShardedGraph`, on its device.

    Edge strategies fill the first block of fields; ``hybrid`` adds its
    head rows; ``owned`` fills only the ``t*``/``h*``/``out_idx`` fields
    and its four state vectors."""

    src: torch.Tensor | None = None  # int32 [E_dev]
    valid: torch.Tensor | None = None  # f [E_dev]
    ptr: torch.Tensor | None = None  # int32 [S+1]
    plan: sk.SegmentPlan | None = None  # segment.cu's plan of ptr
    inv: torch.Tensor | None = None  # f [n_pad] replicated, [block] sharded
    # f64, inv's shape: the 0/1 dangling mask in float64 whatever the run's
    # dtype, so ops.pagerank.dangling_mass needs no cast
    dang: torch.Tensor | None = None
    head_src: torch.Tensor | None = None  # int32 [k, W]: the slot's real rows
    head_ptr: torch.Tensor | None = None  # int32 [runs+1] over the rows' head nodes
    head_plan: sk.SegmentPlan | None = None
    head_nodes: torch.Tensor | None = None  # int32 [runs] the global head node of each run
    tsrc: torch.Tensor | None = None  # owned: int32 [e_dev] lookup indices
    tw: torch.Tensor | None = None  # owned: f [e_dev]
    tptr: torch.Tensor | None = None  # owned: int32 [block+1]
    tplan: sk.SegmentPlan | None = None
    hsrc: torch.Tensor | None = None  # owned: int32 [he_dev] lookup indices
    hw: torch.Tensor | None = None
    hptr: torch.Tensor | None = None  # owned: int32 [h_pad+3]
    hplan: sk.SegmentPlan | None = None
    out_idx: torch.Tensor | None = None  # owned: int32 [b_pad]
    inv_h: torch.Tensor | None = None  # owned: f [h_pad] replicated
    dang_h: torch.Tensor | None = None  # owned: f64 [h_pad] replicated


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _head_runs(head_node: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR pointers over a slot's ``k`` real head rows grouped by head node
    (each node's rows are contiguous), and each run's node."""
    nodes = head_node[:k]
    if k == 0:
        return np.zeros(1, np.int32), np.zeros(0, np.int32)
    starts = np.flatnonzero(np.concatenate([[True], nodes[1:] != nodes[:-1]]))
    ptr = np.concatenate([starts, [k]]).astype(np.int32)
    return ptr, nodes[starts].astype(np.int32)


def device_put_sharded_graph(sg: ShardedGraph, mesh: Mesh) -> list[SlotArrays]:
    """Place each of this process's slots' share of ``sg`` on its device,
    with the segment kernel's plan of every pointer array, built here
    once."""
    out = []
    if sg.strategy == "owned":
        shard = sg.owned
        block = shard.block
        tptr = _row_pointers(shard.tail_dst, block)
        hptr = _row_pointers(shard.head_slot, shard.h_pad + 2)
        for i in mesh.positions:
            dev = mesh.slots[i].device
            out.append(SlotArrays(
                tsrc=_put(shard.tail_src_idx[i], dev), tw=_put(shard.tail_w[i], dev),
                tptr=_put(tptr[i], dev), tplan=sk.segment_plan(tptr[i], device=dev),
                hsrc=_put(shard.head_src_idx[i], dev), hw=_put(shard.head_w[i], dev),
                hptr=_put(hptr[i], dev), hplan=sk.segment_plan(hptr[i], device=dev),
                out_idx=_put(shard.out_idx[i], dev),
                inv=_put(shard.inv_tail[i * block:(i + 1) * block], dev),
                dang=_put(shard.dang_tail[i * block:(i + 1) * block].astype(np.float64), dev),
                inv_h=_put(shard.inv_head, dev),
                dang_h=_put(shard.dang_head.astype(np.float64), dev),
            ))
        return out
    if sg.local_indptr.shape[1] == 1:
        raise ValueError("the sharded step reads the per-slot pointers: partition with "
                         "need_local_indptr=True")
    # node-state vectors follow the strategy: replicated under edges/hybrid
    # (the step reads the full vectors), one block a slot otherwise
    replicated_state = sg.strategy in ("edges", "hybrid")
    block = sg.block
    for i in mesh.positions:
        dev = mesh.slots[i].device
        ptr = sg.local_indptr[i]
        fields = dict(
            src=_put(sg.src[i], dev), valid=_put(sg.valid[i], dev),
            ptr=_put(ptr, dev), plan=sk.segment_plan(ptr, device=dev),
            inv=_put(sg.inv_outdeg if replicated_state
                     else sg.inv_outdeg[i * block:(i + 1) * block], dev),
            dang=_put((sg.dangling if replicated_state
                       else sg.dangling[i * block:(i + 1) * block]).astype(np.float64), dev),
        )
        if sg.strategy == "hybrid":
            k = int(sg.head_rows[i])
            hptr, hnodes = _head_runs(sg.head_node[i], k)
            fields.update(head_src=_put(sg.head_src[i, :k], dev), head_ptr=_put(hptr, dev),
                          head_plan=sk.segment_plan(hptr, device=dev),
                          head_nodes=_put(hnodes, dev))
        out.append(SlotArrays(**fields))
    return out


def make_sharded_runner(sg: ShardedGraph, cfg: PageRankConfig, mesh: Mesh):
    """The sharded iteration loop: ``run(state0, dev, e) -> (state, iters,
    delta)``, ``dev`` from :func:`device_put_sharded_graph`, ``e`` the
    per-slot restart vectors (a ``(tail, head)`` pair of lists under
    ``owned``).  The state is a list of this process's per-slot rank
    tensors: the full replicated vector under ``edges``/``hybrid``, a
    block otherwise; under ``owned`` the 4-tuple ``(tail, head, dslot,
    gdelta)`` of per-slot lists.  ``delta`` is a 0-d tensor on the first
    local slot's device, bit-equal on every process of the mesh, so every
    process takes the same branch of a ``tol`` loop.  Each step writes
    fresh tensors; the input state is left as it was."""
    if cfg.spark_exact:
        raise NotImplementedError(
            "spark_exact is a single-chip parity mode; run it without a mesh"
        )
    if cfg.spmv_impl not in ("segment", "cumsum", "cumsum_mxu"):
        raise NotImplementedError(
            f"spmv_impl={cfg.spmv_impl!r} is not wired into the sharded "
            "runner; use 'segment', 'cumsum' or 'cumsum_mxu' with --mesh"
        )
    if sg.strategy == "owned" and cfg.spmv_impl != "segment":
        raise NotImplementedError(
            "the owned strategy reduces its tail through the sorted "
            "segment path; use spmv_impl='segment'"
        )
    damping = cfg.damping
    total_mass = float(sg.n) if cfg.init is RankInit.ONE else 1.0
    redistribute = cfg.dangling is DanglingMode.REDISTRIBUTE
    n_pad, block = sg.n_pad, sg.block
    impl = cfg.spmv_impl

    if sg.strategy == "owned":
        # per step and slot: the boundary butterfly and ONE [h_pad+2] psum,
        # whose two spare entries carry the dangling mass and the PREVIOUS
        # step's local delta (so the convergence gauge lags one step).  The
        # buffer is float64: each slot's head partials as segment.cu's
        # float64 row sums and its dangling mass as a float64 sum, added
        # over the slots in slot order and rounded to the run's dtype once
        # after the psum, as one device rounds each row and the mass once:
        # a float32 run gets one device's bits at every slot count
        shard = sg.owned
        h_pad, d_ax = shard.h_pad, shard.d
        inv_d = 1.0 / d_ax  # d is a power of two: exact in binary fp

        def owned_step(carry, dev, e):  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, float64 sums by design: the head partials and the dangling mass cross the slots in float64)
            tails, heads, dslots, _gd = carry
            e_t, e_h = e
            wts = [t * a.inv for t, a in zip(tails, dev)]
            whs = [h * a.inv_h for h, a in zip(heads, dev)]
            btables = coll.butterfly_all_gather(
                [ob.pack_boundary(wt, a.out_idx) for wt, a in zip(wts, dev)], mesh=mesh)
            tail_contribs, bufs = [], []
            for i, a in enumerate(dev):
                lookup = ob.boundary_lookup(wts[i], btables[i], whs[i])
                tail_contribs.append(sk.segment_sum_kernel(
                    lookup, a.tptr, block, src=a.tsrc, edge_weight=a.tw, plan=a.tplan))
                buf = sk.segment_sum_kernel(
                    lookup, a.hptr, h_pad + 2, src=a.hsrc, edge_weight=a.hw, plan=a.hplan,
                    out_dtype=torch.float64)
                if redistribute:
                    # the head is replicated: each slot adds 1/d of it so the
                    # psum restores one copy (d pow2: the scale is exact)
                    buf[h_pad] += (ops.dangling_mass(tails[i], a.dang)
                                   + ops.dangling_mass(heads[i], a.dang_h) * inv_d)
                buf[h_pad + 1] += dslots[i][0]
                bufs.append(buf)
            bufs = coll.psum(bufs, mesh=mesh)  # THE one psum of the step
            new = ([], [], [], [])
            for i in range(len(dev)):
                total = bufs[i].to(tails[i].dtype)  # the one rounding
                head_contrib = total[:h_pad]
                tail_contrib = tail_contribs[i]
                if redistribute:
                    dmass = total[h_pad]
                    tail_contrib = tail_contrib + dmass * e_t[i]
                    head_contrib = head_contrib + dmass * e_h[i]
                new_tail = (1.0 - damping) * total_mass * e_t[i] + damping * tail_contrib
                new_head = (1.0 - damping) * total_mass * e_h[i] + damping * head_contrib
                new_dslot = (torch.sum(torch.abs(new_tail - tails[i]))
                             + torch.sum(torch.abs(new_head - heads[i])) * inv_d)[None]
                for lst, v in zip(new, (new_tail, new_head, new_dslot, total[h_pad + 1])):
                    lst.append(v)
            return new

        def owned_run(carry0, dev, e):
            return dataflow.iterate(
                lambda c: owned_step(c, dev, e), carry0,
                iterations=cfg.iterations, tol=cfg.tol,
                delta_fn=lambda new, old: new[3][0],
            )

        return owned_run

    def local_reduce(values, a: SlotArrays, num_segments: int) -> torch.Tensor:
        """One slot's ``reduceByKey`` over its sorted edge slice:
        ``out[v] = Σ valid·values[src]`` over the slot's edges into ``v``."""
        if impl == "segment":
            return sk.segment_sum_kernel(values, a.ptr, num_segments, src=a.src,
                                         edge_weight=a.valid, plan=a.plan)
        per_edge = values[a.src] * a.valid
        if impl == "cumsum":
            return ops.cumsum_diff_spmv(per_edge, a.ptr)
        return ops.cumsum_diff_spmv(per_edge, a.ptr, cumsum_fn=ops.cumsum_blocked)

    def finish(contribs, e, dmass):
        """Each slot's new ranks from its combined contributions, its
        float64 dangling mass rounded to the run's dtype once."""
        out = []
        for i, c in enumerate(contribs):
            if redistribute:
                c = c + dmass[i].to(c.dtype) * e[i]
            out.append((1.0 - damping) * total_mass * e[i] + damping * c)
        return out

    if sg.strategy in ("edges", "hybrid"):
        # replicated ranks: each slot reduces its edges into a full-size
        # partial, and one psum combines them
        has_head = sg.strategy == "hybrid" and bool(
            (np.asarray(sg.head_src) != sg.n_pad).any())

        def partial_of(ranks_i, a: SlotArrays) -> torch.Tensor:
            weighted = ranks_i * a.inv
            if sg.strategy == "edges":
                return local_reduce(weighted, a, n_pad)
            # hybrid: the tail through the segmented sum whatever the impl,
            # as the reference; the slot's head rows on rowsum.cu, summed
            # per head node through segment.cu and written at its nodes
            # (the tail holds none of a head node's edges: its sum there is 0)
            partial = sk.segment_sum_kernel(weighted, a.ptr, n_pad, src=a.src,
                                            edge_weight=a.valid, plan=a.plan)
            if has_head and a.head_src.shape[0]:
                w_ext = torch.cat([weighted, weighted.new_zeros(1)])
                row_sums = pk.rowsum_kernel(w_ext[a.head_src])
                partial[a.head_nodes] = sk.segment_sum_kernel(
                    row_sums, a.head_ptr, a.head_nodes.shape[0], plan=a.head_plan)
            return partial

        def step(ranks, dev, e):
            contribs = coll.psum([partial_of(r, a) for r, a in zip(ranks, dev)], mesh=mesh)
            dmass = ([ops.dangling_mass(r, a.dang) for r, a in zip(ranks, dev)]
                     if redistribute else None)
            return finish(contribs, e, dmass)

        def local_delta(new, old):
            return torch.sum(torch.abs(new[0] - old[0]))
    elif sg.strategy in ("src", "src_ring"):
        # push layout: gather from the LOCAL rank block, reduce into a full
        # per-destination partial, one reduce-scatter combines and re-shards
        exchange = (coll.ring_reduce_scatter if sg.strategy == "src_ring"
                    else coll.reduce_scatter)

        def step(ranks, dev, e):  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, float64 sums by design: the dangling mass crosses the slots in float64)
            contribs = exchange([local_reduce(r * a.inv, a, n_pad)
                                 for r, a in zip(ranks, dev)], mesh=mesh)
            dmass = (coll.psum([ops.dangling_mass(r, a.dang) for r, a in zip(ranks, dev)],
                               mesh=mesh) if redistribute else None)
            return finish(contribs, e, dmass)

        def local_delta(new, old):
            return coll.psum([torch.sum(torch.abs(a - b)) for a, b in zip(new, old)],
                             mesh=mesh)[0]
    else:
        # node strategies: all_gather the weighted rank blocks, reduce into
        # the slot's block, psum only the float64 dangling-mass scalar
        def step(ranks, dev, e):  # graftlint: disable=implicit-promotion (ROADMAP Queue 3, float64 sums by design: the dangling mass crosses the slots in float64)
            full = coll.all_gather([r * a.inv for r, a in zip(ranks, dev)], mesh=mesh)
            contribs = [local_reduce(w, a, block) for w, a in zip(full, dev)]
            dmass = (coll.psum([ops.dangling_mass(r, a.dang) for r, a in zip(ranks, dev)],
                               mesh=mesh) if redistribute else None)
            return finish(contribs, e, dmass)

        def local_delta(new, old):
            return coll.psum([torch.sum(torch.abs(a - b)) for a, b in zip(new, old)],
                             mesh=mesh)[0]

    def run(ranks0, dev, e):
        return dataflow.iterate(
            lambda ranks: step(ranks, dev, e), ranks0,
            iterations=cfg.iterations, tol=cfg.tol, delta_fn=local_delta,
        )

    return run


class _ShardedExec:
    """Everything welded to ONE mesh: the partition, the placed graph
    arrays, the state layout, and the callables ``run_segments`` drives.
    The elastic rung survives a lost slot by building a fresh instance
    over the surviving mesh; nothing here is mutated."""

    def __init__(self, graph: Graph, cfg: PageRankConfig, mesh: Mesh,
                 strategy: str, metrics: MetricsRecorder):
        self.mesh = mesh
        self.d = mesh.size
        with Timer() as t_part:
            self.sg = partition_graph(
                graph, self.d, strategy=strategy, dtype=cfg.dtype,
                head_coverage=cfg.head_coverage,
                head_row_width=cfg.head_row_width,
                owned_max_head=cfg.owned_max_head,
            )
        with Timer() as t_put:
            self.dev = device_put_sharded_graph(self.sg, mesh)
        item = np.dtype(cfg.dtype).itemsize
        owned_extra = {}
        if self.sg.strategy == "owned":
            sh = self.sg.owned
            entries = ob.comm_entries_per_step(self.d, sh.b_pad, sh.h_pad)
            # the reference's model counts the head psum's ring-allreduce
            # entries in the run's item size; the [h_pad+2] buffer travels
            # in float64 (owned_step), which these bytes count
            owned_extra["head_psum_bytes_per_step"] = (
                2 * (sh.h_pad + 2) * (self.d - 1) // self.d * 8)
        else:
            entries = _comm_entries(
                self.sg.strategy, self.d, self.sg.n_pad, self.sg.block
            )
        self.comm_bytes_per_step = int(entries * item)
        obs.gauge("pagerank.comm_bytes_per_step", self.comm_bytes_per_step)
        metrics.record(
            event="partition", strategy=strategy, devices=self.d,
            block=self.sg.block, edges_per_device=int(
                self.sg.owned.e_dev + self.sg.owned.he_dev
                if self.sg.strategy == "owned" else self.sg.src.shape[1]
            ),
            pad_frac=round(self.sg.pad_frac, 4), secs=t_part.elapsed,
            put_secs=t_put.elapsed, comm_bytes_per_step=self.comm_bytes_per_step,
            processes=mesh.processes, backend=mesh.backend, **owned_extra,
        )
        self._cfg = cfg
        self._metrics = metrics
        if self.sg.strategy == "owned":
            shard = self.sg.owned
            self.olayout = OwnedArray.from_shard(shard, mesh=mesh)
            e_t, e_h = ob.split_global(
                shard, ops.restart_vector(self.sg.n, cfg), cfg.dtype
            )
            self.e_vec = (pmesh.sharded_along(mesh, e_t), pmesh.replicated(mesh, e_h))
            self.layout = None
            return
        replicated_state = self.sg.strategy in ("edges", "hybrid")
        padded_e = _restart_padded(self.sg, cfg)
        self.e_vec = (pmesh.replicated(mesh, padded_e) if replicated_state
                      else pmesh.sharded_along(mesh, padded_e))
        # the partitioned-collection view of the rank state
        self.layout = PartitionedArray.from_plan(
            self.sg.n, self.sg.n_pad, self.sg.node_map, mesh, replicated_state
        )

    def make_runner(self, seg_cfg: PageRankConfig):
        return make_sharded_runner(self.sg, seg_cfg, self.mesh)

    def invoke(self, runner, rd):
        if self.sg.strategy == "owned":
            # the delta gets its own guarded site, as in the reference,
            # whose owned carry is donated
            rd, iters, delta = runner(rd, self.dev, self.e_vec)
            with obs.span("pagerank.delta_sync"):
                delta = float(rx.device_get(
                    delta, site="pagerank_delta_sync",
                    metrics=self._metrics,
                    checkpoint_dir=self._cfg.checkpoint_dir,
                ))
            return rd, iters, delta
        rd, iters, delta = runner(rd, self.dev, self.e_vec)
        delta = float(delta)  # the scalar read is the segment's sync
        return rd, iters, delta

    def put_ranks(self, ranks_g: np.ndarray):
        """Global [n] ranks -> padded per-slot state."""
        if self.sg.strategy == "owned":
            arr = self.olayout.put(ranks_g, self._cfg.dtype)
            # the lagged-delta slots start at +inf, so the gauge cannot read
            # "converged" before the first real global delta arrives
            dslot = [torch.full((1,), float("inf"), dtype=t.dtype, device=t.device)
                     for t in arr.tail]
            gdelta = [torch.full((), float("inf"), dtype=t.dtype, device=t.device)
                      for t in arr.tail]
            return (arr.tail, arr.head, dslot, gdelta)
        return self.layout.put(ranks_g, self._cfg.dtype).value

    def extract_np(self, rd) -> np.ndarray:
        """Per-slot state -> global [n] ranks (the checkpoint payload)."""
        with obs.span("pagerank.ckpt_pull"):
            if self.sg.strategy == "owned":
                return self.olayout.with_value(rd[0], rd[1]).pull(
                    site="pagerank_ckpt_pull", metrics=self._metrics,
                    checkpoint_dir=self._cfg.checkpoint_dir,
                )
            return self.layout.with_value(rd).pull(
                site="pagerank_ckpt_pull", metrics=self._metrics,
                checkpoint_dir=self._cfg.checkpoint_dir,
            )

    def pull_view(self, rd):
        """What the result pull reads: the first slot's copy of replicated
        ranks, every block of sharded ones, every tail block and the first
        slot's head (every slot's block gathered onto each process)."""
        if self.sg.strategy == "owned":
            return (coll.gather_slots(list(rd[0]), mesh=self.mesh), rd[1][0])
        return rd[0] if self.layout.replicated else coll.gather_slots(list(rd), mesh=self.mesh)

    def assemble(self, got) -> np.ndarray:
        """The global [n] ranks from what :meth:`pull_view` pulled."""
        if self.sg.strategy == "owned":
            return ob.merge_global(self.sg.owned, np.concatenate(got[0]), got[1])
        padded = np.concatenate(got) if isinstance(got, list) else got
        return padded[self.sg.node_map]


def _named_loss(exc: BaseException) -> BaseException | None:
    """The device loss ``exc`` carries, where it names its slot; None for
    anything else (a whole-backend loss included)."""
    lost = elastic.unwrap_device_loss(exc)
    if lost is None or elastic.device_index(lost) is None:
        return None
    return lost


def _may_rebuild(mesh: Mesh) -> bool:
    """Whether the elastic rungs may rebuild ``mesh``: not under
    ``GRAFT_ELASTIC=0``, and only in one process.  A multi-process mesh
    does not shrink: its loss raises on every process (the reference's
    rung would halve a ``jax.devices()`` that spans the hosts)."""
    return elastic.enabled() and mesh.processes == 1


def _checkpoint_writer(mesh: Mesh):
    """``utils.checkpoint.save_checkpoint`` for a run over ``mesh``: on a
    multi-process mesh process 0 writes and every process passes a barrier
    before it goes on; each returns the checkpoint's path."""
    if mesh.processes == 1:
        return ckpt.save_checkpoint

    def save(directory, step, arrays, config_hash, extra=None):
        pmesh.first_process_writes(mesh, ckpt.save_checkpoint, directory, step, arrays,
                                   config_hash, extra=extra)
        return ckpt.latest_checkpoint(directory)

    return save


def _make_elastic_rebuild(graph: Graph, cfg: PageRankConfig, strategy: str,
                          metrics: MetricsRecorder, exec_box: dict):
    """The mesh-shrink rung of ``run_segments`` (its ``ElasticResult``
    contract): salvage the global ranks, checkpoint them, rebuild the mesh
    over the surviving slots, repartition, and rerun the failed segment
    with zero recomputed committed iterations.  It takes only a loss that
    names its slot, as the single-device salvage does: anything else
    raises on to ``ResilienceExhausted``."""

    def rebuild(exc, ranks_dev, done, seg_cfg):
        lost0 = _named_loss(exc)
        if not _may_rebuild(exec_box["exec"].mesh) or lost0 is None:
            raise exc
        exc = lost0
        elastic.health().mark_lost(elastic.device_index(exc))
        old = exec_box["exec"]
        # (1) salvage the state at the last committed iteration: the live
        # buffers first, else the newest checkpoint.  A further loss inside
        # the salvage pull is acknowledged and the pull retried; each lap
        # marks a NEW slot, so a dead pull falls to the checkpoint.
        while True:
            try:
                ranks_g, at_iter = old.extract_np(ranks_dev), done
                break
            except Exception as exc_s:
                lost_s = _named_loss(exc_s)
                if lost_s is not None and elastic.health().mark_lost(
                        elastic.device_index(lost_s)):
                    exc = lost_s  # the newest loss is what the shrink blames
                    continue
                latest = (ckpt.latest_checkpoint(cfg.checkpoint_dir)
                          if cfg.checkpoint_dir else None)
                if latest is None:
                    raise exc
                step, arrays, _ = ckpt.load_checkpoint(
                    latest, cfg.config_hash()
                )
                ranks_g, at_iter = arrays["ranks"], int(step)
                break
        if cfg.checkpoint_dir:
            ckpt.save_checkpoint(
                cfg.checkpoint_dir, at_iter, {"ranks": ranks_g},
                cfg.config_hash(), extra={"devices": old.d},
            )
        # (2)-(4) shrink, rebuild, rerun, as a LOOP: a second slot can die
        # while the rerun is in flight, and that loss re-enters the ladder
        # from the shrunk mesh.  Committed iterations are never recomputed.
        devices = list(old.mesh.slots)
        axis = old.mesh.axis
        todo2 = done - at_iter + seg_cfg.iterations
        seg_cfg2 = dataclasses.replace(seg_cfg, iterations=todo2)
        while True:
            plan = elastic.plan_shrink(devices)
            if plan is None:
                raise exc
            with elastic.publish_shrink("pagerank_step", plan, exc, metrics):
                new_mesh = rebuild_mesh(plan.devices, axis)
                new = _ShardedExec(graph, cfg, new_mesh, strategy, metrics)
                rd2 = new.put_ranks(ranks_g)
            try:
                rd2, iters, delta = rx.attempt_once(
                    lambda n=new, r=rd2, c=seg_cfg2: n.invoke(
                        n.make_runner(c), r
                    ),
                    site="pagerank_elastic_rerun",
                )
                break
            except Exception as exc2:  # noqa: BLE001 — re-entry filter below
                lost = _named_loss(exc2)
                if lost is None:
                    raise
                elastic.health().mark_lost(elastic.device_index(lost))
                exc = lost
                devices = list(new_mesh.slots)
        exec_box["exec"] = new
        effective = at_iter + int(iters) - done
        return dataflow.ElasticResult(
            rd2, effective, delta, new.make_runner, new.invoke,
            new.extract_np, {"devices": new.d},
        )

    return rebuild


def run_pagerank_sharded(
    graph: Graph,
    cfg: PageRankConfig,
    *,
    n_devices: int | None = None,
    mesh: Mesh | None = None,
    strategy: str = "edges",
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> PageRankResult:
    """Sharded counterpart of ``models.pagerank.run_pagerank``: the same
    semantics flags, checkpoint segments and resume, ranks equal across
    slot counts up to the order of the sums.

    ``mesh`` defaults to ``n_devices`` visible cards (all of them where
    ``n_devices`` is None); ``device="cpu"`` makes it ``n_devices`` CPU
    slots instead.  A lost slot no longer ends the run: the elastic rung
    shrinks the mesh onto the surviving slots, repartitions and resumes,
    raising ``ResilienceExhausted`` with the newest checkpoint only when
    nothing survives, the loss names no slot, or ``GRAFT_ELASTIC=0``.

    On a mesh whose slots span processes (``parallel.init_distributed``)
    every process calls this with the same arguments: each partitions the
    whole graph, places and steps its own slots, and returns the same
    global ranks, bit-equal to the one-process mesh of the same slots.
    Process 0 writes the checkpoints (every process waits for each) and
    every process reads one to resume; a loss raises
    ``ResilienceExhausted`` on every process, with no shrink."""
    metrics = metrics or MetricsRecorder()
    if mesh is None:
        mesh = mesh_for(n_devices, NODES_AXIS, device)
    d = mesh.size
    if graph.n_nodes == 0:
        return PageRankResult(np.zeros(0, cfg.dtype), 0, 0.0, metrics)
    if strategy == "auto":
        strategy = auto_select_strategy(
            graph, d, dtype=cfg.dtype,
            head_coverage=cfg.head_coverage,
            head_row_width=cfg.head_row_width,
            devices=mesh.devices,
        )
        metrics.record(event="auto_strategy", chosen=strategy, devices=d)
    cfg = driver.resolve_personalize(graph, cfg)

    exec_ = _ShardedExec(graph, cfg, mesh, strategy, metrics)
    ranks_g = ops.init_ranks(exec_.sg.n, cfg)
    start_iter = (
        driver.resume_from_checkpoint(cfg, metrics, ranks_g, n=exec_.sg.n)
        if resume else 0
    )
    ranks_dev = exec_.put_ranks(ranks_g)

    # the elastic rung is the sharded path's only degradation: rebuild over
    # the survivors down to a 1-slot mesh (a CPU slot once no card is left)
    exec_box = {"exec": exec_}
    ranks_dev, done, last_delta = driver.run_segments(
        cfg, metrics, ranks_dev, start_iter,
        make_runner=exec_.make_runner,
        invoke=exec_.invoke,
        extract_np=exec_.extract_np,
        extra_metrics={"devices": d},
        elastic_rebuild=_make_elastic_rebuild(
            graph, cfg, strategy, metrics, exec_box
        ),
        save_checkpoint=_checkpoint_writer(mesh),
    )

    # A loss first surfacing at the result pull: salvage the newest
    # checkpoint (the live buffers died with the slot), rebuild over the
    # survivors, rerun the uncommitted iterations there and pull from the
    # rebuilt mesh, whose layout exec_box then holds.
    def pull_rebuild(exc):
        lost0 = _named_loss(exc)
        if not _may_rebuild(exec_box["exec"].mesh) or lost0 is None:
            raise exc
        exc = lost0
        elastic.health().mark_lost(elastic.device_index(exc))
        old = exec_box["exec"]
        at_iter, ranks_g = 0, ops.init_ranks(old.sg.n, cfg)
        if cfg.checkpoint_dir:
            latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
            if latest is not None:
                step, arrays, _ = ckpt.load_checkpoint(latest, cfg.config_hash())
                at_iter, ranks_g = int(step), arrays["ranks"]
        devices = list(old.mesh.slots)
        axis = old.mesh.axis
        todo = done - at_iter
        seg_cfg = dataclasses.replace(
            cfg, iterations=todo, checkpoint_every=0, checkpoint_dir=None
        )
        while True:
            plan = elastic.plan_shrink(devices)
            if plan is None:
                raise exc
            with elastic.publish_shrink(
                "pagerank_result_pull", plan, exc, metrics
            ):
                new_mesh = rebuild_mesh(plan.devices, axis)
                new = _ShardedExec(graph, cfg, new_mesh, strategy, metrics)
                rd2 = new.put_ranks(ranks_g)
            if todo <= 0:
                break
            try:
                rd2, _, _ = rx.attempt_once(
                    lambda n=new, r=rd2: n.invoke(n.make_runner(seg_cfg), r),
                    site="pagerank_elastic_rerun",
                )
                break
            except Exception as exc2:  # noqa: BLE001 — re-entry filter below
                lost = _named_loss(exc2)
                if lost is None:
                    raise
                elastic.health().mark_lost(elastic.device_index(lost))
                exc = lost
                devices = list(new_mesh.slots)
        exec_box["exec"] = new
        # the same site: chaos's device_lost is gated on the health
        # registry, so the acknowledged loss cannot fire again here
        with obs.span("pagerank.result_pull_rebuilt"):
            return rx.device_get(
                new.pull_view(rd2), site="pagerank_result_pull", metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )

    with obs.span("pagerank.result_pull"):
        ranks_np = rx.device_get(
            exec_.pull_view(ranks_dev), site="pagerank_result_pull", metrics=metrics,
            checkpoint_dir=cfg.checkpoint_dir,
            fallbacks=[(None, pull_rebuild)],
        )
    exec_ = exec_box["exec"]  # a rebuild rung may have swapped it
    return PageRankResult(
        ranks=exec_.assemble(ranks_np), iterations=done,
        l1_delta=last_delta, metrics=metrics,
    )
