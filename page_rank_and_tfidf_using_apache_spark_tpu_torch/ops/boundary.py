"""Owned-partition boundary machinery: the host planner of the ``owned``
sharded strategy and the two step-side helpers it needs.

Counterpart of the JAX package's ``ops/boundary.py``.  Everything but the
last two functions is that module's host numpy code, copied with its
imports pointed at the port (``tests/test_torch_owned.py`` holds the plans
and shards equal to the reference's); :func:`pack_boundary` and
:func:`boundary_lookup` work on torch tensors.

Every replicated-state sharded PageRank either replicates the full rank
vector (``edges``/``hybrid``: O(n) state a slot, one O(n) ``psum``) or
gathers it every step (``nodes*``: an O(n) ``all_gather``).  On a power-law
graph the partition cut is dominated by a small hub set (*Sparse
Allreduce*): peel the hubs into a small replicated mini-state and the
remaining cut-crossing ("boundary") entries are a sublinear fraction of n,
so exchanging only those, over fixed-width padded buffers, makes a step's
exchange sublinear in the node count.

Layout (one :class:`OwnedPlan`, materialized as one :class:`OwnedShard`):

- **head**: the top-k nodes by combined (in + out) degree covering
  ``coverage`` of all edge endpoints, capped at ``max_head``.  Their rank
  state is REPLICATED (an [H_pad] mini-vector) and their in-edge
  contributions combine in ONE small ``psum``; head in-edges are dealt
  across slots at edge granularity.
- **tail**: every other node, in d contiguous owned blocks at equal
  tail-in-edge splits (min-max optimal, node count a slot capped at 2x the
  even block).  Each slot holds ONLY its [block] rank slice; a tail node's
  in-edges live with its owner.
- **boundary**: per owner j, the sorted set S_j of tail nodes owned by j
  that some OTHER slot reads as an edge source.  Each step every slot packs
  its outgoing boundary values into a fixed-width [B_pad] buffer, a
  log2(d)-round butterfly all-gathers the d buffers
  (``parallel.collectives.butterfly_all_gather``), and a host-precomputed
  per-edge index gathers every edge's source value from ``[local slice |
  boundary table | replicated head | 0]``.

The steps live in ``parallel/pagerank_sharded.py`` and
``parallel/workloads_sharded.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def comm_entries_per_step(d: int, b_pad: int, h_pad: int) -> int:
    """Array entries each device sends per owned iteration: the butterfly
    ((d-1)·B_pad — round k carries 2^k·B_pad) plus the ring-allreduce
    cost of the one [H_pad+2] head psum (~2 passes).  THE one formula —
    the plan event (:meth:`OwnedPlan.comm_entries_per_step`) and the
    materialized gauge (`_ShardedExec`) both read it, so they cannot
    drift."""
    if d <= 1:
        return 0
    return int((d - 1) * b_pad + 2 * (h_pad + 2) * (d - 1) // d)


# A head member must concentrate at least this many edge endpoints —
# below it, replicating the node costs more state than its boundary
# entries would cost exchange (same role as plan_hybrid_head's row-width
# floor).
OWNED_HEAD_MIN_DEGREE = 8


def plan_owned_head(
    in_degree: np.ndarray,
    out_degree: np.ndarray,
    n_edges: int,
    *,
    coverage: float = 0.5,
    max_head: int = 4096,
) -> np.ndarray:
    """Head-membership policy of the ``owned`` strategy: the smallest
    top-k set by COMBINED (in + out) degree covering ``coverage`` of all
    2E edge endpoints, every member with combined degree >=
    ``OWNED_HEAD_MIN_DEGREE``, capped at ``max_head`` (the replicated
    mini-state and the per-step psum are O(head)).  Both degree axes
    matter: high IN-degree hubs receive from every shard (their combine
    is the psum), high OUT-degree hubs are read by every shard (their
    replication empties the boundary sets).  Returns ASCENDING node ids —
    head slot order is id order, which keeps every per-device head edge
    chunk sorted for the segment reduction."""
    if n_edges == 0 or in_degree.size == 0 or max_head <= 0:
        return np.zeros(0, np.int64)
    combined = in_degree.astype(np.int64) + out_degree.astype(np.int64)
    order = np.argsort(-combined, kind="stable")
    deg_sorted = combined[order]
    k_deg = int(np.searchsorted(-deg_sorted, -OWNED_HEAD_MIN_DEGREE,
                                side="right"))
    if k_deg == 0:
        return np.zeros(0, np.int64)
    cum = np.cumsum(deg_sorted[:k_deg], dtype=np.int64)
    k_cov = int(np.searchsorted(cum, coverage * 2 * n_edges, side="left")) + 1
    k = min(k_deg, k_cov, max_head)
    return np.sort(order[:k].astype(np.int64))


class OwnedPlan(NamedTuple):
    """Pure planning output of the ``owned`` strategy: boundaries, padded
    widths, boundary-set sizes and the padding/comm accounting — no
    per-device array materialized (``build_owned_shard`` materializes
    exactly this plan; the tier-3 pad gauge budgets these numbers)."""

    n: int
    d: int
    head_ids: np.ndarray  # int64 [H] ascending global ids (replicated)
    bounds: np.ndarray  # int64 [d+1] tail-RANK block boundaries
    block: int  # tail nodes per device (padded)
    n_pad: int  # d * block
    h: int  # real head size
    h_pad: int  # pow2 padded head width
    e_dev: int  # tail edge slots per device
    he_dev: int  # head edge slots per device
    b_pad: int  # boundary buffer width (pow2 over max |S_j|)
    boundary_counts: np.ndarray  # int64 [d] real |S_j|
    boundary_keys: np.ndarray  # int64 [Σ|S_j|] sorted owner*n+src keys
    # (a plan artifact build_owned_shard reuses — O(cut), not O(E))
    pad_frac: float  # padded edge-slot fraction (same gauge as others)
    boundary_pad_frac: float  # padded fraction of the d*b_pad exchange

    def comm_entries_per_step(self) -> int:
        """Array entries each device sends per iteration — see the
        module-level :func:`comm_entries_per_step`."""
        return comm_entries_per_step(self.d, self.b_pad, self.h_pad)


def _minmax_tail_split(tail_ip: np.ndarray, nt: int, d: int) -> np.ndarray:
    """Optimal min-max contiguous split of the tail nodes at equal
    tail-in-edge widths (binary search + greedy max-fill — the
    ``nodes_balanced`` planner's algorithm over tail-rank space), node
    count per device capped at 2x the even block."""
    bounds = np.zeros(d + 1, np.int64)
    if nt == 0:
        return bounds
    cap = 2 * max(1, math.ceil(nt / d))
    e_tail = int(tail_ip[-1])

    def fill(width: int) -> np.ndarray | None:
        b = 0
        out = np.zeros(d + 1, np.int64)
        for i in range(d):
            hi = int(np.searchsorted(
                tail_ip, tail_ip[b] + width, side="right")) - 1
            hi = min(max(hi, b), b + cap, nt)
            out[i + 1] = hi
            b = hi
        return out if b >= nt else None

    lo_w = max(1, math.ceil(e_tail / d))
    hi_w = max(e_tail, 1)
    bounds = fill(hi_w)
    assert bounds is not None  # d * cap >= 2 * nt always covers nt
    while lo_w < hi_w:
        mid = (lo_w + hi_w) // 2
        bm = fill(mid)
        if bm is None:
            lo_w = mid + 1
        else:
            hi_w, bounds = mid, bm
    return bounds


def plan_owned(
    graph: Graph,
    n_devices: int,
    *,
    coverage: float = 0.5,
    max_head: int = 4096,
    head_ids: np.ndarray | None = None,
    bounds: np.ndarray | None = None,
) -> OwnedPlan:
    """Plan the owned partition: head set, tail block boundaries, padded
    widths, and the per-owner boundary sets (cut-crossing sources).  One
    O(E) vectorized host pass; no per-device arrays.

    ``head_ids``/``bounds`` override the head policy / the min-max split
    with a FIXED node partition: a workload that pulls along both edge
    directions (owned HITS/CC in parallel/workloads_sharded.py) plans its
    reverse-direction exchange over the transposed graph under the SAME
    ownership, so both directions read one consistent rank slice."""
    d = n_devices
    if d < 1 or d & (d - 1):
        # the boundary butterfly is recursive doubling: partners are
        # i XOR 2^k, which only pairs up on power-of-two meshes (the same
        # shapes the elastic shrink chain rebuilds at) — reject early
        # instead of failing inside the butterfly
        raise ValueError(
            f"the owned strategy needs a power-of-two device count, got {d}"
        )
    n = graph.n_nodes
    e = graph.n_edges
    ip = graph.csr_indptr()
    indeg = np.diff(ip)

    if head_ids is None:
        head_ids = plan_owned_head(indeg, graph.out_degree, e,
                                   coverage=coverage, max_head=max_head)
    else:
        head_ids = np.sort(np.asarray(head_ids, np.int64))
    h = int(head_ids.size)
    h_pad = _pow2_ceil(max(h, 1))
    in_head = np.zeros(n, bool)
    in_head[head_ids] = True

    tail_ids = np.flatnonzero(~in_head)
    nt = int(tail_ids.size)
    tail_rank = np.full(n, -1, np.int64)
    tail_rank[tail_ids] = np.arange(nt, dtype=np.int64)

    mask_t = ~in_head[graph.dst]
    t_dst_rank = tail_rank[graph.dst[mask_t]]  # non-decreasing
    tail_ip = np.searchsorted(t_dst_rank, np.arange(nt + 1)).astype(np.int64)

    if bounds is None:
        bounds = _minmax_tail_split(tail_ip, nt, d)
    else:
        bounds = np.asarray(bounds, np.int64)
        assert bounds.shape == (d + 1,) and bounds[-1] == nt
    block = max(1, int(np.diff(bounds).max())) if nt else 1
    n_pad = d * block

    per_dev_tail = tail_ip[bounds[1:]] - tail_ip[bounds[:-1]]
    e_dev = max(1, int(per_dev_tail.max())) if nt else 1
    he = int(e - t_dst_rank.size)
    he_dev = max(1, math.ceil(he / d)) if he else 1

    # ---- boundary sets: remote (owner, src) pairs over BOTH edge classes
    def owner_of(rank: np.ndarray) -> np.ndarray:
        return np.searchsorted(bounds, rank, side="right") - 1

    te_src = graph.src[mask_t]
    reader_t = owner_of(t_dst_rank)
    he_src = graph.src[~mask_t]
    reader_h = np.arange(he, dtype=np.int64) // he_dev

    keys_parts = []
    for srcs, readers in ((te_src, reader_t), (he_src, reader_h)):
        is_tail_src = ~in_head[srcs]
        src_owner = owner_of(tail_rank[srcs])
        remote = is_tail_src & (src_owner != readers)
        keys_parts.append(src_owner[remote] * np.int64(n) + srcs[remote])
    boundary_keys = np.unique(np.concatenate(keys_parts)) if keys_parts else \
        np.zeros(0, np.int64)
    boundary_counts = np.bincount(
        (boundary_keys // n).astype(np.int64), minlength=d
    ).astype(np.int64)
    b_pad = _pow2_ceil(max(int(boundary_counts.max(initial=0)), 1))

    slots = d * (e_dev + he_dev)
    pad_frac = (slots - e) / max(slots, 1)
    boundary_pad_frac = (
        (d * b_pad - int(boundary_counts.sum())) / max(d * b_pad, 1)
    )
    return OwnedPlan(
        n=n, d=d, head_ids=head_ids, bounds=bounds, block=block,
        n_pad=n_pad, h=h, h_pad=h_pad, e_dev=e_dev, he_dev=he_dev,
        b_pad=b_pad, boundary_counts=boundary_counts,
        boundary_keys=boundary_keys, pad_frac=pad_frac,
        boundary_pad_frac=boundary_pad_frac,
    )


class OwnedShard(NamedTuple):
    """Materialized owned layout, ready to place on the slots.  Every
    ``*_src_idx`` entry indexes the step's per-device LOOKUP vector
    ``[local slice (block) | boundary table (d*b_pad) | head (h_pad) |
    zero slot]`` — padding slots point at the zero slot and carry
    coefficient 0, so no mask survives into the step."""

    n: int
    d: int
    block: int
    n_pad: int
    h: int
    h_pad: int
    b_pad: int
    e_dev: int
    he_dev: int
    head_ids: np.ndarray  # int64 [H] ascending
    tail_map: np.ndarray  # int64 [n]: global id -> padded tail slot; -1 head
    tail_src_idx: np.ndarray  # int32 [d, e_dev] lookup indices
    tail_dst: np.ndarray  # int32 [d, e_dev] block-local dst, non-decreasing
    tail_w: np.ndarray  # f [d, e_dev] edge coefficient (weight / 1; 0 pad)
    head_src_idx: np.ndarray  # int32 [d, he_dev] lookup indices
    head_slot: np.ndarray  # int32 [d, he_dev] psum-buffer slot (pad: h_pad+1)
    head_w: np.ndarray  # f [d, he_dev]
    out_idx: np.ndarray  # int32 [d, b_pad] local tail slots to pack (0 pad)
    boundary_counts: np.ndarray  # int64 [d]
    inv_tail: np.ndarray  # f [n_pad] 1/out-strength in owned layout
    dang_tail: np.ndarray  # f [n_pad]
    inv_head: np.ndarray  # f [h_pad]
    dang_head: np.ndarray  # f [h_pad]

    @property
    def zero_slot(self) -> int:
        return self.block + self.d * self.b_pad + self.h_pad


def build_owned_shard(graph: Graph, plan: OwnedPlan, dtype: str) -> OwnedShard:
    """Materialize exactly ``plan``: per-device edge arrays with
    host-precomputed lookup indices, outgoing boundary pack indices, and
    the owned/replicated node-state vectors."""
    d, n, e = plan.d, plan.n, graph.n_edges
    block, b_pad, h_pad, he_dev, e_dev = (
        plan.block, plan.b_pad, plan.h_pad, plan.he_dev, plan.e_dev
    )
    bounds = plan.bounds
    head_ids = plan.head_ids
    zero_slot = block + d * b_pad + h_pad

    in_head = np.zeros(n, bool)
    in_head[head_ids] = True
    head_slot_of = np.full(n, -1, np.int64)
    head_slot_of[head_ids] = np.arange(plan.h, dtype=np.int64)

    tail_ids = np.flatnonzero(~in_head)
    nt = int(tail_ids.size)
    tail_rank = np.full(n, -1, np.int64)
    tail_rank[tail_ids] = np.arange(nt, dtype=np.int64)

    def owner_of(rank: np.ndarray) -> np.ndarray:
        return np.searchsorted(bounds, rank, side="right") - 1

    # global id -> padded tail slot (device o's nodes at [o*block, ...))
    rank_all = tail_rank[tail_ids]
    owner_all = owner_of(rank_all)
    tail_map = np.full(n, -1, np.int64)
    tail_map[tail_ids] = owner_all * block + (rank_all - bounds[owner_all])

    starts = np.concatenate([[0], np.cumsum(plan.boundary_counts)])

    def lookup_idx(srcs: np.ndarray, readers: np.ndarray) -> np.ndarray:
        """Per-edge index into the reader's lookup vector."""
        src_rank = tail_rank[srcs]
        src_owner = owner_of(src_rank)
        local = src_rank - bounds[np.clip(src_owner, 0, d - 1)]
        keys = src_owner * np.int64(n) + srcs
        pos = np.searchsorted(plan.boundary_keys, keys) - starts[
            np.clip(src_owner, 0, d - 1)
        ]
        remote_idx = block + src_owner * b_pad + pos
        idx = np.where(
            in_head[srcs],
            block + d * b_pad + head_slot_of[srcs],
            np.where(src_owner == readers, local, remote_idx),
        )
        return idx.astype(np.int64)

    weights = (graph.weight if graph.weight is not None
               else np.ones(e, np.float64))  # host staging; cast into the dtype'd coefficient arrays below

    # ---- tail edges: contiguous per-owner runs of the tail edge array
    mask_t = ~in_head[graph.dst]
    te_src = graph.src[mask_t]
    te_w = weights[mask_t]
    t_dst_rank = tail_rank[graph.dst[mask_t]]
    tail_ip = np.searchsorted(t_dst_rank, np.arange(nt + 1)).astype(np.int64)
    reader_t = owner_of(t_dst_rank)
    te_idx = lookup_idx(te_src, reader_t)

    tail_src_idx = np.full((d, e_dev), zero_slot, np.int32)
    tail_dst = np.full((d, e_dev), max(block - 1, 0), np.int32)
    tail_w = np.zeros((d, e_dev), dtype)
    for i in range(d):
        lo = int(tail_ip[bounds[i]]) if nt else 0
        hi = int(tail_ip[bounds[i + 1]]) if nt else 0
        k = hi - lo
        tail_src_idx[i, :k] = te_idx[lo:hi]
        tail_dst[i, :k] = (t_dst_rank[lo:hi] - bounds[i])
        tail_w[i, :k] = te_w[lo:hi]

    # ---- head edges: dealt in d contiguous chunks of the (slot-sorted)
    # head edge array; padding scatters +0.0 into the delta slot (h_pad+1),
    # keeping each device's slot sequence non-decreasing
    mask_h = ~mask_t
    he_src = graph.src[mask_h]
    he_w = weights[mask_h]
    he_slot = head_slot_of[graph.dst[mask_h]]
    he = int(he_src.size)
    reader_h = np.arange(he, dtype=np.int64) // he_dev
    he_idx = lookup_idx(he_src, reader_h) if he else np.zeros(0, np.int64)

    head_src_idx = np.full((d, he_dev), zero_slot, np.int32)
    head_slot = np.full((d, he_dev), h_pad + 1, np.int32)
    head_w = np.zeros((d, he_dev), dtype)
    for i in range(d):
        lo, hi = min(i * he_dev, he), min((i + 1) * he_dev, he)
        k = hi - lo
        head_src_idx[i, :k] = he_idx[lo:hi]
        head_slot[i, :k] = he_slot[lo:hi]
        head_w[i, :k] = he_w[lo:hi]

    # ---- outgoing boundary pack indices: owner j's S_j as local slots
    out_idx = np.zeros((d, b_pad), np.int32)
    for j in range(d):
        seg = plan.boundary_keys[starts[j]:starts[j + 1]]
        srcs = (seg - j * np.int64(n)).astype(np.int64)
        out_idx[j, : srcs.size] = (tail_rank[srcs] - bounds[j])

    # ---- node-state vectors (the shared float64-divide-then-cast
    # normalizer — parity with every other strategy's inv computation)
    inv_g = graph.inv_out_strength(np.float64)  # host staging, scattered into the dtype'd vectors below
    dang_g = (graph.out_degree == 0).astype(np.float64)  # host staging, cast to the run dtype below

    inv_tail = np.zeros(plan.n_pad, dtype)
    dang_tail = np.zeros(plan.n_pad, dtype)
    inv_tail[tail_map[tail_ids]] = inv_g[tail_ids]
    dang_tail[tail_map[tail_ids]] = dang_g[tail_ids]
    inv_head = np.zeros(h_pad, dtype)
    dang_head = np.zeros(h_pad, dtype)
    inv_head[: plan.h] = inv_g[head_ids]
    dang_head[: plan.h] = dang_g[head_ids]

    return OwnedShard(
        n=n, d=d, block=block, n_pad=plan.n_pad, h=plan.h, h_pad=h_pad,
        b_pad=b_pad, e_dev=e_dev, he_dev=he_dev,
        head_ids=head_ids, tail_map=tail_map,
        tail_src_idx=tail_src_idx, tail_dst=tail_dst, tail_w=tail_w,
        head_src_idx=head_src_idx, head_slot=head_slot, head_w=head_w,
        out_idx=out_idx, boundary_counts=plan.boundary_counts,
        inv_tail=inv_tail, dang_tail=dang_tail,
        inv_head=inv_head, dang_head=dang_head,
    )


def split_global(shard, global_vec: np.ndarray,
                 dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """Logical [n] host array -> (tail [n_pad], head [h_pad]) in the
    owned layout (padding zeros).  ``shard`` is duck-typed on the layout
    fields (n_pad/h/h_pad/tail_map/head_ids): an :class:`OwnedShard` or
    the dataflow layer's ``OwnedArray`` view."""
    tail = np.zeros(shard.n_pad, dtype)
    head = np.zeros(shard.h_pad, dtype)
    mask = shard.tail_map >= 0
    tail[shard.tail_map[mask]] = global_vec[mask]
    head[: shard.h] = global_vec[shard.head_ids]
    return tail, head


def merge_global(shard, tail: np.ndarray,
                 head: np.ndarray) -> np.ndarray:
    """(tail [n_pad], head [h_pad]) -> logical [n] host array (same
    duck-typed ``shard`` as :func:`split_global`)."""
    out = np.empty(shard.n, tail.dtype)
    mask = shard.tail_map >= 0
    out[mask] = tail[shard.tail_map[mask]]
    out[shard.head_ids] = head[: shard.h]
    return out


# ------------------------------------------------------ step-side helpers


def pack_boundary(wt_local: torch.Tensor, out_idx: torch.Tensor) -> torch.Tensor:
    """Gather this slot's outgoing boundary values into its fixed-width
    exchange buffer: ``[block] -> [b_pad]`` (padding rows re-read slot 0;
    no receiver ever indexes them)."""
    return wt_local[out_idx]


def boundary_lookup(wt_local: torch.Tensor, btable: torch.Tensor, wh: torch.Tensor,
                    fill=0) -> torch.Tensor:
    """The step's per-slot source-value lookup vector: ``[local slice |
    exchanged boundary table | replicated head | fill]``; every
    host-precomputed ``*_src_idx`` indexes this concatenation.  ``fill`` is
    the padding slot's value: 0 for additive combines, the dtype's max for
    min-combines (owned connected components)."""
    return torch.cat([wt_local, btable, wh, wt_local.new_full((1,), fill)])
