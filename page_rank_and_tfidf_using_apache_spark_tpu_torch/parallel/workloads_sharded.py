"""Sharded graph workloads: HITS and connected components on owned slices,
batched personalized PageRank with its query axis sharded.

Counterpart of the JAX package's ``parallel/workloads_sharded.py``.  HITS
and components pull along BOTH edge directions, so each builds two
boundary-exchange layouts over ONE node ownership: the forward layout on
the graph and the reverse one on the transposed graph under the same tail
bounds (``ops.boundary.plan_owned(bounds=...)``).  Every node's state lives
in one owned slice, and each direction exchanges only its own cut.  Neither
peels a hub head (``max_head=0``).  Per step: one boundary butterfly a
direction plus the norm and convergence reductions.  HITS sums both passes
on ``csrc/segment.cu`` over each slot's CSR pointers and their plans;
components' ``min`` combine is ``dataflow.segment_combine`` (exact,
order-free, no kernel), as on one device.

On a mesh whose slots span processes every process runs the whole call:
each places and steps its own slots, the collectives gather across the
processes, and every process returns the same result, bit-equal to the
one-process mesh of the same slots.

PPR's scale axis is the query batch: ``run_ppr_sharded`` splits the
``[B, n]`` teleport and rank matrices into one row block a slot (B padded
to a multiple of the slot count by repeating the last query), places the
graph on every slot, and runs the single-device batch step
(``ops.pagerank.pagerank_step_batch``) on each block inside one fixpoint
loop whose delta is the worst query's over all slots.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import combine
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import components as cc
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dataflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import hits as hits_mod
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr as ppr_mod
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.partition import OwnedArray
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import put_graph_for
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import boundary as ob
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    NODES_AXIS,
    Mesh,
    mesh_for,
    sharded_along,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    ComponentsConfig,
    HitsConfig,
    PageRankConfig,
    RankInit,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import (
    MetricsRecorder,
    Timer,
)


def transpose_graph(graph: Graph) -> Graph:
    """The reversed edge set as a dst-sorted :class:`Graph` over the SAME
    compacted node ids: the reverse pull of HITS/CC becomes a forward pull
    on this view (``from_edges`` would re-compact ids)."""
    order = np.lexsort((graph.dst, graph.src))  # new (dst, src) = (src, dst)
    return Graph(
        n_nodes=graph.n_nodes,
        src=graph.dst[order].astype(np.int32),
        dst=graph.src[order].astype(np.int32),
        out_degree=np.bincount(
            graph.dst, minlength=graph.n_nodes
        ).astype(np.int32),
        node_ids=graph.node_ids,
        weight=graph.weight[order] if graph.weight is not None else None,
    )


def build_owned_pair(
    graph: Graph, n_devices: int, dtype: str
) -> tuple[ob.OwnedShard, ob.OwnedShard]:
    """(forward, reverse) owned shards over ONE node ownership: the forward
    plan picks the tail bounds (headless), the reverse plan inherits them
    on the transposed graph."""
    tg = transpose_graph(graph)
    fwd_plan = ob.plan_owned(graph, n_devices, max_head=0)
    rev_plan = ob.plan_owned(
        tg, n_devices, max_head=0,
        head_ids=fwd_plan.head_ids, bounds=fwd_plan.bounds,
    )
    return (ob.build_owned_shard(graph, fwd_plan, dtype),
            ob.build_owned_shard(tg, rev_plan, dtype))


class _Direction(NamedTuple):
    """One slot's operands of one direction of a headless owned exchange."""

    src: torch.Tensor  # int32 [e_dev] lookup indices
    dst: torch.Tensor  # int32 [e_dev] block-local, non-decreasing
    w: torch.Tensor  # f [e_dev] coefficients (0 at the padding)
    out_idx: torch.Tensor  # int32 [b_pad]
    ptr: torch.Tensor  # int32 [block+1] CSR pointers over dst
    plan: sk.SegmentPlan


def _device_put_pair(sf: ob.OwnedShard, sr: ob.OwnedShard,
                     mesh: Mesh) -> list[tuple[_Direction, _Direction]]:
    """Each of this process's slots' (forward, reverse) operands on its
    device, with the segment kernel's plan of each pointer array."""
    grid = np.arange(sf.block + 1)
    out = []
    for i in mesh.positions:
        slot = mesh.slots[i]
        dirs = []
        for shard in (sf, sr):
            ptr = np.searchsorted(shard.tail_dst[i], grid).astype(np.int32)

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(slot.device, copy=True)

            dirs.append(_Direction(put(shard.tail_src_idx[i]), put(shard.tail_dst[i]),
                                   put(shard.tail_w[i]), put(shard.out_idx[i]), put(ptr),
                                   sk.segment_plan(ptr, device=slot.device)))
        out.append(tuple(dirs))
    return out


# ------------------------------------------------------------------- HITS


def make_hits_sharded_runner(sf: ob.OwnedShard, sr: ob.OwnedShard,
                             cfg: HitsConfig, mesh: Mesh):
    """The owned HITS fixpoint: ``run((hubs, auths), dev) -> ((hubs,
    auths), iters, delta)`` over per-slot lists; per step one boundary
    butterfly a direction, one ``pmax`` a normalisation and the
    convergence ``psum``, every collective O(boundary) or O(1)."""
    block = sf.block

    def one_pass(vals, dev, which: int, h_pad: int):
        dirs = [dv[which] for dv in dev]
        tables = coll.butterfly_all_gather(
            [ob.pack_boundary(v, a.out_idx) for v, a in zip(vals, dirs)], mesh=mesh)
        raw = [sk.segment_sum_kernel(ob.boundary_lookup(v, t, v.new_zeros(h_pad)), a.ptr,
                                     block, src=a.src, edge_weight=a.w, plan=a.plan)
               for v, t, a in zip(vals, tables, dirs)]
        top = coll.pmax([torch.max(x) for x in raw], mesh=mesh)
        return [x / torch.clamp(m, min=1e-30) for x, m in zip(raw, top)]

    def step(ha, dev):
        hubs, _auths = ha
        auths = one_pass(hubs, dev, 0, sf.h_pad)
        return (one_pass(auths, dev, 1, sr.h_pad), auths)

    def run(ha0, dev):
        return dataflow.iterate(
            lambda ha: step(ha, dev), ha0,
            iterations=cfg.iterations, tol=cfg.tol,
            delta_fn=lambda new, old: coll.psum(
                [torch.sum(torch.abs(a - b)) for a, b in zip(new[0], old[0])], mesh=mesh)[0],
        )

    return run


def run_hits_sharded(
    graph: Graph,
    cfg: HitsConfig = HitsConfig(),
    *,
    n_devices: int | None = None,
    mesh: Mesh | None = None,
    metrics: MetricsRecorder | None = None,
    device: str | torch.device | None = None,
) -> hits_mod.HitsResult:
    """Sharded counterpart of ``dataflow.hits.run_hits`` on owned slices:
    the same networkx-parity iteration, hubs and authorities each held only
    by their owner slot.  ``mesh`` defaults as in
    ``run_pagerank_sharded``."""
    metrics = metrics or MetricsRecorder()
    if mesh is None:
        mesh = mesh_for(n_devices, NODES_AXIS, device)
    d = mesh.size
    n = graph.n_nodes
    if n == 0:
        z = np.zeros(0, cfg.dtype)
        return hits_mod.HitsResult(z, z, 0, 0.0, metrics)

    with Timer() as t_part:
        sf, sr = build_owned_pair(graph, d, cfg.dtype)
        dev = _device_put_pair(sf, sr, mesh)
    metrics.record(event="partition", strategy="owned", workload="hits",
                   devices=d, block=sf.block,
                   pad_frac=round(
                       (d * sf.e_dev - graph.n_edges)
                       / max(d * sf.e_dev, 1), 4),
                   secs=t_part.elapsed, processes=mesh.processes, backend=mesh.backend)
    layout = OwnedArray.from_shard(sf, mesh=mesh)
    init = np.full(n, 1.0 / n, cfg.dtype)
    hub0 = layout.put(init, cfg.dtype)
    auth0 = layout.put(init, cfg.dtype)

    runner = make_hits_sharded_runner(sf, sr, cfg, mesh)
    with obs.span("hits.sharded", devices=d, n=n):
        (hub_d, auth_d), iters, delta = runner((hub0.tail, auth0.tail), dev)
        delta = float(delta)  # the scalar read syncs the loop
        with obs.span("hits.result_pull"):
            hubs = layout.with_value(hub_d, hub0.head).pull(
                site="hits_result_pull", metrics=metrics,
            )
            auths = layout.with_value(auth_d, auth0.head).pull(
                site="hits_result_pull", metrics=metrics,
            )
    hs, as_ = float(hubs.sum()), float(auths.sum())
    hubs = hubs / hs if hs > 0 else hubs
    auths = auths / as_ if as_ > 0 else auths
    metrics.scalar("iterations", int(iters))
    return hits_mod.HitsResult(hubs=hubs, authorities=auths,
                               iterations=int(iters), l1_delta=delta,
                               metrics=metrics)


# ------------------------------------------------- connected components


def make_components_sharded_runner(sf: ob.OwnedShard, sr: ob.OwnedShard,
                                   cfg: ComponentsConfig, mesh: Mesh):
    """The owned min-label fixpoint: both directions' boundary labels come
    through the butterflies, each direction combines with a sorted
    ``min``, and the changed-label count converges through one psum.  The
    padding reads the int32 max, which ``min`` ignores."""
    block = sf.block
    big = torch.iinfo(torch.int32).max

    def incoming(labels, dev, which: int, h_pad: int):
        dirs = [dv[which] for dv in dev]
        tables = coll.butterfly_all_gather(
            [ob.pack_boundary(lab, a.out_idx) for lab, a in zip(labels, dirs)], mesh=mesh)
        return [combine.segment_combine(
                    ob.boundary_lookup(lab, t, lab.new_full((h_pad,), big), fill=big)[a.src],
                    a.dst, block, op="min", indices_are_sorted=True)
                for lab, t, a in zip(labels, tables, dirs)]

    def step(labels, dev):
        fwd = incoming(labels, dev, 0, sf.h_pad)
        rev = incoming(labels, dev, 1, sr.h_pad)
        return [torch.minimum(lab, torch.minimum(f, r))
                for lab, f, r in zip(labels, fwd, rev)]

    def run(labels0, dev):
        return dataflow.iterate(
            lambda lab: step(lab, dev), labels0,
            iterations=cfg.iterations, tol=cfg.tol,
            delta_fn=lambda new, old: coll.psum(
                [torch.sum((a != b).to(torch.float32)) for a, b in zip(new, old)], mesh=mesh)[0],
        )

    return run


def run_components_sharded(
    graph: Graph,
    cfg: ComponentsConfig = ComponentsConfig(),
    *,
    n_devices: int | None = None,
    mesh: Mesh | None = None,
    metrics: MetricsRecorder | None = None,
    device: str | torch.device | None = None,
) -> cc.ComponentsResult:
    """Sharded counterpart of ``dataflow.components.run_components`` on
    owned label slices: labels equal the single-device run's exactly
    (``min`` is order-free)."""
    metrics = metrics or MetricsRecorder()
    if mesh is None:
        mesh = mesh_for(n_devices, NODES_AXIS, device)
    d = mesh.size
    n = graph.n_nodes
    if n == 0:
        return cc.ComponentsResult(np.zeros(0, np.int32), 0, 0, metrics)

    with Timer() as t_part:
        sf, sr = build_owned_pair(graph, d, "float32")
        dev = _device_put_pair(sf, sr, mesh)
    metrics.record(event="partition", strategy="owned", workload="cc",
                   devices=d, block=sf.block, secs=t_part.elapsed,
                   processes=mesh.processes, backend=mesh.backend)
    layout = OwnedArray.from_shard(sf, mesh=mesh)
    lab0 = layout.put(np.arange(n, dtype=np.int32), np.int32)

    runner = make_components_sharded_runner(sf, sr, cfg, mesh)
    with obs.span("cc.sharded", devices=d, n=n):
        lab_d, iters, changed = runner(lab0.tail, dev)
        changed = float(changed)  # the scalar read syncs the loop
        with obs.span("cc.result_pull"):
            labels = layout.with_value(lab_d, lab0.head).pull(
                site="cc_result_pull", metrics=metrics,
            )
    converged = changed <= cfg.tol
    if not converged:
        metrics.record(event="cc_not_converged", iterations=int(iters),
                       still_changing=int(changed))
    n_components = int(np.unique(labels).shape[0])
    metrics.scalar("n_components", n_components)
    return cc.ComponentsResult(labels=labels.astype(np.int32),
                               n_components=n_components,
                               iterations=int(iters), metrics=metrics,
                               converged=converged)


# --------------------------------------------- PPR: sharded query axis


def run_ppr_sharded(
    graph: Graph,
    cfg: PageRankConfig,
    queries,
    *,
    n_devices: int | None = None,
    mesh: Mesh | None = None,
    metrics: MetricsRecorder | None = None,
    device: str | torch.device | None = None,
) -> ppr_mod.PprBatchResult:
    """Batched personalized PageRank with the QUERY axis sharded: the
    ``[B, n]`` teleport matrix and rank carry cut into one row block a slot
    (B padded to a multiple of the slot count by repeating the last
    query), the graph placed on every slot, and each block stepped by the
    single-device batch step; the fixpoint's delta is the worst query's
    over all slots, the only cross-slot traffic."""
    if cfg.personalize is not None:
        raise ValueError("run_ppr_sharded takes queries=, not cfg.personalize")
    if not queries:
        raise ValueError("need at least one personalization query")
    metrics = metrics or MetricsRecorder()
    if mesh is None:
        mesh = mesh_for(n_devices, DATA_AXIS, device)
    d = mesh.size
    n = graph.n_nodes
    b = len(queries)
    b_pad = -(-b // d) * d
    queries_p = list(queries) + [queries[-1]] * (b_pad - b)
    metrics.record(event="ppr_sharded", queries=b, batch_pad=b_pad,
                   devices=d, nodes=n, processes=mesh.processes, backend=mesh.backend)

    e_host = ppr_mod.restart_batch(graph, cfg, queries_p).astype(cfg.dtype)
    r_host = np.broadcast_to(np.asarray(ops.init_ranks(n, cfg)), (b_pad, n)).copy()
    dgs = [put_graph_for(graph, cfg, mesh.slots[i].device) for i in mesh.positions]
    es = sharded_along(mesh, e_host)
    ranks0 = sharded_along(mesh, r_host)
    total_mass = float(n) if cfg.init is RankInit.ONE else 1.0

    def step(rbs):
        return [ops.pagerank_step_batch(
                    rb, dg, e, n=n, damping=cfg.damping, dangling=cfg.dangling,
                    total_mass=total_mass, impl=cfg.spmv_impl)
                for rb, dg, e in zip(rbs, dgs, es)]

    with obs.span("ppr.sharded", devices=d, queries=b):
        rd, iters, delta = dataflow.iterate(
            step, ranks0, iterations=cfg.iterations, tol=cfg.tol,
            delta_fn=lambda new, old: coll.pmax(
                [torch.max(torch.sum(torch.abs(a - o), dim=1)) for a, o in zip(new, old)],
                mesh=mesh)[0],
        )
        delta = float(delta)  # the scalar read syncs the loop
        with obs.span("ppr.result_pull"):
            ranks = rx.device_get(
                coll.gather_slots(list(rd), mesh=mesh), site="ppr_result_pull",
                metrics=metrics,
            )
    return ppr_mod.PprBatchResult(ranks=np.concatenate(ranks)[:b],
                                  iterations=int(iters), l1_delta=delta,
                                  metrics=metrics)
