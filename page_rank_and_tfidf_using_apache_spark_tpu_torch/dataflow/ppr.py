"""Batched personalized PageRank: one teleport vector a query, B queries
over one device-resident graph.

Counterpart of the JAX package's ``dataflow/ppr.py``.  The ``[B, n]`` rank
carry and teleport matrix carry the query axis; the graph's arrays and
plans are shared by every row.  The JAX package maps the single-query step
over the rows with ``vmap``; ``torch.func.vmap`` cannot see through the
hand-written kernels' launches, so the step is written for the batch
(``ops.pagerank.pagerank_step_batch``): the SpMV runs row by row through
the impl's kernel, B launches a step.  The fixpoint stops on the worst
query's L1 delta.  The host loop, checkpoints of the ``[B, n]`` matrix and
resume are ``dataflow.fixpoint.run_single_chip_fixpoint``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import driver
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import put_graph_for
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    PageRankConfig,
    RankInit,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import h2d, resolve_device
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer


def make_ppr_batch_runner(n: int, cfg: PageRankConfig):
    """The batched fixpoint loop: ``run(dg, ranks0 [B, n], e_batch [B, n])
    -> (ranks [B, n], iters, delta)``, with ``delta`` the largest of the
    rows' L1 step deltas, so a tolerance run ends only when the slowest
    query converged.  ``ranks0`` is left unchanged."""
    damping = cfg.damping
    impl = cfg.spmv_impl
    dangling = cfg.dangling
    total_mass = float(n) if cfg.init is RankInit.ONE else 1.0

    def run(dg: ops.DeviceGraph, ranks0: torch.Tensor, e_batch: torch.Tensor):
        return dflow.iterate(
            lambda rb: ops.pagerank_step_batch(
                rb, dg, e_batch, n=n, damping=damping, dangling=dangling,
                total_mass=total_mass, impl=impl,
            ),
            ranks0, iterations=cfg.iterations, tol=cfg.tol,
            delta_fn=lambda new, old: torch.max(torch.sum(torch.abs(new - old), dim=1)),
        )

    return run


def restart_batch(
    graph: Graph, cfg: PageRankConfig, queries: Sequence[Sequence[int]]
) -> np.ndarray:
    """[B, n] teleport matrix: one personalized restart vector per query
    (original node ids, resolved through the compaction mapping the
    single-query path uses)."""
    rows = []
    for q in queries:
        q_cfg = driver.resolve_personalize(
            graph, dataclasses.replace(cfg, personalize=tuple(int(x) for x in q))
        )
        rows.append(ops.restart_vector(graph.n_nodes, q_cfg))
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class PprBatchResult:
    ranks: np.ndarray  # f[B, n_nodes]
    iterations: int
    l1_delta: float  # worst query's final L1 step delta
    metrics: MetricsRecorder


def run_ppr_batch(
    graph: Graph,
    cfg: PageRankConfig,
    queries: Sequence[Sequence[int]],
    *,
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> PprBatchResult:
    """Run one batch of personalized PageRank queries, on ``cuda`` unless
    ``device`` says otherwise.

    ``cfg.personalize`` must stay None: the per-query sets arrive in
    ``queries`` (original node ids).  The checkpoint payload is the
    ``[B, n]`` rank matrix; ``resume=True`` starts from the newest one.

    The call is a ``ppr.call`` span (attributes ``nodes``, ``edges``,
    ``queries``) over a ``ppr.prep`` span of ``restart_batch``, whose
    seconds the ``ppr_batch`` record carries as ``prep_secs``, and the
    fixpoint driver's spans; the restart matrix goes up inside
    ``ppr.put_graph``."""
    dev = resolve_device(device)
    if cfg.personalize is not None:
        raise ValueError("run_ppr_batch takes queries=, not cfg.personalize")
    if cfg.spark_exact:
        raise ValueError("spark_exact cannot be personalized")
    if not queries:
        raise ValueError("need at least one personalization query")
    metrics = metrics or MetricsRecorder()
    n = graph.n_nodes
    b = len(queries)
    with obs.span("ppr.call", nodes=n, edges=graph.n_edges, queries=b):
        with Timer() as t_prep, obs.span("ppr.prep"):
            e_host = restart_batch(graph, cfg, queries)
        metrics.record(event="ppr_batch", queries=b, nodes=n, prep_secs=t_prep.elapsed)

        ranks_np, done, last_delta = dflow.run_single_chip_fixpoint(
            cfg, metrics, site_prefix="ppr",
            init_state=lambda: np.broadcast_to(ops.init_ranks(n, cfg), (b, n)).copy(),
            make_runner=lambda seg_cfg: make_ppr_batch_runner(n, seg_cfg),
            build_operands=lambda on, stats: (put_graph_for(graph, cfg, on, stats),
                                              h2d(e_host, on, stats)),
            call=lambda runner, ops_t, rd: runner(ops_t[0], rd, ops_t[1]),
            device=dev, resume=resume,
        )
    return PprBatchResult(ranks=ranks_np, iterations=done,
                          l1_delta=last_delta, metrics=metrics)
