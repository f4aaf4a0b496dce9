"""PageRank model driver: move the graph to the device once, run the loop
in checkpointed segments, pull the ranks back, and record metrics.

Counterpart of the JAX package's ``models/pagerank.py`` single-device path.
The numeric loop is ``ops/pagerank.py``; the segment loop, checkpoints and
resume are ``dataflow/fixpoint.run_segments`` (through ``models/driver``):
with ``checkpoint_every = k`` the run takes k-iteration segments with a
snapshot of ``(ranks, iteration, config_hash)`` between them, and
``resume=True`` restarts from the newest one, giving an unbroken run's
bits.  Each segment runs under the retry executor at the
``pagerank_step`` site, and each host pull at its own guarded site, the
JAX package's: ``pagerank_delta_sync``, ``pagerank_ckpt_pull`` and
``pagerank_result_pull``.  A transient fault retries with the unbroken
run's bits.  A lost device that names its index hands the run to the
CPU, as in the JAX package: the newest checkpoint is reloaded, the
uncommitted span re-runs on the CPU and the run finishes there
(``dataflow.fixpoint.make_cpu_salvage``, and ``make_pull_salvage`` at the
result pull; the ``pagerank.cpu_salvage`` span).  Any other error (a
whole-backend loss, a kernel's own fault), or a spent retry budget, raises
``ResilienceExhausted`` naming the newest checkpoint, from which
``resume=True`` continues: the reference's per-segment ``cpu`` rung is not
ported (``dataflow/fixpoint.py``).  The host syncs are obs spans under the JAX
package's names: ``pagerank.delta_sync`` (where ``tol`` makes the loop read
its delta, the loop's own syncs are not spanned: the last one is),
``pagerank.ckpt_pull`` and ``pagerank.result_pull``, with
``pagerank.segment`` and ``pagerank.checkpoint`` from the segment loop.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import driver
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder, Timer


def put_graph_for(graph: Graph, cfg: PageRankConfig,
                  device: str | torch.device = "cuda") -> ops.DeviceGraph:
    """``ops.put_graph`` with whatever static layout ``cfg.spmv_impl``
    needs, built from the config's layout knobs.  Layout impls never read
    the raw edge arrays, so their device copy is skipped."""
    layout = ops.layout_for_impl(cfg.spmv_impl)
    return ops.put_graph(
        graph, cfg.dtype,
        layout=layout,
        head_coverage=cfg.head_coverage,
        head_row_width=cfg.head_row_width,
        bucket_width=cfg.shuffle_bucket_width,
        keep_edge_arrays=layout is None,
        device=device,
    )


@dataclasses.dataclass(frozen=True)
class PageRankResult:
    ranks: np.ndarray  # f[n_nodes], aligned with graph's compacted ids
    iterations: int  # iterations actually executed
    l1_delta: float  # L1 delta of the final iteration
    metrics: MetricsRecorder


def run_pagerank(
    graph: Graph,
    cfg: PageRankConfig,
    *,
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> PageRankResult:
    """Run PageRank per ``cfg`` on one device: ``cuda`` unless ``device``
    says otherwise (``device="cpu"`` runs the kernels' plain versions).
    ``resume=True`` starts from the newest checkpoint under
    ``cfg.checkpoint_dir``."""
    dev = resolve_device(device)
    metrics = metrics or MetricsRecorder()
    n = graph.n_nodes
    if n == 0:
        return PageRankResult(np.zeros(0, cfg.dtype), 0, 0.0, metrics)
    cfg = driver.resolve_personalize(graph, cfg)

    # The one-time host layout build is amortized over the whole run.
    with Timer() as t_put:
        dg = put_graph_for(graph, cfg, dev)
    metrics.record(event="put_graph", spmv_impl=cfg.spmv_impl,
                   preprocess_secs=t_put.elapsed)
    e = torch.from_numpy(ops.restart_vector(n, cfg)).to(dev)
    ranks = ops.init_ranks(n, cfg)
    start_iter = driver.resume_from_checkpoint(cfg, metrics, ranks, n=n) if resume else 0
    ranks_dev = torch.from_numpy(ranks).to(dev)

    make = ops.make_spark_exact_runner if cfg.spark_exact else ops.make_pagerank_runner
    # without tol the loop runs with no host sync and this read waits for
    # all of it, so only a tol run's last delta read is a delta_sync span
    sync = (lambda: obs.span("pagerank.delta_sync")) if cfg.tol > 0 else contextlib.nullcontext

    def make_invoke(dg_, e_):
        def invoke(runner, rd):
            rd, iters, delta = runner(dg_, rd, e_)
            with sync():
                # the host sync that ends the segment
                delta = float(rx.device_get(  # graftlint: disable=untraced-guarded-site (ROADMAP Queue 3: the delta read is a pagerank.delta_sync span only under tol > 0)
                    delta, site="pagerank_delta_sync", metrics=metrics,
                    checkpoint_dir=cfg.checkpoint_dir,
                ))
            return rd, iters, delta

        return invoke

    def extract_np(rd) -> np.ndarray:
        with obs.span("pagerank.ckpt_pull"):
            return rx.device_get(
                rd, site="pagerank_ckpt_pull", metrics=metrics,
                checkpoint_dir=cfg.checkpoint_dir,
            )

    def init_state() -> np.ndarray:
        return ops.init_ranks(n, cfg)

    def cpu_salvage_exec(rerun_cfg, ranks_g: np.ndarray):
        """``dataflow.fixpoint.make_cpu_salvage``'s ``cpu_exec``: the span
        on the CPU from host state (no read of the card's memory), and the
        invoke of every later segment."""
        dg_cpu = put_graph_for(graph, cfg, torch.device("cpu"))
        e_cpu = torch.from_numpy(ops.restart_vector(n, cfg))
        rd_cpu = torch.from_numpy(np.asarray(ranks_g).astype(cfg.dtype))
        rd2, iters, delta = make(n, rerun_cfg)(dg_cpu, rd_cpu, e_cpu)
        return rd2, int(iters), float(delta), make_invoke(dg_cpu, e_cpu)

    ranks_dev, done, last_delta = driver.run_segments(
        cfg, metrics, ranks_dev, start_iter,
        make_runner=lambda seg_cfg: make(n, seg_cfg),
        invoke=make_invoke(dg, e),
        extract_np=extract_np,
        segments_allowed=not cfg.spark_exact,
        elastic_rebuild=dflow.make_cpu_salvage(
            cfg, metrics, site_prefix="pagerank",
            init_state=init_state, cpu_exec=cpu_salvage_exec,
            make_runner=lambda c: make(n, c), extract_np=extract_np,
        ),
    )
    with obs.span("pagerank.result_pull"):
        ranks_np = rx.device_get(
            ranks_dev, site="pagerank_result_pull", metrics=metrics,
            checkpoint_dir=cfg.checkpoint_dir,
            fallbacks=[(None, dflow.make_pull_salvage(
                cfg, metrics, site_prefix="pagerank",
                init_state=init_state, cpu_exec=cpu_salvage_exec,
                get_done=lambda: done,
            ))],
        )
    return PageRankResult(
        ranks=ranks_np, iterations=done, l1_delta=last_delta, metrics=metrics,
    )
