"""PageRank model driver: move the graph to the device once, run the loop
in checkpointed segments, pull the ranks back, and record metrics.

Counterpart of the JAX package's ``models/pagerank.py`` single-device path.
The numeric loop is ``ops/pagerank.py``; the segment loop, checkpoints and
resume are ``dataflow/fixpoint.run_segments`` (through ``models/driver``):
with ``checkpoint_every = k`` the run takes k-iteration segments with a
snapshot of ``(ranks, iteration, config_hash)`` between them, and
``resume=True`` restarts from the newest one, giving an unbroken run's
bits.  The reference's recovery rungs are not ported (ROADMAP Queue 1
items 3 and 12).  The host syncs are obs spans under the JAX package's
names: ``pagerank.delta_sync`` (where ``tol`` makes the loop read its
delta, the loop's own syncs are not spanned: the last one is),
``pagerank.ckpt_pull`` and ``pagerank.result_pull``, with
``pagerank.segment`` and ``pagerank.checkpoint`` from the segment loop.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import driver
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
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

    def invoke(runner, rd):
        rd, iters, delta = runner(dg, rd, e)
        with sync():
            # the reference's guarded site pagerank_delta_sync
            delta = float(delta)  # the host sync that ends the segment
        return rd, iters, delta

    def extract_np(rd) -> np.ndarray:
        with obs.span("pagerank.ckpt_pull"):
            return rd.cpu().numpy()

    ranks_dev, done, last_delta = driver.run_segments(
        cfg, metrics, ranks_dev, start_iter,
        make_runner=lambda seg_cfg: make(n, seg_cfg),
        invoke=invoke,
        extract_np=extract_np,
        segments_allowed=not cfg.spark_exact,
    )
    with obs.span("pagerank.result_pull"):
        ranks_np = ranks_dev.cpu().numpy()
    return PageRankResult(
        ranks=ranks_np, iterations=done, l1_delta=last_delta, metrics=metrics,
    )
