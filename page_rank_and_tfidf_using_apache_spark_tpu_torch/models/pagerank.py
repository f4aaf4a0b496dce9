"""PageRank model driver: move the graph to the device once, run the loop,
pull the ranks back, and record metrics.

Counterpart of the JAX package's ``models/pagerank.py`` single-device path.
The numeric loop is ``ops/pagerank.py``.  Checkpointed segments, resume
and the recovery ladder are not part of the port yet: a config that asks
for checkpoints is refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    device: str | torch.device | None = None,
) -> PageRankResult:
    """Run PageRank per ``cfg`` on one device: ``cuda`` unless ``device``
    says otherwise (``device="cpu"`` runs the kernels' plain versions)."""
    dev = resolve_device(device)
    if cfg.checkpoint_every or cfg.checkpoint_dir:
        raise ValueError("checkpointing is not supported by the PyTorch port yet")
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
    ranks0 = torch.from_numpy(ops.init_ranks(n, cfg)).to(dev)

    make = ops.make_spark_exact_runner if cfg.spark_exact else ops.make_pagerank_runner
    runner = make(n, cfg)
    with Timer() as t:
        ranks, done, delta = runner(dg, ranks0, e)
        last_delta = float(delta)  # the host sync that ends the loop
    metrics.record(
        iter=done, l1_delta=last_delta, secs=t.elapsed,
        iters_per_sec=done / t.elapsed if t.elapsed > 0 else float("inf"),
    )
    metrics.scalar("iterations", done)
    metrics.scalar("l1_delta", last_delta)
    return PageRankResult(
        ranks=ranks.cpu().numpy(), iterations=done, l1_delta=last_delta,
        metrics=metrics,
    )
