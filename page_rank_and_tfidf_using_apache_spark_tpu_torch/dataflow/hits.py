"""HITS (hubs and authorities): two interleaved SpMV fixpoints with norm
steps, with networkx.hits's semantics.

Counterpart of the JAX package's ``dataflow/hits.py``.  Per iteration:

1. ``auth[v] = Σ_{(u,v)∈E} w(u,v)·hub[u]``: the forward pass, the
   segmented-sum kernel over the dst-sorted edges' CSR pointers
   (``DeviceGraph.indptr`` and its ``segment_plan``), gathering ``hub``
   through ``src``;
2. ``auth /= max(max(auth), 1e-30)``;
3. ``hub[u] = Σ_{(u,v)∈E} w(u,v)·auth[v]``: the reverse pass.  The JAX
   package scatters over ``src`` unsorted; here it is the same kernel over
   a src-sorted layout (:class:`HitsGraph`, built once per graph: a stable
   argsort of ``src``, its CSR pointers, ``dst`` and the weights in that
   order, and the pointers' plan), so no float scatter-add runs and no call
   in the loop builds a plan;
4. ``hub /= max(max(hub), 1e-30)``;
5. converge on the hub vector's L1 delta; sum-normalize both at the end.

Both passes sum float32 values in float64 in an order fixed by the graph,
so two runs give equal bits on the card.  Both vectors ride one ``[2, n]``
carry (row 0 hubs, row 1 authorities) through
``dataflow.fixpoint.run_single_chip_fixpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import HitsConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder


class HitsGraph(NamedTuple):
    """The graph both HITS passes read, on the device."""

    fwd: ops.DeviceGraph  # dst-sorted edges, indptr and its segment plan
    rev_ptr: torch.Tensor  # int32 [n+1] CSR pointers over the src-sorted edges
    rev_dst: torch.Tensor  # int32 [E] dst of each edge, in src-sorted order
    rev_w: torch.Tensor | None  # f[E] edge weights in src-sorted order
    rev_plan: sk.SegmentPlan  # the segment kernel's plan of rev_ptr


def put_hits_graph(graph: Graph, dtype: str, device: str | torch.device) -> HitsGraph:
    """``ops.put_graph`` plus the src-sorted layout of the reverse pass.
    The argsort is stable, so a source's edges keep their dst order: the
    order in which the JAX package's scatter adds them."""
    order = np.argsort(graph.src, kind="stable")
    rev_ptr = ops.segment_pointers(graph.src[order], graph.n_nodes)
    weighted = graph.weight is not None
    return HitsGraph(
        fwd=ops.put_graph(graph, dtype, device=device),
        rev_ptr=torch.from_numpy(rev_ptr).to(device),
        rev_dst=torch.from_numpy(graph.dst[order].astype(np.int32)).to(device),
        rev_w=(torch.from_numpy(graph.weight[order].astype(dtype)).to(device)
               if weighted else None),
        rev_plan=sk.segment_plan(rev_ptr, device=device),
    )


def hits_step(ha: torch.Tensor, hg: HitsGraph, n: int) -> torch.Tensor:
    """One networkx-parity HITS iteration over the ``[2, n]`` carry (row 0
    hubs, row 1 authorities).  Edge weights, where the graph has them,
    scale each edge's contribution in both directions."""
    dg = hg.fwd
    auth = sk.segment_sum_kernel(ha[0], dg.indptr, n, src=dg.src,
                                 edge_weight=dg.edge_weight, plan=dg.segment_plan)
    auth = auth / torch.clamp(torch.max(auth), min=1e-30)
    hub = sk.segment_sum_kernel(auth, hg.rev_ptr, n, src=hg.rev_dst,
                                edge_weight=hg.rev_w, plan=hg.rev_plan)
    hub = hub / torch.clamp(torch.max(hub), min=1e-30)
    return torch.stack([hub, auth])


def make_hits_runner(n: int, cfg: HitsConfig):
    """The HITS fixpoint: ``run(hg, ha0 [2, n]) -> (ha, iters, delta)``,
    converging on the hub vector's L1 delta (networkx's ``err``)."""

    def run(hg: HitsGraph, ha0: torch.Tensor):
        return dflow.iterate(
            lambda ha: hits_step(ha, hg, n), ha0,
            iterations=cfg.iterations, tol=cfg.tol,
            delta_fn=lambda new, old: torch.sum(torch.abs(new[0] - old[0])),
        )

    return run


@dataclasses.dataclass(frozen=True)
class HitsResult:
    hubs: np.ndarray  # f[n], sum-normalized
    authorities: np.ndarray  # f[n], sum-normalized
    iterations: int
    l1_delta: float
    metrics: MetricsRecorder


def run_hits(
    graph: Graph,
    cfg: HitsConfig = HitsConfig(),
    *,
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> HitsResult:
    """Run HITS to convergence, on ``cuda`` unless ``device`` says
    otherwise.  Segments, checkpoints of the ``[2, n]`` carry and resume
    come from the shared fixpoint driver."""
    dev = resolve_device(device)
    metrics = metrics or MetricsRecorder()
    n = graph.n_nodes
    if n == 0:
        z = np.zeros(0, cfg.dtype)
        return HitsResult(z, z, 0, 0.0, metrics)

    ha, done, last_delta = dflow.run_single_chip_fixpoint(
        cfg, metrics, site_prefix="hits",
        init_state=lambda: np.full((2, n), 1.0 / n, cfg.dtype),
        make_runner=lambda seg_cfg: make_hits_runner(n, seg_cfg),
        build_operands=lambda: (put_hits_graph(graph, cfg.dtype, dev),),
        call=lambda runner, ops_t, hd: runner(ops_t[0], hd),
        device=dev, resume=resume,
    )
    hubs, auths = ha[0], ha[1]
    hs, as_ = float(hubs.sum()), float(auths.sum())
    hubs = hubs / hs if hs > 0 else hubs
    auths = auths / as_ if as_ > 0 else auths
    return HitsResult(hubs=hubs, authorities=auths, iterations=done,
                      l1_delta=last_delta, metrics=metrics)
