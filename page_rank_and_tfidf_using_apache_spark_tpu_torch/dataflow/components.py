"""Connected components by min-label propagation.

Counterpart of the JAX package's ``dataflow/components.py``.  The
PageRank SpMV skeleton (gather along edges, combine by destination) with
the combine swapped from ``add`` to ``min``
(``dataflow.segment_combine(op="min")``, an exact, order-free
``scatter_reduce`` over the int32 labels): every node starts labeled with
its own id, each round every node takes the minimum label over itself and
its neighbours along both edge directions (a directed edge list asks an
undirected connectivity question), and the fixpoint is reached when no
label changes.  A converged label is the smallest node id of the node's
weakly connected component.  No kernel of the port runs, as in the JAX
package (XLA ``segment_min``).

Convergence depends on the data (about the component diameter), so the
loop is a tolerance fixpoint: the delta is the COUNT of changed labels and
``tol=0.5`` means "stop when nothing moved".  With ``tol=0`` it runs
exactly ``iterations`` rounds, which the segment driver can checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import combine
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint as dflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import ComponentsConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder


def label_step(labels: torch.Tensor, dg: ops.DeviceGraph, n: int) -> torch.Tensor:
    """One min-propagation round over both edge directions.  Empty
    segments come back as the dtype's max from ``segment_combine``; the
    outer ``minimum`` against the current labels clamps them away."""
    incoming = combine.segment_combine(
        combine.broadcast_join(labels, dg.src), dg.dst, n,
        op="min", indices_are_sorted=True,
    )
    outgoing = combine.segment_combine(
        combine.broadcast_join(labels, dg.dst), dg.src, n,
        op="min", indices_are_sorted=False,
    )
    return torch.minimum(labels, torch.minimum(incoming, outgoing))


def make_components_runner(n: int, cfg: ComponentsConfig):
    """The label-propagation fixpoint: ``run(dg, labels0 [n] int32) ->
    (labels, iters, changed)``, ``changed`` a float32 count."""

    def run(dg: ops.DeviceGraph, labels0: torch.Tensor):
        return dflow.iterate(
            lambda lab: label_step(lab, dg, n), labels0,
            iterations=cfg.iterations, tol=cfg.tol,
            delta_fn=lambda new, old: torch.sum((new != old).to(torch.float32)),
        )

    return run


@dataclasses.dataclass(frozen=True)
class ComponentsResult:
    labels: np.ndarray  # int32 [n]: smallest node id in the component
    n_components: int
    iterations: int
    metrics: MetricsRecorder
    # False when the iteration cap ended the run with labels still
    # changing: the split is then an OVER-segmentation, so callers must not
    # trust n_components without checking this.
    converged: bool = True

    def groups(self) -> list[set[int]]:
        """Components as sets of compacted node indices (the shape of
        networkx.connected_components)."""
        out: dict[int, set[int]] = {}
        for i, lab in enumerate(self.labels):
            out.setdefault(int(lab), set()).add(i)
        return list(out.values())


def run_components(
    graph: Graph,
    cfg: ComponentsConfig = ComponentsConfig(),
    *,
    metrics: MetricsRecorder | None = None,
    resume: bool = False,
    device: str | torch.device | None = None,
) -> ComponentsResult:
    """Weakly connected components of the edge list, to the fixpoint, on
    ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    metrics = metrics or MetricsRecorder()
    n = graph.n_nodes
    if n == 0:
        return ComponentsResult(np.zeros(0, np.int32), 0, 0, metrics)

    labels, done, last_changed = dflow.run_single_chip_fixpoint(
        cfg, metrics, site_prefix="cc",
        init_state=lambda: np.arange(n, dtype=np.int32),
        make_runner=lambda seg_cfg: make_components_runner(n, seg_cfg),
        build_operands=lambda: (ops.put_graph(graph, "float32", device=dev),),
        call=lambda runner, ops_t, ld: runner(ops_t[0], ld),
        device=dev, resume=resume,
    )
    # last_changed is the last round's changed-label COUNT: above tol at
    # the cap means labels were still moving and the grouping
    # over-segments long components
    converged = last_changed <= cfg.tol
    if not converged:
        metrics.record(event="cc_not_converged", iterations=done,
                       still_changing=int(last_changed))
    n_components = int(np.unique(labels).shape[0])
    metrics.scalar("n_components", n_components)
    return ComponentsResult(labels=labels, n_components=n_components,
                            iterations=done, metrics=metrics,
                            converged=converged)
