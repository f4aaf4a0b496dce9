"""Per-stage SpMV timing on the card: which stage of the PageRank step
takes the time.

Counterpart of the JAX package's ``tools/spmv_breakdown.py``: the same 13
stages under the same keys, built from this package's graph and SpMV code
at web-Google scale, and the dominant stage of the deployed prefix-sum
path (gather, cumsum, CSR difference) and of the segment path (gather,
segmented sum).

Usage::

    python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.spmv_breakdown \
        [--nodes N] [--edges E] [--reps R] [--seed S] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import tools
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import Graph, synthetic_powerlaw
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import DanglingMode
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.timing import Stage, run_stages

# Stages of the deployed prefix-sum path, and of the segment path.
CUMSUM_PATH = ("gather_w_src", "cumsum_E", "monotone_diff_N")
SEGMENT_PATH = ("gather_w_src", "segment_sum_E_to_N")


def inputs(n: int, e: int, seed: int = 0, dtype: str = "float32") -> dict[str, np.ndarray]:
    """The stages' random operands, drawn in the JAX tool's order: ``w``
    [N], per-edge values ``pe`` [E], and a prefix-sum-shaped ``ce`` [E+1]."""
    rng = np.random.default_rng(seed)
    return {"w": rng.random(n).astype(dtype), "pe": rng.random(e).astype(dtype),
            "ce": rng.random(e + 1).astype(dtype)}


def stages(graph: Graph, device: torch.device, *, dtype: str = "float32",
           seed: int = 0) -> dict[str, Stage]:
    """The JAX tool's stages (``tools/spmv_breakdown.py:114-162``) on
    ``graph``, with their operands on ``device``."""
    n = graph.n_nodes
    dg = ops.put_graph(graph, dtype, device=device)
    hl = ops.put_graph(graph, dtype, layout="hybrid", keep_edge_arrays=False, device=device)
    sl = ops.put_graph(graph, dtype, layout="sort_shuffle", keep_edge_arrays=False,
                       device=device)
    w, pe, ce = (torch.from_numpy(a).to(device)
                 for a in inputs(n, graph.n_edges, seed, dtype).values())
    src_sorted = torch.from_numpy(np.sort(graph.src)).to(device)
    e = torch.full((n,), 1.0 / n, dtype=w.dtype, device=device)
    h, s = hl.hybrid, sl.shuffle
    st = {
        "gather_w_src": Stage(lambda: w[dg.src], (dg.src,)),
        "gather_w_src_sorted": Stage(lambda: w[src_sorted], (src_sorted,)),
        "cumsum_E": Stage(lambda: torch.cumsum(pe, 0), (pe,)),
        "cumsum_blocked_E": Stage(lambda: ops.cumsum_blocked(pe), (pe,)),
        # the segment impl's own reduction (the segmented-sum kernel, float32
        # summed in float64)
        "segment_sum_E_to_N": Stage(lambda: sk.segment_sum_kernel(pe, dg.indptr, n),
                                    (pe, dg.indptr)),
        # the diff gathers from an (E+1)-long prefix sum, as the real stage does
        "monotone_diff_N": Stage(lambda: ce[dg.indptr[1:]] - ce[dg.indptr[:-1]], (dg.indptr,)),
        "spmv_cumsum": Stage(lambda: ops.spmv_cumsum(dg, w, n), (dg.src, dg.indptr)),
        "spmv_cumsum_mxu": Stage(lambda: ops.spmv_cumsum_mxu(dg, w, n), (dg.src, dg.indptr)),
        "spmv_segment": Stage(lambda: ops.spmv_segment(dg, w, n), (dg.src, dg.indptr)),
    }
    if h.head_ids.shape[0]:
        # as spmv_hybrid does: the sentinel id n reads an appended zero
        st["hybrid_head_rowsum"] = Stage(
            lambda: pk.rowsum_kernel(torch.cat([w, w.new_zeros(1)])[h.head_src]), (h.head_src,))
    st["spmv_hybrid"] = Stage(
        lambda: ops.spmv_hybrid(hl, w, n),
        (h.tail_src, h.tail_indptr, h.head_src, h.head_row_ptr, h.head_ids))
    st["spmv_sort_shuffle"] = Stage(lambda: ops.spmv_sort_shuffle(sl, w, n),
                                    (s.bucket_src, s.bucket_ptr))
    st["full_step_cumsum"] = Stage(
        lambda: ops.pagerank_step(w, dg, e, n=n, damping=0.85,
                                  dangling=DanglingMode.REDISTRIBUTE, total_mass=1.0,
                                  impl="cumsum"),
        (w, dg.inv_outdeg, dg.dangling, e, dg.src, dg.indptr))
    return st


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spmv_breakdown", description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=875_000)
    ap.add_argument("--edges", type=int, default=5_100_000)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    tools.add_common_args(ap)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    started = tools.start(args)
    if started is None:
        return 3
    device, backend, stamp = started
    g = synthetic_powerlaw(args.nodes, args.edges, seed=args.seed)
    print(f"backend={backend} n={g.n_nodes} E={g.n_edges} reps={args.reps}",
          file=sys.stderr, flush=True)
    table = run_stages(stages(g, device), args.reps, device)
    for name, ms in table.items():
        print(f"{name:24s} ms {ms}", file=sys.stderr, flush=True)
    timed = all(v is not None for v in table.values())

    def dominant(path: tuple[str, ...]) -> str | None:
        return max(path, key=table.get) if timed else None

    payload = {
        "n_nodes": g.n_nodes,
        "n_edges": g.n_edges,
        "reps": args.reps,
        "ms_per_op": table,
        "dominant_component": dominant(CUMSUM_PATH),
        "dominant_component_segment_path": dominant(SEGMENT_PATH),
    }
    return tools.emit(args, payload, backend, stamp)


if __name__ == "__main__":
    sys.exit(main())
