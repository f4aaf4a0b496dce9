"""Hand-written CUDA kernels of the PageRank SpMV, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  Its two TPU
kernels are CUDA C++ here (``csrc/cumsum.cu``, ``csrc/rowsum.cu``), built
for ``sm_90a`` on first use (``ops/_build.py``):

- :func:`cumsum_kernel` replaces ``cumsum_pallas``: the inclusive prefix
  sum under ``spmv_impl='pallas'``; :func:`spmv_pallas` composes it with
  the gather and the CSR difference, which stay plain PyTorch as the JAX
  package leaves them to XLA.
- :func:`rowsum_kernel` replaces ``rowsum_pallas``: the row sums of the
  ``spmv_impl='hybrid'`` dense head.

Each wrapper checks its input, takes a CPU tensor to the plain PyTorch
version beside it (``cumsum_plain``, ``rowsum_plain``), and launches the
kernel on a CUDA tensor or raises: there is no fallback on the card.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES: dict[str, int] = {"cumsum": 0, "rowsum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_FLOATS = (torch.float32, torch.float64)


def _check(x: torch.Tensor, ndim: int, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"{what} takes float32 or float64, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what} takes a {ndim}-D tensor, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")


def _raise_on(rc: int, lib, error_string: str, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum, plain PyTorch."""
    return torch.cumsum(x, dim=0)


def cumsum_kernel(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D prefix sum of a contiguous float32/float64 tensor:
    ``csrc/cumsum.cu`` on CUDA, :func:`cumsum_plain` on the CPU.  An empty
    input is returned as is."""
    _check(x, 1, "cumsum")
    if x.device.type == "cpu":
        return cumsum_plain(x)
    n = x.shape[0]
    if n == 0:
        return x
    lib = _build.library("cumsum")
    out = torch.empty_like(x)
    scratch = torch.empty(lib.cumsum_scratch_len(n), dtype=x.dtype, device=x.device)
    launch = lib.cumsum_f32 if x.dtype == torch.float32 else lib.cumsum_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, stream)
    _raise_on(rc, lib, "cumsum_error_string", "cumsum")
    LAUNCHES["cumsum"] += 1
    return out


def rowsum_plain(rows: torch.Tensor) -> torch.Tensor:
    """Row sums ``[R, W] -> [R]``, plain PyTorch."""
    return rows.sum(dim=1)


def rowsum_kernel(rows: torch.Tensor) -> torch.Tensor:
    """Row sums ``[R, W] -> [R]`` of a contiguous float32/float64 matrix:
    ``csrc/rowsum.cu`` on CUDA, :func:`rowsum_plain` on the CPU."""
    _check(rows, 2, "rowsum")
    if rows.device.type == "cpu":
        return rowsum_plain(rows)
    r, w = rows.shape
    out = torch.empty(r, dtype=rows.dtype, device=rows.device)
    if r == 0:
        return out
    lib = _build.library("rowsum")
    launch = lib.rowsum_f32 if rows.dtype == torch.float32 else lib.rowsum_f64
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(rows.data_ptr(), out.data_ptr(), r, w, stream)
    _raise_on(rc, lib, "rowsum_error_string", "rowsum")
    LAUNCHES["rowsum"] += 1
    return out


def spmv_pallas(
    src: torch.Tensor,
    indptr: torch.Tensor,
    w: torch.Tensor,
    *,
    n: int,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """``contribs[v] = Σ_{e: dst-sorted, dst[e]=v} w[src[e]] (· edge_weight[e])``
    with the prefix sum in :func:`cumsum_kernel` (gather and CSR-row
    difference in PyTorch).

    Args:
      src: int32 [E] edge sources in dst-sorted order.
      indptr: int32 [N+1] CSR row pointers into the dst-sorted edge list.
      w: f[N] per-node values (already divided by out-degree).
      n: number of nodes.
    """
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pagerank import (
        cumsum_diff_spmv,
    )

    if src.shape[0] == 0:
        return torch.zeros(n, dtype=w.dtype, device=w.device)
    per_edge = w[src]
    if edge_weight is not None:  # weighted PageRank: w(u,v)·rank[u]/s[u]
        per_edge = per_edge * edge_weight
    return cumsum_diff_spmv(per_edge, indptr, cumsum_kernel)
