"""Hand-written CUDA kernels of the PageRank SpMV, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  Its TPU kernels
are CUDA C++ here, built for ``sm_90a`` on first use (``ops/_build.py``):

- :func:`spmv_pallas` replaces ``spmv_pallas``, the SpMV under
  ``spmv_impl='pallas'``: gather, prefix sum and CSR-row difference fused
  into one kernel a call (``csrc/spmv.cu``), reading the int32 ``src`` and
  ``indptr`` as they are, with each tile's CSR pointers and the call's
  scratch from a :class:`SpmvPlan` built once per graph.
- :func:`cumsum_kernel` replaces ``cumsum_pallas``: the same single-pass,
  deterministic scan on its own (``csrc/cumsum.cu``; both share
  ``csrc/scan.cuh``).  On the main path its scan runs inside the fused
  kernel, so the main path launches it no more.
- :func:`rowsum_kernel` replaces ``rowsum_pallas``: the row sums of the
  ``spmv_impl='hybrid'`` dense head (``csrc/rowsum.cu``): one pass of
  16-byte loads on a grid of one wave.

Each wrapper checks its input, takes a CPU tensor to the plain PyTorch
version beside it (``spmv_pallas_plain``, ``cumsum_plain``,
``rowsum_plain``), and launches the kernel on a CUDA tensor or raises: there
is no fallback on the card.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that it went through the kernels.  Under the
static analyzer's trace (fake tensors on a CUDA device) each wrapper is one
op of the ``graft_torch`` namespace instead (``ops/traced.py``), named by
its ``LAUNCHES`` key, wherever it would launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build, traced
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import timed_span

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES: dict[str, int] = {"cumsum": 0, "rowsum": 0, "spmv": 0}


# Plans built since the last reset_launches().
PLANS_BUILT: dict[str, int] = {"spmv": 0}

# Edges per tile of csrc/spmv.cu, as its spmv_tile_len() reports; and its
# scratch: a 16-byte call state, then three 16-byte descriptors a tile
# (spmv_scratch_len()).
TILE = 4096
_STATE_BYTES, _SLOTS_BYTES = 16, 48


def reset_launches() -> None:
    for counts in (LAUNCHES, PLANS_BUILT):
        for k in counts:
            counts[k] = 0


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
    if traced.is_fake(x):
        return _op("cumsum")(x)
    lib = _build.library("cumsum")
    out = torch.empty_like(x)
    scratch = torch.empty(lib.cumsum_scratch_len(n), dtype=torch.uint8, device=x.device)
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
    """Row sums ``[R, W] -> [R]`` of a contiguous float32/float64 matrix of
    any shape: ``csrc/rowsum.cu`` on CUDA, :func:`rowsum_plain` on the CPU.
    The kernel adds each row in an order fixed by W alone (16-byte loads
    where W is a multiple of 4 on a 16-byte aligned base, a scalar loop
    otherwise), so two calls give the same bits."""
    _check(rows, 2, "rowsum")
    if rows.device.type == "cpu":
        return rowsum_plain(rows)
    r, w = rows.shape
    if r and traced.is_fake(rows):
        return _op("rowsum")(rows)
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


class SpmvPlan(NamedTuple):
    """The fused SpMV's partition of one CSR pointer array, built once per
    graph by :func:`spmv_plan`, with the scratch of every call.

    Tile ``t`` takes edges ``[t·TILE, (t+1)·TILE)`` and the CSR pointers
    ``[rows[t], rows[t+1])``: those with ``indptr[i]`` in ``(t·TILE,
    (t+1)·TILE]`` (tile 0 also those equal to 0; the last tile's end is E).
    ``state`` holds the kernel's call state and its descriptors, zeroed
    once: each call flags them with a new epoch, so a call clears nothing.
    A plan serves one stream at a time: calls on it must follow each other
    on one stream."""

    n: int  # rows
    e: int  # edges
    rows: torch.Tensor  # int32 [tiles + 1]
    state: torch.Tensor  # uint8 [16 + 48·tiles], zeroed once


def spmv_rows(indptr, tile: int = TILE) -> np.ndarray:
    """int64 ``[tiles + 1]`` first CSR pointer of each tile of ``tile``
    edges, and ``n + 1`` last: ``np.searchsorted(indptr, t·tile, 'right')``
    for the tiles after the first."""
    indptr = np.asarray(indptr, np.int64)
    n, e = indptr.shape[0] - 1, int(indptr[-1])
    tiles = -(-e // tile)
    rows = np.zeros(tiles + 1, np.int64)
    if tiles:
        rows[1:tiles] = np.searchsorted(indptr, np.arange(1, tiles, dtype=np.int64) * tile,
                                        side="right")
        rows[tiles] = n + 1
    return rows


def spmv_plan(indptr, *, device: str | torch.device | None = None, e: int | None = None,
              stats: dict | None = None) -> SpmvPlan:
    """The :class:`SpmvPlan` of the CSR pointers ``indptr`` (a numpy array
    or an int32 tensor), on ``device`` (default: the tensor's, else the
    CPU).  A tensor on the card is planned there, by
    ``put_kernels.spmv_rows_kernel`` on the current stream, to the numbers of
    :func:`spmv_rows`; ``e`` is ``indptr[-1]``, which such a tensor reads
    back when it is not given.  Anything else is planned on the host and
    copied to ``device``.  The build, its copies included, is an
    ``ops.spmv_plan`` span; with ``stats`` its seconds are added to
    ``stats["plan_secs"]``.  On the card the span ends once the kernel is
    enqueued: it times the host's part, and the kernel's device time falls
    after it on the stream."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import put_kernels

    on_card = (isinstance(indptr, torch.Tensor) and indptr.device.type == "cuda"
               and (device is None or torch.device(device) == indptr.device))
    if device is None:
        device = indptr.device if isinstance(indptr, torch.Tensor) else "cpu"
    with timed_span("ops.spmv_plan", stats, "plan_secs"):
        if on_card:
            n = indptr.shape[0] - 1
            e = int(indptr[-1]) if e is None else e
            rows = put_kernels.spmv_rows_kernel(indptr, e, TILE)
        else:
            host = indptr.cpu().numpy() if isinstance(indptr, torch.Tensor) else np.asarray(indptr)
            n, e = host.shape[0] - 1, int(host[-1])
            rows = torch.from_numpy(spmv_rows(host).astype(np.int32)).to(device)
        PLANS_BUILT["spmv"] += 1
        return SpmvPlan(
            n=n, e=e, rows=rows,
            state=torch.zeros(_STATE_BYTES + _SLOTS_BYTES * (rows.shape[0] - 1),
                              dtype=torch.uint8, device=device))


def _check_spmv(src, indptr, w, n: int, edge_weight, plan) -> None:
    for name, idx in (("src", src), ("indptr", indptr)):
        if not isinstance(idx, torch.Tensor):
            raise TypeError(f"spmv_pallas {name} takes a torch.Tensor, got {type(idx).__name__}")
        if idx.dtype != torch.int32:
            raise TypeError(f"spmv_pallas {name} takes int32, got {idx.dtype}")
        if idx.dim() != 1 or not idx.is_contiguous():
            raise ValueError(f"spmv_pallas {name} takes a contiguous 1-D tensor")
    if indptr.shape[0] != n + 1:
        raise ValueError(f"spmv_pallas indptr has {indptr.shape[0]} entries, wanted n+1 = {n + 1}")
    _check(w, 1, "spmv_pallas w")
    if w.shape[0] != n:
        raise ValueError(f"spmv_pallas w has {w.shape[0]} entries, wanted n = {n}")
    tensors = [src, indptr, w]
    if edge_weight is not None:
        _check(edge_weight, 1, "spmv_pallas edge_weight")
        if edge_weight.dtype != w.dtype:
            raise TypeError(f"spmv_pallas edge_weight is {edge_weight.dtype}, w is {w.dtype}")
        if edge_weight.shape[0] != src.shape[0]:
            raise ValueError(f"spmv_pallas edge_weight has {edge_weight.shape[0]} entries, "
                             f"src has {src.shape[0]}")
        tensors.append(edge_weight)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("spmv_pallas takes all its tensors on one device")
    if plan is not None:
        if not isinstance(plan, SpmvPlan):
            raise TypeError(f"spmv_pallas plan takes a SpmvPlan, got {type(plan).__name__}")
        if (plan.n, plan.e) != (n, src.shape[0]):
            raise ValueError(f"spmv_pallas plan is for n={plan.n}, E={plan.e}, the call has "
                             f"n={n}, E={src.shape[0]}")
        if plan.rows.device != w.device or plan.state.device != w.device:
            raise ValueError("spmv_pallas takes its plan on w's device")


def spmv_pallas_plain(
    src: torch.Tensor,
    indptr: torch.Tensor,
    w: torch.Tensor,
    *,
    n: int,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`spmv_pallas` in plain PyTorch: the gather, ``torch.cumsum``
    and the CSR-row difference (``cumsum_diff_spmv``)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pagerank import (
        cumsum_diff_spmv,
    )

    if src.shape[0] == 0:
        return torch.zeros(n, dtype=w.dtype, device=w.device)
    per_edge = w[src]
    if edge_weight is not None:  # weighted PageRank: w(u,v)·rank[u]/s[u]
        per_edge = per_edge * edge_weight
    return cumsum_diff_spmv(per_edge, indptr, cumsum_plain)


def spmv_pallas(
    src: torch.Tensor,
    indptr: torch.Tensor,
    w: torch.Tensor,
    *,
    n: int,
    edge_weight: torch.Tensor | None = None,
    plan: SpmvPlan | None = None,
) -> torch.Tensor:
    """``contribs[v] = Σ_{e: dst-sorted, dst[e]=v} w[src[e]] (· edge_weight[e])``:
    ``csrc/spmv.cu`` on CUDA (one kernel a call, given ``indptr``'s plan),
    and :func:`spmv_pallas_plain` on the CPU.  With no edges it returns
    zeros.

    Args:
      src: int32 [E] edge sources in dst-sorted order.
      indptr: int32 [N+1] CSR row pointers into the dst-sorted edge list.
      w: f[N] per-node values (already divided by out-degree), float32 or
        float64.
      n: number of nodes.
      edge_weight: optional f[E] of ``w``'s type.
      plan: ``indptr``'s :class:`SpmvPlan` on ``w``'s device.  A call
        without one on the card builds one there, which allocates: it
        stays right and costs more.  The CPU ignores it.
    """
    _check_spmv(src, indptr, w, n, edge_weight, plan)
    if w.device.type == "cpu":
        return spmv_pallas_plain(src, indptr, w, n=n, edge_weight=edge_weight)
    e = src.shape[0]
    if e == 0 or n == 0:
        return torch.zeros(n, dtype=w.dtype, device=w.device)
    if traced.is_fake(w):
        return _op("spmv")(src, indptr, w, n, edge_weight)
    lib = _build.library("spmv")
    if plan is None:
        plan = spmv_plan(indptr, e=e)
    out = torch.empty(n, dtype=w.dtype, device=w.device)
    launch = lib.spmv_f32 if w.dtype == torch.float32 else lib.spmv_f64
    ew = None if edge_weight is None else edge_weight.data_ptr()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(src.data_ptr(), indptr.data_ptr(), plan.rows.data_ptr(), w.data_ptr(), ew,
                    out.data_ptr(), plan.state.data_ptr(), plan.state.numel(), e, n, stream)
    _raise_on(rc, lib, "spmv_error_string", "spmv")
    LAUNCHES["spmv"] += 1
    return out


# The kernels' ops for the analyzer's trace: name -> (schema, impl, fake).
_OPS = {
    "cumsum": ("(Tensor x) -> Tensor",
               lambda x: cumsum_kernel(x) if x.numel() else x.clone(),
               torch.empty_like),
    "rowsum": ("(Tensor rows) -> Tensor",
               rowsum_kernel,
               lambda rows: rows.new_empty(rows.shape[0])),
    "spmv": ("(Tensor src, Tensor indptr, Tensor w, int n, Tensor? edge_weight) -> Tensor",
             lambda src, indptr, w, n, edge_weight: spmv_pallas(src, indptr, w, n=n,
                                                                edge_weight=edge_weight),
             lambda src, indptr, w, n, edge_weight: w.new_empty(n)),
}


def _op(name: str):
    return traced.kernel_op(name, *_OPS[name])
