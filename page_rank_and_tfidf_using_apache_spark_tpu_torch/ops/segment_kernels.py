"""The sorted segmented sum of the PageRank SpMVs, as a hand-written CUDA kernel.

Counterpart of ``jax.ops.segment_sum(..., indices_are_sorted=True)`` in the
JAX package's ``ops/pagerank.py`` (``:378`` under ``segment`` and
``spark_exact``, ``:508`` in the ``hybrid`` head, ``:537`` under
``sort_shuffle``), which the JAX package leaves to XLA.  Its segments are
given here as CSR pointers over the sorted ids (``ptr[r]`` is the first
value of segment ``r``): ``DeviceGraph.indptr`` for the edges, and the
pointers ``put_graph`` builds over ``head_row_node`` and ``bucket_node``.

On the card it is ``csrc/segment.cu``, built for ``sm_90a`` on first use
(``ops/_build.py``): a merge-path split over rows and values, so a hub's
segment spans many tiles, with every partial sum added in an order fixed
by the shapes, in one launch a call.  A float32 call may ask for its rows
in float64 (``out_dtype``): the kernel's float64 row sums, not rounded,
for a caller that adds rows summed on several slots and rounds once.  Two
calls give the same bits, which the float64 ``index_add_`` of
:func:`segment_sum_plain` does not promise on CUDA.  The split is a
:class:`SegmentPlan`, built once per pointer array (``put_graph`` builds
one for each of its three; a pointer tensor on the card is planned there,
by ``csrc/put.cu``) and passed to every call.  On the CPU the wrapper runs
:func:`segment_sum_plain` and ignores the plan.

``LAUNCHES`` counts kernel launches, so a run can show that it went
through the kernel.  Under the static analyzer's trace (fake tensors on a
CUDA device) the wrapper is one ``graft_torch::segment`` op instead
(``ops/traced.py``), wherever it would launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build, put_kernels, traced
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pallas_kernels import _check, _raise_on
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import timed_span

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES: dict[str, int] = {"segment": 0}

# The kernel indexes values and rows with 32-bit ints.
_INT_LIMIT = 2 ** 31 - 1

# Merge-path items (row ends and values) a tile of csrc/segment.cu takes, as
# its segment_block_items() reports; and its scratch: a 16-byte call state,
# then one 16-byte carry slot a tile (segment_scratch_len()).
BLOCK_ITEMS = 2048
_STATE_BYTES, _SLOT_BYTES = 16, 16

# Plans built per pointer array since the last reset_launches().
PLANS_BUILT: dict[str, int] = {"segment": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, PLANS_BUILT):
        for k in counts:
            counts[k] = 0


class SegmentPlan(NamedTuple):
    """The kernel's partition of one CSR pointer array, built once per graph
    by :func:`segment_plan`, with the scratch of every call.

    ``coords[b]`` is the merge-path coordinate of tile ``b``'s first item
    ``d = b·BLOCK_ITEMS``: the number of row ends among the first ``d``
    items (its values start at ``d - coords[b]``).  ``state`` is the
    kernel's call state and one carry slot a tile, zeroed once: each call
    flags its slots with a new epoch, so a call clears nothing.  A plan
    serves one stream at a time: calls on it must follow each other on one
    stream."""

    n: int  # rows
    e: int  # values
    coords: torch.Tensor  # int32 [tiles + 1]
    state: torch.Tensor  # uint8 [16 + 16·tiles], zeroed once


def segment_tiles(n: int, e: int, block_items: int = BLOCK_ITEMS) -> int:
    """Tiles of ``block_items`` merge-path items over ``n`` rows and ``e``
    values; 0 where the kernel launches nothing."""
    return -(-(n + e) // block_items) if n > 0 and e > 0 else 0


def segment_coords(ptr, block_items: int = BLOCK_ITEMS) -> np.ndarray:
    """int64 ``[tiles + 1]`` merge-path coordinates of the CSR pointers
    ``ptr``: entry ``b`` counts the row ends among the first ``d =
    min(b·block_items, n + E)`` items.  Row ``p``'s end comes before item
    ``d`` iff ``ptr[p+1] + p + 1 <= d``, and those keys rise strictly, so
    one ``searchsorted`` finds every tile's coordinate."""
    ptr = np.asarray(ptr, np.int64)
    n, e = ptr.shape[0] - 1, int(ptr[-1])
    d = np.minimum(np.arange(segment_tiles(n, e, block_items) + 1, dtype=np.int64) * block_items,
                   n + e)
    return np.searchsorted(ptr[1:] + np.arange(1, n + 1), d, side="right")


def segment_plan(ptr, *, device: str | torch.device | None = None, e: int | None = None,
                 stats: dict | None = None) -> SegmentPlan:
    """The :class:`SegmentPlan` of the CSR pointers ``ptr`` (a numpy array
    or an int32 tensor), on ``device`` (default: the tensor's, else the
    CPU).  A tensor on the card is planned there, by
    ``put_kernels.segment_coords_kernel`` on the current stream, to the numbers
    of :func:`segment_coords`; ``e`` is ``ptr[-1]``, which such a tensor
    reads back when it is not given.  Anything else is planned on the host
    and copied to ``device``.  The build, its copies included, is an
    ``ops.segment_plan`` span; with ``stats`` its seconds are added to
    ``stats["plan_secs"]``.  On the card the span ends once the kernel is
    enqueued: it times the host's part, and the kernel's device time falls
    after it on the stream."""
    on_card = (isinstance(ptr, torch.Tensor) and ptr.device.type == "cuda"
               and (device is None or torch.device(device) == ptr.device))
    if device is None:
        device = ptr.device if isinstance(ptr, torch.Tensor) else "cpu"
    with timed_span("ops.segment_plan", stats, "plan_secs"):
        if on_card:
            n = ptr.shape[0] - 1
            e = int(ptr[-1]) if e is None else e
            coords = put_kernels.segment_coords_kernel(ptr, e, segment_tiles(n, e), BLOCK_ITEMS)
        else:
            host = ptr.cpu().numpy() if isinstance(ptr, torch.Tensor) else np.asarray(ptr)
            n, e = host.shape[0] - 1, int(host[-1])
            coords = torch.from_numpy(segment_coords(host).astype(np.int32)).to(device)
        PLANS_BUILT["segment"] += 1
        return SegmentPlan(
            n=n, e=e, coords=coords,
            state=torch.zeros(_STATE_BYTES + _SLOT_BYTES * segment_tiles(n, e),
                              dtype=torch.uint8, device=device))


def _check_index(t, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"segment_sum {name} takes a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"segment_sum {name} takes int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"segment_sum {name} takes a contiguous 1-D tensor")


def _check_segment(values, ptr, n: int, src, edge_weight, plan) -> int:
    """Raises on anything the kernel does not take; returns E, the number of
    values summed."""
    _check(values, 1, "segment_sum values")
    _check_index(ptr, "ptr")
    if ptr.shape[0] != n + 1:
        raise ValueError(f"segment_sum ptr has {ptr.shape[0]} entries, wanted n+1 = {n + 1}")
    tensors = [values, ptr]
    e = values.shape[0]
    if src is not None:
        _check_index(src, "src")
        e = src.shape[0]
        tensors.append(src)
    if edge_weight is not None:
        if src is None:
            raise ValueError("segment_sum takes edge_weight only with src")
        _check(edge_weight, 1, "segment_sum edge_weight")
        if edge_weight.dtype != values.dtype:
            raise TypeError(f"segment_sum edge_weight is {edge_weight.dtype}, "
                            f"values are {values.dtype}")
        if edge_weight.shape[0] != e:
            raise ValueError(f"segment_sum edge_weight has {edge_weight.shape[0]} entries, "
                             f"src has {e}")
        tensors.append(edge_weight)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("segment_sum takes all its tensors on one device")
    if e > _INT_LIMIT or n >= _INT_LIMIT:
        raise ValueError(f"segment_sum takes fewer than 2^31 values and rows, got E={e}, n={n}")
    if plan is not None:
        if not isinstance(plan, SegmentPlan):
            raise TypeError(f"segment_sum plan takes a SegmentPlan, got {type(plan).__name__}")
        if (plan.n, plan.e) != (n, e):
            raise ValueError(f"segment_sum plan is for n={plan.n}, E={plan.e}, "
                             f"the call has n={n}, E={e}")
        if plan.coords.device != values.device or plan.state.device != values.device:
            raise ValueError("segment_sum takes its plan on the values' device")
    return e


def _out_dtype(values: torch.Tensor, out_dtype: torch.dtype | None) -> torch.dtype:
    """The rows' dtype: the values', or float64 where float32 values ask
    for it."""
    if out_dtype is None or out_dtype == values.dtype:
        return values.dtype
    if values.dtype == torch.float32 and out_dtype == torch.float64:
        return out_dtype
    raise TypeError(f"segment_sum widens only float32 to float64, got {values.dtype} "
                    f"to {out_dtype}")


def segment_sum_plain(
    values: torch.Tensor,
    ptr: torch.Tensor,
    n: int,
    *,
    src: torch.Tensor | None = None,
    edge_weight: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """:func:`segment_sum_kernel` in plain PyTorch: the per-value segment
    ids from ``ptr``, then one ``index_add_``, accumulated in float64 and
    rounded to ``out_dtype`` (default: the values' dtype) once.  The
    product with ``edge_weight`` is taken in the values' dtype first.
    ``index_add_`` adds one value at a time into its segment, and a
    power-law hub's segment holds a large share of all edges at web-Google
    scale: a float32 running sum over it loses the accuracy the segment impl
    is held to (L1 1e-3 from a float64 run over 20 iterations), which
    float64 accumulation keeps."""
    per = values if src is None else values[src]
    if edge_weight is not None:
        per = per * edge_weight
    ids = torch.repeat_interleave(torch.arange(n, device=per.device), ptr.diff(),
                                  output_size=per.shape[0])
    acc = torch.float64 if per.dtype == torch.float32 else per.dtype
    out = torch.zeros(n, dtype=acc, device=per.device)
    return out.index_add_(0, ids, per.to(acc)).to(_out_dtype(per, out_dtype))


def segment_sum_kernel(
    values: torch.Tensor,
    ptr: torch.Tensor,
    n: int,
    *,
    src: torch.Tensor | None = None,
    edge_weight: torch.Tensor | None = None,
    plan: SegmentPlan | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``out[r] = Σ_{e in [ptr[r], ptr[r+1])} v[e]`` for ``r < n``, with
    ``v = values`` or, given ``src``, ``v[e] = values[src[e]] (·
    edge_weight[e])``, the product taken in ``values``' type.  float32 sums
    in float64 and rounds once a row, or, given ``out_dtype=torch.float64``,
    returns the float64 row sums as they are; float64 stays float64.
    ``csrc/segment.cu`` on CUDA (one kernel a call, given ``ptr``'s plan),
    and :func:`segment_sum_plain` on the CPU.  With no values it returns
    zeros.

    Args:
      values: f[E] values, or f[N] per-node values gathered through ``src``;
        float32 or float64, contiguous.
      ptr: int32 [n+1] CSR pointers over the E values: ``ptr[0] = 0``,
        nondecreasing, ``ptr[n] = E``.  The kernel does not check them.
      n: number of segments.
      src: optional int32 [E] indices into ``values``, each in range (not
        checked on the card).
      edge_weight: optional f[E] of ``values``' type, only with ``src``.
      plan: ``ptr``'s :class:`SegmentPlan` on the values' device.  A call
        without one on the card builds one there, which allocates: it
        stays right and costs more.  The CPU ignores it.
      out_dtype: the rows' dtype: the values' (default), or float64 for
        float32 values.
    """
    e = _check_segment(values, ptr, n, src, edge_weight, plan)
    out_dtype = _out_dtype(values, out_dtype)
    if values.device.type == "cpu":
        return segment_sum_plain(values, ptr, n, src=src, edge_weight=edge_weight,
                                 out_dtype=out_dtype)
    if traced.is_fake(values):
        if not (n and e):
            return values.new_zeros(n, dtype=out_dtype)
        return _segment_op()(values, ptr, n, src, edge_weight, out_dtype)
    out = torch.empty(n, dtype=out_dtype, device=values.device)
    lib = _build.library("segment")  # it returns at once for n = 0, zeros out for E = 0
    if plan is None:
        plan = segment_plan(ptr, e=e)
    types = {(torch.float32, torch.float32): "f32", (torch.float64, torch.float64): "f64",
             (torch.float32, torch.float64): "f32_f64"}[values.dtype, out_dtype]
    coords, state = plan.coords.data_ptr(), plan.state.data_ptr()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        if src is None:
            launch = getattr(lib, f"segment_values_{types}")
            rc = launch(values.data_ptr(), ptr.data_ptr(), coords, out.data_ptr(), state,
                        plan.state.numel(), n, e, stream)
        else:
            launch = getattr(lib, f"segment_gather_{types}")
            ew = None if edge_weight is None else edge_weight.data_ptr()
            rc = launch(src.data_ptr(), values.data_ptr(), ew, ptr.data_ptr(), coords,
                        out.data_ptr(), state, plan.state.numel(), n, e, stream)
    _raise_on(rc, lib, "segment_error_string", "segment")
    if n and e:
        LAUNCHES["segment"] += 1
    return out


def _segment_impl(values, ptr, n, src, edge_weight, out_dtype=None):
    return segment_sum_kernel(values, ptr, n, src=src, edge_weight=edge_weight,
                              out_dtype=out_dtype)


def _segment_fake(values, ptr, n, src, edge_weight, out_dtype=None):
    return values.new_empty(n, dtype=out_dtype)


def _segment_op():
    return traced.kernel_op(
        "segment", "(Tensor values, Tensor ptr, int n, Tensor? src, Tensor? edge_weight, "
                   "ScalarType? out_dtype=None) -> Tensor",
        _segment_impl, _segment_fake)
