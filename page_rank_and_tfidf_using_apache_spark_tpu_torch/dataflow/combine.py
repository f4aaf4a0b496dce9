"""``segment_combine`` / ``graph_combine`` / ``broadcast_join``: the
dataflow shuffle and broadcast primitives.

Counterpart of the JAX package's ``dataflow/combine.py``, with its
signatures:

- ``reduceByKey(op)`` → :func:`segment_combine`, a segmented reduction of
  a keyed flat array (``add``, ``min``, ``max``).  ``min`` and ``max`` are
  ``scatter_reduce``: exact and order-free.  ``add`` on floats is the
  segmented-sum kernel (``ops/segment_kernels.py``, ``csrc/segment.cu`` on
  the card) over CSR pointers built from the keys, which adds in an order
  fixed by the shapes; unsorted keys are first sorted stably, so the order
  is the keys' order within a segment.  A float ``index_add_`` or scatter-add
  would change bits from run to run on the card.  Integers add with
  ``scatter_add``, exact in any order.
- the per-iteration SpMV shuffle → :func:`graph_combine`, one dispatch
  into the SpMV impls of ``ops/pagerank.py`` and their static layouts.
- ``broadcast(table)`` + map-side join → :func:`broadcast_join`, a gather.
"""

from __future__ import annotations

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

_OPS = ("add", "min", "max")


def segment_combine(
    values: torch.Tensor,
    keys: torch.Tensor,
    num_segments: int,
    *,
    op: str = "add",
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """``reduceByKey``: combine ``values`` by ``keys`` into
    ``num_segments`` slots.  Empty segments yield 0 for ``add`` and the
    dtype's extreme for ``min``/``max`` (``±inf`` for floats), as
    ``jax.ops.segment_min`` and ``segment_max`` do; values whose key lies
    outside ``[0, num_segments)`` are dropped, as there.
    ``indices_are_sorted`` promises non-decreasing keys (the ``add`` path
    then skips its sort).  float32 ``add`` sums in float64 and rounds once
    a segment."""
    if op not in _OPS:
        raise ValueError(f"unknown combine op {op!r} (want add/min/max)")
    n = num_segments
    if n == 0:
        return values.new_zeros(0)
    inside = (keys >= 0) & (keys < n)
    keys = keys.clamp(0, n - 1).long()
    if op != "add":
        if values.is_floating_point():
            fill = float("inf") if op == "min" else float("-inf")
        else:
            fill = torch.iinfo(values.dtype).max if op == "min" else torch.iinfo(values.dtype).min
        out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
        vals = torch.where(inside, values, torch.full_like(values, fill))
        return out.scatter_reduce_(0, keys, vals, "amin" if op == "min" else "amax")
    vals = torch.where(inside, values, torch.zeros_like(values))
    if not values.is_floating_point():
        return torch.zeros(n, dtype=values.dtype, device=values.device).scatter_add_(0, keys, vals)
    if not indices_are_sorted:
        keys, order = torch.sort(keys, stable=True)
        vals = vals[order]
    ptr = torch.searchsorted(keys, torch.arange(n + 1, device=keys.device), out_int32=True)
    return sk.segment_sum_kernel(vals.contiguous(), ptr, n)


def graph_combine(dg, weighted: torch.Tensor, n: int, impl: str = "segment") -> torch.Tensor:
    """The graph-shuffle form of :func:`segment_combine`:
    ``out[v] = Σ_{(u,v)∈E} w(u,v)·weighted[u]`` through whichever SpMV impl
    (and static layout) the ``ops.pagerank.DeviceGraph`` was built for."""
    # ops.pagerank imports dataflow.fixpoint; resolved here to keep the
    # package import graph acyclic
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops

    return ops.spmv(dg, weighted, n, impl)


def broadcast_join(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Map-side join against a broadcast table: ``out[i] = table[keys[i]]``."""
    return table[keys]
