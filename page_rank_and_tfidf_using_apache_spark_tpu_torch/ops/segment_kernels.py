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
segment spans many blocks, with every partial sum added in an order fixed
by the shapes.  Two calls give the same bits, which the float64
``index_add_`` of :func:`segment_sum_plain` does not promise on CUDA.  On
the CPU the wrapper runs :func:`segment_sum_plain`.

``LAUNCHES`` counts kernel launches, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pallas_kernels import _check, _raise_on

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES: dict[str, int] = {"segment": 0}

# The kernel indexes values and rows with 32-bit ints.
_INT_LIMIT = 2 ** 31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_index(t, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"segment_sum {name} takes a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"segment_sum {name} takes int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"segment_sum {name} takes a contiguous 1-D tensor")


def _check_segment(values, ptr, n: int, src, edge_weight) -> int:
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
    return e


def segment_sum_plain(
    values: torch.Tensor,
    ptr: torch.Tensor,
    n: int,
    *,
    src: torch.Tensor | None = None,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`segment_sum_kernel` in plain PyTorch: the per-value segment
    ids from ``ptr``, then one ``index_add_``, accumulated in float64.
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
    return out.index_add_(0, ids, per.to(acc)).to(per.dtype)


def segment_sum_kernel(
    values: torch.Tensor,
    ptr: torch.Tensor,
    n: int,
    *,
    src: torch.Tensor | None = None,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """``out[r] = Σ_{e in [ptr[r], ptr[r+1])} v[e]`` for ``r < n``, with
    ``v = values`` or, given ``src``, ``v[e] = values[src[e]] (·
    edge_weight[e])``, the product taken in ``values``' type.  float32 sums
    in float64 and rounds once a row; float64 stays float64.
    ``csrc/segment.cu`` on CUDA (two kernels a call), and
    :func:`segment_sum_plain` on the CPU.  With no values it returns zeros.

    Args:
      values: f[E] values, or f[N] per-node values gathered through ``src``;
        float32 or float64, contiguous.
      ptr: int32 [n+1] CSR pointers over the E values: ``ptr[0] = 0``,
        nondecreasing, ``ptr[n] = E``.  The kernel does not check them.
      n: number of segments.
      src: optional int32 [E] indices into ``values``, each in range (not
        checked on the card).
      edge_weight: optional f[E] of ``values``' type, only with ``src``.
    """
    e = _check_segment(values, ptr, n, src, edge_weight)
    if values.device.type == "cpu":
        return segment_sum_plain(values, ptr, n, src=src, edge_weight=edge_weight)
    out = torch.empty(n, dtype=values.dtype, device=values.device)
    lib = _build.library("segment")  # it returns at once for n = 0, zeros out for E = 0
    scratch = torch.empty(lib.segment_scratch_len(n, e), dtype=torch.uint8,
                          device=values.device)
    f32 = values.dtype == torch.float32
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        if src is None:
            launch = lib.segment_values_f32 if f32 else lib.segment_values_f64
            rc = launch(values.data_ptr(), ptr.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                        n, e, stream)
        else:
            launch = lib.segment_gather_f32 if f32 else lib.segment_gather_f64
            ew = None if edge_weight is None else edge_weight.data_ptr()
            rc = launch(src.data_ptr(), values.data_ptr(), ew, ptr.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), n, e, stream)
    _raise_on(rc, lib, "segment_error_string", "segment")
    if n and e:
        LAUNCHES["segment"] += 1
    return out
