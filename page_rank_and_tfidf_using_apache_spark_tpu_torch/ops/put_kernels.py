"""A graph's derived device fields and kernel plans, built on the card.

``ops/pagerank.put_graph`` on a CUDA device copies only the arrays the host
graph holds: the edge sources, the cached int64 CSR pointers and the node
normaliser (the int32 out-degree, or the cached float64 out-strength of a
weighted graph).  The put narrows the pointers to int32 with PyTorch's cast
(``.to(torch.int32)``), and every other field of the ``DeviceGraph`` is
derived from those here, on the card, by ``csrc/put.cu`` (built on first
use, ``ops/_build.py``):

- :func:`spmv_rows_kernel`: the fused SpMV's plan,
  ``pallas_kernels.spmv_rows``;
- :func:`expand_dst_kernel`: every edge's destination, ``r`` for the
  edges in ``[ptr[r], ptr[r+1])``;
- :func:`segment_coords_kernel`: the segmented sum's plan,
  ``segment_kernels.segment_coords``;
- :func:`node_vectors_kernel`: ``inv_outdeg``, ``dangling`` and
  ``has_outlinks``, as ``Graph.inv_out_strength`` and the masks of
  ``out_degree`` give them.

Each gives the numpy builders' numbers bit for bit, and has a plain PyTorch
version beside it (``*_plain``), which the wrapper runs for a CPU tensor;
on a CUDA tensor the wrapper launches the kernel on the current stream,
with no host sync, or raises.  ``LAUNCHES`` counts the launches.  The JAX
package has no such kernel: it builds these on the host, as this
package's put still does on the CPU.
"""

from __future__ import annotations

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pallas_kernels import _raise_on

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES: dict[str, int] = {"spmv_rows": 0, "expand_dst": 0, "segment_coords": 0,
                            "node_vectors": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The kernels index pointers and edges with 32-bit ints, as segment.cu does.
_INT_LIMIT = 2 ** 31 - 1


def _check_sizes(ptr: torch.Tensor, e: int, what: str) -> None:
    if e >= _INT_LIMIT or ptr.shape[0] > _INT_LIMIT:
        raise ValueError(f"{what} takes fewer than 2^31 - 1 edges and rows, got E={e}, "
                         f"n={ptr.shape[0] - 1}")


def _check(t, dtypes: tuple, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} takes a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} takes {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 1-D tensor")


def _launch(entry: str, *args) -> None:
    """Calls ``entry`` of ``csrc/put.cu`` with ``args`` and the current
    stream of the first tensor's device; raises on a launch error."""
    lib = _build.library("put")
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                   for a in args), stream)
    _raise_on(rc, lib, "put_error_string", entry)


def spmv_rows_plain(ptr: torch.Tensor, e: int, tile: int) -> torch.Tensor:
    n = ptr.shape[0] - 1
    tiles = -(-e // tile)
    rows = torch.zeros(tiles + 1, dtype=torch.int64, device=ptr.device)
    if tiles:
        starts = torch.arange(1, tiles, dtype=torch.int64, device=ptr.device) * tile
        rows[1:tiles] = torch.searchsorted(ptr.to(torch.int64), starts, right=True)
        rows[tiles] = n + 1
    return rows.to(torch.int32)


def spmv_rows_kernel(ptr: torch.Tensor, e: int, tile: int) -> torch.Tensor:
    """int32 ``[tiles + 1]``, ``tiles = ceil(e / tile)``: the number of
    the int32 CSR pointers ``ptr`` (over ``e`` edges) at most ``t·tile``
    for ``0 < t < tiles``, 0 first and ``n + 1`` last where there are
    tiles (``pallas_kernels.spmv_rows``)."""
    _check(ptr, (torch.int32,), "spmv_rows")
    _check_sizes(ptr, e, "spmv_rows")
    if ptr.device.type == "cpu":
        return spmv_rows_plain(ptr, e, tile)
    tiles = -(-e // tile)
    rows = torch.empty(tiles + 1, dtype=torch.int32, device=ptr.device)
    _launch("put_spmv_rows", ptr, rows, ptr.shape[0] - 1, tiles, tile)
    LAUNCHES["spmv_rows"] += 1
    return rows


def expand_dst_plain(ptr: torch.Tensor, e: int) -> torch.Tensor:
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=ptr.device),
                                   ptr.diff(), output_size=e)


def expand_dst_kernel(ptr: torch.Tensor, e: int, rows: torch.Tensor, tile: int) -> torch.Tensor:
    """int32 ``[e]``: ``r`` at every position in ``[ptr[r], ptr[r+1])`` of
    the int32 CSR pointers ``ptr``.  ``rows`` is :func:`spmv_rows_kernel` of
    ``ptr`` at ``tile``: the kernel's block takes a tile of edges and finds
    their rows among the pointers ``rows`` gives it."""
    _check(ptr, (torch.int32,), "expand_dst")
    _check_sizes(ptr, e, "expand_dst")
    if ptr.device.type == "cpu":
        return expand_dst_plain(ptr, e)
    _check(rows, (torch.int32,), "expand_dst rows")
    if rows.shape[0] != -(-e // tile) + 1 or rows.device != ptr.device:
        raise ValueError(f"expand_dst takes the {-(-e // tile) + 1} rows of ptr's tiles "
                         f"on its device, got {rows.shape[0]} on {rows.device}")
    out = torch.empty(e, dtype=torch.int32, device=ptr.device)
    if e:
        _launch("put_expand_dst", ptr, rows, out, e, tile)
        LAUNCHES["expand_dst"] += 1
    return out


def segment_coords_plain(ptr: torch.Tensor, e: int, tiles: int, items: int) -> torch.Tensor:
    n = ptr.shape[0] - 1
    keys = ptr[1:].to(torch.int64) + torch.arange(1, n + 1, dtype=torch.int64, device=ptr.device)
    d = torch.clamp(torch.arange(tiles + 1, dtype=torch.int64, device=ptr.device) * items,
                    max=n + e)
    return torch.searchsorted(keys, d, right=True).to(torch.int32)


def segment_coords_kernel(ptr: torch.Tensor, e: int, tiles: int, items: int) -> torch.Tensor:
    """int32 ``[tiles + 1]``: entry ``b`` counts the rows ``p`` of the
    int32 CSR pointers ``ptr`` (over ``e`` values) whose end comes among
    the first ``min(b·items, n + e)`` merge-path items, ``ptr[p+1] + p + 1
    <= d`` (``segment_kernels.segment_coords``)."""
    _check(ptr, (torch.int32,), "segment_coords")
    _check_sizes(ptr, e, "segment_coords")
    if ptr.device.type == "cpu":
        return segment_coords_plain(ptr, e, tiles, items)
    coords = torch.empty(tiles + 1, dtype=torch.int32, device=ptr.device)
    _launch("put_segment_coords", ptr, coords, ptr.shape[0] - 1, e, tiles, items)
    LAUNCHES["segment_coords"] += 1
    return coords


def node_vectors_plain(norm: torch.Tensor, dtype: torch.dtype):
    s = norm.to(torch.float64)
    out = s > 0
    inv = torch.where(out, 1.0 / torch.where(out, s, 1.0), 0.0).to(dtype)
    return inv, (~out).to(torch.float64), out.to(dtype)


def node_vectors_kernel(norm: torch.Tensor, dtype: torch.dtype):
    """``(inv_outdeg, dangling, has_outlinks)`` of the node normaliser
    ``norm`` (int32 out-degree or float64 out-strength; ``s`` below): ``1 /
    s`` divided in float64 and rounded to ``dtype`` once, 0 where ``s`` is
    0; float64 1.0 where ``s`` is 0; ``dtype`` 1.0 where ``s > 0``.  A
    weighted graph's strength is 0 exactly where its out-degree is, its
    weights being positive."""
    _check(norm, (torch.int32, torch.float64), "node_vectors")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node_vectors gives float32 or float64, got {dtype}")
    if norm.device.type == "cpu":
        return node_vectors_plain(norm, dtype)
    n = norm.shape[0]
    inv = torch.empty(n, dtype=dtype, device=norm.device)
    dangling = torch.empty(n, dtype=torch.float64, device=norm.device)
    has = torch.empty(n, dtype=dtype, device=norm.device)
    if n:
        types = ("i32" if norm.dtype == torch.int32 else "f64",
                 "f32" if dtype == torch.float32 else "f64")
        _launch("put_node_vectors_{}_{}".format(*types), norm, inv, dangling, has, n)
        LAUNCHES["node_vectors"] += 1
    return inv, dangling, has
