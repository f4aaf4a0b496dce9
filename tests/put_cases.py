"""Graphs around the edges of the put's derivation (``ops/put_kernels.py``),
and that derivation assembled from its plain versions.

Imports no JAX, so the card's tests (``test_torch_put_card.py``) share it.
"""

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import put_kernels as pt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk


def _edgeless(n: int) -> tg.Graph:
    none = np.zeros(0, np.int32)
    return tg.Graph(n_nodes=n, src=none, dst=none, out_degree=np.zeros(n, np.int32),
                    node_ids=np.arange(n, dtype=np.int64))


def _edges(src, dst, **kw) -> tg.Graph:
    return tg.from_edges(np.asarray(src), np.asarray(dst), compact_ids=False, **kw)


def _multiple() -> tg.Graph:
    """E = 8,192 (a multiple of BLOCK_ITEMS and of TILE) over n = 2,048
    nodes, so n + E is a multiple of BLOCK_ITEMS too."""
    i = np.arange(2 * pk.TILE)
    return _edges(i % 2048, i // 2048)


def _hub() -> tg.Graph:
    """Node 3 takes 20,000 in-edges: its segment spans ten segment tiles
    and five spmv tiles, between rows with a few edges each."""
    rng = np.random.default_rng(3)
    src = np.r_[np.arange(20_000) + 10, rng.integers(0, 30_010, 400)]
    dst = np.r_[np.full(20_000, 3), rng.integers(0, 9, 400)]
    return _edges(src, dst)


def _sparse_tail() -> tg.Graph:
    """3,000 edges into 60,000 mostly empty rows: an spmv tile's edges span
    more rows than the kernel stages in shared memory."""
    rng = np.random.default_rng(4)
    return _edges(np.r_[rng.integers(0, 60_000, 2_999), 59_999],
                  np.r_[rng.integers(0, 60_000, 2_999), 0])


def _weighted() -> tg.Graph:
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 400, 3_000), rng.integers(0, 400, 3_000)
    return _edges(src, dst, weight=rng.random(3_000) * 3 + 1e-3)


GRAPHS = {
    "edgeless, no nodes": lambda: _edgeless(0),
    "every node dangling": lambda: _edgeless(7),
    "one node, no edge": lambda: _edgeless(1),
    "one node, a self-loop": lambda: _edges([0], [0]),
    "one hub over many tiles": _hub,
    "E a multiple of BLOCK_ITEMS and TILE": _multiple,
    "sparse tail": _sparse_tail,
    "weighted": _weighted,
    "power law": lambda: tg.synthetic_powerlaw(3_000, 20_000, seed=6),
}


def uploads(graph: tg.Graph, device) -> tuple:
    """What the card's put copies: ``src``, the int64 CSR pointers and the
    node normaliser, on ``device``."""
    norm = graph.out_strength() if graph.weight is not None else graph.out_degree
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (graph.src, graph.csr_indptr(), norm))


def derived(graph: tg.Graph, dtype: str, device="cpu", *, plain: bool = True) -> dict:
    """Every field the card's put derives, from :func:`uploads` on
    ``device``: by the plain versions, or by the wrappers (the kernels on a
    CUDA device), from the pointers narrowed as the put narrows them."""
    src, ptr64, norm = uploads(graph, device)
    e, n = graph.n_edges, graph.n_nodes
    fn = {name: getattr(pt, f"{name}_{'plain' if plain else 'kernel'}")
          for name in ("spmv_rows", "expand_dst", "segment_coords", "node_vectors")}
    indptr = ptr64.to(torch.int32)
    rows = fn["spmv_rows"](indptr, e, pk.TILE)
    inv, dangling, has = fn["node_vectors"](norm, getattr(torch, dtype))
    dst = fn["expand_dst"](indptr, e) if plain else fn["expand_dst"](indptr, e, rows, pk.TILE)
    return {
        "src": src,
        "dst": dst,
        "indptr": indptr,
        "inv_outdeg": inv,
        "dangling": dangling,
        "has_outlinks": has,
        "coords": fn["segment_coords"](indptr, e, sk.segment_tiles(n, e), sk.BLOCK_ITEMS),
        "rows": rows,
    }


def host_fields(dg) -> dict:
    """The same fields of a ``DeviceGraph``."""
    return {
        "src": dg.src, "dst": dg.dst, "indptr": dg.indptr, "inv_outdeg": dg.inv_outdeg,
        "dangling": dg.dangling, "has_outlinks": dg.has_outlinks,
        "coords": dg.segment_plan.coords, "rows": dg.spmv_plan.rows,
    }


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (float -0.0 and 0.0 told apart)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        bits = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)
