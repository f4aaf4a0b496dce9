"""The put's derivation on the card, through its plain versions.

On a CUDA device ``ops.put_graph`` copies ``src``, the int64 CSR pointers
and the node normaliser, and derives every other field and both kernel
plans with ``csrc/put.cu`` (``ops/put_kernels.py``).  The kernels run only
on the card (``test_torch_put_card.py``); here their plain versions, and a
numpy model of ``put_expand_dst``'s tiled search, are held bit for bit to
the numpy builders the CPU put runs, over graphs at the edges of each
derivation, in float32 and float64.
"""

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import put_kernels as pt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import put_stats
from put_cases import GRAPHS, bit_equal, derived, host_fields

FIELDS = ("src", "dst", "indptr", "inv_outdeg", "dangling", "has_outlinks", "coords", "rows")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_plain_derivation_equals_the_host_builders(case, dtype):
    g = GRAPHS[case]()
    dg = tops.put_graph(g, dtype, device="cpu")
    want, got = host_fields(dg), derived(g, dtype)
    for name in FIELDS:
        assert bit_equal(got[name], want[name]), name
    assert np.array_equal(got["dst"].numpy(), g.dst)
    assert (dg.segment_plan.n, dg.segment_plan.e) == (dg.spmv_plan.n, dg.spmv_plan.e) == (
        g.n_nodes, g.n_edges)


def _expand_model(ptr: np.ndarray, e: int, tile: int) -> np.ndarray:
    """``put_expand_dst`` in numpy: tile ``t`` searches its edges' rows
    among the pointers ``[rows[t], rows[t+1])`` of the spmv plan at
    ``tile``; an edge's row is one less than the first pointer above it
    there, or than ``rows[t+1]``."""
    rows = pt.spmv_rows_plain(torch.from_numpy(ptr.astype(np.int32)), e, tile).numpy()
    out = np.full(e, -1, np.int64)
    for t in range(rows.shape[0] - 1):
        lo, hi = int(rows[t]), int(rows[t + 1])
        i = np.arange(t * tile, min((t + 1) * tile, e))
        j = lo + np.searchsorted(ptr[lo:hi], i, side="right")
        assert np.all((lo <= j) & (j <= hi) & (ptr[j - 1] <= i) & (i < ptr[j]))
        out[i] = j - 1
    return out


@pytest.mark.parametrize("tile", [4, 7, pk.TILE])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_the_kernels_tiled_search_gives_dst(case, tile):
    g = GRAPHS[case]()
    got = _expand_model(g.csr_indptr(), g.n_edges, tile)
    assert np.array_equal(got, g.dst)


def test_each_wrapper_runs_its_plain_version_on_the_cpu():
    g = GRAPHS["power law"]()
    pt.reset_launches()
    plain, wrapped = derived(g, "float32"), derived(g, "float32", plain=False)
    for name in FIELDS:
        assert bit_equal(wrapped[name], plain[name]), name
    assert set(pt.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("call, error", [
    (lambda: pt.spmv_rows_kernel(torch.zeros(6, dtype=torch.int32)[::2], 0, 4), ValueError),
    (lambda: pt.spmv_rows_kernel(torch.zeros(3, dtype=torch.int64), 0, 4), TypeError),
    (lambda: pt.segment_coords_kernel(torch.zeros(2, 3, dtype=torch.int32), 0, 0, 4), ValueError),
    (lambda: pt.node_vectors_kernel(torch.zeros(3, dtype=torch.float32), torch.float32), TypeError),
    (lambda: pt.node_vectors_kernel(torch.zeros(3, dtype=torch.int32), torch.int32), TypeError),
    (lambda: pt.expand_dst_kernel([0, 1], 1, None, 4), TypeError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    with pytest.raises(error):
        call()


def test_the_put_counts_where_it_derived_and_says_so_in_its_stats():
    g = GRAPHS["weighted"]()
    tops.reset_launches()
    stats = put_stats()
    tops.put_graph(g, "float64", device="cpu", stats=stats)
    assert stats["derived_on"] == "host" and tops.DERIVED_ON == {"card": 0, "host": 1}
    assert stats["h2d_bytes"] > 0 and stats["plan_secs"] > 0
    tops.put_graph(g, "float32", layout="hybrid", keep_edge_arrays=False, device="cpu")
    assert tops.DERIVED_ON == {"card": 0, "host": 2}
    tops.reset_launches()
    assert tops.DERIVED_ON == {"card": 0, "host": 0}
    assert sk.PLANS_BUILT == {"segment": 0} and pk.PLANS_BUILT == {"spmv": 0}


def test_a_run_records_where_its_put_derived():
    g = GRAPHS["power law"]()
    res = run_pagerank(g, tcfg.PageRankConfig(iterations=3), device="cpu")
    (put,) = [r for r in res.metrics.records if r.get("event") == "put_graph"]
    assert put["derived_on"] == "host"


@pytest.mark.parametrize("n, e, raises", [
    (10, tops.INT32_LIMIT - 10, False),  # the merge path at the limit
    (11, tops.INT32_LIMIT - 10, True),  # one past it
    (0, tops.INT32_LIMIT, False),
    (0, tops.INT32_LIMIT + 1, True),  # the edges alone past it
    (41_652_230, 1_468_365_182, False),  # LAW twitter-2010, n + E at 70% of the limit
])
def test_the_int32_limit_on_edges_and_the_merge_path(n, e, raises):
    if raises:
        with pytest.raises(ValueError, match=f"{n} nodes and {e} edges.*2147483647"):
            tops.check_int32_counts(n, e)
    else:
        tops.check_int32_counts(n, e)


class _CountsOnly:
    """A graph that has counts and no arrays: a put that reads an array
    raises AttributeError."""

    weight = None

    def __init__(self, n_nodes, n_edges):
        self.n_nodes, self.n_edges = n_nodes, n_edges


@pytest.mark.parametrize("layout", [None, "hybrid"])
def test_a_put_past_the_int32_limit_raises_before_any_copy(layout):
    tops.reset_launches()
    stats = put_stats()
    over = _CountsOnly(1000, tops.INT32_LIMIT - 999)
    with pytest.raises(ValueError, match="int32 limit"):
        tops.put_graph(over, device="cpu", layout=layout, stats=stats)
    assert stats == put_stats() and tops.DERIVED_ON == {"card": 0, "host": 0}
    # one under the limit passes the check and goes on to read the arrays
    with pytest.raises(AttributeError):
        tops.put_graph(_CountsOnly(1000, tops.INT32_LIMIT - 1000), device="cpu", layout=layout)


def _held(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@pytest.mark.parametrize("case", ["power law", "weighted"])
def test_a_put_records_the_bytes_it_holds(case):
    """``device_bytes`` is the bytes of every tensor of the returned graph,
    its plans' coordinates and scratch included."""
    g = GRAPHS[case]()
    stats = put_stats()
    dg = tops.put_graph(g, device="cpu", stats=stats)
    plans = (dg.segment_plan.coords, dg.segment_plan.state, dg.spmv_plan.rows, dg.spmv_plan.state)
    want = _held(dg.src, dg.dst, dg.inv_outdeg, dg.dangling, dg.has_outlinks, dg.indptr,
                 dg.edge_weight, *plans)
    assert stats["device_bytes"] == tops.device_graph_bytes(dg) == want
    assert want >= 8 * g.n_edges + 4 * (g.n_nodes + 1)  # src, dst and indptr at least
    res = run_pagerank(g, tcfg.PageRankConfig(iterations=2), device="cpu")
    (put,) = [r for r in res.metrics.records if r.get("event") == "put_graph"]
    assert put["device_bytes"] == want


def test_the_bytes_of_a_layout_and_of_a_tensor_held_twice():
    g = GRAPHS["power law"]()
    dg = tops.put_graph(g, device="cpu", layout="hybrid")
    hl = dg.hybrid
    layout = _held(*(t for t in hl if isinstance(t, torch.Tensor)), hl.head_row_plan.coords,
                   hl.head_row_plan.state)
    assert layout > 0
    base = tops.put_graph(g, device="cpu")
    assert tops.device_graph_bytes(dg) == tops.device_graph_bytes(base) + layout
    # a tensor under two fields, as the card's zero-length placeholders are
    twice = base._replace(dst=base.src)
    assert tops.device_graph_bytes(twice) == tops.device_graph_bytes(base) - _held(base.dst)
