"""The put's derivation on the card (``csrc/put.cu``): needs a CUDA card,
skips without one.

Imports no JAX, so it runs on a machine with the card and no JAX package:
``python -m pytest tests/test_torch_put_card.py -m chip --noconftest -q``.
The kernels are held bit for bit to their plain versions at a seeded
web-Google-sized graph and at the edge cases of ``put_cases.GRAPHS``; the
card's put to the host builders' arrays copied to the card, as the put
built them before it derived on the card; and the ranks of ``api.pagerank``
and ``run_ppr_batch`` over the two to each other.
"""

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import api
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr as ppr_mod
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import pagerank as model
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import put_kernels as pt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import put_stats
from put_cases import GRAPHS, bit_equal, derived, host_fields

pytestmark = pytest.mark.chip

FIELDS = ("src", "dst", "indptr", "inv_outdeg", "dangling", "has_outlinks", "coords", "rows")
_WEB_GOOGLE = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def web_google(weighted: bool = False) -> tg.Graph:
    """A seeded power-law graph at web-Google's counts (875,713 nodes,
    5,105,039 edges drawn; dedup keeps about 3.6M), built once."""
    if weighted not in _WEB_GOOGLE:
        g = tg.synthetic_powerlaw(875_713, 5_105_039, seed=7)
        if weighted:
            w = np.random.default_rng(8).random(g.n_edges) * 4 + 1e-3
            g = tg.from_edges(g.src, g.dst, weight=w, compact_ids=False)
        _WEB_GOOGLE[weighted] = g
    return _WEB_GOOGLE[weighted]


def _graphs():
    return [("web-Google", lambda: web_google()), ("web-Google weighted",
                                                    lambda: web_google(True)),
            *sorted(GRAPHS.items())]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", [name for name, _ in _graphs()])
def test_kernels_equal_their_plain_versions(card, case, dtype):
    g = dict(_graphs())[case]()
    pt.reset_launches()
    got = derived(g, dtype, card, plain=False)
    torch.cuda.synchronize()
    want = derived(g, dtype, card)
    host = host_fields(tops.put_graph(g, dtype, device="cpu"))
    for name in FIELDS:
        assert bit_equal(got[name], want[name]) and bit_equal(got[name], host[name]), name
    if g.n_edges:
        assert pt.LAUNCHES == {"spmv_rows": 1, "expand_dst": 1, "segment_coords": 1,
                               "node_vectors": int(g.n_nodes > 0)}


def _host_put_on_card(g, dtype, card, **kw) -> tops.DeviceGraph:
    """The host builders' put, every array copied to the card as it is: the
    put before it derived on the card."""
    dg = tops.put_graph(g, dtype, device="cpu", **kw)

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(card)
        if isinstance(x, tuple):
            return type(x)(*(move(y) for y in x))
        return x

    return move(dg)


def _same(a, b, where="dg") -> None:
    if isinstance(a, torch.Tensor):
        assert a.device.type == "cuda" and bit_equal(a, b), where
    elif isinstance(a, tuple):
        assert type(a) is type(b), where
        for name, x, y in zip(a._fields if hasattr(a, "_fields") else range(len(a)), a, b):
            _same(x, y, f"{where}.{name}")
    else:
        assert a == b, where


@pytest.mark.parametrize("layout", [None, "hybrid", "sort_shuffle"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("weighted", [False, True])
def test_the_card_put_equals_the_host_put(card, weighted, dtype, layout):
    g = web_google(weighted)
    kw = dict(layout=layout, keep_edge_arrays=layout is None)
    tops.reset_launches()
    stats = put_stats()
    dg = tops.put_graph(g, dtype, device=card, stats=stats, **kw)
    assert tops.DERIVED_ON == {"card": 1, "host": 0} and stats["derived_on"] == "card"
    _same(dg, _host_put_on_card(g, dtype, card, **kw))
    assert tops.DERIVED_ON == {"card": 1, "host": 1}
    if layout is None:
        norm = 8 if weighted else 4
        ew = g.n_edges * (4 if dtype == "float32" else 8) if weighted else 0
        assert stats["h2d_bytes"] == 4 * g.n_edges + 8 * (g.n_nodes + 1) + norm * g.n_nodes + ew
        assert sk.PLANS_BUILT == {"segment": 2} and pk.PLANS_BUILT == {"spmv": 2}


@pytest.mark.parametrize("impl", ["segment", "pallas"])
def test_pagerank_ranks_equal_over_the_card_and_host_puts(card, impl, monkeypatch):
    g = web_google()
    cfg = tcfg.PageRankConfig(iterations=20, dangling="redistribute", init="uniform",
                              spmv_impl=impl)
    card_ranks = api.pagerank(g, cfg, device=card)
    assert card_ranks.metrics.records[0]["derived_on"] == "card"
    monkeypatch.setattr(model, "put_graph_for",
                        lambda graph, c, device, stats=None: _host_put_on_card(
                            graph, c.dtype, device))
    host_ranks = api.pagerank(g, cfg, device=card)
    assert card_ranks.ranks.dtype == np.float32
    assert np.array_equal(card_ranks.ranks.view(np.int32), host_ranks.ranks.view(np.int32))


def test_ppr_ranks_equal_over_the_card_and_host_puts(card, monkeypatch):
    g = web_google()
    rng = np.random.default_rng(9)
    queries = [[int(g.node_ids[i])] for i in rng.integers(0, g.n_nodes, 8)]
    cfg = tcfg.PageRankConfig(iterations=10)
    tops.reset_launches()
    card_res = ppr_mod.run_ppr_batch(g, cfg, queries, device=card)
    assert tops.DERIVED_ON == {"card": 1, "host": 0}
    monkeypatch.setattr(ppr_mod, "put_graph_for",
                        lambda graph, c, device, stats=None: _host_put_on_card(
                            graph, c.dtype, device))
    host_res = ppr_mod.run_ppr_batch(g, cfg, queries, device=card)
    assert np.array_equal(card_res.ranks.view(np.int32), host_res.ranks.view(np.int32))


def test_a_card_put_records_what_it_holds(card):
    """``device_bytes`` is the bytes of the returned graph's tensors, plans
    included: what the put leaves allocated on the card, less the slack
    of the allocator's blocks (it splits a block only where more than
    1 MiB would be left over)."""
    g = web_google()
    stats = put_stats()
    before = torch.cuda.memory_allocated(card)
    dg = tops.put_graph(g, "float32", device=card, stats=stats)
    held = torch.cuda.memory_allocated(card) - before
    assert stats["device_bytes"] == tops.device_graph_bytes(dg)
    fields = (dg.src, dg.dst, dg.indptr, dg.inv_outdeg, dg.dangling, dg.has_outlinks,
              dg.segment_plan.coords, dg.segment_plan.state, dg.spmv_plan.rows,
              dg.spmv_plan.state)
    assert stats["device_bytes"] == sum(t.numel() * t.element_size() for t in fields)
    assert stats["device_bytes"] <= held < stats["device_bytes"] + 2 ** 20 * len(fields)
    res = api.pagerank(g, tcfg.PageRankConfig(iterations=2), device=card)
    (put,) = [r for r in res.metrics.records if r.get("event") == "put_graph"]
    assert put["device_bytes"] == stats["device_bytes"]
