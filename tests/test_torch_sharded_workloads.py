"""The port's sharded graph workloads (``..._torch/parallel/
workloads_sharded.py``) against the JAX package's and against the port's
single-device runs, on the CPU: the transposed graph and the owned pair,
HITS and connected components on owned slices (both directions' boundary
exchanges over one ownership), and PPR with its query axis sharded, at
D = 1, 2, 4 and 8 CPU slots.  Bars: HITS float64 within 1e-12 of the
reference and of ``run_hits``; labels equal; PPR rows within 1e-12 of the
reference and of ``run_ppr_batch``.
"""

from __future__ import annotations

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import workloads_sharded as jws
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import run_components
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import workloads_sharded as tws
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

F64 = dict(dangling="redistribute", init="uniform", dtype="float64")
DS = (1, 2, 4, 8)


def cpu_mesh(d: int, axis: str = pmesh.NODES_AXIS) -> pmesh.Mesh:
    return pmesh.make_mesh(d, axis, devices=["cpu"] * d)


@pytest.fixture(scope="module")
def graphs():
    return tg.synthetic_powerlaw(600, 3600, seed=33), jg.synthetic_powerlaw(600, 3600, seed=33)


@pytest.fixture(scope="module")
def clusters():
    """Several disconnected clusters, so the labels are not trivial."""
    rng = np.random.default_rng(5)
    parts = [(rng.integers(c * 120, c * 120 + 120, 300), rng.integers(c * 120, c * 120 + 120, 300))
             for c in range(6)]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    return tg.from_edges(src, dst), jg.from_edges(src, dst)


def _weighted(n: int = 200, e: int = 1600, seed: int = 8):
    rng = np.random.default_rng(seed)
    src, dst, w = rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e) + 0.1
    return tg.from_edges(src, dst, weight=w), jg.from_edges(src, dst, weight=w)


def test_transpose_graph_is_the_references(graphs):
    g, jgr = graphs
    t, jt = tws.transpose_graph(g), jws.transpose_graph(jgr)
    for f in ("n_nodes", "src", "dst", "out_degree", "node_ids"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f), f)
    assert (np.diff(t.dst) >= 0).all()


@pytest.mark.parametrize("d", DS)
def test_owned_pair_is_the_references(graphs, d):
    g, jgr = graphs
    for got, want in zip(tws.build_owned_pair(g, d, "float64"),
                         jws.build_owned_pair(jgr, d, "float64")):
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    sf, sr = tws.build_owned_pair(g, d, "float32")
    np.testing.assert_array_equal(sf.tail_map, sr.tail_map)


@pytest.mark.parametrize("d", DS)
def test_hits_sharded(graphs, d):
    g, jgr = graphs
    cfg = dict(iterations=50, tol=1e-10, dtype="float64")
    res = tws.run_hits_sharded(g, tcfg.HitsConfig(**cfg), mesh=cpu_mesh(d))
    want = jws.run_hits_sharded(jgr, jcfg.HitsConfig(**cfg), n_devices=d)
    base = run_hits(g, tcfg.HitsConfig(**cfg), device="cpu")
    for r in (want, base):
        np.testing.assert_allclose(res.hubs, r.hubs, rtol=0, atol=1e-12)
        np.testing.assert_allclose(res.authorities, r.authorities, rtol=0, atol=1e-12)
    assert res.iterations == want.iterations


def test_hits_sharded_runs_both_passes_on_the_segment_kernel(graphs):
    """Two segmented sums a slot a step (the CPU runs their plain version
    and counts no launch; the plans are built once, at placement)."""
    g, _ = graphs
    sk.reset_launches()
    tws.run_hits_sharded(g, tcfg.HitsConfig(iterations=5, tol=0.0), mesh=cpu_mesh(4))
    assert sk.PLANS_BUILT["segment"] == 8  # 4 slots x 2 directions


def test_hits_sharded_weighted():
    g, jgr = _weighted()
    cfg = dict(iterations=30, tol=0.0, dtype="float64")
    res = tws.run_hits_sharded(g, tcfg.HitsConfig(**cfg), mesh=cpu_mesh(4))
    base = run_hits(g, tcfg.HitsConfig(**cfg), device="cpu")
    want = jws.run_hits_sharded(jgr, jcfg.HitsConfig(**cfg), n_devices=4)
    np.testing.assert_allclose(res.hubs, base.hubs, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.hubs, want.hubs, rtol=0, atol=1e-12)


@pytest.mark.parametrize("d", DS)
def test_components_sharded(clusters, d):
    g, jgr = clusters
    res = tws.run_components_sharded(g, tcfg.ComponentsConfig(), mesh=cpu_mesh(d))
    want = jws.run_components_sharded(jgr, jcfg.ComponentsConfig(), n_devices=d)
    base = run_components(g, device="cpu")
    np.testing.assert_array_equal(res.labels, base.labels)
    np.testing.assert_array_equal(res.labels, want.labels)
    assert res.n_components == base.n_components == 6 and res.converged
    assert res.iterations == want.iterations


def test_components_cap_reports_not_converged(clusters):
    g, _ = clusters
    res = tws.run_components_sharded(g, tcfg.ComponentsConfig(iterations=1), mesh=cpu_mesh(4))
    assert not res.converged
    assert any(r.get("event") == "cc_not_converged" for r in res.metrics.records)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("queries", [[[1], [5, 9], [17], [3, 4, 5], [250]], [[2], [7], [11]]],
                         ids=["five", "uneven"])
def test_ppr_sharded_query_axis(graphs, d, queries):
    g, jgr = graphs
    cfg = dict(iterations=40, **F64)
    res = tws.run_ppr_sharded(g, tcfg.PageRankConfig(**cfg), queries, mesh=cpu_mesh(d, "data"))
    want = jws.run_ppr_sharded(jgr, jcfg.PageRankConfig(**cfg), queries, n_devices=d)
    base = run_ppr_batch(g, tcfg.PageRankConfig(**cfg), queries, device="cpu")
    assert res.ranks.shape == (len(queries), g.n_nodes)
    assert np.abs(res.ranks - want.ranks).max() <= 1e-12
    assert np.abs(res.ranks - base.ranks).max() <= 1e-12
    pads = [r for r in res.metrics.records if r.get("event") == "ppr_sharded"]
    assert pads[0]["batch_pad"] == -(-len(queries) // d) * d


def test_ppr_sharded_tolerance_and_refusals(graphs):
    g, jgr = graphs
    cfg = dict(iterations=200, tol=1e-9, **F64)
    q = [[1], [5], [9]]
    res = tws.run_ppr_sharded(g, tcfg.PageRankConfig(**cfg), q, mesh=cpu_mesh(2, "data"))
    want = jws.run_ppr_sharded(jgr, jcfg.PageRankConfig(**cfg), q, n_devices=2)
    assert res.iterations == want.iterations < 200 and res.l1_delta <= 1e-9
    with pytest.raises(ValueError, match="queries="):
        tws.run_ppr_sharded(g, tcfg.PageRankConfig(personalize=(1,)), q, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="at least one"):
        tws.run_ppr_sharded(g, tcfg.PageRankConfig(), [], mesh=cpu_mesh(2))


def test_empty_graph_workloads():
    g = tg.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert tws.run_hits_sharded(g, mesh=cpu_mesh(2)).hubs.shape == (0,)
    assert tws.run_components_sharded(g, mesh=cpu_mesh(2)).labels.shape == (0,)
