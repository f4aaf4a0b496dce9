"""End-to-end PageRank parity of the PyTorch port (on the CPU) with the JAX
package, with Spark's RDD semantics and with networkx.

Every SpMV impl runs on both sides in float64 on the same graph; ranks
agree to 1e-12 of the total rank mass (the prefix-sum impls' float64
accuracy class, ``ops/pagerank.py`` spmv_cumsum).
"""

import pathlib

import networkx as nx
import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.cli import pagerank as jcli
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.models.pagerank import run_pagerank as jrun
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pagerank as jops
from page_rank_and_tfidf_using_apache_spark_tpu.utils.config import PageRankConfig as JConfig
from page_rank_and_tfidf_using_apache_spark_tpu_torch import convert, pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank as trun
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import SPMV_IMPLS
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig as TConfig

from tests.spark_oracle import spark_pagerank

TINY = str(pathlib.Path(__file__).resolve().parent / "fixtures" / "tiny.txt")
EDGES_SMALL = [(0, 1), (0, 2), (1, 2), (2, 0), (2, 4), (5, 5), (0, 4), (3, 2)]
TOL = 1e-12  # of the total rank mass


def _graphs(weighted: bool):
    """The same graph built by each package (byte-identical, see
    test_torch_graph.py)."""
    args = (150, 900)
    jgr, tgr = jg.synthetic_powerlaw(*args, seed=11), tg.synthetic_powerlaw(*args, seed=11)
    if weighted:
        w = np.random.default_rng(4).uniform(0.25, 4.0, jgr.n_edges)
        jgr = jg.from_edges(jgr.src, jgr.dst, weight=w)
        tgr = tg.from_edges(tgr.src, tgr.dst, weight=w)
    return jgr, tgr


def _kw(dangling):
    # drop pairs with the Spark init (mass n), redistribute with the
    # textbook one (mass 1)
    init = "one" if dangling == "drop" else "uniform"
    return dict(iterations=20, dangling=dangling, init=init, dtype="float64",
                head_row_width=16)


@pytest.mark.parametrize("dangling", ["drop", "redistribute"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("impl", SPMV_IMPLS)
def test_every_impl_matches_jax(impl, weighted, dangling):
    jgr, tgr = _graphs(weighted)
    kw = dict(_kw(dangling), spmv_impl=impl)
    want = jrun(jgr, JConfig(**kw))
    got = trun(tgr, TConfig(**kw), device="cpu")
    mass = float(tgr.n_nodes) if kw["init"] == "one" else 1.0
    assert got.iterations == want.iterations == 20
    assert np.abs(got.ranks - want.ranks).max() <= TOL * mass
    assert got.ranks.dtype == want.ranks.dtype


@pytest.mark.parametrize("impl", SPMV_IMPLS)
def test_runner_on_converted_jax_graph(impl):
    """The port's runner reads the JAX package's own device graph (carried
    across by ``convert``), so a difference is the SpMV's, not a layout's."""
    jgr, _ = _graphs(weighted=True)
    kw = dict(_kw("redistribute"), spmv_impl=impl)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    layout = jops.layout_for_impl(impl)
    jdg = jops.put_graph(jgr, "float64", layout=layout, head_row_width=16)
    n = jgr.n_nodes
    e = jops.restart_vector(n, jcfg)
    r0 = jops.init_ranks(n, jcfg)
    jr, jit_, jd = jops.make_pagerank_runner(n, jcfg)(jdg, np.array(r0), e)
    tdg = convert.device_graph(jdg, device="cpu")
    tr, tit, td = tops.make_pagerank_runner(n, tcfg)(
        tdg, convert.ranks_tensor(r0, device="cpu"), convert.ranks_tensor(e, device="cpu"))
    assert tit == int(jit_) == 20
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= TOL
    assert abs(float(td) - float(jd)) <= TOL


@pytest.mark.parametrize("impl", ["segment", "bcoo"])
def test_spark_exact_matches_jax_and_rdd_oracle(impl):
    a = np.array(EDGES_SMALL)
    tgr, jgr = tg.from_edges(a[:, 0], a[:, 1]), jg.from_edges(a[:, 0], a[:, 1])
    kw = dict(iterations=7, spark_exact=True, dtype="float64", spmv_impl=impl)
    got = trun(tgr, TConfig(**kw), device="cpu")
    want = jrun(jgr, JConfig(**kw))
    assert np.abs(got.ranks - want.ranks).max() <= TOL * tgr.n_nodes
    oracle = spark_pagerank(EDGES_SMALL, 7)
    for i in range(tgr.n_nodes):
        nid = int(tgr.node_ids[i])
        assert got.ranks[i] == pytest.approx(oracle.get(nid, 0.0), abs=1e-9), nid


def test_spark_exact_matches_rdd_oracle_synthetic():
    g = tg.synthetic_powerlaw(200, 600, seed=5)
    edges = [(int(g.node_ids[a]), int(g.node_ids[b])) for a, b in zip(g.src, g.dst)]
    res = pagerank(g, TConfig(iterations=10, spark_exact=True, dtype="float64"), device="cpu")
    oracle = spark_pagerank(edges, 10)
    got = {int(g.node_ids[i]): res.ranks[i] for i in range(g.n_nodes) if res.ranks[i] != 0.0}
    assert set(got) == set(oracle)
    assert sum(abs(got[k] - oracle[k]) for k in oracle) <= 1e-6


def _nx_ranks(g, weighted=False, **kw):
    G = nx.DiGraph()
    G.add_nodes_from(range(g.n_nodes))
    if weighted:
        G.add_weighted_edges_from(zip(g.src.tolist(), g.dst.tolist(), g.weight.tolist()))
    else:
        G.add_edges_from(zip(g.src.tolist(), g.dst.tolist()))
    d = nx.pagerank(G, alpha=0.85, max_iter=1000, tol=1e-15,
                    weight="weight" if weighted else None, **kw)
    return np.array([d[i] for i in range(g.n_nodes)])


@pytest.mark.parametrize("impl", ["segment", "pallas", "hybrid"])
@pytest.mark.parametrize("weighted", [False, True])
def test_networkx_parity(impl, weighted):
    _, g = _graphs(weighted)
    res = pagerank(g, iterations=200, dangling="redistribute", init="uniform",
                   dtype="float64", spmv_impl=impl, head_row_width=16, device="cpu")
    assert np.abs(res.ranks - _nx_ranks(g, weighted)).max() <= 1e-8


def test_personalize_uses_original_node_ids():
    edges = [(10, 20), (20, 30), (30, 10), (40, 10)]
    a = np.array(edges)
    g = tg.from_edges(a[:, 0], a[:, 1])
    res = pagerank(g, iterations=200, tol=1e-12, dangling="redistribute",
                   init="uniform", personalize=(30,), dtype="float64", device="cpu")
    want = jrun(jg.from_edges(a[:, 0], a[:, 1]),
                JConfig(iterations=200, tol=1e-12, dangling="redistribute",
                        init="uniform", personalize=(30,), dtype="float64"))
    assert np.abs(res.ranks - want.ranks).max() <= TOL
    nxr = nx.pagerank(nx.DiGraph(edges), alpha=0.85, personalization={30: 1.0},
                      tol=1e-12, max_iter=500)
    for i in range(g.n_nodes):
        assert abs(res.ranks[i] - nxr[int(g.node_ids[i])]) < 1e-9
    with pytest.raises(ValueError, match="not present"):
        pagerank(g, iterations=5, personalize=(15,), device="cpu")


def test_tolerance_early_stop_matches_jax():
    _, tgr = _graphs(False)
    jgr, _ = _graphs(False)
    kw = dict(iterations=500, tol=1e-10, dangling="redistribute", init="uniform",
              dtype="float64")
    got = trun(tgr, TConfig(**kw), device="cpu")
    want = jrun(jgr, JConfig(**kw))
    assert got.iterations == want.iterations < 500
    assert got.l1_delta <= 1e-10
    assert abs(got.l1_delta - want.l1_delta) <= TOL
    assert np.abs(got.ranks - want.ranks).max() <= TOL


def test_zero_iterations_and_empty_graph():
    a = np.array(EDGES_SMALL)
    g = tg.from_edges(a[:, 0], a[:, 1])
    res = pagerank(g, iterations=0, device="cpu")
    np.testing.assert_array_equal(res.ranks, 1.0)
    assert res.iterations == 0 and res.l1_delta == float("inf")
    want = jrun(jg.from_edges(a[:, 0], a[:, 1]), JConfig(iterations=0))
    assert want.l1_delta == res.l1_delta
    empty = pagerank(tg.parse_snap_text(""), device="cpu")
    assert empty.ranks.shape == (0,) and empty.iterations == 0


def test_run_records_metrics_and_writes_checkpoints(tmp_path):
    _, g = _graphs(False)
    res = pagerank(g, iterations=3, spmv_impl="hybrid", device="cpu")
    events = [r.get("event") for r in res.metrics.records]
    assert "put_graph" in events
    # the last segment record, by kind: a retry record may follow it
    assert [r for r in res.metrics.records if "iter" in r and "l1_delta" in r][-1]["iter"] == 3
    assert res.metrics.scalars == {"iterations": 3, "l1_delta": res.l1_delta}
    ck = pagerank(g, iterations=5, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                  device="cpu")
    saved = [r for r in ck.metrics.records if r.get("event") == "checkpoint"]
    assert [r["iter"] for r in saved] == [2, 4]
    assert all(pathlib.Path(r["path"]).is_file() for r in saved)
    assert ck.metrics.scalars == {"iterations": 5, "l1_delta": ck.l1_delta}


@pytest.mark.parametrize("flags", [
    ["--spmv-impl", "segment"],
    ["--spmv-impl", "pallas", "--dangling", "redistribute", "--init", "uniform"],
    ["--spmv-impl", "hybrid", "--head-row-width", "8", "--dangling", "redistribute"],
    ["--spark-exact", "--top-k", "3"],
    ["--personalize", "2", "--tol", "1e-12", "--dangling", "redistribute"],
])
def test_cli_output_matches_jax_cli(flags, tmp_path):
    """Line for line on tiny.txt.  The JAX CLI runs with --tuned-profile off,
    so both resolve knobs to TUNABLE_DEFAULTS or the explicit flag."""
    common = [TINY, "30", "--dtype", "float64", *flags]
    t_out, j_out = tmp_path / "t.txt", tmp_path / "j.txt"
    assert tcli.main(common + ["--device", "cpu", "--output", str(t_out)]) == 0
    assert jcli.main(common + ["--tuned-profile", "off", "--output", str(j_out)]) == 0
    t_lines, j_lines = t_out.read_text().splitlines(), j_out.read_text().splitlines()
    assert t_lines == j_lines and len(t_lines) > 0


def test_cli_stdout_matches_jax_cli(capsys):
    assert tcli.main([TINY, "10", "--dtype", "float64", "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert jcli.main([TINY, "10", "--dtype", "float64", "--tuned-profile", "off"]) == 0
    j_out = capsys.readouterr().out
    assert t_out == j_out and t_out.count("\n") == 5
