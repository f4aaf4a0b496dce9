"""The port's dataflow workloads against the JAX package and networkx, on
the CPU: ``segment_combine``, batched personalized PageRank, HITS,
connected components and ``cli.workloads``.

The same ``synthetic_powerlaw`` graphs, built by each package from one
seed, go through both (JAX in float64, as ``tests/conftest.py`` sets it).
Tolerances: float64 PPR and HITS within 1e-12 of the JAX package for every
impl; component labels equal; the networkx oracles of
``tests/test_workload_oracles.py`` (PPR 1e-8, HITS 1e-6, components
exact); a run killed after a checkpoint and resumed equals an unbroken
run bit for bit.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.cli import workloads as jcli
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import components as jcc
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import hits as jhits
from page_rank_and_tfidf_using_apache_spark_tpu.dataflow import ppr as jppr
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import dataflow
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import workloads as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import components as tcc
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import hits as thits
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr as tppr
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

TOL = 1e-12


def graphs(n: int = 150, e: int = 700, seed: int = 11, weighted: bool = False):
    """The same graph from each package (byte-identical, see
    test_torch_graph.py), optionally with the same edge weights."""
    j, t = jg.synthetic_powerlaw(n, e, seed=seed), tg.synthetic_powerlaw(n, e, seed=seed)
    if weighted:
        w = np.random.default_rng(4).uniform(0.25, 4.0, j.n_edges)
        j, t = jg.from_edges(j.src, j.dst, weight=w), tg.from_edges(t.src, t.dst, weight=w)
    return j, t


def queries_of(g) -> list:
    ids = g.node_ids
    return [[int(ids[0])], [int(ids[3]), int(ids[9])], [int(ids[7]), int(ids[7]), int(ids[2])]]


def nx_digraph(g):
    G = nx.DiGraph()
    G.add_nodes_from(range(g.n_nodes))
    G.add_edges_from(zip(g.src.tolist(), g.dst.tolist()))
    return G


# ----------------------------------------------------------- combine


@pytest.mark.parametrize("sorted_keys", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segment_combine_matches_jax(op, dtype, sorted_keys):
    """Against ``jax.ops.segment_*`` on keys with empty segments and keys
    out of range (dropped by both): integers and min/max exactly, float64
    sums to 1e-12, float32 sums (the port's in float64) to 1e-6."""
    rng = np.random.default_rng(5)
    n, e = 40, 500
    keys = rng.integers(-3, n + 3, e).astype(np.int32)
    keys[(keys >= 10) & (keys < 14)] = 2  # segments 10..13 empty
    if sorted_keys:
        keys.sort()
    vals = (rng.integers(-50, 50, e) if dtype == "int32" else rng.standard_normal(e)).astype(dtype)
    jfn = {"add": jax.ops.segment_sum, "min": jax.ops.segment_min,
           "max": jax.ops.segment_max}[op]
    want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(keys), num_segments=n,
                          indices_are_sorted=sorted_keys))
    got = dataflow.segment_combine(torch.from_numpy(vals), torch.from_numpy(keys), n, op=op,
                                   indices_are_sorted=sorted_keys).numpy()
    assert got.dtype == want.dtype and got.shape == (n,)
    if op != "add" or dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL if dtype == "float64" else 1e-6)


def test_segment_combine_add_orders_like_sorted_keys():
    """Unsorted float keys are sorted stably first: the result's bits are
    those of the same values in key order."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 30, 400)
    vals = torch.from_numpy(rng.standard_normal(400).astype(np.float32))
    order = np.argsort(keys, kind="stable")
    a = dataflow.segment_combine(vals, torch.from_numpy(keys), 30)
    b = dataflow.segment_combine(vals[order], torch.from_numpy(keys[order]), 30,
                                 indices_are_sorted=True)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    with pytest.raises(ValueError, match="unknown combine op"):
        dataflow.segment_combine(vals, torch.from_numpy(keys), 30, op="mean")


def test_graph_combine_and_broadcast_join():
    _, g = graphs()
    dg = tops.put_graph(g, "float64", device="cpu")
    w = torch.from_numpy(np.random.default_rng(1).random(g.n_nodes))
    want = np.zeros(g.n_nodes)
    np.add.at(want, g.dst, w.numpy()[g.src])
    np.testing.assert_allclose(dataflow.graph_combine(dg, w, g.n_nodes).numpy(), want,
                               rtol=0, atol=TOL)
    assert dataflow.broadcast_join(w, dg.src).numpy().tolist() == w.numpy()[g.src].tolist()


# --------------------------------------------- personalized PageRank


@pytest.mark.parametrize("impl", tcfg.SPMV_IMPLS)
def test_ppr_matches_jax(impl):
    jgr, tgr = graphs()
    kw = dict(iterations=30, dangling="redistribute", init="uniform", dtype="float64",
              spmv_impl=impl, head_row_width=8)
    want = jppr.run_ppr_batch(jgr, jcfg.PageRankConfig(**kw), queries_of(jgr))
    got = tppr.run_ppr_batch(tgr, tcfg.PageRankConfig(**kw), queries_of(tgr), device="cpu")
    assert got.ranks.shape == (3, tgr.n_nodes) and got.ranks.dtype == np.float64
    assert got.iterations == want.iterations == 30
    assert np.abs(got.ranks - np.asarray(want.ranks)).max() <= TOL
    assert abs(got.l1_delta - want.l1_delta) <= TOL


@pytest.mark.parametrize("impl", ["segment", "pallas", "hybrid", "cumsum"])
def test_ppr_rows_equal_single_query_runs(impl):
    """Each row of the batch is the single-query personalized run: the
    batch changes the schedule, never a value."""
    _, g = graphs()
    cfg = tcfg.PageRankConfig(iterations=25, dangling="redistribute", init="uniform",
                              dtype="float64", spmv_impl=impl, head_row_width=8)
    qs = queries_of(g)
    res = tppr.run_ppr_batch(g, cfg, qs, device="cpu")
    for qi, q in enumerate(qs):
        one = run_pagerank(g, dataclasses.replace(cfg, personalize=tuple(q)), device="cpu")
        assert np.abs(res.ranks[qi] - one.ranks).max() <= TOL


def test_ppr_matches_networkx_personalization():
    _, g = graphs(150, 700, seed=11)
    G = nx_digraph(g)
    qs = queries_of(g)
    cfg = tcfg.PageRankConfig(iterations=500, tol=1e-12, dangling="redistribute",
                              init="uniform", dtype="float64")
    res = tppr.run_ppr_batch(g, cfg, qs, device="cpu")
    assert res.iterations < 500 and res.l1_delta <= 1e-12
    for qi, q in enumerate(qs):
        pers = {i: 0.0 for i in range(g.n_nodes)}
        for oid in q:  # duplicates accumulate, as in restart_vector
            pers[int(np.searchsorted(g.node_ids, oid))] += 1.0 / len(q)
        want = nx.pagerank(G, alpha=0.85, personalization=pers, tol=1e-12, max_iter=1000)
        got = res.ranks[qi] / res.ranks[qi].sum()
        np.testing.assert_allclose(got, [want[i] for i in range(g.n_nodes)], atol=1e-8)


def test_ppr_refusals_and_concentration():
    _, g = graphs(200, 900, seed=4)
    q0, q1 = [int(g.node_ids[0])], [int(g.node_ids[50])]
    cfg = tcfg.PageRankConfig(iterations=100, tol=1e-10, dangling="redistribute",
                              init="uniform")
    res = tppr.run_ppr_batch(g, cfg, [q0, q1], device="cpu")
    i0, i1 = (int(np.searchsorted(g.node_ids, q[0])) for q in (q0, q1))
    assert res.ranks[0][i0] > res.ranks[1][i0] and res.ranks[1][i1] > res.ranks[0][i1]
    with pytest.raises(ValueError, match="not cfg.personalize"):
        tppr.run_ppr_batch(g, dataclasses.replace(cfg, personalize=(1,)), [q0], device="cpu")
    with pytest.raises(ValueError, match="spark_exact"):
        tppr.run_ppr_batch(g, tcfg.PageRankConfig(spark_exact=True), [q0], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tppr.run_ppr_batch(g, cfg, [], device="cpu")


# ----------------------------------------------------------------- HITS


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tol", [0.0, 1e-10])
def test_hits_matches_jax(tol, weighted):
    jgr, tgr = graphs(weighted=weighted)
    kw = dict(iterations=60, tol=tol, dtype="float64")
    want = jhits.run_hits(jgr, jcfg.HitsConfig(**kw))
    got = thits.run_hits(tgr, tcfg.HitsConfig(**kw), device="cpu")
    assert got.iterations == want.iterations
    assert np.abs(got.hubs - np.asarray(want.hubs)).max() <= TOL
    assert np.abs(got.authorities - np.asarray(want.authorities)).max() <= TOL
    assert abs(got.l1_delta - want.l1_delta) <= TOL


def test_hits_matches_networkx():
    _, g = graphs(150, 700, seed=13)
    res = thits.run_hits(g, tcfg.HitsConfig(iterations=1000, tol=1e-13, dtype="float64"),
                         device="cpu")
    nh, na = nx.hits(nx_digraph(g), max_iter=2000, tol=1e-13)
    np.testing.assert_allclose(res.hubs, [nh[i] for i in range(g.n_nodes)], atol=1e-6)
    np.testing.assert_allclose(res.authorities, [na[i] for i in range(g.n_nodes)], atol=1e-6)
    assert abs(res.hubs.sum() - 1.0) < 1e-9 and abs(res.authorities.sum() - 1.0) < 1e-9


def test_hits_reverse_layout_is_built_once(monkeypatch):
    """The reverse pass reads a src-sorted layout built with the graph: two
    plans a run (forward and reverse pointers), none in the loop."""
    _, g = graphs(weighted=True)
    sk.reset_launches()
    thits.run_hits(g, tcfg.HitsConfig(iterations=20, tol=0.0, dtype="float64"), device="cpu")
    assert sk.PLANS_BUILT["segment"] == 2
    hg = thits.put_hits_graph(g, "float64", "cpu")
    order = np.argsort(g.src, kind="stable")
    assert hg.rev_dst.numpy().tolist() == g.dst[order].tolist()
    assert hg.rev_w.numpy().tolist() == g.weight[order].tolist()
    assert hg.rev_ptr.numpy().tolist() == np.searchsorted(
        g.src[order], np.arange(g.n_nodes + 1)).tolist()


def test_hits_empty_graph():
    res = thits.run_hits(tg.parse_snap_text(""), device="cpu")
    assert res.hubs.shape == (0,) and res.iterations == 0


# ----------------------------------------------------- connected components


@pytest.mark.parametrize("seed", [1, 9, 42])
def test_components_match_jax_and_networkx(seed):
    jgr, tgr = graphs(300, 600, seed=seed)
    got = tcc.run_components(tgr, device="cpu")
    want = jcc.run_components(jgr)
    assert got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    assert got.iterations == want.iterations and got.converged
    nxc = sorted(sorted(c) for c in nx.connected_components(nx_digraph(tgr).to_undirected()))
    groups = sorted(sorted(c) for c in got.groups())
    assert groups == nxc and got.n_components == len(nxc)
    for comp in groups:  # a label is the smallest member id
        assert all(got.labels[i] == comp[0] for i in comp)


def test_components_isolated_nodes_and_empty():
    g = tg.from_edges(np.array([0, 1, 5]), np.array([1, 0, 6]))
    res = tcc.run_components(g, device="cpu")
    assert res.n_components == 2 and res.converged
    empty = tcc.run_components(tg.parse_snap_text(""), device="cpu")
    assert empty.n_components == 0 and empty.labels.shape == (0,)


def test_components_iteration_cap_flags_non_convergence():
    n = 40
    g = tg.from_edges(np.arange(n - 1), np.arange(1, n))  # a path
    m = MetricsRecorder()
    res = tcc.run_components(g, tcfg.ComponentsConfig(iterations=3), metrics=m, device="cpu")
    assert not res.converged and res.n_components > 1
    jm = jcc.MetricsRecorder()
    jcc.run_components(jg.from_edges(np.arange(n - 1), np.arange(1, n)),
                       jcfg.ComponentsConfig(iterations=3), metrics=jm)
    flagged = [r for r in m.records if r.get("event") == "cc_not_converged"]
    assert flagged == [r for r in jm.records if r.get("event") == "cc_not_converged"]
    assert flagged[0]["iterations"] == 3 and flagged[0]["still_changing"] > 0
    full = tcc.run_components(g, device="cpu")
    assert full.converged and full.n_components == 1


# ------------------------------------------------------ kill and resume


def _run(workload: str, g, cfg_kw: dict, **kw):
    if workload == "ppr":
        cfg = tcfg.PageRankConfig(dangling="redistribute", init="uniform", spmv_impl="pallas",
                                  **cfg_kw)
        return tppr.run_ppr_batch(g, cfg, queries_of(g), device="cpu", **kw).ranks
    if workload == "hits":
        res = thits.run_hits(g, tcfg.HitsConfig(**cfg_kw), device="cpu", **kw)
        return np.stack([res.hubs, res.authorities])
    cfg_kw = {k: v for k, v in cfg_kw.items() if k != "dtype"}
    return tcc.run_components(g, tcfg.ComponentsConfig(**cfg_kw), device="cpu", **kw).labels


@pytest.mark.parametrize("workload", ["ppr", "hits", "cc"])
def test_kill_and_resume_gives_equal_bits(workload, tmp_path):
    """At tol 0 a run splits into checkpointed segments; killed after 10 of
    14 iterations and resumed, it gives the unbroken run's bits."""
    _, g = graphs(300, 900, seed=9)
    base = dict(iterations=14, tol=0.0, dtype="float32")
    ck = dict(checkpoint_every=4, checkpoint_dir=str(tmp_path))
    full = _run(workload, g, base)
    _run(workload, g, {**base, **ck, "iterations": 10})
    m = MetricsRecorder()
    got = _run(workload, g, {**base, **ck}, resume=True, metrics=m)
    assert got.dtype == full.dtype and got.tobytes() == full.tobytes()
    assert [r["start_iter"] for r in m.records if r.get("event") == "resume"] == [8]


def test_resume_rejects_another_batch(tmp_path):
    """A PPR checkpoint of another batch size is another carry: refused."""
    _, g = graphs()
    cfg = tcfg.PageRankConfig(iterations=8, tol=0.0, checkpoint_every=4,
                              checkpoint_dir=str(tmp_path))
    tppr.run_ppr_batch(g, cfg, queries_of(g)[:2], device="cpu")
    with pytest.raises(ValueError, match="different graph"):
        tppr.run_ppr_batch(g, cfg, queries_of(g), resume=True, device="cpu")


# ------------------------------------------------------- cli.workloads


def _cli(main, argv, capsys) -> tuple[str, str]:
    assert main(argv) == 0
    out = capsys.readouterr()
    return out.out, out.err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["ppr", "synthetic:150,700,11", "--queries", "1,2", "7", "--iterations", "40",
     "--dtype", "float64", "--spmv-impl", "hybrid", "--top-k", "5"],
    ["ppr", "synthetic:150,700,11", "--queries", "3", "--dtype", "float64"],
    ["hits", "synthetic:150,700,13", "--dtype", "float64", "--top-k", "6"],
    ["cc", "synthetic:300,600,9"],
    ["cc", "synthetic:300,600,9", "--iterations", "2"],
])
def test_cli_matches_jax_cli(argv, capsys, tmp_path):
    """The port's ``cli.workloads`` prints the JAX CLI's lines and ``cc
    --output`` file on the CPU, and its summary, whose float64 ``l1_delta``
    agrees to 1e-12."""
    extra = ["--output", str(tmp_path / "j.tsv")] if argv[0] == "cc" else []
    j_out, j_sum = _cli(jcli.main, argv + extra, capsys)
    extra = ["--output", str(tmp_path / "t.tsv")] if argv[0] == "cc" else []
    t_out, t_sum = _cli(tcli.main, argv + extra + ["--device", "cpu"], capsys)
    assert t_out == j_out
    t_sum, j_sum = json.loads(t_sum), json.loads(j_sum)
    assert abs(t_sum.pop("l1_delta", 0.0) - j_sum.pop("l1_delta", 0.0)) <= TOL
    assert t_sum == j_sum
    if argv[0] == "cc":
        assert (tmp_path / "t.tsv").read_text() == (tmp_path / "j.tsv").read_text()
    else:
        assert len(t_out.splitlines()) > 0


def test_cli_checkpoint_flags(capsys, tmp_path):
    """hits at --tol 0, killed at 10 of 20 iterations with checkpoints every
    4, then resumed: the lines of an unbroken run."""
    base = ["hits", "synthetic:300,900,9", "--tol", "0", "--device", "cpu"]
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "4"]
    full, _ = _cli(tcli.main, base + ["--iterations", "20"], capsys)
    _cli(tcli.main, base + ["--iterations", "10"] + ck, capsys)
    resumed, summary = _cli(tcli.main, base + ["--iterations", "20", "--resume"] + ck, capsys)
    assert resumed == full and '"iterations": 20' in summary
