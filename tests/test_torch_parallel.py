"""The port's sharded layer (``..._torch/parallel/``) against the JAX
package's, on the CPU.

The JAX package runs its mesh over the 8 simulated host devices of
``tests/conftest.py``; the port runs the same slot counts as CPU slots of
one process (``make_mesh(d, devices=["cpu"] * d)``).  Held here:

- each collective against the reference's under ``shard_map`` at D = 1, 2,
  4, 8: gathers and permutes exact, sums within 1e-12;
- ``plan_partition`` and ``partition_graph`` equal to the reference's for
  every strategy and D, array for array; the per-slot CSR pointers, which
  the reference builds only for the prefix-sum impls, equal its pointers
  but in the last entry, where the port's row holds the padding edges;
- ``run_pagerank_sharded`` for every strategy, D and impl within 1e-12 of
  the reference's in float64 and within 1e-9 L1 of the single-device run;
  dangling drop with init one, personalization, ``tol``, checkpoint and
  resume, ``auto`` and the refusals;
- float32 ``nodes`` and ``nodes_balanced`` at D = 2 and 4 bit for bit equal
  to the single-device run (their float64 dangling-mass psum);
- ``auto_select_strategy``'s choice equal to the reference's at a given
  ``hbm_bytes``;
- the elastic mesh shrink: the same ``chaos`` plan through both packages
  gives the same ordered ``(event, site, ladder, devices_old,
  devices_new)`` records; a whole-backend loss, which the reference's rung
  takes and the port's does not, exhausts in the port;
- ``run_tfidf_sharded`` against the reference and against the port's own
  streaming run (equal bits), with its shrink;
- ``--mesh`` through the PageRank and TF-IDF CLIs on the CPU, equal to the
  API and to the JAX CLI.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from page_rank_and_tfidf_using_apache_spark_tpu import ResilienceExhausted as JExhausted
from page_rank_and_tfidf_using_apache_spark_tpu.cli import pagerank as jpcli
from page_rank_and_tfidf_using_apache_spark_tpu.cli import tfidf as jtcli
from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import collectives as jcoll
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import mesh as jmesh
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import pagerank_sharded as jps
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import tfidf_sharded as jts
from page_rank_and_tfidf_using_apache_spark_tpu.parallel.compat import shard_map
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import elastic as jelastic
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.metrics import MetricsRecorder as JMetrics
from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted
from page_rank_and_tfidf_using_apache_spark_tpu_torch import parallel
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as tpcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as ttcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import pagerank_sharded as tps
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import tfidf_sharded as tts
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

TINY = "tests/fixtures/tiny.txt"
F64 = dict(dangling="redistribute", init="uniform", dtype="float64")
CFG = dict(iterations=30, **F64)
DS = (1, 2, 4, 8)
EDGE_STRATEGIES = ("edges", "nodes", "nodes_balanced", "src", "src_ring")


def cpu_mesh(d: int, axis: str = pmesh.NODES_AXIS) -> pmesh.Mesh:
    return pmesh.make_mesh(d, axis, devices=["cpu"] * d)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """Quick backoff, no plan from the env, both health registries empty."""
    monkeypatch.setenv("GRAFT_BACKOFF_BASE_S", "0.001")
    for k in ("GRAFT_CHAOS", "GRAFT_SYNC_DEADLINE_S", "GRAFT_STEP_DEADLINE_S",
              "GRAFT_RETRY_MAX", "GRAFT_ELASTIC", "PR_TFIDF_HBM_BYTES"):
        monkeypatch.delenv(k, raising=False)
    elastic.reset_health()
    jelastic.reset_health()
    yield
    elastic.reset_health()
    jelastic.reset_health()


@pytest.fixture(scope="module")
def graphs():
    """The reference's small power-law graph (tests/test_parallel.py:25-26),
    built by both packages."""
    return tg.synthetic_powerlaw(500, 3000, seed=42), jg.synthetic_powerlaw(500, 3000, seed=42)


@pytest.fixture(scope="module")
def single(graphs):
    return run_pagerank(graphs[0], tcfg.PageRankConfig(**CFG), device="cpu").ranks


# ------------------------------------------------------------- the mesh


def test_mesh_slots_ids_and_repeats():
    m = cpu_mesh(4, "batch")
    assert m.size == 4 and m.axis == "batch"
    assert [s.id for s in m.slots] == [0, 1, 2, 3]
    assert m.devices == [torch.device("cpu")] * 4
    # a rebuilt mesh keeps its slots' ids
    kept = pmesh.rebuild_mesh([m.slots[0], m.slots[2]], "batch")
    assert [s.id for s in kept.slots] == [0, 2] and kept.axis == "batch"
    with pytest.raises(ValueError, match="requested 5 devices but only 4 available"):
        pmesh.make_mesh(5, devices=["cpu"] * 4)


def test_make_mesh_counts_visible_cards(monkeypatch):
    """With no ``devices`` the mesh spans the visible cards, and asking for
    more raises the reference's message; without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="available"):
        jmesh.make_mesh(99)


def test_shrink_helpers_equal_the_references():
    assert [pmesh.largest_pow2(n) for n in (0, 1, 2, 3, 5, 8)] == \
        [jmesh.largest_pow2(n) for n in (0, 1, 2, 3, 5, 8)]
    m = cpu_mesh(3)
    assert [s.id for s in pmesh.shrink_devices(m.slots)] == [0, 1]
    assert pmesh.shrink_devices([]) == []


def test_placement_helpers():
    m = cpu_mesh(4)
    host = np.arange(8.0)
    rep = pmesh.replicated(m, host)
    assert len(rep) == 4 and all((t.numpy() == host).all() for t in rep)
    blocks = pmesh.sharded_along(m, host)
    assert [t.tolist() for t in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    rep[0][0] = 9.0  # copies, not views of the host array or of each other
    assert host[0] == 0.0 and rep[1][0] == 0.0
    with pytest.raises(ValueError, match="equal blocks"):
        pmesh.sharded_along(m, np.arange(6.0))


# ---------------------------------------------------------- collectives

# (per-slot input shape at D slots, port fn, reference fn inside shard_map)
COLLECTIVES = {
    "psum": (lambda d: (16,), coll.psum, jcoll.psum),
    "pmax": (lambda d: (16,), coll.pmax, jcoll.pmax),
    "all_gather": (lambda d: (16,), coll.all_gather, jcoll.all_gather),
    "reduce_scatter": (lambda d: (d * 16,), coll.reduce_scatter, jcoll.reduce_scatter),
    "ring_reduce_scatter": (lambda d: (d * 16,), coll.ring_reduce_scatter,
                            jcoll.ring_reduce_scatter),
    "ppermute_ring": (lambda d: (16,), coll.ppermute_ring, jcoll.ppermute_ring),
    "ppermute_ring_shift2": (lambda d: (16,), lambda xs: coll.ppermute_ring(xs, shift=2),
                             lambda v, a: jcoll.ppermute_ring(v, a, shift=2)),
    "butterfly_all_gather": (lambda d: (5, 3), coll.butterfly_all_gather,
                             jcoll.butterfly_all_gather),
}
EXACT = {"all_gather", "ppermute_ring", "ppermute_ring_shift2", "butterfly_all_gather", "pmax"}


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_equals_the_references(name, d):
    shape_of, port_fn, ref_fn = COLLECTIVES[name]
    shape = shape_of(d)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((d,) + shape)
    got = port_fn([torch.from_numpy(x[i]) for i in range(d)])
    assert len(got) == d
    got = np.stack([t.numpy() for t in got])

    mesh = jmesh.make_mesh(d)
    axis = mesh.axis_names[0]
    spec = P(axis, *([None] * len(shape)))
    out_rank = got.ndim - 1
    mapped = shard_map(lambda v: ref_fn(v[0], axis)[None], mesh=mesh, in_specs=spec,
                       out_specs=P(axis, *([None] * out_rank)), check_vma=False)
    want = np.asarray(jax.jit(mapped)(x))
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("d", DS)
def test_sums_run_slot_0_first(d):
    """psum and reduce_scatter add left to right from slot 0, so the result
    is the same float every run and equal to that sequential sum."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((d, d * 4)).astype(np.float32)
    want = x[0].copy()
    for i in range(1, d):
        want = want + x[i]
    xs = [torch.from_numpy(x[i]) for i in range(d)]
    for got in (coll.psum(xs)[d - 1], torch.cat(coll.reduce_scatter(xs))):
        np.testing.assert_array_equal(got.numpy(), want)
    assert coll.axis_size(xs) == d and coll.axis_index(xs) == list(range(d))


def test_butterfly_refuses_non_pow2():
    with pytest.raises(ValueError, match="power-of-two"):
        coll.butterfly_all_gather([torch.zeros(2)] * 3)


# ------------------------------------------------------------ partitions

PLAN_FIELDS = ("strategy", "n", "n_pad", "block", "e_dev", "pad_frac", "head",
               "comm_entries_per_step")


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("strategy", tps.STRATEGIES)
def test_plan_and_partition_equal_the_references(graphs, strategy, d):
    g, jgr = graphs
    plan = tps.plan_partition(g, d, strategy=strategy)
    jplan = jps.plan_partition(jgr, d, strategy=strategy)
    for f in PLAN_FIELDS:
        assert getattr(plan, f) == getattr(jplan, f), f
    for f in ("bounds_nodes", "ebounds", "per"):
        a, b = getattr(plan, f), getattr(jplan, f)
        assert (a is None and b is None) or np.array_equal(a, b), f

    sg = tps.partition_graph(g, d, strategy=strategy, dtype="float64")
    jsg = jps.partition_graph(jgr, d, strategy=strategy, dtype="float64")
    for f in ("strategy", "n", "n_pad", "block", "pad_frac"):
        assert getattr(sg, f) == getattr(jsg, f), f
    for f in ("src", "dst", "valid", "inv_outdeg", "dangling", "node_map",
              "head_src", "head_node"):
        a, b = getattr(sg, f), getattr(jsg, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    if strategy == "owned":
        for f in sg.owned._fields:
            np.testing.assert_array_equal(getattr(sg.owned, f), getattr(jsg.owned, f), f)
        return
    # the pointers: the reference's where it builds them (the prefix-sum
    # impls) but in the last entry, which holds the padding edges
    ptr = sg.local_indptr
    assert ptr.dtype == np.int32 and (ptr[:, -1] == sg.src.shape[1]).all()
    assert (np.diff(ptr, axis=1) >= 0).all()
    if strategy != "hybrid":
        ref = jps.partition_graph(jgr, d, strategy=strategy, dtype="float64",
                                  need_local_indptr=True).local_indptr
        np.testing.assert_array_equal(ptr[:, :-1], ref[:, :-1])
    else:
        real = [int((sg.head_src[i] != sg.n_pad).any(axis=1).sum()) for i in range(d)]
        assert sg.head_rows.tolist() == real


def test_partition_arrays_stay_int32(graphs):
    for strategy in tps.STRATEGIES:
        sg = tps.partition_graph(graphs[0], 4, strategy=strategy)
        for f in ("src", "dst", "local_indptr", "head_src", "head_node"):
            a = getattr(sg, f)
            assert a is None or a.dtype == np.int32, (strategy, f)


# ------------------------------------------------------ sharded PageRank

RUNS = ([(s, i) for s in EDGE_STRATEGIES for i in ("segment", "cumsum", "cumsum_mxu")]
        + [("hybrid", "segment"), ("owned", "segment")])


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("strategy, impl", RUNS)
def test_sharded_pagerank_equals_the_references(graphs, single, strategy, impl, d):
    g, jgr = graphs
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**CFG, spmv_impl=impl),
                                   mesh=cpu_mesh(d), strategy=strategy)
    want = jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**CFG, spmv_impl=impl),
                                    n_devices=d, strategy=strategy).ranks
    assert res.iterations == 30
    assert np.abs(res.ranks - want).max() <= 1e-12
    assert np.abs(res.ranks - single).sum() <= 1e-9


@pytest.mark.parametrize("case", ["drop_one_init", "personalized", "tolerance"])
def test_sharded_semantics_flags(graphs, case):
    g, jgr = graphs
    kw = {"drop_one_init": dict(iterations=10, dtype="float64"),
          "personalized": dict(iterations=40, personalize=(3, 17), **F64),
          "tolerance": dict(iterations=500, tol=1e-10, **F64)}[case]
    strategy = "nodes" if case == "personalized" else "edges"
    d = 8 if case == "personalized" else 4
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**kw), mesh=cpu_mesh(d),
                                   strategy=strategy)
    want = jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**kw), n_devices=d,
                                    strategy=strategy)
    base = run_pagerank(g, tcfg.PageRankConfig(**kw), device="cpu")
    assert np.abs(res.ranks - want.ranks).max() <= 1e-12
    assert np.abs(res.ranks - base.ranks).sum() <= 1e-9
    assert res.iterations == want.iterations
    if case == "tolerance":
        assert res.iterations < 500 and res.l1_delta <= 1e-10


@pytest.mark.parametrize("strategy", ["edges", "src_ring", "owned"])
def test_sharded_checkpoint_resume(graphs, strategy, tmp_path):
    g = graphs[0]
    full = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**CFG), mesh=cpu_mesh(4),
                                    strategy=strategy)
    ck = dict(checkpoint_every=5, checkpoint_dir=str(tmp_path / "ck"), **F64)
    tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=10, **ck), mesh=cpu_mesh(4),
                             strategy=strategy)
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=30, **ck),
                                   mesh=cpu_mesh(4), strategy=strategy, resume=True)
    np.testing.assert_array_equal(res.ranks, full.ranks)
    assert res.iterations == 30
    assert any(r.get("event") == "resume" for r in res.metrics.records)


@pytest.mark.parametrize("refusal", ["spark_exact", "pallas", "hybrid_impl", "bcoo",
                                     "sort_shuffle", "owned_cumsum", "weighted_hybrid",
                                     "owned_non_pow2", "unknown"])
def test_refusals_are_the_references(graphs, refusal):
    g, jgr = graphs
    strategy, kw, exc = {
        "spark_exact": ("edges", dict(spark_exact=True), NotImplementedError),
        "pallas": ("edges", dict(spmv_impl="pallas"), NotImplementedError),
        "hybrid_impl": ("edges", dict(spmv_impl="hybrid"), NotImplementedError),
        "bcoo": ("nodes", dict(spmv_impl="bcoo"), NotImplementedError),
        "sort_shuffle": ("src", dict(spmv_impl="sort_shuffle"), NotImplementedError),
        "owned_cumsum": ("owned", dict(spmv_impl="cumsum"), NotImplementedError),
        "weighted_hybrid": ("hybrid", {}, NotImplementedError),
        "owned_non_pow2": ("owned", {}, ValueError),
        "unknown": ("rows", {}, ValueError),
    }[refusal]
    d = 3 if refusal == "owned_non_pow2" else 2
    if refusal == "weighted_hybrid":
        rng = np.random.default_rng(8)
        src, dst = rng.integers(0, 60, 400), rng.integers(0, 60, 400)
        w = rng.random(400) + 0.1
        g, jgr = tg.from_edges(src, dst, weight=w), jg.from_edges(src, dst, weight=w)
    with pytest.raises(exc):
        tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=2, **kw),
                                 mesh=cpu_mesh(d), strategy=strategy)
    with pytest.raises(exc):
        jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(iterations=2, **kw),
                                 n_devices=d, strategy=strategy)


@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("hbm", [10_000, 200_000, 8 << 30])
def test_auto_select_equals_the_references(graphs, d, hbm):
    g, jgr = graphs
    assert tps.auto_select_strategy(g, d, hbm_bytes=hbm) == \
        jps.auto_select_strategy(jgr, d, hbm_bytes=hbm)


def test_auto_strategy_run_and_budget(graphs, single):
    g = graphs[0]
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**CFG), mesh=cpu_mesh(4),
                                   strategy="auto")
    chosen = [r for r in res.metrics.records if r.get("event") == "auto_strategy"]
    assert chosen and chosen[0]["chosen"] == "hybrid"
    assert np.abs(res.ranks - single).sum() <= 1e-9
    # the budget: half of each slot's share of its device's memory
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert tps.default_hbm_bytes(["cpu"]) == host // 2 > 0
    assert tps.default_hbm_bytes(["cpu"] * 4) == host // 4 // 2


def test_weighted_sharded_matches_single(graphs):
    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, 200, 1600), rng.integers(0, 200, 1600)
    w = rng.random(1600) + 0.1
    g = tg.from_edges(src, dst, weight=w)
    base = run_pagerank(g, tcfg.PageRankConfig(iterations=20, **F64), device="cpu").ranks
    for strategy in ("edges", "nodes_balanced", "src", "owned"):
        res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=20, **F64),
                                       mesh=cpu_mesh(4), strategy=strategy)
        assert np.abs(res.ranks - base).sum() <= 1e-9, strategy


# ------------------------------------- float32 bits of the node strategies

F32_FIXED = dict(iterations=20, dangling="redistribute", init="uniform", dtype="float32")


@pytest.fixture(scope="module")
def f32_graphs():
    """Zipf graphs with many dangling nodes (Zipf sources), unweighted and
    weighted, each with its one-device float32 ranks under ``segment``."""
    g0 = tg.synthetic_zipf(4000, 40000, seed=9, src_exponent=1.2)
    w = np.random.default_rng(3).random(g0.n_edges) + 0.1
    graphs = {"unweighted": tg.synthetic_zipf(8000, 80000, seed=7, src_exponent=1.2),
              "weighted": tg.from_edges(g0.src, g0.dst, weight=w)}
    return {k: (g, run_pagerank(g, tcfg.PageRankConfig(**F32_FIXED), device="cpu").ranks)
            for k, g in graphs.items()}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("strategy", ["nodes", "nodes_balanced"])
@pytest.mark.parametrize("kind", ["unweighted", "weighted"])
def test_float32_node_strategies_have_one_devices_bits(f32_graphs, kind, strategy, d):
    """Each row sums whole on its slot, and the dangling mass crosses the
    slots in float64 and rounds once: a fixed-count float32 run equals one
    device bit for bit."""
    g, one = f32_graphs[kind]
    assert (g.out_degree == 0).sum() > g.n_nodes // 10
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**F32_FIXED), mesh=cpu_mesh(d),
                                   strategy=strategy)
    assert res.ranks.dtype == np.float32
    differ = int(np.count_nonzero(res.ranks.view(np.uint32) != one.view(np.uint32)))
    assert res.ranks.tobytes() == one.tobytes(), differ


# --------------------------------------------------------- elastic shrink


def degraded(records) -> list:
    return [(r["event"], r["site"], r["ladder"], r["devices_old"], r["devices_new"])
            for r in records if r.get("event") == "degraded"]


def partitions(records) -> list:
    return [r["devices"] for r in records if r.get("event") == "partition"]


LADDERS = {
    "4-2-1 at the step and the rerun": (
        "pagerank_step:device_lost@dev:1;pagerank_elastic_rerun:device_lost@dev:2", 4),
    "two wildcard losses": ("*:device_lost@dev:1;*:device_lost@dev:2", 4),
    "one loss of 4": ("*:device_lost@dev:3", 4),
    "2-1 at the step": ("*:device_lost@dev:1", 2),
    "at the result pull": ("pagerank_result_pull:device_lost@dev:1", 2),
}


@pytest.mark.parametrize("strategy", ["edges", "nodes_balanced", "hybrid", "owned"])
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_shrink_ladder_records_are_the_references(strategy, ladder, tmp_path):
    plan, d = LADDERS[ladder]
    g, jgr = tg.synthetic_powerlaw(800, 3200, seed=17), jg.synthetic_powerlaw(800, 3200, seed=17)
    kw = dict(iterations=8, checkpoint_every=4, **F64)
    base = run_pagerank(g, tcfg.PageRankConfig(iterations=8, **F64), device="cpu").ranks
    m, jm_ = MetricsRecorder(), JMetrics()
    with chaos.inject(plan):
        res = tps.run_pagerank_sharded(
            g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
            mesh=cpu_mesh(d), strategy=strategy, metrics=m)
    with jchaos.inject(plan):
        want = jps.run_pagerank_sharded(
            jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")),
            n_devices=d, strategy=strategy, metrics=jm_)
    assert degraded(m.records) and degraded(m.records) == degraded(jm_.records)
    assert partitions(m.records) == partitions(jm_.records)
    assert elastic.health().lost() == jelastic.health().lost()
    assert res.iterations == want.iterations == 8
    # the shrink changes D and with it the order of the sums
    assert np.abs(res.ranks - base).sum() <= 1e-9
    assert np.abs(res.ranks - want.ranks).max() <= 1e-12
    iters = [r["iter"] for r in m.records if "iter" in r and "l1_delta" in r]
    assert iters == sorted(set(iters))  # no committed iteration recomputed


def test_shrink_span_and_event_in_the_trace(tmp_path):
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs

    g = tg.synthetic_powerlaw(300, 1200, seed=6)
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    try:
        with chaos.inject("*:device_lost@dev:1"):
            tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=6, **F64),
                                     mesh=cpu_mesh(2))
    finally:
        obs.bus().detach(sink)
    ev = sink.of_kind("degraded")
    assert [(e["site"], e["ladder"], e["devices_old"], e["devices_new"]) for e in ev] == \
        [("pagerank_step", "single_device", 2, 1)]
    spans = [e for e in sink.of_kind("span_end") if e.get("name") == "mesh.shrink"]
    assert len(spans) == 1


def test_whole_backend_loss_exhausts_where_the_reference_shrinks(tmp_path):
    """By design (ROADMAP Queue 3): the port's rungs take only a loss that
    names its slot, so a whole-backend ``lost`` exhausts with the newest
    checkpoint; the reference's rung halves the mesh."""
    g, jgr = tg.synthetic_powerlaw(400, 1600, seed=3), jg.synthetic_powerlaw(400, 1600, seed=3)
    kw = dict(iterations=6, checkpoint_every=3, **F64)
    m, jm_ = MetricsRecorder(), JMetrics()
    with chaos.inject("pagerank_step:lost@2"), pytest.raises(ResilienceExhausted) as ei:
        tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                                 mesh=cpu_mesh(4), metrics=m)
    assert ei.value.last_checkpoint and ei.value.last_checkpoint.endswith("00000003.npz")
    assert degraded(m.records) == []
    with jchaos.inject("pagerank_step:lost@2"):
        jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")),
                                 n_devices=4, metrics=jm_)
    assert degraded(jm_.records) == [("degraded", "pagerank_step", "mesh_shrink", 4, 2)]


def test_loss_at_the_checkpoint_pull_shrinks_where_the_reference_exhausts(tmp_path):
    """By design (ROADMAP Queue 3): a loss first surfacing at the checkpoint
    pull reaches the rung wrapped in the pull's ``ResilienceExhausted``; the
    port's rung sees through the wrapper (``unwrap_device_loss``), as its
    single-device salvage does, and shrinks; the reference's sharded rung
    does not and exhausts."""
    g, jgr = tg.synthetic_powerlaw(800, 3200, seed=17), jg.synthetic_powerlaw(800, 3200, seed=17)
    kw = dict(iterations=8, checkpoint_every=4, **F64)
    base = run_pagerank(g, tcfg.PageRankConfig(iterations=8, **F64), device="cpu").ranks
    m = MetricsRecorder()
    with chaos.inject("pagerank_ckpt_pull:device_lost@dev:2"):
        res = tps.run_pagerank_sharded(
            g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
            mesh=cpu_mesh(4), metrics=m)
    assert degraded(m.records) == [("degraded", "pagerank_step", "mesh_shrink", 4, 2)]
    assert np.abs(res.ranks - base).sum() <= 1e-9 and res.iterations == 8
    with jchaos.inject("pagerank_ckpt_pull:device_lost@dev:2"), pytest.raises(JExhausted):
        jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")),
                                 n_devices=4)


def test_elastic_disabled_exhausts_in_both(monkeypatch, tmp_path):
    monkeypatch.setenv("GRAFT_ELASTIC", "0")
    g, jgr = tg.synthetic_powerlaw(400, 1600, seed=3), jg.synthetic_powerlaw(400, 1600, seed=3)
    kw = dict(iterations=6, checkpoint_every=3, **F64)
    with chaos.inject("*:device_lost@dev:1"), pytest.raises(ResilienceExhausted):
        tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
                                 mesh=cpu_mesh(2))
    with jchaos.inject("*:device_lost@dev:1"), pytest.raises(JExhausted):
        jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")),
                                 n_devices=2)


def test_plan_shrink_rungs_equal_the_references():
    m = cpu_mesh(4)
    jdevs = jax.devices()[:4]
    for k in (3, 1):
        elastic.health().mark_lost(k)
        jelastic.health().mark_lost(jdevs[k].id)
    got = elastic.plan_shrink(m.slots[:4])
    want = jelastic.plan_shrink(jdevs)
    assert (got.old_count, got.new_count, got.rung) == (want.old_count, want.new_count, want.rung)
    assert [s.id for s in got.devices] == [d.id for d in want.devices]
    # an unattributed loss still halves
    elastic.reset_health()
    jelastic.reset_health()
    got, want = elastic.plan_shrink(m.slots), jelastic.plan_shrink(jdevs)
    assert (got.old_count, got.new_count, got.rung) == (want.old_count, want.new_count,
                                                         want.rung) == (4, 2, "mesh_shrink")
    # every CPU slot lost: no CPU to fall to
    for s in m.slots:
        elastic.health().mark_lost(s.id)
    assert elastic.plan_shrink(m.slots) is None


def test_plan_shrink_cpu_rung_for_lost_cards():
    """Every card slot lost (a probe that raises marks its slot): one CPU
    slot hosts the mesh, the ``cpu`` rung."""
    slots = [pmesh.Slot(i, torch.device("cuda", 0)) for i in range(2)]
    elastic.health().mark_lost(0)
    plan = elastic.plan_shrink(slots)
    if torch.cuda.is_available():  # pragma: no cover - a card answers the probe
        assert plan.rung == "single_device"
        return
    assert plan.rung == "cpu" and (plan.old_count, plan.new_count) == (2, 1)
    assert plan.devices[0].device == torch.device("cpu")
    assert elastic.health().lost() == frozenset({0, 1})


# ---------------------------------------------------------- sharded TF-IDF

DOCS = [f"w{i % 7} w{i % 3} common tail{i}" for i in range(40)]
CHUNKS = [DOCS[i: i + 5] for i in range(0, 40, 5)]


@pytest.mark.parametrize("d", [2, 4, 8])
def test_tfidf_sharded_equals_streaming_and_reference(d):
    kw = dict(vocab_bits=12, idf_mode="smooth", l2_normalize=True)
    out = tts.run_tfidf_sharded(iter(CHUNKS), tcfg.TfidfConfig(**kw), mesh=cpu_mesh(d, "data"))
    base = tm.run_tfidf_streaming(iter(CHUNKS), tcfg.TfidfConfig(**kw), device="cpu")
    want = jts.run_tfidf_sharded(iter(CHUNKS), jcfg.TfidfConfig(**kw), n_devices=d)
    for f in ("doc", "term", "count", "df", "idf", "weight"):
        np.testing.assert_array_equal(getattr(out, f), getattr(base, f), f)
    assert out.n_docs == want.n_docs
    np.testing.assert_array_equal(out.df, want.df)
    np.testing.assert_allclose(out.to_dense(), want.to_dense(), rtol=0, atol=2e-6)
    sc = [r for r in out.metrics.records if r.get("event") == "super_chunk"]
    assert sum(r["devices"] for r in sc) == len(CHUNKS)


def test_tfidf_sharded_uneven_tail():
    docs = [f"a b c d{i}" for i in range(11)]
    chunks = [docs[i: i + 2] for i in range(0, 11, 2)]  # 6 chunks, 4 slots
    out = tts.run_tfidf_sharded(iter(chunks), tcfg.TfidfConfig(vocab_bits=10),
                                mesh=cpu_mesh(4, "data"))
    want = jts.run_tfidf_sharded(iter(chunks), jcfg.TfidfConfig(vocab_bits=10), n_devices=4)
    np.testing.assert_allclose(out.to_dense(), want.to_dense(), rtol=0, atol=2e-6)


def test_tfidf_sharded_checkpoint_resume(tmp_path):
    # serial, so the chunks before the source's death drain and checkpoint
    cfg = tcfg.TfidfConfig(vocab_bits=10, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                           prefetch=0, pipeline_depth=0)
    full = tts.run_tfidf_sharded(iter(CHUNKS), tcfg.TfidfConfig(vocab_bits=10),
                                 mesh=cpu_mesh(2, "data"))

    def dies():
        yield from CHUNKS[:5]
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        tts.run_tfidf_sharded(dies(), cfg, mesh=cpu_mesh(2, "data"))
    res = tts.run_tfidf_sharded(iter(CHUNKS), cfg, mesh=cpu_mesh(2, "data"), resume=True)
    np.testing.assert_array_equal(res.to_dense(), full.to_dense())
    assert any(r.get("event") == "resume" for r in res.metrics.records)


def _chunks(n_chunks: int, per: int = 2) -> list:
    docs = [f"tok{i} tok{i % 5} shared word extra{i % 3}" for i in range(n_chunks * per)]
    return [docs[i:i + per] for i in range(0, len(docs), per)]


@pytest.mark.parametrize("plan, d", [("*:device_lost@dev:1;*:device_lost@dev:2", 4),
                                     ("*:device_lost@dev:1", 2),
                                     ("tfidf_shard_sync:device_lost@dev:3", 4)])
def test_tfidf_shrink_records_are_the_references(plan, d, tmp_path):
    ch = _chunks(12)
    m, jm_ = MetricsRecorder(), JMetrics()
    ck = dict(vocab_bits=10, checkpoint_every=4)
    with chaos.inject(plan):
        res = tts.run_tfidf_sharded(iter(ch), tcfg.TfidfConfig(**ck, checkpoint_dir=str(
            tmp_path / "p")), mesh=cpu_mesh(d, "data"), metrics=m)
    with jchaos.inject(plan):
        want = jts.run_tfidf_sharded(iter(ch), jcfg.TfidfConfig(**ck, checkpoint_dir=str(
            tmp_path / "j")), n_devices=d, metrics=jm_)
    assert degraded(m.records) and degraded(m.records) == degraded(jm_.records)
    sc = [r for r in m.records if r.get("event") == "super_chunk"]
    assert sum(r["devices"] for r in sc) == 12  # no chunk reprocessed
    base = tm.run_tfidf_streaming(iter(ch), tcfg.TfidfConfig(vocab_bits=10), device="cpu")
    np.testing.assert_array_equal(res.to_dense(), base.to_dense())
    np.testing.assert_allclose(res.to_dense(), want.to_dense(), rtol=0, atol=2e-6)


# ------------------------------------------------------------------ CLIs


def _rank_lines(path) -> dict:
    out = {}
    for line in open(path):
        k, v = line.split("\t")
        out[int(k)] = float(v)
    return out


@pytest.mark.parametrize("strategy", ["auto", "nodes_balanced", "src_ring", "owned"])
def test_pagerank_cli_mesh_equals_the_api_and_the_jax_cli(strategy, tmp_path):
    args = [TINY, "20", "--dtype", "float64", "--dangling", "redistribute",
            "--mesh", "4", "--shard-strategy", strategy]
    assert tpcli.main([*args, "--device", "cpu", "--output", str(tmp_path / "p.txt")]) == 0
    assert jpcli.main([*args, "--tuned-profile", "off", "--output", str(tmp_path / "j.txt")]) == 0
    g = tg.load_snap(TINY)
    api = tps.run_pagerank_sharded(
        g, tcfg.PageRankConfig(iterations=20, dtype="float64", dangling="redistribute"),
        mesh=cpu_mesh(4), strategy=strategy).ranks
    port, jax_ = _rank_lines(tmp_path / "p.txt"), _rank_lines(tmp_path / "j.txt")
    assert set(port) == set(jax_) == {int(i) for i in g.node_ids}
    for i, node in enumerate(g.node_ids):
        assert port[int(node)] == float(f"{api[i]:.10g}")
        assert abs(port[int(node)] - jax_[int(node)]) <= 1e-9


def test_tfidf_cli_mesh_equals_streaming_and_the_jax_cli(tmp_path, capsys):
    common = [TINY, "--lines", "--streaming", "--chunk-docs", "2", "--vocab-bits", "10",
              "--idf-mode", "smooth", "--l2-normalize"]
    assert ttcli.main([*common, "--mesh", "4", "--device", "cpu",
                       "--output", str(tmp_path / "m.tsv")]) == 0
    assert ttcli.main([*common, "--device", "cpu", "--output", str(tmp_path / "s.tsv")]) == 0
    assert jtcli.main([*common, "--mesh", "4", "--tuned-profile", "off",
                       "--output", str(tmp_path / "j.tsv")]) == 0
    mesh_lines = (tmp_path / "m.tsv").read_text().splitlines()
    assert mesh_lines == (tmp_path / "s.tsv").read_text().splitlines() and mesh_lines
    jax_lines = (tmp_path / "j.tsv").read_text().splitlines()
    assert [ln.split("\t")[:2] for ln in mesh_lines] == [ln.split("\t")[:2] for ln in jax_lines]
    for a, b in zip(mesh_lines, jax_lines):
        assert abs(float(a.split("\t")[2]) - float(b.split("\t")[2])) <= 2e-6
    with pytest.raises(SystemExit, match="requires --streaming"):
        ttcli.main([TINY, "--lines", "--mesh", "2", "--device", "cpu"])
    capsys.readouterr()


def test_cli_mesh_beyond_the_visible_cards(monkeypatch, tmp_path):
    """``--mesh 2`` on a one-card machine: the reference's message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        tpcli.main([TINY, "5", "--mesh", "2", "--tuned-profile", "off",
                    "--output", str(tmp_path / "r.txt")])
    assert not (tmp_path / "r.txt").exists()


def test_parallel_surface_is_the_references():
    from page_rank_and_tfidf_using_apache_spark_tpu import parallel as jparallel

    assert set(parallel.__all__) == set(jparallel.__all__)
    for name in parallel.__all__:
        assert hasattr(parallel, name), name
