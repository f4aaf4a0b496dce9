"""The ``owned`` strategy of the port (``..._torch/ops/boundary.py``,
``dataflow/partition.py`` and the owned runner of
``parallel/pagerank_sharded.py``) against the JAX package's, on the CPU.

- the host planner is the reference's copy: ``plan_owned_head``,
  ``plan_owned`` (with and without a fixed ownership) and
  ``build_owned_shard`` give equal arrays at every slot count, the
  reference's ``comm_entries_per_step``, and a numpy simulation of one
  owned step over the port's shard reproduces the dense SpMV;
- ``pack_boundary`` and ``boundary_lookup`` on torch equal the
  reference's on ``jnp``;
- ``PartitionedArray`` and ``OwnedArray`` put and pull a logical array
  unchanged over CPU slots;
- owned PageRank: slot-count invariance against the single-device run and
  the reference within 1e-12, the lagged delta under ``tol``, drop with
  init one, personalization, checkpoint and resume, its refusals, a
  weighted graph, and the 4 -> 2 -> 1 shrink with the reference's records;
- float32 owned bit for bit equal to a one-device run at D = 1, 2, 4, 8
  and across the 4 -> 2 -> 1 shrink (its head partials and dangling mass
  summed in float64 and rounded once), and the widened segmented sum
  under it: the float64 sum of the float32 products.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.ops import boundary as job
from page_rank_and_tfidf_using_apache_spark_tpu.parallel import pagerank_sharded as jps
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import elastic as jelastic
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.metrics import MetricsRecorder as JMetrics
from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.partition import (
    OwnedArray,
    PartitionedArray,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import boundary as ob
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import pagerank_sharded as tps
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

F64 = dict(dangling="redistribute", init="uniform", dtype="float64")
F32 = dict(dangling="redistribute", init="uniform", dtype="float32")


def cpu_mesh(d: int) -> pmesh.Mesh:
    return pmesh.make_mesh(d, devices=["cpu"] * d)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.setenv("GRAFT_BACKOFF_BASE_S", "0.001")
    for k in ("GRAFT_CHAOS", "GRAFT_ELASTIC", "GRAFT_RETRY_MAX"):
        monkeypatch.delenv(k, raising=False)
    elastic.reset_health()
    jelastic.reset_health()
    yield
    elastic.reset_health()
    jelastic.reset_health()


@pytest.fixture(scope="module")
def graphs():
    """The reference's owned test graph (tests/test_owned.py:80-82)."""
    return tg.synthetic_powerlaw(600, 3600, seed=33), jg.synthetic_powerlaw(600, 3600, seed=33)


# ----------------------------------------------------- the host planner


@pytest.mark.parametrize("coverage, max_head", [(0.5, 4096), (0.25, 16), (0.75, 0)])
def test_plan_owned_head_is_the_references(graphs, coverage, max_head):
    g, _ = graphs
    indeg = np.diff(g.csr_indptr())
    args = (indeg, g.out_degree, g.n_edges)
    np.testing.assert_array_equal(
        ob.plan_owned_head(*args, coverage=coverage, max_head=max_head),
        job.plan_owned_head(*args, coverage=coverage, max_head=max_head))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("max_head", [4096, 8, 0])
def test_plan_and_shard_are_the_references(graphs, d, max_head):
    g, jgr = graphs
    plan = ob.plan_owned(g, d, max_head=max_head)
    jplan = job.plan_owned(jgr, d, max_head=max_head)
    for f in plan._fields:
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f), f)
    assert plan.comm_entries_per_step() == jplan.comm_entries_per_step()
    for dtype in ("float32", "float64"):
        shard = ob.build_owned_shard(g, plan, dtype)
        jshard = job.build_owned_shard(jgr, jplan, dtype)
        for f in shard._fields:
            a, b = getattr(shard, f), getattr(jshard, f)
            np.testing.assert_array_equal(a, b, f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert shard.zero_slot == jshard.zero_slot


def test_fixed_ownership_plan_is_the_references(graphs):
    """The reverse plan of HITS/CC: the forward plan's head and bounds over
    the transposed graph."""
    from page_rank_and_tfidf_using_apache_spark_tpu.parallel import workloads_sharded as jws
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import workloads_sharded as tws

    g, jgr = graphs
    fwd = ob.plan_owned(g, 4, max_head=0)
    rev = ob.plan_owned(tws.transpose_graph(g), 4, max_head=0, head_ids=fwd.head_ids,
                        bounds=fwd.bounds)
    jfwd = job.plan_owned(jgr, 4, max_head=0)
    jrev = job.plan_owned(jws.transpose_graph(jgr), 4, max_head=0, head_ids=jfwd.head_ids,
                          bounds=jfwd.bounds)
    for f in rev._fields:
        np.testing.assert_array_equal(getattr(rev, f), getattr(jrev, f), f)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_comm_entries_per_step_is_the_references(d):
    for b_pad, h_pad in ((1, 1), (64, 1024), (4096, 4096)):
        assert ob.comm_entries_per_step(d, b_pad, h_pad) == \
            job.comm_entries_per_step(d, b_pad, h_pad)


def _numpy_owned_step(graph, shard, ranks_g):
    """One owned iteration in numpy from the shard's arrays: exchange,
    lookup, both combines, the head psum; and the dense SpMV."""
    d, block, h_pad = shard.d, shard.block, shard.h_pad
    strength = graph.out_strength()
    inv = np.where(strength > 0, 1.0 / np.where(strength > 0, strength, 1), 0)
    tail, head = ob.split_global(shard, ranks_g * inv, "float64")
    btable = np.concatenate([tail[j * block:(j + 1) * block][shard.out_idx[j]]
                             for j in range(d)])
    contribs = np.zeros(graph.n_nodes)
    hbuf = np.zeros(h_pad + 2)
    mask = shard.tail_map >= 0
    for i in range(d):
        lk = np.concatenate([tail[i * block:(i + 1) * block], btable, head, [0.0]])
        tgt = np.zeros(block)
        np.add.at(tgt, shard.tail_dst[i], lk[shard.tail_src_idx[i]] * shard.tail_w[i])
        slots = shard.tail_map[mask]
        sel = (slots >= i * block) & (slots < (i + 1) * block)
        contribs[np.flatnonzero(mask)[sel]] += tgt[slots[sel] - i * block]
        np.add.at(hbuf, shard.head_slot[i], lk[shard.head_src_idx[i]] * shard.head_w[i])
    contribs[shard.head_ids] += hbuf[: shard.h]
    ref = np.zeros(graph.n_nodes)
    np.add.at(ref, graph.dst, (ranks_g * inv)[graph.src])
    return contribs, ref


@pytest.mark.parametrize("d", [2, 4, 8])
def test_boundary_covers_every_cut_edge(graphs, d):
    g, _ = graphs
    shard = ob.build_owned_shard(g, ob.plan_owned(g, d), "float64")
    got, ref = _numpy_owned_step(g, shard, np.random.default_rng(1).random(g.n_nodes))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_step_helpers_are_the_references():
    rng = np.random.default_rng(4)
    wt, bt, wh = rng.random(9), rng.random(12), rng.random(4)
    idx = np.array([0, 8, 3, 3, 1], np.int32)
    np.testing.assert_array_equal(
        ob.pack_boundary(torch.from_numpy(wt), torch.from_numpy(idx)).numpy(),
        np.asarray(job.pack_boundary(jnp.asarray(wt), jnp.asarray(idx))))
    for fill in (0, 7.5):
        np.testing.assert_array_equal(
            ob.boundary_lookup(*(torch.from_numpy(a) for a in (wt, bt, wh)), fill=fill).numpy(),
            np.asarray(job.boundary_lookup(jnp.asarray(wt), jnp.asarray(bt), jnp.asarray(wh),
                                           fill=fill)))
    labels = torch.arange(5, dtype=torch.int32)
    big = torch.iinfo(torch.int32).max
    lk = ob.boundary_lookup(labels, labels, labels.new_full((1,), big), fill=big)
    assert lk.dtype == torch.int32 and int(lk[-1]) == big


def test_owned_partition_covers_all_edges(graphs):
    sh = tps.partition_graph(graphs[0], 8, strategy="owned").owned
    assert int((sh.tail_w != 0).sum() + (sh.head_w != 0).sum()) == graphs[0].n_edges


# ------------------------------------------------------ the dataflow types


@pytest.mark.parametrize("d", [1, 2, 4])
def test_owned_array_roundtrip(graphs, d):
    g, _ = graphs
    shard = ob.build_owned_shard(g, ob.plan_owned(g, d), "float64")
    v = np.random.default_rng(0).random(g.n_nodes)
    arr = OwnedArray.from_shard(shard, mesh=cpu_mesh(d)).put(v, "float64")
    assert len(arr.tail) == d and all(t.shape == (shard.block,) for t in arr.tail)
    assert all((h.numpy() == arr.head[0].numpy()).all() for h in arr.head)
    np.testing.assert_array_equal(arr.pull(), v)


@pytest.mark.parametrize("strategy", ["edges", "nodes_balanced", "src"])
def test_partitioned_array_roundtrip(graphs, strategy):
    g, _ = graphs
    sg = tps.partition_graph(g, 4, strategy=strategy, need_local_indptr=False)
    replicated = strategy == "edges"
    v = np.random.default_rng(1).random(g.n_nodes)
    arr = PartitionedArray.from_plan(sg.n, sg.n_pad, sg.node_map, cpu_mesh(4),
                                     replicated).put(v, "float64")
    want = sg.n_pad if replicated else sg.block
    assert len(arr.value) == 4 and all(t.shape == (want,) for t in arr.value)
    np.testing.assert_array_equal(arr.pull(), v)


# ------------------------------------------------------ owned PageRank


@pytest.fixture(scope="module")
def single(graphs):
    return run_pagerank(graphs[0], tcfg.PageRankConfig(iterations=30, **F64),
                        device="cpu").ranks


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_owned_slot_count_invariance(graphs, single, d):
    g, jgr = graphs
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=30, **F64),
                                   mesh=cpu_mesh(d), strategy="owned")
    want = jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(iterations=30, **F64),
                                    n_devices=d, strategy="owned").ranks
    assert np.abs(res.ranks - single).sum() <= 1e-9
    assert np.abs(res.ranks - want).max() <= 1e-12


def test_owned_tolerance_and_lagged_delta(graphs):
    g, jgr = graphs
    cfg = dict(iterations=500, tol=1e-10, **F64)
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**cfg), mesh=cpu_mesh(4),
                                   strategy="owned")
    ref = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**cfg), mesh=cpu_mesh(4),
                                   strategy="edges")
    want = jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**cfg), n_devices=4,
                                    strategy="owned")
    assert res.l1_delta <= 1e-10 and res.iterations <= ref.iterations + 2
    assert res.iterations == want.iterations
    assert np.abs(res.ranks - want.ranks).max() <= 1e-12


@pytest.mark.parametrize("case", ["drop_one_init", "personalized", "float32"])
def test_owned_semantics(graphs, case):
    g, jgr = graphs
    kw = {"drop_one_init": dict(iterations=10, dtype="float64"),
          "personalized": dict(iterations=40, personalize=(3, 17), **F64),
          "float32": dict(iterations=20, **F32)}[case]
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**kw), mesh=cpu_mesh(8),
                                   strategy="owned")
    base = run_pagerank(g, tcfg.PageRankConfig(**kw), device="cpu").ranks
    want = jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**kw), n_devices=8,
                                    strategy="owned").ranks
    if case == "float32":
        f64 = run_pagerank(g, tcfg.PageRankConfig(iterations=20, **F64), device="cpu").ranks
        assert res.ranks.dtype == np.float32
        assert np.abs(res.ranks.astype(np.float64) - f64).sum() <= 1e-3
        assert np.abs(res.ranks - want).sum() <= 1e-5
    else:
        assert np.abs(res.ranks - base).sum() <= 1e-9
        assert np.abs(res.ranks - want).max() <= 1e-12


def test_owned_checkpoint_resume(graphs, tmp_path):
    g = graphs[0]
    full = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=12, **F64),
                                    mesh=cpu_mesh(4), strategy="owned")
    ck = dict(checkpoint_every=3, checkpoint_dir=str(tmp_path / "ck"), **F64)
    tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=6, **ck), mesh=cpu_mesh(4),
                             strategy="owned")
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=12, **ck),
                                   mesh=cpu_mesh(4), strategy="owned", resume=True)
    np.testing.assert_array_equal(res.ranks, full.ranks)


def test_owned_refusals(graphs):
    g, _ = graphs
    with pytest.raises(NotImplementedError, match="segment"):
        tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=2, spmv_impl="cumsum", **F64),
                                 mesh=cpu_mesh(2), strategy="owned")
    with pytest.raises(ValueError, match="power-of-two"):
        tps.plan_partition(g, 3, strategy="owned")
    with pytest.raises(ValueError, match="power-of-two"):
        tps.run_pagerank_sharded(g, tcfg.PageRankConfig(iterations=2, **F64),
                                 mesh=cpu_mesh(6), strategy="owned")


def test_owned_weighted_matches_single_and_reference():
    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, 200, 1600), rng.integers(0, 200, 1600)
    w = rng.random(1600) + 0.1
    g, jgr = tg.from_edges(src, dst, weight=w), jg.from_edges(src, dst, weight=w)
    cfg = dict(iterations=20, **F64)
    base = run_pagerank(g, tcfg.PageRankConfig(**cfg), device="cpu").ranks
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**cfg), mesh=cpu_mesh(4),
                                   strategy="owned").ranks
    want = jps.run_pagerank_sharded(jgr, jcfg.PageRankConfig(**cfg), n_devices=4,
                                    strategy="owned").ranks
    assert np.abs(res - base).sum() <= 1e-9 and np.abs(res - want).max() <= 1e-12


def test_auto_select_fallbacks_are_the_references():
    rng = np.random.default_rng(0)
    dst = np.concatenate([rng.integers(0, 4, 9000), rng.integers(4, 2000, 1000)])
    src = rng.integers(0, 2000, dst.size)
    w = rng.uniform(0.5, 2.0, dst.size)
    for weighted in (False, True):
        kw = dict(weight=w) if weighted else {}
        g, jgr = tg.from_edges(src, dst, **kw), jg.from_edges(src, dst, **kw)
        for d, hbm in ((8, 8 << 30), (8, 10_000), (6, 10_000)):
            assert tps.auto_select_strategy(g, d, hbm_bytes=hbm) == \
                jps.auto_select_strategy(jgr, d, hbm_bytes=hbm), (weighted, d, hbm)


# ------------------------------------------------ the elastic shrink, owned


def test_owned_shrink_ladder_4_2_1(tmp_path):
    """Stacked losses walk owned down 4 -> 2 -> 1, re-owning the slices each
    lap: the reference's ordered records, one partition per mesh shape,
    ranks within 1e-9 L1 of the unbroken run."""
    g, jgr = tg.synthetic_powerlaw(900, 3600, seed=21), jg.synthetic_powerlaw(900, 3600, seed=21)
    plan = "pagerank_step:device_lost@dev:1;pagerank_elastic_rerun:device_lost@dev:2"
    kw = dict(iterations=8, checkpoint_every=4, **F64)
    base = run_pagerank(g, tcfg.PageRankConfig(iterations=8, **F64), device="cpu").ranks
    m, jm_ = MetricsRecorder(), JMetrics()
    with chaos.inject(plan):
        res = tps.run_pagerank_sharded(
            g, tcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "p")),
            mesh=cpu_mesh(4), strategy="owned", metrics=m)
    with jchaos.inject(plan):
        jps.run_pagerank_sharded(
            jgr, jcfg.PageRankConfig(**kw, checkpoint_dir=str(tmp_path / "j")),
            n_devices=4, strategy="owned", metrics=jm_)

    def ladder(records):
        return [(r["event"], r["site"], r["ladder"], r["devices_old"], r["devices_new"])
                for r in records if r.get("event") == "degraded"]

    assert ladder(m.records) == ladder(jm_.records) == [
        ("degraded", "pagerank_step", "mesh_shrink", 4, 2),
        ("degraded", "pagerank_step", "single_device", 2, 1)]
    parts = [r for r in m.records if r.get("event") == "partition"]
    assert [p["devices"] for p in parts] == [4, 2, 1]
    assert all(p["comm_bytes_per_step"] is not None for p in parts)
    assert np.abs(res.ranks - base).sum() <= 1e-9 and res.iterations == 8


def test_owned_loss_at_result_pull(tmp_path):
    g = tg.synthetic_powerlaw(700, 2800, seed=11)
    base = run_pagerank(g, tcfg.PageRankConfig(iterations=8, **F64), device="cpu").ranks
    m = MetricsRecorder()
    with chaos.inject("pagerank_result_pull:device_lost@dev:1"):
        res = tps.run_pagerank_sharded(
            g, tcfg.PageRankConfig(iterations=8, checkpoint_every=4,
                                   checkpoint_dir=str(tmp_path / "ck"), **F64),
            mesh=cpu_mesh(2), strategy="owned", metrics=m)
    deg = [r for r in m.records if r.get("event") == "degraded"]
    assert [(d["ladder"], d["site"]) for d in deg] == [("single_device", "pagerank_result_pull")]
    assert np.abs(res.ranks - base).sum() <= 1e-9


# ----------------------------------- float32 owned: one device's bits at every D

F32_FIXED = dict(iterations=20, **F32)
SHRINK_PLAN = "pagerank_step:device_lost@dev:1;pagerank_elastic_rerun:device_lost@dev:2"


def _zipf_graphs() -> dict:
    """Zipf graphs with Zipf sources, so many nodes are dangling, and a hub
    head that ``owned`` replicates, whose rows the slots split: unweighted,
    and weighted.  With the float32 head partials and dangling mass the
    slots used to add, a third to a half of their entries differed from one
    device after 20 iterations; with the float32 head partials alone, some
    entries at D = 2, 4 and 8 on one graph or the other."""
    g0 = tg.synthetic_zipf(4000, 40000, seed=9, src_exponent=1.2)
    w = np.random.default_rng(3).random(g0.n_edges) + 0.1
    return {"unweighted": tg.synthetic_zipf(8000, 80000, seed=7, src_exponent=1.2),
            "weighted": tg.from_edges(g0.src, g0.dst, weight=w)}


@pytest.fixture(scope="module")
def f32_graphs():
    """Each graph and its one-device float32 ranks under ``segment``."""
    return {k: (g, run_pagerank(g, tcfg.PageRankConfig(**F32_FIXED), device="cpu").ranks)
            for k, g in _zipf_graphs().items()}


def _bits_differ(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a.view(np.uint32) != b.view(np.uint32)))


@pytest.mark.parametrize("kind", ["unweighted", "weighted"])
def test_f32_graphs_have_dangling_nodes_and_a_head(f32_graphs, kind):
    g, one = f32_graphs[kind]
    assert (g.out_degree == 0).sum() > g.n_nodes // 10
    assert tps.partition_graph(g, 4, strategy="owned").owned.h > 0
    assert one.dtype == np.float32 and np.isfinite(one).all()


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["unweighted", "weighted"])
def test_float32_owned_has_one_devices_bits(f32_graphs, kind, d):
    """A fixed-count float32 owned run equals one-device ``run_pagerank``
    bit for bit at every slot count."""
    g, one = f32_graphs[kind]
    res = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**F32_FIXED), mesh=cpu_mesh(d),
                                   strategy="owned")
    assert res.ranks.dtype == np.float32 and res.iterations == 20
    assert res.ranks.tobytes() == one.tobytes(), _bits_differ(res.ranks, one)


@pytest.mark.parametrize("kind", ["unweighted", "weighted"])
def test_float32_owned_shrink_keeps_the_unbroken_bits(f32_graphs, kind, tmp_path):
    """Under ``test_owned_shrink_ladder_4_2_1``'s plan a float32 owned run
    walks 4 -> 2 -> 1 slots and ends with the unbroken run's bits, which
    are one device's."""
    g, _ = f32_graphs[kind]
    kw = dict(iterations=8, **F32)
    one = run_pagerank(g, tcfg.PageRankConfig(**kw), device="cpu").ranks
    unbroken = tps.run_pagerank_sharded(g, tcfg.PageRankConfig(**kw), mesh=cpu_mesh(4),
                                        strategy="owned").ranks
    m = MetricsRecorder()
    with chaos.inject(SHRINK_PLAN):
        res = tps.run_pagerank_sharded(
            g, tcfg.PageRankConfig(checkpoint_every=4, checkpoint_dir=str(tmp_path / "ck"), **kw),
            mesh=cpu_mesh(4), strategy="owned", metrics=m)
    assert [r["devices"] for r in m.records if r.get("event") == "partition"] == [4, 2, 1]
    assert res.iterations == 8
    assert res.ranks.tobytes() == unbroken.tobytes() == one.tobytes(), \
        (_bits_differ(res.ranks, unbroken), _bits_differ(unbroken, one))


def _csr(rng, n: int, e: int) -> torch.Tensor:
    dst = np.sort(rng.integers(0, n, e))
    return torch.from_numpy(np.searchsorted(dst, np.arange(n + 1)).astype(np.int32))


@pytest.mark.parametrize("loader", ["values", "gather", "gather weighted"])
def test_widened_segment_sum_is_the_float64_sum_of_float32_products(loader):
    """``out_dtype=torch.float64`` on float32 values gives each row's
    float64 sum of the float32 values or products, not rounded: the float32
    rows are those sums rounded once.  The product with the edge weight is
    a float32 product, as one device takes it; a float64 one is another
    number."""
    rng = np.random.default_rng(12)
    n, e, table = 60, 900, 300
    ptr = _csr(rng, n, e)
    w = torch.from_numpy(rng.random(e if loader == "values" else table).astype(np.float32))
    src = (None if loader == "values"
           else torch.from_numpy(rng.integers(0, table, e).astype(np.int32)))
    ew = (torch.from_numpy((rng.random(e) + 0.5).astype(np.float32))
          if loader == "gather weighted" else None)
    got = sk.segment_sum_plain(w, ptr, n, src=src, edge_weight=ew, out_dtype=torch.float64)
    per = w if src is None else w[src]
    if ew is not None:
        per = per * ew  # float32 products
    ids = torch.repeat_interleave(torch.arange(n), ptr.diff().long())
    want = torch.zeros(n, dtype=torch.float64).index_add_(0, ids, per.double())
    assert got.dtype == torch.float64 and torch.equal(got, want)
    assert torch.equal(sk.segment_sum_kernel(w, ptr, n, src=src, edge_weight=ew,
                                             out_dtype=torch.float64), got)
    assert torch.equal(sk.segment_sum_plain(w, ptr, n, src=src, edge_weight=ew),
                       want.float())
    if ew is not None:
        wide = torch.zeros(n, dtype=torch.float64).index_add_(
            0, ids, w.double()[src] * ew.double())
        assert not torch.equal(wide, want)


def test_widening_takes_only_float32_to_float64():
    rng = np.random.default_rng(1)
    ptr = _csr(rng, 4, 16)
    x32 = torch.from_numpy(rng.random(16).astype(np.float32))
    assert sk.segment_sum_kernel(x32, ptr, 4, out_dtype=torch.float32).dtype == torch.float32
    assert sk.segment_sum_kernel(x32.double(), ptr, 4,
                                 out_dtype=torch.float64).dtype == torch.float64
    for values, out in ((x32.double(), torch.float32), (x32, torch.float16)):
        with pytest.raises(TypeError, match="widens only float32 to float64"):
            sk.segment_sum_kernel(values, ptr, 4, out_dtype=out)
