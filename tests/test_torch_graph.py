"""Host-side parity of the PyTorch port with the JAX package: graphs, layouts,
config, and the device graph ``put_graph`` builds.

The port copies these modules instead of importing them; every test here
holds the copy byte-identical (or, for configs, field-identical) to the
JAX package on the same input.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pagerank as jops
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

TINY = pathlib.Path(__file__).resolve().parent / "fixtures" / "tiny.txt"


def assert_same_array(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def assert_same_graph(a, b):
    assert a.n_nodes == b.n_nodes
    for f in ("src", "dst", "out_degree", "node_ids"):
        assert_same_array(getattr(a, f), getattr(b, f), f)
    assert (a.weight is None) == (b.weight is None)
    if a.weight is not None:
        assert_same_array(a.weight, b.weight, "weight")
    assert_same_array(a.csr_indptr(), b.csr_indptr(), "indptr")
    assert_same_array(a.inv_out_strength("float32"), b.inv_out_strength("float32"))


def _weighted_edges(seed, n=40, e=300):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.uniform(0.1, 3.0, e))


@pytest.mark.parametrize("args, kw", [
    ((100, 400), {"seed": 7}),
    ((2000, 10_000), {"seed": 3}),
    ((300, 1500), {"seed": 0, "zipf_a": 2.0}),
])
def test_synthetic_powerlaw_identical(args, kw):
    assert_same_graph(tg.synthetic_powerlaw(*args, **kw), jg.synthetic_powerlaw(*args, **kw))


@pytest.mark.parametrize("args, kw", [
    ((200, 1000), {"seed": 1}),
    ((500, 3000), {"seed": 2, "src_exponent": 1.3}),
])
def test_synthetic_zipf_identical(args, kw):
    assert_same_graph(tg.synthetic_zipf(*args, **kw), jg.synthetic_zipf(*args, **kw))


def test_parse_snap_and_load_snap_identical():
    text = TINY.read_text()
    assert_same_graph(tg.parse_snap_text(text), jg.parse_snap_text(text))
    assert_same_graph(tg.load_snap(str(TINY)), jg.load_snap(str(TINY)))
    assert_same_graph(tg.parse_snap_text(""), jg.parse_snap_text(""))


@pytest.mark.parametrize("kw", [
    {},
    {"drop_self_loops": True},
    {"compact_ids": False},
    {"dedup": False},
])
def test_weighted_from_edges_identical(kw):
    src, dst, w = _weighted_edges(5)
    assert_same_graph(tg.from_edges(src, dst, weight=w, **kw),
                      jg.from_edges(src, dst, weight=w, **kw))
    assert_same_graph(tg.from_edges(src, dst, **kw), jg.from_edges(src, dst, **kw))


def test_from_edges_rejects_what_jax_rejects():
    for kw in ({"weight": np.array([1.0, -1.0])}, {"weight": np.array([1.0])}):
        for mod in (tg, jg):
            with pytest.raises(ValueError):
                mod.from_edges(np.array([0, 1]), np.array([1, 0]), **kw)
    for mod in (tg, jg):
        with pytest.raises(ValueError):
            mod.parse_snap_text("1 2 3")


def test_save_ranks_identical(tmp_path):
    g = tg.parse_snap_text(TINY.read_text())
    ranks = np.random.default_rng(0).random(g.n_nodes)
    tg.save_ranks(str(tmp_path / "t.txt"), g, ranks, top_k=3)
    jg.save_ranks(str(tmp_path / "j.txt"), g, ranks, top_k=3)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("coverage, width", [(0.5, 128), (0.9, 16), (0.2, 8)])
def test_hybrid_layout_identical(weighted, coverage, width):
    g = jg.synthetic_powerlaw(400, 3000, seed=4)
    if weighted:
        g = jg.from_edges(g.src, g.dst,
                          weight=np.random.default_rng(1).uniform(0.5, 2, g.n_edges))
    t = tops.build_hybrid_layout(g, coverage=coverage, row_width=width)
    j = jops.build_hybrid_layout(g, coverage=coverage, row_width=width)
    assert t._fields == j._fields
    for f in t._fields:
        if isinstance(getattr(j, f), int):
            assert getattr(t, f) == getattr(j, f), f
        elif getattr(j, f) is None:
            assert getattr(t, f) is None, f
        else:
            assert_same_array(getattr(t, f), getattr(j, f), f)
    assert t.head_ids.size > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bucket_width", [2, 8])
def test_shuffle_layout_identical(weighted, bucket_width):
    g = jg.synthetic_powerlaw(300, 2000, seed=6)
    if weighted:
        g = jg.from_edges(g.src, g.dst,
                          weight=np.random.default_rng(2).uniform(0.5, 2, g.n_edges))
    t = tops.build_shuffle_layout(g, bucket_width=bucket_width)
    j = jops.build_shuffle_layout(g, bucket_width=bucket_width)
    for a, b in zip(t, j):
        if b is None:
            assert a is None
        else:
            assert_same_array(a, b)


@pytest.mark.parametrize("layout", [None, "hybrid", "sort_shuffle"])
@pytest.mark.parametrize("weighted", [False, True])
def test_put_graph_builds_the_jax_arrays(layout, weighted):
    """The port's own ``put_graph`` builds the same arrays, field by field
    and dtype by dtype, as the JAX package's."""
    g = jg.synthetic_powerlaw(200, 1200, seed=8)
    if weighted:
        g = jg.from_edges(g.src, g.dst,
                          weight=np.random.default_rng(3).uniform(0.5, 2, g.n_edges))
    kw = dict(layout=layout, head_row_width=16, keep_edge_arrays=layout is None)
    t = tops.put_graph(g, "float64", device="cpu", **kw)
    j = jops.put_graph(g, "float64", **kw)

    def compare(a, b, prefix):
        for f in b._fields:
            va, vb = getattr(a, f), getattr(b, f)
            if vb is None:
                assert va is None, prefix + f
            elif hasattr(vb, "_fields"):
                compare(va, vb, prefix + f + ".")
            else:
                assert_same_array(va.numpy(), np.asarray(vb), prefix + f)

    compare(t, j, "")


def test_config_fields_and_defaults_match():
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.PageRankConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.PageRankConfig)}
    assert tf == jf
    assert {m.value for m in tcfg.DanglingMode} == {m.value for m in jcfg.DanglingMode}
    assert {m.value for m in tcfg.RankInit} == {m.value for m in jcfg.RankInit}
    for k, v in tcfg.TUNABLE_DEFAULTS.items():
        assert jcfg.TUNABLE_DEFAULTS[k] == v, k


@pytest.mark.parametrize("kw", [
    {},
    {"dangling": "redistribute", "init": "uniform", "spmv_impl": "hybrid"},
    {"personalize": [3, 1], "damping": 0.5, "dtype": "float64"},
    {"spark_exact": True, "spmv_impl": "bcoo"},
])
def test_config_hash_matches(kw):
    t, j = tcfg.PageRankConfig(**kw), jcfg.PageRankConfig(**kw)
    assert t.config_hash() == j.config_hash()
    assert t.personalize == j.personalize


@pytest.mark.parametrize("kw", [
    {"iterations": -1},
    {"damping": 1.5},
    {"dangling": "sideways"},
    {"spark_exact": True, "dangling": "redistribute"},
    {"spark_exact": True, "personalize": (1,)},
    {"spmv_impl": "magic"},
    {"head_coverage": 0.0},
    {"head_row_width": 4},
    {"shuffle_bucket_width": 1},
    {"owned_max_head": -1},
    {"spark_exact": True, "spmv_impl": "pallas"},
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError) as te:
        tcfg.PageRankConfig(**kw)
    with pytest.raises(ValueError) as je:
        jcfg.PageRankConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    {"dtype": "float64"},
    {"dtype": "float32", "init": "uniform"},
    {"dtype": "float64", "personalize": (2, 2, 5)},
])
def test_restart_and_init_vectors_identical(kw):
    t, j = tcfg.PageRankConfig(**kw), jcfg.PageRankConfig(**kw)
    assert_same_array(tops.restart_vector(10, t), jops.restart_vector(10, j))
    assert_same_array(tops.init_ranks(10, t), jops.init_ranks(10, j))
