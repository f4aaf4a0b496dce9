"""The sorted segmented sum of the port (``ops/segment_kernels.py``, whose
kernel is ``csrc/segment.cu``) against ``jax.ops.segment_sum``, and the CSR
pointers the port builds over the JAX package's layouts.

On the CPU the wrapper runs its plain version, a float64 ``index_add_``
over the segment ids the pointers give; the kernel itself runs only on the
card (``chip_smoke.py``).  Each call site of the JAX package's
``segment_sum`` (``ops/pagerank.py:378``, ``:508``, ``:537``) is fed the same
numpy inputs on both sides, in float32 and float64 (x64 on, as
``tests/conftest.py`` sets it).  Tolerance per segment of k values:
float64, 1e-12 of the segment's sum of |x| (two float64 sums in other
orders); float32, k·2^-24 of it (the JAX package sums in float32, the port
in float64 with one rounding).  Integer inputs are exact on both sides.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.io import graph as jg
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pagerank as jops
from page_rank_and_tfidf_using_apache_spark_tpu_torch import convert
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as tpk
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

jax.config.update("jax_enable_x64", True)

SEGMENT_CU = pathlib.Path(_build.SRC_DIR) / "segment.cu"
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}


def _graph_pair(kind: str, weighted: bool = False):
    """The same graph built by each package."""
    if kind == "powerlaw":
        jgr, tgr = jg.synthetic_powerlaw(200, 1500, seed=5), tg.synthetic_powerlaw(200, 1500,
                                                                                   seed=5)
    elif kind == "hub":  # every edge into node 3, nodes 0-2 and 4-9 receive none
        src = np.arange(10, 110) % 10
        dst = np.full(100, 3)
        jgr, tgr = jg.from_edges(src, dst), tg.from_edges(src, dst)
    else:  # "gaps": in-degree 0 at the first and last nodes and in between
        rng = np.random.default_rng(9)
        src = rng.integers(0, 60, 400)
        dst = rng.integers(10, 45, 400) // 5 * 5
        jgr, tgr = jg.from_edges(src, dst), tg.from_edges(src, dst)
    if weighted:
        w = np.random.default_rng(4).uniform(0.25, 4.0, jgr.n_edges)
        jgr = jg.from_edges(jgr.src, jgr.dst, weight=w)
        tgr = tg.from_edges(tgr.src, tgr.dst, weight=w)
    return jgr, tgr


def _assert_close(got: np.ndarray, want: np.ndarray, scale: np.ndarray, counts: np.ndarray,
                  dtype: str) -> None:
    limit = (1e-12 if dtype == "float64" else counts * 2.0 ** -24) * scale
    assert got.shape == want.shape
    assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= limit)


# ---------------------------------------------------------- the call sites

def _site_inputs(site: str, weighted: bool, dtype: str, integer: bool):
    """``(jax values, jax ids, n, port kwargs)`` for one call site."""
    npt, _ = DTYPES[dtype]
    jgr, tgr = _graph_pair("powerlaw", weighted)
    rng = np.random.default_rng(13)
    n = tgr.n_nodes
    draw = (lambda size: rng.integers(-3, 4, size).astype(npt)) if integer else (
        lambda size: rng.uniform(-1.0, 1.0, size).astype(npt))
    if site == "segment":
        w = draw(n)
        ew = tgr.weight.astype(npt) if weighted else None
        per = w[jgr.src] * ew if weighted else w[jgr.src]
        ptr = tgr.csr_indptr().astype(np.int32)
        kw = dict(values=torch.from_numpy(w), src=torch.from_numpy(tgr.src),
                  edge_weight=None if ew is None else torch.from_numpy(ew))
        return per, jgr.dst, n, ptr, kw
    if site == "hybrid_head":
        hl = jops.build_hybrid_layout(jgr, coverage=0.5, row_width=16)
        h = hl.head_ids.shape[0]
        vals = draw(hl.head_row_node.shape[0])
        return vals, hl.head_row_node, h, tops.segment_pointers(hl.head_row_node, h), \
            dict(values=torch.from_numpy(vals))
    bucket_src, bucket_node, _ = jops.build_shuffle_layout(jgr, bucket_width=4)
    vals = draw(bucket_node.shape[0])
    return vals, bucket_node, n, tops.segment_pointers(bucket_node, n), \
        dict(values=torch.from_numpy(vals))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("site, weighted", [("segment", False), ("segment", True),
                                            ("hybrid_head", False), ("sort_shuffle", False)])
def test_plain_matches_jax_segment_sum(site, weighted, dtype):
    per, ids, n, ptr, kw = _site_inputs(site, weighted, dtype, integer=False)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(per), jnp.asarray(ids), num_segments=n,
                                          indices_are_sorted=True))
    got = sk.segment_sum_plain(ptr=torch.from_numpy(ptr), n=n, **kw).numpy()
    scale = np.bincount(ids, weights=np.abs(per.astype(np.float64)), minlength=n)
    _assert_close(got, want, scale, np.bincount(ids, minlength=n), dtype)
    assert got.dtype == per.dtype


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("site, weighted", [("segment", False), ("segment", True),
                                            ("hybrid_head", False), ("sort_shuffle", False)])
def test_plain_exact_on_integers(site, weighted, dtype):
    per, ids, n, ptr, kw = _site_inputs(site, weighted, dtype, integer=True)
    if weighted:  # integer products: weights rounded to integers
        kw["edge_weight"] = torch.round(kw["edge_weight"])
        per = kw["values"].numpy()[kw["src"].numpy()] * kw["edge_weight"].numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(per), jnp.asarray(ids), num_segments=n,
                                          indices_are_sorted=True))
    got = sk.segment_sum_kernel(ptr=torch.from_numpy(ptr), n=n, **kw).numpy()
    exact = np.bincount(ids, weights=per.astype(np.float64), minlength=n)
    assert np.array_equal(got, want) and np.array_equal(got.astype(np.float64), exact)


@pytest.mark.parametrize("ptr, e", [([0], 0), ([0, 0, 0, 0], 0), ([0, 7], 7),
                                    ([0, 0, 0, 5, 5, 5], 5), ([0, 1, 1, 1, 4], 4),
                                    ([0, 3, 3, 3, 3, 3, 3], 3)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_cases_match_jax(ptr, e, dtype):
    """No segments, no values, one hub segment, empty leading, inner and
    trailing segments."""
    npt, tdt = DTYPES[dtype]
    n = len(ptr) - 1
    vals = np.arange(1, e + 1).astype(npt)
    ids = np.repeat(np.arange(n), np.diff(ptr))
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids, np.int32),
                                          num_segments=n, indices_are_sorted=True))
    got = sk.segment_sum_kernel(torch.from_numpy(vals), torch.tensor(ptr, dtype=torch.int32), n)
    assert got.dtype == tdt and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)


def test_float32_sums_in_float64():
    """A float32 running sum drops the small values after a large one; the
    port keeps them, as its float64 accumulation promises."""
    vals = torch.tensor([2.0 ** 24] + [1.0] * 64, dtype=torch.float32)
    got = sk.segment_sum_kernel(vals, torch.tensor([0, 65], dtype=torch.int32), 1)
    assert float(got[0]) == 2.0 ** 24 + 64


# --------------------------------------------------------------- pointers

@pytest.mark.parametrize("kind", ["powerlaw", "hub", "gaps"])
@pytest.mark.parametrize("weighted", [False, True])
def test_layout_pointers_are_searchsorted_over_the_jax_ids(kind, weighted):
    jgr, tgr = _graph_pair(kind, weighted)
    hl = jops.build_hybrid_layout(jgr, coverage=0.5, row_width=16)
    _, bucket_node, _ = jops.build_shuffle_layout(jgr, bucket_width=4)
    dg = tops.put_graph(tgr, "float64", layout="hybrid", head_row_width=16,
                        keep_edge_arrays=False, device="cpu")
    ds = tops.put_graph(tgr, "float64", layout="sort_shuffle", bucket_width=4,
                        keep_edge_arrays=False, device="cpu")
    h = hl.head_ids.shape[0]
    head_ptr = dg.hybrid.head_row_ptr.numpy()
    bucket_ptr = ds.shuffle.bucket_ptr.numpy()
    assert head_ptr.dtype == bucket_ptr.dtype == np.int32
    assert np.array_equal(head_ptr, np.searchsorted(hl.head_row_node, np.arange(h + 1)))
    assert np.array_equal(bucket_ptr, np.searchsorted(bucket_node, np.arange(tgr.n_nodes + 1)))
    assert head_ptr[-1] == hl.head_row_node.shape[0] and bucket_ptr[-1] == bucket_node.shape[0]
    assert np.array_equal(np.diff(bucket_ptr), np.bincount(bucket_node, minlength=tgr.n_nodes))
    if kind == "hub":  # one head segment holds every row; every other node is empty
        assert h == 1 and head_ptr.tolist() == [0, hl.head_row_node.shape[0]]
        assert (np.diff(bucket_ptr) > 0).sum() == 1
    if kind == "gaps":
        assert (np.diff(bucket_ptr) == 0).sum() > 0


@pytest.mark.parametrize("layout", ["hybrid", "sort_shuffle"])
def test_convert_builds_the_pointers_of_put_graph(layout):
    """A JAX ``DeviceGraph`` carries no pointers; the converted one gets
    those ``put_graph`` builds, and the port's SpMV runs on it."""
    jgr, tgr = _graph_pair("powerlaw")
    jdg = jops.put_graph(jgr, "float64", layout=layout, head_row_width=16, bucket_width=4,
                         keep_edge_arrays=False)
    dg = convert.device_graph(jdg, device="cpu")
    want = tops.put_graph(tgr, "float64", layout=layout, head_row_width=16, bucket_width=4,
                          keep_edge_arrays=False, device="cpu")
    got_l, want_l = (dg.hybrid, want.hybrid) if layout == "hybrid" else (dg.shuffle,
                                                                          want.shuffle)
    for name in got_l._fields:
        a, b = getattr(got_l, name), getattr(want_l, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    w = torch.from_numpy(np.random.default_rng(2).random(tgr.n_nodes))
    assert torch.equal(tops.spmv(dg, w, tgr.n_nodes, layout), tops.spmv(want, w, tgr.n_nodes,
                                                                        layout))


# ------------------------------------------------ SpMVs bit-equal to before

def _old_segment_sum(values, ids, n):
    """The port's segmented sum before the kernel: a float64 ``index_add_``
    over the segment ids."""
    acc = torch.float64 if values.dtype == torch.float32 else values.dtype
    return torch.zeros(n, dtype=acc).index_add_(0, ids, values.to(acc)).to(values.dtype)


def _old_spmv(dg, w, n, impl):
    """Each impl as the port computed it before its sums moved to the
    kernels: ``index_add_`` segmented sums and ``torch.cumsum`` scans."""
    scan = lambda x: torch.cumsum(x, dim=0)  # noqa: E731
    if impl == "segment":
        per = w[dg.src] if dg.edge_weight is None else w[dg.src] * dg.edge_weight
        return _old_segment_sum(per, dg.dst, n)
    if impl == "cumsum":
        per = w[dg.src] if dg.edge_weight is None else w[dg.src] * dg.edge_weight
        return tops.cumsum_diff_spmv(per, dg.indptr, scan)
    if impl == "sort_shuffle":
        sl = dg.shuffle
        vals = torch.cat([w, w.new_zeros(1)])[sl.bucket_src]
        if sl.bucket_w is not None:
            vals = vals * sl.bucket_w
        return _old_segment_sum(vals.sum(dim=1), sl.bucket_node, n)
    hl = dg.hybrid
    per = w[hl.tail_src] if hl.tail_w is None else w[hl.tail_src] * hl.tail_w
    contribs = tops.cumsum_diff_spmv(per, hl.tail_indptr, scan)
    rows = torch.cat([w, w.new_zeros(1)])[hl.head_src]
    if hl.head_w is not None:
        rows = rows * hl.head_w
    head = _old_segment_sum(tpk.rowsum_plain(rows), hl.head_row_node, hl.head_ids.shape[0])
    return contribs.index_add_(0, hl.head_ids, head)


@pytest.mark.parametrize("impl", ["segment", "cumsum", "hybrid", "sort_shuffle"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmv_on_the_cpu_is_bit_equal_to_before(impl, dtype, weighted):
    _, tgr = _graph_pair("powerlaw", weighted)
    layout = tops.layout_for_impl(impl)
    dg = tops.put_graph(tgr, dtype, layout=layout, head_row_width=16, device="cpu")
    w = torch.from_numpy(np.random.default_rng(8).random(tgr.n_nodes)).to(DTYPES[dtype][1])
    assert torch.equal(tops.spmv(dg, w, tgr.n_nodes, impl), _old_spmv(dg, w, tgr.n_nodes, impl))


def test_cumsum_blocked_base_case_is_the_scan_on_a_strided_carry():
    x = torch.from_numpy(np.random.default_rng(1).random(128 * 500))
    # 500 rows of 128: the carry (500 row totals, strided) takes the base case
    got = tops.cumsum_blocked(x)
    m = x.reshape(500, 128)
    rows = m @ torch.triu(torch.ones(128, 128, dtype=x.dtype))
    tot = rows[:, -1]
    want = (rows + (torch.cumsum(tot.contiguous(), 0) - tot)[:, None]).reshape(-1)
    assert torch.equal(got, want)


def test_layout_impls_need_their_pointers():
    _, tgr = _graph_pair("powerlaw")
    w = torch.ones(tgr.n_nodes, dtype=torch.float64)
    for impl in ("hybrid", "sort_shuffle"):
        dg = tops.put_graph(tgr, "float64", layout=impl, device="cpu")
        field = "hybrid" if impl == "hybrid" else "shuffle"
        ptr = "head_row_ptr" if impl == "hybrid" else "bucket_ptr"
        bare = dg._replace(**{field: getattr(dg, field)._replace(**{ptr: None})})
        with pytest.raises(ValueError, match=impl):
            tops.spmv(bare, w, tgr.n_nodes, impl)
    dg = tops.put_graph(tgr, "float64", device="cpu")
    with pytest.raises(ValueError, match="segment"):
        tops.spmv(dg._replace(indptr=None), w, tgr.n_nodes, "segment")


# ------------------------------------------------------------------ wrapper

def _ok_args():
    """A valid 4-segment, 6-value call: ``(values, ptr, n, kwargs)``."""
    return (torch.ones(6, dtype=torch.float64), torch.tensor([0, 2, 3, 5, 6], dtype=torch.int32),
            4, {})


@pytest.mark.parametrize("bad, error", [
    ({"values": np.ones(6)}, TypeError),
    ({"values": torch.ones(6, dtype=torch.int64)}, TypeError),
    ({"values": torch.ones(6, dtype=torch.float16)}, TypeError),
    ({"values": torch.ones(2, 3, dtype=torch.float64)}, ValueError),
    ({"values": torch.ones(12, dtype=torch.float64)[::2]}, ValueError),
    ({"values": torch.ones(6, dtype=torch.float64, device="meta")}, ValueError),
    ({"ptr": torch.tensor([0, 2, 3, 5, 6], dtype=torch.int64)}, TypeError),
    ({"ptr": torch.tensor([0, 2, 3, 6], dtype=torch.int32)}, ValueError),
    ({"ptr": torch.tensor([0, 0, 2, 0, 3, 0, 5, 0, 6, 0], dtype=torch.int32)[::2]}, ValueError),
    ({"ptr": [0, 2, 3, 5, 6]}, TypeError),
    ({"src": torch.zeros(6, dtype=torch.int64)}, TypeError),
    ({"src": torch.zeros(12, dtype=torch.int32)[::2]}, ValueError),
    ({"edge_weight": torch.ones(6, dtype=torch.float64)}, ValueError),
    ({"src": torch.zeros(6, dtype=torch.int32), "edge_weight": torch.ones(5, dtype=torch.float64)},
     ValueError),
    ({"src": torch.zeros(6, dtype=torch.int32), "edge_weight": torch.ones(6)}, TypeError),
    ({"src": torch.zeros(6, dtype=torch.int32, device="meta")}, ValueError),
])
def test_wrapper_rejects_bad_input(bad, error):
    values, ptr, n, kw = _ok_args()
    sk.segment_sum_kernel(values, ptr, n)  # the unchanged call is fine
    args = {"values": values, "ptr": ptr, **kw}
    args.update(bad)
    with pytest.raises(error):
        sk.segment_sum_kernel(args.pop("values"), args.pop("ptr"), n, **args)


def test_wrapper_rejects_more_values_than_int32(monkeypatch):
    monkeypatch.setattr(sk, "_INT_LIMIT", 5)
    values, ptr, n, _ = _ok_args()
    with pytest.raises(ValueError, match="2\\^31"):
        sk.segment_sum_kernel(values, ptr, n)


def test_cpu_calls_count_no_launch():
    sk.reset_launches()
    values, ptr, n, _ = _ok_args()
    got = sk.segment_sum_kernel(values, ptr, n)
    assert torch.equal(got, sk.segment_sum_plain(values, ptr, n))
    assert got.tolist() == [2.0, 1.0, 2.0, 1.0]
    assert sk.LAUNCHES == {"segment": 0}


# ---------------------------------------------------------------- the build

def test_build_knows_every_export_of_segment_cu():
    """``_build.SIGNATURES['segment']`` names exactly the C functions
    ``segment.cu`` exports, with as many arguments."""
    text = SEGMENT_CU.read_text()
    exported = text[text.index('extern "C" {'):]
    found = {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
             for m in re.finditer(r"^(?:int|long long|const char\*) (\w+)\(([^)]*)\)", exported,
                                  re.M)}
    assert {k: len(v[1]) for k, v in _build.SIGNATURES["segment"].items()} == found


def test_source_note_names_what_it_replaces():
    text = SEGMENT_CU.read_text()
    for needle in ("ops/pagerank.py:378", ":508", ":537", "Bound on the H100", "24.7 MB"):
        assert needle in text, needle
