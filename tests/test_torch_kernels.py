"""The port's kernel module on the CPU, against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.  Inputs come from a numpy seed; tolerances are
float64 at 1e-12 (summation order differs between the two).
"""

import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.io.graph import from_edges, synthetic_powerlaw
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pagerank as jops
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pallas_kernels as jpk
from page_rank_and_tfidf_using_apache_spark_tpu_torch import convert
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as tops
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as tpk

RTOL = ATOL = 1e-12


@pytest.mark.parametrize("reference", ["jnp.cumsum", "cumsum_pallas"])
@pytest.mark.parametrize("n", [0, 1, 5, 1024, 1025, 40_001])
def test_cumsum_plain_matches_jax(n, reference):
    x = np.random.default_rng(n).standard_normal(n)
    if reference == "jnp.cumsum":
        want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    else:
        want = np.asarray(jpk.cumsum_pallas(jnp.asarray(x), interpret=True))
    got = tpk.cumsum_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tpk.cumsum_kernel(torch.from_numpy(x)).numpy(), got)


# Widths on both sides of csrc/rowsum.cu's 16-byte route (below 4, not a
# multiple of 4, one vector a lane at 128, several at 1000), and row counts
# around a block's run (8 rows at W = 128 and 1000) and the TPU kernel's
# 1024-row block.
@pytest.mark.parametrize("shape", [
    (1, 8), (7, 128), (33, 64), (2049, 128),
    (63, 1), (65, 3), (9, 100), (64, 128), (1025, 129), (8, 1000), (7, 1000),
])
def test_rowsum_plain_matches_rowsum_pallas(shape):
    rows = np.random.default_rng(shape[0]).random(shape)
    want = np.asarray(jpk.rowsum_pallas(jnp.asarray(rows), interpret=True))
    got = tpk.rowsum_plain(torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tpk.rowsum_kernel(torch.from_numpy(rows)).numpy(), got)
    # and the JAX package's off-TPU route for the same reduction
    np.testing.assert_allclose(got, np.asarray(jops.hybrid_rowsum(jnp.asarray(rows))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_spmv_pallas_matches_jax(weighted):
    """Both sides read one layout, carried across by ``convert``."""
    g = synthetic_powerlaw(300, 2000, seed=12)
    if weighted:
        g = from_edges(g.src, g.dst,
                       weight=np.random.default_rng(5).uniform(0.5, 2, g.n_edges))
    jdg = jops.put_graph(g, "float64")
    tdg = convert.device_graph(jdg, device="cpu")
    w = np.random.default_rng(6).random(g.n_nodes)
    want = np.asarray(jpk.spmv_pallas(jdg.src, jdg.indptr, jnp.asarray(w), n=g.n_nodes,
                                      edge_weight=jdg.edge_weight, interpret=True))
    got = tpk.spmv_pallas(tdg.src, tdg.indptr, convert.ranks_tensor(w, device="cpu"),
                          n=g.n_nodes, edge_weight=tdg.edge_weight).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# Edges per tile of csrc/spmv.cu's scan (spmv_tile_len()).
SCAN_TILE = 4096


def _edge_graph(kind: str):
    """Node ids 0..n-1 kept as they are (``compact_ids=False``); the largest
    id appears as a source, so every empty row stays in the graph."""
    rng = np.random.default_rng(len(kind))
    if kind == "empty_lead_and_tail_rows":  # rows 0-9 and 190-199 receive nothing
        n, e = 200, 3 * SCAN_TILE + 5
        dst = rng.integers(10, n - 10, e)
    elif kind == "hub_row":  # every edge lands on row 7
        n, e = 50, 2 * SCAN_TILE + 1
        dst = np.full(e, 7)
    else:  # "ragged_tiles": E not a multiple of the tile
        n, e = 1000, 2 * SCAN_TILE + 7
        dst = rng.integers(0, n, e)
    src = rng.integers(0, n, e)
    src[0] = n - 1
    return from_edges(src, dst, dedup=False, compact_ids=False), rng


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["empty_lead_and_tail_rows", "hub_row", "ragged_tiles"])
def test_spmv_pallas_plain_matches_jax_edge_graphs(kind, weighted):
    """The fused kernel's plain version against the JAX ``spmv_pallas`` with
    ``cumsum_pallas`` in interpret mode, on the graphs the card's sweep
    covers: empty rows at both ends, one hub row, E off the tile."""
    g, rng = _edge_graph(kind)
    if weighted:
        g = from_edges(g.src, g.dst, weight=rng.uniform(0.5, 2.0, g.n_edges), dedup=False,
                       compact_ids=False)
    jdg = jops.put_graph(g, "float64")
    tdg = convert.device_graph(jdg, device="cpu")
    indptr = np.asarray(jdg.indptr)
    if kind == "empty_lead_and_tail_rows":
        assert indptr[10] == 0 and indptr[-11] == g.n_edges
    w = rng.random(g.n_nodes)
    want = np.asarray(jpk.spmv_pallas(jdg.src, jdg.indptr, jnp.asarray(w), n=g.n_nodes,
                                      edge_weight=jdg.edge_weight, interpret=True))
    args = (tdg.src, tdg.indptr, convert.ranks_tensor(w, device="cpu"))
    got = tpk.spmv_pallas_plain(*args, n=g.n_nodes, edge_weight=tdg.edge_weight).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tpk.spmv_pallas(*args, n=g.n_nodes, edge_weight=tdg.edge_weight).numpy(), got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["empty_lead_and_tail_rows", "hub_row", "ragged_tiles"])
def test_spmv_pallas_exact_on_integers(kind, weighted, dtype):
    """On small integers every prefix sum is exact in either type, so the
    port and the JAX ``spmv_pallas`` agree bit for bit with the float64 sum,
    in float32 too; ``chip_smoke.py`` holds the kernel to the same inputs."""
    g, rng = _edge_graph(kind)
    if weighted:
        g = from_edges(g.src, g.dst, weight=rng.integers(1, 3, g.n_edges).astype(np.float64),
                       dedup=False, compact_ids=False)
    jdg = jops.put_graph(g, dtype)
    tdg = convert.device_graph(jdg, device="cpu")
    w = rng.integers(1, 4, g.n_nodes).astype(dtype)
    want = np.asarray(jpk.spmv_pallas(jdg.src, jdg.indptr, jnp.asarray(w), n=g.n_nodes,
                                      edge_weight=jdg.edge_weight, interpret=True))
    got = tpk.spmv_pallas(tdg.src, tdg.indptr, torch.from_numpy(w), n=g.n_nodes,
                          edge_weight=tdg.edge_weight).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    per_edge = w.astype(np.float64)[g.src] * (1.0 if g.weight is None else g.weight)
    np.testing.assert_array_equal(got, np.bincount(g.dst, per_edge, minlength=g.n_nodes))


def test_spmv_pallas_empty_graph():
    got = tpk.spmv_pallas(torch.zeros(0, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                          torch.ones(3, dtype=torch.float64), n=3)
    assert got.tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("n", [0, 1, 5, 512, 513, 128 * 9, 40_001])
def test_cumsum_blocked_matches_jax(n):
    x = np.random.default_rng(n).standard_normal(n)
    want = np.asarray(jops.cumsum_blocked(jnp.asarray(x)))
    got = tops.cumsum_blocked(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.cumsum(x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wrapper, bad, error", [
    ("cumsum", np.zeros(4), TypeError),
    ("cumsum", torch.zeros(4, dtype=torch.int32), TypeError),
    ("cumsum", torch.zeros(4, dtype=torch.float16), TypeError),
    ("cumsum", torch.zeros(2, 2), ValueError),
    ("cumsum", torch.zeros(8)[::2], ValueError),
    ("rowsum", torch.zeros(4, dtype=torch.int64), TypeError),
    ("rowsum", torch.zeros(4), ValueError),
    ("rowsum", torch.zeros(2, 2, 2), ValueError),
    ("rowsum", torch.zeros(4, 8).t(), ValueError),
    ("rowsum", torch.zeros(4, 8, device="meta"), ValueError),
    ("spmv", {"src": torch.zeros(6, dtype=torch.int64)}, TypeError),
    ("spmv", {"w": torch.ones(4, dtype=torch.float16)}, TypeError),
    ("spmv", {"indptr": torch.zeros(4, dtype=torch.int32)}, ValueError),
    ("spmv", {"src": torch.zeros(12, dtype=torch.int32)[::2]}, ValueError),
    ("spmv", {"edge_weight": torch.ones(5, dtype=torch.float64)}, ValueError),
    ("spmv", {"edge_weight": torch.ones(6, dtype=torch.float32)}, TypeError),
    ("spmv", {"w": torch.ones(5, dtype=torch.float64)}, ValueError),
])
def test_wrappers_reject_bad_input(wrapper, bad, error):
    if wrapper == "spmv":  # bad replaces arguments of a valid 4-node, 6-edge call
        args = dict(src=torch.tensor([0, 1, 2, 3, 0, 1], dtype=torch.int32),
                    indptr=torch.tensor([0, 2, 3, 5, 6], dtype=torch.int32),
                    w=torch.ones(4, dtype=torch.float64), edge_weight=None)
        tpk.spmv_pallas(args["src"], args["indptr"], args["w"], n=4)
        args.update(bad)

        def fn(_):
            return tpk.spmv_pallas(args["src"], args["indptr"], args["w"], n=4,
                                   edge_weight=args["edge_weight"])
    else:
        fn = tpk.cumsum_kernel if wrapper == "cumsum" else tpk.rowsum_kernel
    with pytest.raises(error):
        fn(bad)


def test_cpu_calls_count_no_launch():
    """The counters count kernel launches only: the CPU route runs the plain
    version and leaves them alone."""
    tpk.reset_launches()
    tpk.cumsum_kernel(torch.ones(10))
    tpk.rowsum_kernel(torch.ones(3, 8))
    tpk.spmv_pallas(torch.zeros(2, dtype=torch.int32), torch.tensor([0, 2], dtype=torch.int32),
                    torch.ones(1), n=1)
    assert tpk.LAUNCHES == {"cumsum": 0, "rowsum": 0, "spmv": 0}


def test_convert_checks_field_names():
    g = synthetic_powerlaw(50, 200, seed=1)
    fields = {k: np.asarray(v) for k, v in jops.put_graph(g, "float64")._asdict().items()
              if v is not None and not hasattr(v, "_fields")}
    dg = convert.device_graph(fields, device="cpu")
    assert dg.src.dtype == torch.int32 and dg.inv_outdeg.dtype == torch.float64
    with pytest.raises(ValueError, match="no fields"):
        convert.device_graph({**fields, "bogus": np.zeros(1)}, device="cpu")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """``_build`` pointed at a copy of ``csrc/`` whose libraries (empty
    files) are newer than every source."""
    src, build = tmp_path / "csrc", tmp_path / "_build"
    shutil.copytree(_build.SRC_DIR, src)
    build.mkdir()
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    now = time.time()
    for p in src.iterdir():
        os.utime(p, (now - 100, now - 100))
    for name in _build.SIGNATURES:
        assert _build._stale(name)  # not built yet
        _build.lib_path(name).write_bytes(b"")
        os.utime(_build.lib_path(name), (now - 50, now - 50))
        assert not _build._stale(name)
    return src, now


def test_stale_follows_a_shared_header(csrc_copy):
    """A library that includes ``scan.cuh`` is rebuilt once the header is
    newer, though its own ``.cu`` is not."""
    src, now = csrc_copy
    os.utime(src / "scan.cuh", (now, now))
    assert _build._stale("cumsum") and _build._stale("spmv")


def test_stale_follows_its_own_source(csrc_copy):
    src, now = csrc_copy
    os.utime(src / "spmv.cu", (now, now))
    assert _build._stale("spmv")
    assert not _build._stale("cumsum")

