"""The port's kernel module on the CPU, against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.  Inputs come from a numpy seed; tolerances are
float64 at 1e-12 (summation order differs between the two).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu.io.graph import from_edges, synthetic_powerlaw
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pagerank as jops
from page_rank_and_tfidf_using_apache_spark_tpu.ops import pallas_kernels as jpk
from page_rank_and_tfidf_using_apache_spark_tpu_torch import convert
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


@pytest.mark.parametrize("shape", [(1, 8), (7, 128), (33, 64), (2049, 128)])
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
])
def test_wrappers_reject_bad_input(wrapper, bad, error):
    fn = tpk.cumsum_kernel if wrapper == "cumsum" else tpk.rowsum_kernel
    with pytest.raises(error):
        fn(bad)


def test_cpu_calls_count_no_launch():
    """The counters count kernel launches only: the CPU route runs the plain
    version and leaves them alone."""
    tpk.reset_launches()
    tpk.cumsum_kernel(torch.ones(10))
    tpk.rowsum_kernel(torch.ones(3, 8))
    assert tpk.LAUNCHES == {"cumsum": 0, "rowsum": 0}


def test_convert_checks_field_names():
    g = synthetic_powerlaw(50, 200, seed=1)
    fields = {k: np.asarray(v) for k, v in jops.put_graph(g, "float64")._asdict().items()
              if v is not None and not hasattr(v, "_fields")}
    dg = convert.device_graph(fields, device="cpu")
    assert dg.src.dtype == torch.int32 and dg.inv_outdeg.dtype == torch.float64
    with pytest.raises(ValueError, match="no fields"):
        convert.device_graph({**fields, "bogus": np.zeros(1)}, device="cpu")
