"""The plain reference against a dense NumPy power iteration, and its
personalized columns against single-query runs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import graphgen, reference


def dense_pagerank(src, dst, n, restart, *, iterations, damping, dangling, init):
    """Textbook power iteration on the dense column-stochastic matrix."""
    a = np.zeros((n, n))
    pairs = sorted(set(zip(src.tolist(), dst.tolist())))
    out = np.zeros(n)
    for u, _ in pairs:
        out[u] += 1
    for u, v in pairs:
        a[v, u] += 1.0 / out[u]
    total = float(n) if init == "one" else 1.0
    r = np.full(restart.shape, 1.0 if init == "one" else 1.0 / n)
    for _ in range(iterations):
        contrib = a @ r
        if dangling == "redistribute":
            contrib += (r * (out == 0)[:, None]).sum(0) * restart
        r = (1 - damping) * total * restart + damping * contrib
    return r


def small_graph(seed=5, n=60, e=300):
    g = graphgen.generate(n, e, out_exponent=2.5, in_exponent=2.2, max_out_degree=15.0,
                          max_in_degree=30.0, dangling_share=0.2, seed=seed, device="cpu")
    return g.src.numpy(), g.dst.numpy(), n


@pytest.mark.parametrize("dangling", ["redistribute", "drop"])
@pytest.mark.parametrize("init", ["uniform", "one"])
@pytest.mark.parametrize("queries", [None, [[3], [7, 7, 11], [0]]])
def test_reference_equals_dense_power_iteration(dangling, init, queries):
    src, dst, n = small_graph()
    g = reference.build(src, dst, n, "cpu")
    e = reference.restart_matrix(n, queries, "cpu")
    got = reference.pagerank(g, e, iterations=20, damping=0.85, dangling=dangling, init=init)
    want = dense_pagerank(src, dst, n, e.numpy(), iterations=20, damping=0.85,
                          dangling=dangling, init=init)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_repeated_pairs_and_input_order_do_not_matter():
    src, dst, n = small_graph(seed=9)
    perm = np.random.default_rng(0).permutation(src.shape[0])
    dup_src = np.concatenate([src[perm], src[:40]])
    dup_dst = np.concatenate([dst[perm], dst[:40]])
    kw = dict(iterations=20, damping=0.85, dangling="redistribute", init="uniform")
    e = reference.restart_matrix(n, None, "cpu")
    a = reference.pagerank(reference.build(src, dst, n, "cpu"), e, **kw)
    b = reference.pagerank(reference.build(dup_src, dup_dst, n, "cpu"), e, **kw)
    assert torch.equal(a, b)


def test_batched_columns_equal_single_query_runs_in_any_block():
    src, dst, n = small_graph(seed=11, n=400, e=2400)
    g = reference.build(src, dst, n, "cpu")
    queries = [[q] for q in (0, 5, 17, 17, 200, 399)]
    kw = dict(iterations=20, damping=0.85, dangling="redistribute", init="uniform")
    whole = reference.pagerank(g, reference.restart_matrix(n, queries, "cpu"), **kw)
    blocked = reference.pagerank(g, reference.restart_matrix(n, queries, "cpu"),
                                 max_block_bytes=1, **kw)
    np.testing.assert_allclose(whole.numpy(), blocked.numpy(), rtol=1e-14, atol=0)
    for col, q in enumerate(queries):
        one = reference.pagerank(g, reference.restart_matrix(n, [q], "cpu"), **kw)
        np.testing.assert_allclose(whole[:, col].numpy(), one[:, 0].numpy(), rtol=1e-14, atol=0)
    np.testing.assert_allclose(whole.sum(0).numpy(), 1.0, rtol=1e-12)


def test_lower_precision_runs_stay_close_but_not_equal():
    src, dst, n = small_graph(seed=13, n=400, e=2400)
    g = reference.build(src, dst, n, "cpu")
    e = reference.restart_matrix(n, None, "cpu")
    kw = dict(iterations=20, damping=0.85, dangling="redistribute", init="uniform")
    hi = reference.pagerank(g, e, **kw)
    lo = reference.pagerank(g, e, dtype=torch.bfloat16, acc=torch.float32, **kw)
    assert lo.dtype == torch.bfloat16
    err = float(((lo.double() - hi).abs() / hi).max())
    assert 1e-4 < err < 0.1
