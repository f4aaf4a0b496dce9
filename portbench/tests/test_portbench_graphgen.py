"""The generator: exact counts, distinct pairs, destination order, coverage
and seed determinism, at small sizes on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench import graphgen

LAW = dict(out_exponent=2.7, in_exponent=2.1, max_out_degree=40.0, max_in_degree=300.0)


@pytest.mark.parametrize("n,e,dangling", [(500, 3000, 0.155), (2000, 2500, 0.1),
                                          (1000, 14000, 0.0), (3000, 17500, 0.111)])
def test_counts_pairs_order_and_coverage(n, e, dangling):
    g = graphgen.generate(n, e, dangling_share=dangling, seed=7, device="cpu", **LAW)
    assert (g.n, g.src.shape[0], g.dst.shape[0]) == (n, e, e)
    assert g.src.dtype == g.dst.dtype == torch.int32
    key = g.dst.long() * n + g.src.long()
    assert bool((key[1:] > key[:-1]).all()), "pairs distinct and sorted by (dst, src)"
    assert bool((g.dst[1:] >= g.dst[:-1]).all())
    assert int(g.src.min()) >= 0 and int(max(g.src.max(), g.dst.max())) < n
    assert torch.unique(torch.cat([g.src, g.dst])).shape[0] == n, "every id on an edge"
    out_deg = torch.bincount(g.src.long(), minlength=n)
    assert int((out_deg == 0).sum()) == round(dangling * n)
    s = graphgen.stats(g)
    assert (s["nodes"], s["edges"]) == (n, e)
    assert s["dangling_share"] == round(dangling * n) / n


def test_seed_determinism_large_seeds():
    seed = 2 ** 33 + 12345
    a = graphgen.generate(800, 6000, dangling_share=0.1, seed=seed, device="cpu", **LAW)
    b = graphgen.generate(800, 6000, dangling_share=0.1, seed=seed, device="cpu", **LAW)
    c = graphgen.generate(800, 6000, dangling_share=0.1, seed=seed + 1, device="cpu", **LAW)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert not (torch.equal(a.src, c.src) and torch.equal(a.dst, c.dst))


def test_degree_caps_hold_roughly():
    g = graphgen.generate(20000, 120000, dangling_share=0.15, seed=3, device="cpu",
                          out_exponent=2.7, in_exponent=2.1, max_out_degree=60.0,
                          max_in_degree=800.0)
    s = graphgen.stats(g)
    # the cap is the largest expected degree before the distinct pairs are taken
    assert 0.5 * 800 < s["max_in_degree"] < 1.5 * 800
    assert s["max_out_degree"] < 1.5 * 60


@pytest.mark.parametrize("n,e,share", [(100, 99, 0.1), (100, 500, 1.0)])
def test_refuses_counts_it_cannot_meet(n, e, share):
    with pytest.raises(ValueError):
        graphgen.generate(n, e, dangling_share=share, seed=1, device="cpu", **LAW)
