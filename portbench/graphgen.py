"""Synthetic directed graphs with power-law degrees, made on the device from a seed.

A Chung-Lu graph: each edge's source is drawn with probability proportional
to an out-weight and its destination to an in-weight, both shifted power
laws ``w_j = (j + j0)^(-1/(gamma - 1))`` over a seeded permutation of the
nodes, the shift ``j0`` chosen so that the largest expected degree is the
configuration's ``max_out_degree`` / ``max_in_degree``.  A share
``dangling_share`` of the nodes gets out-weight 0: those nodes have no
out-links.

Counts are exact, so a graph of the configuration's size has exactly
``nodes`` nodes and ``edges`` distinct directed pairs:

1. every node is covered first: a node with out-links gets one edge to a
   destination drawn by in-weight, a dangling node one edge from a source
   drawn by out-weight, so every id lies on at least one edge and the
   dangling nodes are exactly the chosen share;
2. top-up rounds then draw Chung-Lu pairs, drop those already present
   (and repeats among themselves), and keep a seeded random subset of the
   new ones, until the count of distinct pairs is ``edges``.

The result is sorted by ``(dst, src)``.  Every random draw comes from one
``torch.Generator`` on ``device``, so a seed gives the same graph on the
same kind of device.  Nothing of the program under test is imported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Edges(NamedTuple):
    n: int
    src: torch.Tensor  # int32 [E], sorted by (dst, src)
    dst: torch.Tensor  # int32 [E], non-decreasing
    rounds: int  # top-up rounds taken


def _shape(j: torch.Tensor, j0: float, a: float) -> torch.Tensor:
    return (j + j0) ** (-a)


def _shift_for_max(count: int, edges: int, gamma: float, max_degree: float,
                   device: torch.device) -> float:
    """The shift ``j0`` at which the largest of ``count`` weights expects
    ``max_degree`` of ``edges`` draws (bisection on a log scale; the share
    of the largest weight falls as ``j0`` grows)."""
    a = 1.0 / (gamma - 1.0)
    j = torch.arange(count, dtype=torch.float64, device=device)

    def top_share(j0: float) -> float:
        w = _shape(j, j0, a)
        return float(w[0] / w.sum())

    target = max_degree / edges
    lo, hi = 1e-3, 1e12
    if top_share(hi) > target:
        return hi  # nearly flat weights still exceed the cap: take the flattest
    for _ in range(100):
        mid = (lo * hi) ** 0.5
        if top_share(mid) > target:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + 1e-9:
            break
    return hi


def _weights(n: int, order: torch.Tensor, active: int, edges: int, gamma: float,
             max_degree: float) -> torch.Tensor:
    """float64 [n] weights: node ``order[j]`` gets rank ``j``; ranks past
    ``active`` get 0."""
    j0 = _shift_for_max(active, edges, gamma, max_degree, order.device)
    ranked = _shape(torch.arange(active, dtype=torch.float64, device=order.device),
                    j0, 1.0 / (gamma - 1.0))
    w = torch.zeros(n, dtype=torch.float64, device=order.device)
    w[order[:active]] = ranked
    return w


def _draw(cdf: torch.Tensor, count: int, gen: torch.Generator) -> torch.Tensor:
    """``count`` int64 node ids drawn by the weights whose running sum,
    scaled to end at 1, is ``cdf`` (a zero weight is never drawn)."""
    u = torch.rand(count, dtype=torch.float64, device=cdf.device, generator=gen)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.shape[0] - 1)


def generate(nodes: int, edges: int, *, out_exponent: float, in_exponent: float,
             max_out_degree: float, max_in_degree: float, dangling_share: float,
             seed: int, device: str | torch.device = "cuda",
             max_rounds: int = 64) -> Edges:
    """The graph of the module docstring.  Raises ``ValueError`` where the
    counts cannot be met (fewer edges than nodes, or more than the
    distinct pairs a top-up can reach within ``max_rounds``)."""
    device = torch.device(device)
    n, e = int(nodes), int(edges)
    dangling = int(round(dangling_share * n))
    if not 0 <= dangling < n:
        raise ValueError(f"dangling_share {dangling_share} leaves no node with out-links")
    if e < n:
        raise ValueError(f"{e} edges cannot cover {n} nodes")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    out_order = torch.randperm(n, generator=gen, device=device)
    in_order = torch.randperm(n, generator=gen, device=device)
    w_out = _weights(n, out_order, n - dangling, e, out_exponent, max_out_degree)
    w_in = _weights(n, in_order, n, e, in_exponent, max_in_degree)
    cdf_out = torch.cumsum(w_out, 0)
    cdf_out /= cdf_out[-1].clone()
    cdf_in = torch.cumsum(w_in, 0)
    cdf_in /= cdf_in[-1].clone()

    # 1. cover every node: an out-edge for each node with out-links, an
    # in-edge for each dangling node
    linked = out_order[: n - dangling]
    hanging = out_order[n - dangling:]
    src = torch.cat([linked, _draw(cdf_out, dangling, gen)])
    dst = torch.cat([_draw(cdf_in, n - dangling, gen), hanging])
    keys = torch.unique(dst * n + src)  # distinct pairs, sorted by (dst, src)

    # 2. top up with Chung-Lu pairs to exactly e distinct pairs
    rounds = 0
    while keys.shape[0] < e:
        if rounds == max_rounds:
            raise ValueError(f"{keys.shape[0]} distinct pairs after {rounds} rounds, "
                             f"wanted {e}")
        rounds += 1
        need = e - keys.shape[0]
        draws = need + need // 8 + 1024
        cand = torch.unique(_draw(cdf_in, draws, gen) * n + _draw(cdf_out, draws, gen))
        cand = cand[~torch.isin(cand, keys)]
        if cand.shape[0] > need:
            pick = torch.randperm(cand.shape[0], generator=gen, device=device)[:need]
            cand = cand[pick]
        keys = torch.sort(torch.cat([keys, cand])).values
    return Edges(n=n, src=(keys % n).to(torch.int32), dst=(keys // n).to(torch.int32),
                 rounds=rounds)


def stats(g: Edges) -> dict:
    """What the harness prints of a graph: its counts, largest degrees and
    dangling share."""
    in_deg = torch.bincount(g.dst.long(), minlength=g.n)
    out_deg = torch.bincount(g.src.long(), minlength=g.n)
    return {
        "nodes": g.n,
        "edges": int(g.src.shape[0]),
        "max_in_degree": int(in_deg.max()),
        "max_out_degree": int(out_deg.max()),
        "dangling_share": float((out_deg == 0).sum()) / g.n,
        "self_loops": int((g.src == g.dst).sum()),
        "topup_rounds": g.rounds,
    }
