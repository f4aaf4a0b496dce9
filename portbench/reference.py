"""Plain PageRank and personalized PageRank in PyTorch: the benchmark's yardstick.

It starts from the raw edge arrays the benchmark hands the program and
works out again everything the program derives from them: the distinct
pairs, the destination order, the out-degrees, the dangling nodes and the
restart vectors.  It imports nothing of the program.

One step, for each column ``r`` of the ``[n, Q]`` rank matrix and its
restart column ``e`` (a distribution over the nodes)::

    contrib[v] = sum over distinct edges (u, v) of r[u] / outdeg[u]
    contrib   += (sum of r over dangling nodes) * e     # dangling="redistribute"
    r'         = (1 - d) * total * e + d * contrib

with ``total`` the rank sum the initial ranks give (1 under ``uniform``,
``n`` under ``one``).  Ranks are held in ``dtype`` and summed in ``acc``:
float64 and float64 for the yardstick; a lower pair for the control that
stands in the program's place to show the comparison can fail.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class RefGraph(NamedTuple):
    n: int
    src: torch.Tensor  # int64 [E] distinct pairs, sorted by (dst, src)
    dst: torch.Tensor  # int64 [E]
    inv_out: torch.Tensor  # float64 [n], 1 / out-degree, 0 where dangling
    dangling: torch.Tensor  # float64 [n], 1.0 where out-degree is 0


def build(src, dst, n: int, device: str | torch.device) -> RefGraph:
    """The graph of the raw ``(src, dst)`` id arrays (any integer type,
    numpy or torch) over nodes ``[0, n)``, on ``device``."""
    src = torch.as_tensor(src).to(device=device, dtype=torch.int64)
    dst = torch.as_tensor(dst).to(device=device, dtype=torch.int64)
    keys = torch.unique(dst * n + src)
    src, dst = keys % n, keys // n
    out_deg = torch.bincount(src, minlength=n).to(torch.float64)
    inv_out = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    return RefGraph(n=n, src=src, dst=dst, inv_out=inv_out,
                    dangling=(out_deg == 0).to(torch.float64))


def restart_matrix(n: int, queries: Sequence[Sequence[int]] | None,
                   device: str | torch.device) -> torch.Tensor:
    """float64 ``[n, Q]`` restart columns: one uniform column where
    ``queries`` is None, else one column a query, ``1/k`` at each of its
    ``k`` source ids (a repeated id counts each time)."""
    if queries is None:
        return torch.full((n, 1), 1.0 / n, dtype=torch.float64, device=device)
    e = torch.zeros(n, len(queries), dtype=torch.float64, device=device)
    for col, q in enumerate(queries):
        ids = torch.as_tensor(list(q), dtype=torch.int64, device=device)
        e[:, col].index_add_(0, ids, torch.full(ids.shape, 1.0 / len(q),
                                                dtype=torch.float64, device=device))
    return e


def pagerank(g: RefGraph, restart: torch.Tensor, *, iterations: int, damping: float,
             dangling: str, init: str, dtype: torch.dtype = torch.float64,
             acc: torch.dtype = torch.float64,
             max_block_bytes: int = 2 << 30) -> torch.Tensor:
    """``[n, Q]`` ranks after ``iterations`` steps from the initial ranks
    ``init`` (``"uniform"``: 1/n, ``"one"``: 1), in ``dtype``.  Columns
    are taken in blocks whose per-edge values fit ``max_block_bytes``."""
    if dangling not in ("redistribute", "drop"):
        raise ValueError(f"unknown dangling mode {dangling!r}")
    if init not in ("uniform", "one"):
        raise ValueError(f"unknown init {init!r}")
    n, q = restart.shape
    total = float(n) if init == "one" else 1.0
    width = max(1, max_block_bytes // max(1, g.src.shape[0] * 8))
    out = []
    for lo in range(0, q, width):
        e = restart[:, lo:lo + width].to(dtype)
        r = torch.full(e.shape, 1.0 if init == "one" else 1.0 / n, dtype=dtype,
                       device=e.device)
        inv = g.inv_out.to(dtype).unsqueeze(1)
        for _ in range(iterations):
            vals = (r * inv).index_select(0, g.src).to(acc)
            contrib = torch.zeros(e.shape, dtype=acc, device=e.device).index_add_(0, g.dst, vals)
            del vals
            if dangling == "redistribute":
                mass = (r.to(acc) * g.dangling.to(acc).unsqueeze(1)).sum(0)
                contrib += mass * e.to(acc)
            r = ((1.0 - damping) * total * e.to(acc) + damping * contrib).to(dtype)
        out.append(r)
    return torch.cat(out, dim=1)
