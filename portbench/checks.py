"""The numbers that decide ``correct``: the program's ranks against the reference's.

Each call's answer is a ``[B, n]`` rank matrix, one row a query (one row
for a whole ranking job).  Against the float64 reference's ``[n, B]``
columns, each row gives two readings, and a run keeps the worst of each
over every row it compares:

- ``rank_l1``: ``sum |p - r| / sum |r|``, the share of the row's rank mass
  that is misplaced;
- ``rank_max_rel``: ``max |p - r| / max(|r|, floor)``, the largest error
  of one entry relative to its own rank, with ``floor`` a thousandth of
  the row's mean rank, so that entries the reference puts at or near 0
  are held to that much and no less.

A reading that is not a number (a NaN in the answer, a wrong shape) is
infinite, and fails any limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("rank_l1", "rank_max_rel")
FLOOR_OF_MEAN = 1e-3


def readings(program: np.ndarray, ref: torch.Tensor) -> dict[str, float]:
    """The worst readings over the rows of ``program`` (``[B, n]``, any
    float type) against the columns of ``ref`` (``[n, B]``, float64)."""
    n, b = ref.shape
    if program.shape != (b, n):
        return {k: math.inf for k in NAMES}
    p = torch.from_numpy(np.ascontiguousarray(program)).to(ref.device, torch.float64).T
    diff = (p - ref).abs()
    mass = ref.abs().sum(0)
    l1 = diff.sum(0) / mass
    rel = diff / torch.maximum(ref.abs(), (FLOOR_OF_MEAN / n) * mass)
    out = {"rank_l1": float(l1.max()), "rank_max_rel": float(rel.max())}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(a: dict[str, float] | None, b: dict[str, float]) -> dict[str, float]:
    return dict(b) if a is None else {k: max(a[k], b[k]) for k in NAMES}


def judge(values: dict[str, float] | None, limits: dict) -> tuple[bool, dict]:
    """``(passed, {name: {"value", "limit"}})``: every reading at or under
    its limit.  No readings (nothing compared) or a missing limit fails."""
    table = {k: {"value": (values or {}).get(k, math.inf), "limit": limits.get(k)}
             for k in NAMES}
    ok = values is not None and all(
        t["limit"] is not None and t["value"] <= t["limit"] for t in table.values())
    return ok, table
