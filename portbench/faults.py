"""Faults planted in the program's timed path, to show the comparison catches them.

Each fault wraps one step of the program's loop (``ops.pagerank.pagerank_step``
under ``api.pagerank``, ``pagerank_step_batch`` under ``run_ppr_batch``):

- ``unchanged``: the step returns its state unchanged;
- ``altered``: one answer altered where the step makes it, the largest
  entry of every row 5% high (an entry far below the row's mean, such as
  a node far from a query's source, is held to a floor, ``checks.py``);
- ``half_batch``: half the batch left out, its rows replaced by the mean
  of the rest (batched steps only).

``calibrate.py --fault-seeds`` reads them on the card at a cell's own size; the
benchmark's tests read them on the CPU at the tests' size.  The cells run
on one card, so they have no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


def _unchanged(real):
    return lambda ranks, *a, **k: ranks.clone()


def _altered(real):
    def step(ranks, *a, **k):
        out = real(ranks, *a, **k).clone()
        top = out.argmax(-1, keepdim=True)
        return out.scatter_(-1, top, out.gather(-1, top) * 1.05)
    return step


def _half_batch(real):
    def step(ranks, *a, **k):
        out = real(ranks, *a, **k)
        h = out.shape[0] // 2
        out[h:] = out[:h].mean(0, keepdim=True)
        return out
    return step


FAULTS = {"unchanged": _unchanged, "altered": _altered, "half_batch": _half_batch}


def step_name(entry: str) -> str:
    """The step of the program's ``ops.pagerank`` that the traffic's entry drives."""
    return "pagerank_step_batch" if entry == "ppr_batch" else "pagerank_step"


def applies(name: str, entry: str) -> bool:
    """Whether the fault ``name`` can happen under the entry ``entry``."""
    return name != "half_batch" or entry == "ppr_batch"


@contextlib.contextmanager
def planted(name: str, entry: str):
    """The fault ``name`` planted in the step the entry drives, for the
    ``with`` block's length."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops

    attr = step_name(entry)
    real = getattr(ops, attr)
    setattr(ops, attr, FAULTS[name](real))
    try:
        yield
    finally:
        setattr(ops, attr, real)
