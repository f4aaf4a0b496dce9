"""``iterate``, the iterate-to-convergence loop under every PageRank
runner, and ``commit_barrier``, the commit point of the streaming ingest.

Counterpart of the JAX package's ``dataflow/fixpoint.py`` ``iterate``,
``default_delta`` and ``commit_barrier``.  PyTorch runs eagerly, so the
loop is a Python loop that enqueues one step after another on the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs


def commit_barrier(
    drain_all: Callable[[], None],
    commit: Callable[[], None],
    save_checkpoint: Callable[[], None] | None = None,
) -> None:
    """The drain-before-commit barrier of the staged ingest pipeline: every
    in-flight launch drains, then the device carry is pulled, then
    (optionally) the snapshot is written, so a checkpoint never holds carry
    contributions from chunks it does not record as ingested.  The
    ``ingest.commit_barrier`` span makes the drain's stall visible in a
    trace."""
    with obs.span("ingest.commit_barrier"):
        drain_all()
        commit()
        if save_checkpoint is not None:
            save_checkpoint()


def default_delta(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """L1 distance between successive carries."""
    return torch.sum(torch.abs(new - old))


def _first_tensor(carry) -> torch.Tensor:
    return carry if isinstance(carry, torch.Tensor) else carry[0]


def iterate(
    step: Callable,
    carry0,
    *,
    iterations: int,
    tol: float = 0.0,
    delta_fn: Callable = default_delta,
):
    """Run ``step(carry) -> carry`` to a fixpoint.

    With ``tol == 0`` it runs exactly ``iterations`` steps with no host
    sync, and measures ``delta_fn(new, old)`` on the last step only.  With
    ``tol > 0`` it measures the delta every step and reads it on the host
    (one sync per step), stopping once it is ``<= tol``.  Returns
    ``(carry, iters_done, last_delta)``; ``last_delta`` is a 0-d tensor of
    the carry's dtype (float32 for a non-float carry), ``inf`` when
    ``iterations == 0``."""
    like = _first_tensor(carry0)
    dtype = like.dtype if like.is_floating_point() else torch.float32
    delta = torch.full((), float("inf"), dtype=dtype, device=like.device)
    carry = carry0
    if tol > 0.0:
        it = 0
        while it < iterations and float(delta) > tol:
            new = step(carry)
            delta = delta_fn(new, carry)
            carry = new
            it += 1
        return carry, it, delta
    for i in range(iterations):
        new = step(carry)
        if i == iterations - 1:
            delta = delta_fn(new, carry)
        carry = new
    return carry, iterations, delta
