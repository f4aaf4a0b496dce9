"""Tracing / profiling.

Counterpart of the JAX package's ``utils/profiling.py``.  Two layers:

- ``trace(logdir)`` wraps a region in a ``torch.profiler.profile`` over
  the host and the card, and writes its Chrome trace into ``logdir``
  (viewable in Perfetto or ``chrome://tracing``);
- ``annotate(name)`` marks a host-side phase: an :func:`obs.span`, which
  lands in the run's crash-safe JSONL trace and, through
  ``torch.profiler.record_function``, in the profile beside the card's
  kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs


@contextlib.contextmanager
def trace(logdir: str | None) -> Iterator[None]:
    """Profile the enclosed region into ``logdir`` (no-op if None): one
    ``<pid>.pt.trace.json`` Chrome trace of host ops and, where CUDA is
    available, the card's kernels and copies."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"{os.getpid()}.pt.trace.json"))


def annotate(name: str, **attrs):
    """Named host-side phase: an obs span (JSONL trace + nesting) bridged
    to the ``torch.profiler`` timeline."""
    return obs.span(name, **attrs)
