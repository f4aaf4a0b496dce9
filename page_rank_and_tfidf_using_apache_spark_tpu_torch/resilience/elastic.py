"""Device health and device-loss classification: the single-device half of
the JAX package's ``resilience/elastic.py``.

- a process-global :class:`DeviceHealth` registry of lost devices, whose
  indices are ``torch.cuda`` device indices: the index space the chaos
  grammar's ``device_lost@dev:K`` names.  A rung that takes a loss marks
  its device here, and ``resilience/chaos.py`` stops injecting a
  ``device_lost`` once its device is marked, as a card that is no longer
  scheduled onto can no longer fail a call;
- :func:`is_device_loss`, :func:`unwrap_device_loss` and
  :func:`device_index`: whether an error is a device loss (an injected
  ``DeviceLostError`` or one of the reference's loss markers), seen
  through a :class:`~.executor.ResilienceExhausted` that wraps one, and
  which device it names.

The rungs that use these are the CPU salvage of ``dataflow/fixpoint.py``
(PageRank, PPR, HITS, components) and the streaming rollback of
``models/tfidf.py``.  A sticky CUDA error (``executor._STICKY_CUDA_MARKERS``)
is not a loss here: it is as likely to be one of the port's own kernels
at fault, and a rung that took it would hide the kernel behind its plain
version.

The mesh half of the reference (``probe_devices``, ``ShrinkPlan``,
``plan_shrink``, ``publish_shrink``) needs a device mesh, which the port
does not have yet: ROADMAP Queue 1 item 11.

Env knob: ``GRAFT_ELASTIC`` ("0" turns the salvage off: a device loss
then raises ``ResilienceExhausted`` with the newest checkpoint).
"""

from __future__ import annotations

import os
import threading

from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos


class DeviceHealth:
    """Thread-safe registry of lost device indices (``torch.cuda`` device
    indices, the chaos grammar's ``device_lost@dev:K``)."""

    def __init__(self) -> None:
        self._lost: set[int] = set()
        self._lock = threading.Lock()

    def mark_lost(self, index: int) -> bool:
        """Record device ``index`` as dead; True if newly marked."""
        with self._lock:
            if index in self._lost:
                return False
            self._lost.add(index)
            return True

    def is_lost(self, index: int) -> bool:
        with self._lock:
            return index in self._lost

    def lost(self) -> frozenset:
        with self._lock:
            return frozenset(self._lost)

    def reset(self) -> None:
        with self._lock:
            self._lost.clear()


_health = DeviceHealth()


def health() -> DeviceHealth:
    """The process-global device-health registry."""
    return _health


def reset_health() -> None:
    """Forget all recorded losses (tests; a fresh run of a fresh process
    never needs this)."""
    _health.reset()


def enabled() -> bool:
    return os.environ.get("GRAFT_ELASTIC", "1") != "0"


# The reference's lexical markers of a device-loss error, for an error that
# is not an injected chaos.DeviceLostError.  No CUDA message is among them
# (see the module docstring).
_DEVICE_LOSS_MARKERS = ("DEVICE_LOST", "device is lost", "device lost")


def is_device_loss(exc: BaseException) -> bool:
    if isinstance(exc, chaos.DeviceLostError):
        return True
    return any(m in str(exc) for m in _DEVICE_LOSS_MARKERS)


def unwrap_device_loss(exc: BaseException) -> BaseException | None:
    """The device-loss error carried by ``exc``: the exception itself, or
    the terminal error inside a :class:`~.executor.ResilienceExhausted`
    (an inner guarded call with no rung of its own exhausts with the loss
    as its ``last_error``).  None when ``exc`` is not a loss."""
    if is_device_loss(exc):
        return exc
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience.executor import (
        ResilienceExhausted,
    )

    if isinstance(exc, ResilienceExhausted) and is_device_loss(exc.last_error):
        return exc.last_error
    return None


def device_index(exc: BaseException) -> int | None:
    """The lost device index an error names, or None (a whole-backend loss,
    or no attribution)."""
    dev = getattr(exc, "device", None)
    return int(dev) if isinstance(dev, int) else None
