"""Device health, device-loss classification and the elastic mesh shrink.

Counterpart of the JAX package's ``resilience/elastic.py``:

- a process-global :class:`DeviceHealth` registry of lost devices, whose
  indices are logical device indices: a ``torch.cuda`` device index on the
  single-device paths and a mesh slot's id on the sharded ones
  (``parallel/mesh.py``), the index space the chaos grammar's
  ``device_lost@dev:K`` names.  A rung that takes a loss marks its device
  here, and ``resilience/chaos.py`` stops injecting a ``device_lost`` once
  its device is marked, as a card that is no longer scheduled onto can no
  longer fail a call;
- :func:`is_device_loss`, :func:`unwrap_device_loss` and
  :func:`device_index`: whether an error is a device loss (an injected
  ``DeviceLostError`` or one of the reference's loss markers), seen
  through a :class:`~.executor.ResilienceExhausted` that wraps one, and
  which device it names;
- the mesh half: :func:`probe_devices` (a cheap liveness check of each
  slot), :class:`ShrinkPlan` and :func:`plan_shrink` (the surviving slots,
  truncated to a power-of-two count; the rung: ``mesh_shrink`` while more
  than one slot survives, ``single_device`` at the end of the chain,
  ``cpu`` when no slot survives and one CPU slot hosts the mesh; None when
  not even that exists), and :func:`publish_shrink` (the ``mesh.shrink``
  span and ONE ``degraded`` event with the rung and the old and new slot
  counts).

The single-device rungs are the CPU salvage of ``dataflow/fixpoint.py``
(PageRank, PPR, HITS, components) and the streaming rollback of
``models/tfidf.py``; the mesh rungs are those of
``parallel/pagerank_sharded.py`` and ``parallel/tfidf_sharded.py``.  All
of them take only a loss that names its device: a whole-backend loss
(``lost``) raises ``ResilienceExhausted`` with the newest checkpoint.  A
sticky CUDA error (``executor._STICKY_CUDA_MARKERS``) is not a loss here:
it is as likely to be one of the port's own kernels at fault, and a rung
that took it would hide the kernel behind its plain version.

Env knob: ``GRAFT_ELASTIC`` ("0" turns the rungs off: a device loss then
raises ``ResilienceExhausted`` with the newest checkpoint).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Iterator, Sequence

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos


class DeviceHealth:
    """Thread-safe registry of lost logical device indices (``torch.cuda``
    device indices, or mesh slot ids: the chaos grammar's
    ``device_lost@dev:K``)."""

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


def probe_devices(devices: Sequence) -> list:
    """The slots of ``devices`` (``parallel.mesh.Slot`` s) that are both
    unmarked in the health registry and answer a one-element round trip to
    their device.  The probe is the production-path detector (a dead card
    raises on the copy); under chaos the registry alone decides, since an
    injected loss leaves the card answering."""
    import torch

    alive = []
    for s in devices:
        if _health.is_lost(s.id):
            continue
        try:
            # one round trip a slot, by design: the probe's job is touching
            # each device, and it runs only on the (rare) shrink path
            torch.ones(1, dtype=torch.int32, device=s.device).cpu()  # graftlint: disable=host-sync-in-loop (ROADMAP Queue 3, shared with the reference: one round trip a slot on the rare shrink path)
        except Exception:
            _health.mark_lost(s.id)
            continue
        alive.append(s)
    return alive


@dataclasses.dataclass(frozen=True)
class ShrinkPlan:
    """One planned mesh shrink: the slots the rebuilt mesh will span, the
    ladder rung it is, and the old and new counts that the ``degraded``
    event and the ``mesh.shrink`` span publish."""

    devices: tuple
    old_count: int
    new_count: int
    rung: str  # a utils/config.DEGRADE_LADDER member


def plan_shrink(mesh_devices: Sequence) -> ShrinkPlan | None:
    """Plan the next shrink for a mesh spanning the slots ``mesh_devices``.

    Survivors are probed, truncated to a power-of-two count
    (``parallel.mesh.shrink_devices``), and, when the loss could not be
    attributed to any one slot but the step keeps failing, cut to strictly
    fewer slots than before, so the ladder always makes progress.  With no
    surviving slot the plan hosts a 1-slot mesh on the CPU (the ``cpu``
    rung), unless the dying mesh was already on the CPU; None means the
    ladder is exhausted."""
    import torch

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh

    devices = list(mesh_devices)
    old = len(devices)
    alive = probe_devices(devices)
    survivors = pmesh.shrink_devices(alive)
    if len(survivors) == old and old > 1:
        # nothing attributable died, yet the sharded step keeps failing:
        # halve anyway rather than rebuild the same mesh forever
        survivors = survivors[: pmesh.largest_pow2(old - 1)]
    if survivors:
        rung = "mesh_shrink" if len(survivors) > 1 else "single_device"
        return ShrinkPlan(tuple(survivors), old, len(survivors), rung)
    # No slot survives: host the 1-slot mesh on the CPU, unless the dying
    # mesh was on the CPU already (there is no fresh CPU to fall to)
    if any(s.device.type == "cpu" for s in devices):
        return None
    return ShrinkPlan((pmesh.Slot(0, torch.device("cpu")),), old, 1, "cpu")


@contextlib.contextmanager
def publish_shrink(
    site: str,
    plan: ShrinkPlan,
    exc: BaseException,
    metrics=None,
) -> Iterator[None]:
    """The one shrink-event contract of both sharded runners: a
    ``mesh.shrink`` span around the rebuild, exactly ONE ``degraded`` event
    with the rung and the old and new slot counts, and its metrics record."""
    with obs.span("mesh.shrink", site=site, ladder=plan.rung,
                  devices_old=plan.old_count, devices_new=plan.new_count):
        obs.emit(
            "degraded", site=site, ladder=plan.rung,
            devices_old=plan.old_count, devices_new=plan.new_count,
            error=f"{type(exc).__name__}: {exc}"[:200],
        )
        obs.counter("degraded")
        if metrics is not None:
            metrics.record(
                event="degraded", site=site, ladder=plan.rung,
                devices_old=plan.old_count, devices_new=plan.new_count,
            )
        yield
