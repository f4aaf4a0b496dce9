"""The device mesh of the sharded runners: ordered slots along one axis.

Counterpart of the JAX package's ``parallel/mesh.py``.  The reference is a
single-controller program: one ``shard_map`` over a ``jax.sharding.Mesh``
in one process.  The port keeps that shape.  A :class:`Mesh` is an ordered
tuple of :class:`Slot` s and one axis name; a slot is a logical id plus the
``torch.device`` its shard lives on.  The sharded runners loop over the
slots inside one process, each slot's step on its own device, and the
collectives of :mod:`.collectives` move the per-slot tensors between them.

A slot's device may repeat: D slots of ``cuda:0`` run the D-shard layout,
with its shard shapes, kernels and collectives, on one card, as the
reference's tests run 8 simulated devices on the CPU host
(``--xla_force_host_platform_device_count``); ``cpu`` slots serve the CPU
tests.  :func:`make_mesh` with no ``devices`` spans the visible cards, one
slot each, and raises when fewer than ``n_devices`` are visible.

Slot ids are the logical device index: the index space of the health
registry (``resilience/elastic.py``) and of the chaos grammar's
``device_lost@dev:K``.  A mesh rebuilt over surviving slots keeps their
ids.  Multi-host initialisation (the reference's ``init_distributed``) is
not ported: ROADMAP Queue 1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device

NODES_AXIS = "nodes"  # rank-vector / node-block axis (sharded PageRank, HITS, CC)
DATA_AXIS = "data"  # document/chunk axis (sharded TF-IDF ingest, PPR's query axis)


@dataclasses.dataclass(frozen=True)
class Slot:
    """One position of a mesh: its logical id and the device its shard is on."""

    id: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ordered slots along one named axis."""

    slots: tuple[Slot, ...]
    axis: str = NODES_AXIS

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def devices(self) -> list[torch.device]:
        """Each slot's device, in slot order (a device may repeat)."""
        return [s.device for s in self.slots]


def visible_devices() -> list[torch.device]:
    """Every visible CUDA card, one entry each; raises without CUDA."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_slot(pos: int, d) -> Slot:
    if isinstance(d, Slot):
        return d
    return Slot(pos, torch.device(d))


def make_mesh(
    n_devices: int | None = None,
    axis: str = NODES_AXIS,
    *,
    devices: Sequence | None = None,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible card).  ``devices`` may hold :class:`Slot` s, which keep their
    ids, or devices (``torch.device`` or a string such as ``"cuda:0"``),
    which take their position as id; a device may repeat."""
    devs = list(devices if devices is not None else visible_devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    slots = tuple(_as_slot(i, d) for i, d in enumerate(devs))
    for s in slots:
        resolve_device(s.device)  # a cuda slot without CUDA raises here
    return Mesh(slots, axis)


def mesh_for(n_devices: int | None, axis: str,
             device: str | torch.device | None = None) -> Mesh:
    """The mesh an entry point builds when its caller passes none: the
    visible cards for a CUDA ``device`` (the default), ``n_devices`` slots
    of ``device`` otherwise (one where ``n_devices`` is None)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return make_mesh(n_devices, axis)
    return make_mesh(n_devices, axis, devices=[dev] * (n_devices or 1))


def largest_pow2(n: int) -> int:
    """Largest power of two <= n (0 for n < 1)."""
    if n < 1:
        return 0
    return 1 << (n.bit_length() - 1)


def shrink_devices(devices: Sequence) -> list:
    """Truncate a surviving-slot list to the largest power-of-two count.

    The elastic rung (``resilience/elastic.py``) rebuilds meshes only at
    power-of-two sizes: both sharded runners pad their partitions to the
    slot count, so halving the mesh at worst doubles per-slot state, the
    bound the partition planners already budget for.  Returns ``[]`` when
    nothing survives."""
    return list(devices)[: largest_pow2(len(devices))]


def rebuild_mesh(devices: Sequence, axis: str) -> Mesh:
    """1-D mesh over exactly ``devices`` (slots keep their ids): the
    mesh-rebuild entry point of the elastic rung after
    :func:`shrink_devices` picked the survivors."""
    return make_mesh(axis=axis, devices=devices)


def replicated(mesh: Mesh, host: np.ndarray) -> list[torch.Tensor]:
    """One copy of ``host`` on every slot's device."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    return [src.to(s.device, copy=True) for s in mesh.slots]


def sharded_along(mesh: Mesh, host: np.ndarray) -> list[torch.Tensor]:
    """``host`` cut into ``mesh.size`` equal blocks along dim 0, block ``i``
    on slot ``i``'s device."""
    d = mesh.size
    if host.shape[0] % d:
        raise ValueError(f"dim 0 of {host.shape} does not split into {d} equal blocks")
    blocks = np.split(np.ascontiguousarray(host), d)
    return [torch.from_numpy(np.ascontiguousarray(b)).to(s.device, copy=True)
            for b, s in zip(blocks, mesh.slots)]
