"""The device mesh of the sharded runners: ordered slots along one axis,
in one process or across several.

Counterpart of the JAX package's ``parallel/mesh.py``.  The reference is a
single-controller program: one ``shard_map`` over a ``jax.sharding.Mesh``.
The port keeps that shape.  A :class:`Mesh` is an ordered tuple of
:class:`Slot` s and one axis name; a slot is a logical id, the
``torch.device`` its shard lives on and the process that owns it.  The
sharded runners loop over the slots this process owns, each slot's step on
its own device, and the collectives of :mod:`.collectives` move the
per-slot tensors between the slots.

A slot's device may repeat: D slots of ``cuda:0`` run the D-shard layout,
with its shard shapes, kernels and collectives, on one card, as the
reference's tests run 8 simulated devices on the CPU host
(``--xla_force_host_platform_device_count``); ``cpu`` slots serve the CPU
tests.  :func:`make_mesh` with no ``devices`` spans the visible cards, one
slot each, and raises when fewer than ``n_devices`` are visible.

Several processes: after :func:`init_distributed` (the reference's
``jax.distributed.initialize``), a mesh's slots may name every process of
the group, each owning an equal, contiguous run of slots in process order.
Every process runs the same program over its own slots (the *local*
slots), and the collectives gather every slot's tensor onto each process
and fold them in slot order, so each slot holds the bits the one-process
mesh of the same slots gives.  ``make_mesh()`` then spans every process's
visible cards, and :func:`mesh_for` spreads CPU slots evenly over the
processes.  A mesh whose slots all name one process is a one-process mesh:
whichever process runs it holds every slot.  A slot's ``device`` is named
as its own process names it; a remote slot's device is never touched.

Slot ids are the logical device index: the index space of the health
registry (``resilience/elastic.py``) and of the chaos grammar's
``device_lost@dev:K``.  A mesh rebuilt over surviving slots keeps their
ids; only a one-process mesh is rebuilt (the runners' elastic rungs stay
in one process).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Sequence

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import resolve_device

NODES_AXIS = "nodes"  # rank-vector / node-block axis (sharded PageRank, HITS, CC)
DATA_AXIS = "data"  # document/chunk axis (sharded TF-IDF ingest, PPR's query axis)

# How long a process waits in a collective, a barrier or the rendezvous
# before it raises: a peer that died ends every other process's wait.
DEFAULT_TIMEOUT_S = 300.0

# The object/barrier group of the process group (gloo, whatever the
# collectives' backend), set by init_distributed.
_META_GROUP: list = []


@dataclasses.dataclass(frozen=True)
class Slot:
    """One position of a mesh: its logical id, the device its shard is on
    (as the owning process names it) and that process."""

    id: int
    device: torch.device
    process: int = 0


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

    @property
    def processes(self) -> int:
        """How many processes own the slots (1: a one-process mesh)."""
        return len({s.process for s in self.slots})

    @property
    def positions(self) -> list[int]:
        """The positions of this process's slots along the axis."""
        if self.processes == 1:
            return list(range(self.size))
        me = process_index()
        return [i for i, s in enumerate(self.slots) if s.process == me]

    @property
    def local_slots(self) -> list[Slot]:
        """This process's slots, in slot order."""
        return [self.slots[i] for i in self.positions]

    @property
    def backend(self) -> str | None:
        """The process group's backend on a multi-process mesh, else None."""
        return backend() if self.processes > 1 else None


def _dist():
    import torch.distributed as dist

    return dist


def is_distributed() -> bool:
    """Whether :func:`init_distributed` joined this process to a group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return _dist().get_rank() if is_distributed() else 0


def process_count() -> int:
    """The process group's size (1 outside a process group)."""
    return _dist().get_world_size() if is_distributed() else 1


def backend() -> str | None:
    """The process group's backend (``"gloo"`` or ``"nccl"``), else None."""
    return str(_dist().get_backend()) if is_distributed() else None


def _resolve(coordinator_address, num_processes, process_id, backend_):
    """``(host, port, world, rank, backend)`` from the arguments, each one
    left None read from ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``; the backend defaults to NCCL where CUDA is available, gloo
    otherwise."""
    env = os.environ

    def need(name: str) -> str:
        if name not in env:
            raise ValueError(f"init_distributed: no argument given and ${name} is not set")
        return env[name]

    if coordinator_address is None:
        coordinator_address = f"{need('MASTER_ADDR')}:{need('MASTER_PORT')}"
    host, sep, port = str(coordinator_address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address {coordinator_address!r} is not host:port")
    world = int(need("WORLD_SIZE") if num_processes is None else num_processes)
    rank = int(need("RANK") if process_id is None else process_id)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world} processes")
    if backend_ is None:
        backend_ = "nccl" if torch.cuda.is_available() else "gloo"
    if backend_ not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend_!r}: use 'gloo' or 'nccl'")
    if backend_ == "nccl" and not torch.cuda.is_available():
        raise ValueError("backend 'nccl' needs CUDA cards, and CUDA is not available; "
                         "CPU slots exchange over backend='gloo'")
    return host, int(port), world, rank, backend_


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to a group of ``num_processes``: call once in
    every process before building a mesh.  Afterwards ``make_mesh()`` spans
    every process's visible cards and every sharded runner runs over a mesh
    whose slots span the processes.

    ``coordinator_address`` is ``host:port`` of process 0's rendezvous
    (``torch.distributed``'s ``tcp://`` init method); the arguments left
    None are read from ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``, which ``torchrun`` sets, as the reference reads its cluster's
    environment.  ``backend`` defaults to ``"nccl"`` where CUDA is
    available and ``"gloo"`` otherwise.  NCCL runs one process a card: a
    card that two processes see raises ``ValueError`` (processes that
    share a card pass ``backend="gloo"``; their tensors then cross through
    the host).  Every wait of the group (the rendezvous, a collective, a
    barrier) raises after ``timeout_s``, so a dead peer ends the others'
    runs instead of hanging them."""
    dist = _dist()
    host, port, world, rank, be = _resolve(coordinator_address, num_processes,
                                           process_id, backend)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(be, init_method=f"tcp://{host}:{port}", world_size=world,
                            rank=rank, timeout=timeout)
    meta = None if be == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    _META_GROUP[:] = [meta]
    if be == "nccl":
        cards = [str(torch.cuda.get_device_properties(i).uuid)
                 for i in range(torch.cuda.device_count())]
        seen: list = [None] * world
        dist.all_gather_object(seen, cards, group=meta)
        owner: dict = {}
        for r, theirs in enumerate(seen):
            for c in theirs:
                if c in owner:
                    dist.destroy_process_group()
                    _META_GROUP.clear()
                    raise ValueError(
                        f"backend 'nccl' cannot run two processes on one card: processes "
                        f"{owner[c]} and {r} both see card {c}; give each process its "
                        "own cards (CUDA_VISIBLE_DEVICES), or pass backend='gloo' to "
                        "share a card through the host")
                owner[c] = r
        torch.cuda.set_device(0)


def _meta_group():
    return _META_GROUP[0] if _META_GROUP else None


def all_processes(value) -> list:
    """``value`` from every process of the group, in process order (a
    picklable object; one process: ``[value]``)."""
    if not is_distributed():
        return [value]
    out: list = [None] * process_count()
    _dist().all_gather_object(out, value, group=_meta_group())
    return out


def barrier() -> None:
    """Every process of the group waits here for the others (no-op in one
    process)."""
    if is_distributed():
        _dist().barrier(group=_meta_group())


def first_process_writes(mesh: Mesh, write, *args, **kwargs):
    """``write(*args, **kwargs)`` for the mesh: in one process it is just
    the call; on a multi-process mesh process 0 writes and every process
    then passes a barrier, so none reads or goes on before the write
    lands.  Returns ``write``'s value on process 0, None elsewhere."""
    if mesh.processes == 1:
        return write(*args, **kwargs)
    out = write(*args, **kwargs) if process_index() == 0 else None
    barrier()
    return out


def visible_devices() -> list[torch.device]:
    """Every visible CUDA card, one entry each; raises without CUDA."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _default_slots() -> list:
    """The visible cards, one slot each; in a process group every
    process's visible cards, ids in process order."""
    if process_count() == 1:
        return visible_devices()
    counts = all_processes(len(visible_devices()))
    slots = []
    for p, n in enumerate(counts):
        slots += [Slot(len(slots), torch.device("cuda", k), p) for k in range(n)]
    return slots


def _as_slot(pos: int, d) -> Slot:
    if isinstance(d, Slot):
        return d
    return Slot(pos, torch.device(d))


def _check_processes(slots: tuple[Slot, ...]) -> None:
    """A multi-process mesh: the group's every process, each holding an
    equal, contiguous run of slots in process order."""
    procs = [s.process for s in slots]
    n = len(set(procs))
    if n == 1:
        return
    if len(slots) % n:
        raise ValueError(f"{len(slots)} slots do not divide evenly over {n} processes")
    per = len(slots) // n
    if procs != [i // per for i in range(len(slots))]:
        raise ValueError(f"slot processes {procs}: each process must hold {per} "
                         "contiguous slots, in process order")
    if process_count() != n:
        raise ValueError(f"the mesh spans {n} processes but the process group has "
                         f"{process_count()} (call init_distributed in every process)")


def make_mesh(
    n_devices: int | None = None,
    axis: str = NODES_AXIS,
    *,
    devices: Sequence | None = None,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible card, every process's in a process group).  ``devices`` may
    hold :class:`Slot` s, which keep their ids and processes, or devices
    (``torch.device`` or a string such as ``"cuda:0"``), which take their
    position as id and process 0; a device may repeat.  A mesh over
    several processes must hold an equal, contiguous run of slots a
    process, in process order, over every process of the group."""
    devs = list(devices if devices is not None else _default_slots())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    slots = tuple(_as_slot(i, d) for i, d in enumerate(devs))
    _check_processes(slots)
    mesh = Mesh(slots, axis)
    for s in mesh.local_slots:
        resolve_device(s.device)  # a cuda slot without CUDA raises here
    return mesh


def mesh_for(n_devices: int | None, axis: str,
             device: str | torch.device | None = None) -> Mesh:
    """The mesh an entry point builds when its caller passes none: the
    visible cards for a CUDA ``device`` (the default), ``n_devices`` slots
    of ``device`` otherwise (one where ``n_devices`` is None); in a process
    group those slots are spread evenly over the processes (one a process
    where ``n_devices`` is None)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return make_mesh(n_devices, axis)
    procs = process_count()
    n = n_devices or procs
    if n % procs:
        raise ValueError(f"{n} slots do not divide evenly over {procs} processes")
    per = n // procs
    return make_mesh(axis=axis, devices=[Slot(i, dev, i // per) for i in range(n)])


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
    """One copy of ``host`` on each of this process's slots."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    return [src.to(s.device, copy=True) for s in mesh.local_slots]


def sharded_along(mesh: Mesh, host: np.ndarray) -> list[torch.Tensor]:
    """``host`` cut into ``mesh.size`` equal blocks along dim 0, block ``i``
    on slot ``i``'s device; this process's slots' blocks."""
    d = mesh.size
    if host.shape[0] % d:
        raise ValueError(f"dim 0 of {host.shape} does not split into {d} equal blocks")
    blocks = np.split(np.ascontiguousarray(host), d)
    return [torch.from_numpy(np.ascontiguousarray(blocks[i])).to(mesh.slots[i].device,
                                                                 copy=True)
            for i in mesh.positions]
