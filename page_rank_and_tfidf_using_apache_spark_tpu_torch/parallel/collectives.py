"""The collectives of the sharded runners, over lists of per-slot tensors.

Counterpart of the JAX package's ``parallel/collectives.py``, whose
functions are XLA collectives inside ``shard_map``.  Here a sharded value
is a list with one tensor per slot this process owns, in slot order (entry
``i`` on that slot's device), and each collective takes such a list and
returns one:

- :func:`psum`            every slot gets the sum over slots
- :func:`all_gather`      tiled: ``[B]`` a slot -> ``[D*B]`` on every slot
- :func:`reduce_scatter`  ``[D*B]`` a slot -> the sum's block ``i`` on slot ``i``
- :func:`ppermute_ring`   slot ``i``'s tensor moves to slot ``i+shift``
- :func:`ring_reduce_scatter`  :func:`reduce_scatter` hop by hop over
                          :func:`ppermute_ring`, in the reference's order
- :func:`pmax`            every slot gets the max over slots
- :func:`butterfly_all_gather`  log2(D) rounds of pairwise exchange
- :func:`axis_index`, :func:`axis_size`

A reduction adds in one fixed order, slot 0 first, on the first slot's
device, so two runs give equal bits.  Moving a tensor to another slot is a
``.to()`` copy onto that slot's device, which is no copy where two slots
share a device: a result may then be the same tensor on several slots, and
no caller writes into a collective's result in place.

Each collective takes the ``mesh`` the list belongs to.  Without one, or on
a one-process mesh, the list holds every slot.  On a mesh whose slots span
processes (``mesh.init_distributed``) the list holds this process's slots:
the collective first gathers every slot's tensor, in slot order, onto this
process (:func:`gather_slots`, one ``torch.distributed.all_gather``), then
computes on the gathered list exactly what the one-process mesh computes,
and keeps what this process's slots receive.  So every slot holds the
one-process mesh's bits, where ``all_reduce`` would add in an order the
library picks; the price is D-fold traffic, not the least.  Under gloo the
tensors cross through the host (gloo takes no CUDA tensor), under NCCL
they stay on the card.  Every slot's tensor must have one shape and dtype.

Being Python over lists, a collective leaves no op of its own in a traced
graph.  So while the static analyzer traces a step (``analysis/trace.py``
opens :func:`recording`), each reports its name, the mesh's axis and slot
count and its results to the recorder: :func:`ppermute_ring` as one
``ppermute``, :func:`ring_reduce_scatter` as its D-1 ``ppermute`` hops and
:func:`butterfly_all_gather` as its log2(D) ``ppermute`` rounds, the
reference's communication primitives.  Outside a trace nothing records.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

# This thread's open recorder, if any (see ``recording``).
_TRACING = threading.local()


@contextlib.contextmanager
def recording(recorder: Callable):
    """While open, every collective of this thread calls ``recorder(name,
    axis, size, outputs, count)``: its primitive's name, ``mesh.axis``
    (None without a mesh), the slot count, the per-slot results and how
    many primitives of that name it ran."""
    was = getattr(_TRACING, "recorder", None)
    _TRACING.recorder = recorder
    try:
        yield
    finally:
        _TRACING.recorder = was


def _note(name: str, xs: list, mesh, out: list, count: int = 1) -> list:
    recorder = getattr(_TRACING, "recorder", None)
    if recorder is not None and count:
        recorder(name, None if mesh is None else mesh.axis,
                 len(xs) if _one_process(mesh) else mesh.size, out, count)
    return out


def _one_process(mesh) -> bool:
    return mesh is None or mesh.processes == 1


def gather_slots(xs: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """Every slot's tensor, in slot order, on this process: ``xs`` itself
    on a one-process mesh, else each process's slots' tensors gathered onto
    the device of this process's first slot."""
    if _one_process(mesh):
        return list(xs)
    import torch.distributed as dist

    home = xs[0].device
    if len({(tuple(x.shape), x.dtype) for x in xs}) != 1:
        raise ValueError("a collective across processes needs one shape and dtype a slot")
    send = torch.stack([x.to(home) for x in xs])
    if mesh.backend == "gloo":
        send = send.cpu()  # graftlint: disable=unguarded-host-sync (ROADMAP Queue 3: parallel/collectives.py across processes — gloo takes no CUDA tensor, so it goes through the host)
    parts = [torch.empty_like(send) for _ in range(mesh.processes)]
    dist.all_gather(parts, send.contiguous())
    return list(torch.cat(parts).to(home).unbind(0))


def _keep(full: list[torch.Tensor], xs: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """What this process's slots receive of a result over every slot."""
    return [full[g].to(x.device) for g, x in zip(mesh.positions, xs)]


def _spread(value: torch.Tensor, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``value`` on every slot's device (``xs`` gives the devices)."""
    return [value.to(x.device) for x in xs]


def _fold(xs: list[torch.Tensor], op) -> torch.Tensor:
    home = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(home))
    return acc


def psum(xs: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """The sum over slots, left to right from slot 0, on every slot."""
    return _note("psum", xs, mesh, _spread(_fold(gather_slots(xs, mesh=mesh), torch.add), xs))


def pmax(xs: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """The elementwise max over slots on every slot (the normalisation
    collective of sharded HITS)."""
    return _note("pmax", xs, mesh,
                 _spread(_fold(gather_slots(xs, mesh=mesh), torch.maximum), xs))


def all_gather(xs: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """Tiled gather: ``[B]`` a slot -> the ``[D*B]`` concatenation in slot
    order on every slot."""
    full = gather_slots(xs, mesh=mesh)
    home = full[0].device
    return _note("all_gather", xs, mesh, _spread(torch.cat([x.to(home) for x in full]), xs))


def _across(one_process_fn, xs: list, mesh) -> list:
    """``one_process_fn`` over every slot's tensor: over ``xs`` on a
    one-process mesh, else over the gathered list, of which this process's
    slots keep theirs."""
    if _one_process(mesh):
        return one_process_fn(xs)
    return _keep(one_process_fn(gather_slots(xs, mesh=mesh)), xs, mesh)


def _reduce_scatter(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    d = len(xs)
    blocks = _fold(xs, torch.add).reshape(d, -1)
    return [blocks[i].to(x.device) for i, x in enumerate(xs)]


def reduce_scatter(xs: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """``[D*B]`` a slot -> the sum over slots, of which slot ``i`` keeps
    block ``i``."""
    return _note("reduce_scatter", xs, mesh, _across(_reduce_scatter, xs, mesh))


def _ppermute(xs: list[torch.Tensor], shift: int) -> list[torch.Tensor]:
    n = len(xs)
    return [xs[(i - shift) % n].to(x.device) for i, x in enumerate(xs)]


def ppermute_ring(xs: list[torch.Tensor], *, shift: int = 1,
                  mesh=None) -> list[torch.Tensor]:
    """Rotate: slot ``i``'s tensor goes to slot ``(i + shift) % D``."""
    return _note("ppermute", xs, mesh, _across(lambda full: _ppermute(full, shift), xs, mesh))


def _ring_reduce_scatter(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    d = len(partials)
    if d == 1:
        return list(partials)
    chunks = [p.reshape(d, -1) for p in partials]
    acc = [chunks[i][(i - 1) % d] for i in range(d)]
    for s in range(d - 1):
        acc = _ppermute(acc, 1)  # receive from slot i-1
        acc = [a + chunks[i][(i - 2 - s) % d] for i, a in enumerate(acc)]
    return acc


def ring_reduce_scatter(partials: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """The ring reduce-scatter of the reference's ``src_ring`` strategy,
    hop by hop.  ``partials``: a ``[D*B]`` per-destination partial a slot.
    Slot ``i`` seeds with its partial for block ``i-1``; each of the D-1
    hops rotates the accumulating block one slot forward and the receiver
    adds its own partial for that block, so slot ``i`` ends with block
    ``i`` complete.  Equal to :func:`reduce_scatter` up to the order of
    the adds.  Across processes the hops run on the gathered partials."""
    out = _across(_ring_reduce_scatter, partials, mesh)
    return _note("ppermute", partials, mesh, out, axis_size(partials, mesh=mesh) - 1)


def butterfly_all_gather(blocks: list[torch.Tensor], *, mesh=None) -> list[torch.Tensor]:
    """Recursive-doubling all-gather, the ``owned`` strategy's boundary
    exchange: each slot contributes a fixed-width ``[B, ...]`` block and
    ends with the ``[D*B, ...]`` concatenation in slot order, after log2(D)
    rounds in which slot ``i`` sends its filled aligned ``2^k``-row group
    to slot ``i XOR 2^k``.  D must be a power of two (the ``owned``
    planner refuses other counts).  Across processes the rounds run on the
    gathered blocks."""
    out = _across(_butterfly_all_gather, blocks, mesh)
    return _note("ppermute", blocks, mesh, out, axis_size(blocks, mesh=mesh).bit_length() - 1)


def _butterfly_all_gather(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    d = len(blocks)
    if d == 1:
        return list(blocks)
    if d & (d - 1):
        raise ValueError(f"butterfly_all_gather needs a power-of-two slot count, got {d}")
    bufs = []
    for i, b in enumerate(blocks):
        buf = b.new_zeros((d,) + tuple(b.shape))
        buf[i] = b
        bufs.append(buf)
    for k in range(d.bit_length() - 1):
        width = 1 << k
        # every slot's receive first, then the writes: a round reads only
        # the senders' own groups, which no write of the round touches
        recv = []
        for i in range(d):
            j = i ^ width
            base_j = (j >> k) << k
            recv.append(bufs[j][base_j:base_j + width].to(bufs[i].device))
        for i in range(d):
            partner_base = ((i >> k) << k) ^ width
            bufs[i][partner_base:partner_base + width] = recv[i]
    return [buf.reshape((d * blocks[0].shape[0],) + tuple(blocks[0].shape[1:]))
            for buf in bufs]


def axis_index(xs: list, *, mesh=None) -> list[int]:
    """Each of the list's slots' position along the axis."""
    return list(range(len(xs))) if _one_process(mesh) else mesh.positions


def axis_size(xs: list, *, mesh=None) -> int:
    """The number of slots."""
    return len(xs) if _one_process(mesh) else mesh.size
