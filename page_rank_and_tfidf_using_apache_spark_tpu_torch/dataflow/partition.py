"""``PartitionedArray`` and ``OwnedArray``: the partitioned-collection
types of the sharded runners.

Counterpart of the JAX package's ``dataflow/partition.py``.  ONE logical
``[n]`` array plus the layout bookkeeping that maps it onto a mesh's
slots: the padded length, the global-id -> padded-slot relabeling a
partition strategy chose (``parallel.pagerank_sharded.plan_partition``),
and whether the padded value is replicated on every slot or cut into one
block a slot.  Where the reference holds one sharded ``jax.Array``, the
port holds a list of per-slot tensors (``parallel/mesh.py``).

The host->device direction pads, relabels and places this process's
slots' share; the device->host direction gathers every slot's block onto
this process where the mesh spans processes
(``parallel.collectives.gather_slots``), then makes one guarded pull
(``resilience.executor.device_get``: retry, sync deadline, rungs) of the
logical array.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx


@dataclasses.dataclass(frozen=True)
class PartitionedArray:
    """A logical [n] array laid out as a padded value of length ``n_pad``,
    with ``node_map[global_id] -> padded slot``: replicated on every slot
    of ``mesh`` (``replicated=True``) or cut into one ``[n_pad / D]``
    block a slot."""

    n: int
    n_pad: int
    node_map: np.ndarray  # int64 [n]: global id -> padded slot
    value: Any = None  # list of this process's per-slot tensors
    mesh: Any = None  # parallel.mesh.Mesh
    replicated: bool = False

    @classmethod
    def from_plan(cls, n: int, n_pad: int, node_map: np.ndarray,
                  mesh: Any = None,
                  replicated: bool = False) -> "PartitionedArray":
        """Layout from a partition plan's bookkeeping (the sharded runners
        pass ``ShardedGraph.n/n_pad/node_map`` and their state layout)."""
        return cls(n=n, n_pad=n_pad, node_map=node_map, mesh=mesh, replicated=replicated)

    def put(self, global_np: np.ndarray, dtype=None) -> "PartitionedArray":
        """Pad + relabel + place a logical [n] host array; returns a new
        PartitionedArray holding the device value."""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh

        dtype = dtype or global_np.dtype
        if self.n_pad == self.n and self.node_map.shape[0] == self.n and (
            self.node_map == np.arange(self.n)
        ).all():
            padded = np.asarray(global_np, dtype)
        else:
            padded = np.zeros(self.n_pad, dtype)
            padded[self.node_map] = global_np
        value = (pmesh.replicated(self.mesh, padded) if self.replicated
                 else pmesh.sharded_along(self.mesh, padded))
        return dataclasses.replace(self, value=value)

    def with_value(self, value: Any) -> "PartitionedArray":
        """The same layout around a new device value (a fixpoint's output
        carry keeps the input's partition plan)."""
        return dataclasses.replace(self, value=value)

    def pull(self, *, site: str = "partitioned_pull", metrics=None,
             checkpoint_dir: str | None = None) -> np.ndarray:
        """Guarded device->host pull of the LOGICAL array: one batched
        transfer through the resilience executor (the first slot's copy of
        a replicated value, every block of a sharded one), then the node_map
        inverse on host."""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll

        if self.value is None:
            raise ValueError("PartitionedArray holds no device value")
        with obs.span("dataflow.pull", site=site, n=self.n):
            view = (self.value[0] if self.replicated
                    else coll.gather_slots(list(self.value), mesh=self.mesh))
            got = rx.device_get(view, site=site, metrics=metrics,
                                checkpoint_dir=checkpoint_dir)
        padded = got if self.replicated else np.concatenate(got)
        return padded[self.node_map]


@dataclasses.dataclass(frozen=True)
class OwnedArray:
    """The owned-slice layout: ONE logical [n] array split into a padded
    tail cut into one owned block a slot (nothing replicated O(n)) plus a
    small hub-head mini-vector replicated on every slot, mirroring
    ``ops.boundary.OwnedShard``'s node split.  Same contract as
    :class:`PartitionedArray`."""

    n: int
    n_pad: int  # d * block (tail layout width)
    h: int  # real head size
    h_pad: int
    tail_map: np.ndarray  # int64 [n]: global id -> padded tail slot; -1 head
    head_ids: np.ndarray  # int64 [H] ascending global ids
    tail: Any = None  # list of this process's per-slot [block] tensors
    head: Any = None  # list of this process's per-slot [h_pad] tensors (equal values)
    mesh: Any = None  # parallel.mesh.Mesh

    @classmethod
    def from_shard(cls, shard, *, mesh: Any = None) -> "OwnedArray":
        """Layout view over a materialized ``ops.boundary.OwnedShard``."""
        return cls(
            n=shard.n, n_pad=shard.n_pad, h=shard.h, h_pad=shard.h_pad,
            tail_map=shard.tail_map, head_ids=shard.head_ids, mesh=mesh,
        )

    def put(self, global_np: np.ndarray, dtype=None) -> "OwnedArray":
        """Pad + split + place a logical [n] host array into the (sharded
        tail, replicated head) pair.  The split is
        ``ops.boundary.split_global``, shared with the host planning."""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import boundary as ob
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh

        dtype = dtype or global_np.dtype
        tail_np, head_np = ob.split_global(self, global_np, dtype)
        return dataclasses.replace(self, tail=pmesh.sharded_along(self.mesh, tail_np),
                                   head=pmesh.replicated(self.mesh, head_np))

    def with_value(self, tail: Any, head: Any) -> "OwnedArray":
        """The same layout around a fixpoint's output carry components."""
        return dataclasses.replace(self, tail=tail, head=head)

    def pull(self, *, site: str = "partitioned_pull", metrics=None,
             checkpoint_dir: str | None = None) -> np.ndarray:
        """Guarded boundary-aware pull: ONE batched transfer of every tail
        block and the first slot's head, then the tail_map/head reassembly
        on host."""
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import boundary as ob
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll

        if self.tail is None or self.head is None:
            raise ValueError("OwnedArray holds no device value")
        with obs.span("dataflow.pull", site=site, n=self.n, owned=True):
            tails = coll.gather_slots(list(self.tail), mesh=self.mesh)
            tail_np, head_np = rx.device_get(
                (tails, self.head[0]), site=site, metrics=metrics,
                checkpoint_dir=checkpoint_dir,
            )
        return ob.merge_global(self, np.concatenate(tail_np), head_np)
