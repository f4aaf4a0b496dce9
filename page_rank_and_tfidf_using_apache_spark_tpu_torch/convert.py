"""Carry the JAX package's state across to this package.

PageRank has no weights: its state is the device graph and the rank carry.
:func:`device_graph` turns a ``DeviceGraph`` of the JAX package — or any
record with the same field names, a NamedTuple or a mapping — into this
package's :class:`~ops.pagerank.DeviceGraph`, nested ``hybrid`` and
``shuffle`` layouts and ``edge_weight`` included.  Every array passes
through ``numpy.asarray``, so the source framework is never imported here.
Feeding both packages one layout lets a test pin a difference on the SpMV
rather than on the layout builders.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pagerank import (
    DeviceGraph,
    HybridLayout,
    ShuffleLayout,
)


def _fields(record: Any) -> dict:
    return dict(record._asdict()) if hasattr(record, "_asdict") else dict(record)


def _tensor(a, device) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(cls, record: Any, device) -> Any:
    fields = _fields(record)
    unknown = set(fields) - set(cls._fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**{k: _tensor(v, device) for k, v in fields.items()})


def device_graph(record: Any, *, device: str | torch.device = "cuda") -> DeviceGraph:
    """A ``DeviceGraph``-shaped record as this package's ``DeviceGraph``
    on ``device``; each array keeps its dtype (int32 indices, the run's
    float type)."""
    fields = _fields(record)
    hybrid = fields.pop("hybrid", None)
    shuffle = fields.pop("shuffle", None)
    dg = _convert(DeviceGraph, fields, device)
    return dg._replace(
        hybrid=None if hybrid is None else _convert(HybridLayout, hybrid, device),
        shuffle=None if shuffle is None else _convert(ShuffleLayout, shuffle, device),
    )


def ranks_tensor(ranks, *, device: str | torch.device = "cuda") -> torch.Tensor:
    """A rank vector (any array numpy can read) as a tensor on ``device``."""
    return _tensor(ranks, device)
