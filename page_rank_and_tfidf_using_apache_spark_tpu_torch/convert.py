"""Carry the JAX package's state across to this package.

PageRank has no weights: its state is the device graph and the rank carry.
:func:`device_graph` turns a ``DeviceGraph`` of the JAX package — or any
record with the same field names, a NamedTuple or a mapping — into this
package's :class:`~ops.pagerank.DeviceGraph`, nested ``hybrid`` and
``shuffle`` layouts and ``edge_weight`` included.  TF-IDF's state is its
postings: :func:`tfidf_result` turns a JAX ``TfidfResult`` (padded, with
``n_pairs`` and ``valid``) or ``TfidfOutput`` (exact-length) into this
package's :class:`~ops.tfidf.TfidfResult`.  Every array passes through
``numpy.asarray``, so the source framework is never imported here.
Feeding both packages one layout or one COO lets a test pin a difference
on the SpMV or the scorer rather than on what builds their inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.pagerank import (
    DeviceGraph,
    HybridLayout,
    ShuffleLayout,
    segment_pointers,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops.tfidf import TfidfResult


def _fields(record: Any) -> dict:
    if hasattr(record, "_asdict"):
        return dict(record._asdict())
    if dataclasses.is_dataclass(record):
        return {f.name: getattr(record, f.name) for f in dataclasses.fields(record)}
    return dict(record)


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
    float type).  The layouts' CSR pointers over ``head_row_node`` and
    ``bucket_node``, which the JAX package has no need of, are built from
    those ids where the record lacks them."""
    fields = _fields(record)
    hybrid = fields.pop("hybrid", None)
    shuffle = fields.pop("shuffle", None)
    if hybrid is not None:
        hybrid = _fields(hybrid)
        if hybrid.get("head_row_ptr") is None:
            hybrid["head_row_ptr"] = segment_pointers(np.asarray(hybrid["head_row_node"]),
                                                      np.asarray(hybrid["head_ids"]).shape[0])
    if shuffle is not None:
        shuffle = _fields(shuffle)
        if shuffle.get("bucket_ptr") is None:
            shuffle["bucket_ptr"] = segment_pointers(np.asarray(shuffle["bucket_node"]),
                                                     np.asarray(fields["inv_outdeg"]).shape[0])
    dg = _convert(DeviceGraph, fields, device)
    return dg._replace(
        hybrid=None if hybrid is None else _convert(HybridLayout, hybrid, device),
        shuffle=None if shuffle is None else _convert(ShuffleLayout, shuffle, device),
    )


def ranks_tensor(ranks, *, device: str | torch.device = "cuda") -> torch.Tensor:
    """A rank vector (any array numpy can read) as a tensor on ``device``."""
    return _tensor(ranks, device)


def tfidf_result(record: Any, *, device: str | torch.device = "cuda") -> TfidfResult:
    """A ``TfidfResult``- or ``TfidfOutput``-shaped record as this package's
    exact-length ``TfidfResult`` on ``device``.  A padded record keeps its
    first ``n_pairs`` rows, which must be exactly the rows its ``valid``
    mask marks; other fields (``n_docs``, ``metrics``, ...) are not read."""
    fields = _fields(record)
    missing = {"doc", "term", "weight", "idf", "df"} - set(fields)
    if missing:
        raise ValueError(f"record has no fields {sorted(missing)}")
    doc = np.asarray(fields["doc"])
    n = int(np.asarray(fields.get("n_pairs", doc.shape[0])))
    if fields.get("valid") is not None:
        valid = np.asarray(fields["valid"]) != 0
        if not (valid[:n].all() and not valid[n:].any()):
            raise ValueError(f"valid does not mark exactly the first n_pairs={n} rows")
    rows = {k: None if fields.get(k) is None else np.asarray(fields[k])[:n]
            for k in ("doc", "term", "weight", "count")}
    return TfidfResult(**{k: _tensor(v, device) for k, v in rows.items()},
                       idf=_tensor(fields["idf"], device), df=_tensor(fields["df"], device))
