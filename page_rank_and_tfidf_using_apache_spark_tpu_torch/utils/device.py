"""Device resolution for every entry point of the port, and its one
host-to-device copy helper.

The port runs on the card unless the caller asks for the CPU.  It never
moves to the CPU on its own: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np
import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import timed_span

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.  Raises
    ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def backend_name(device: str | torch.device | None = None) -> str:
    """The backend stamp of a run on ``device`` (``None`` means ``cuda``;
    availability is not checked): ``"gpu"`` for a CUDA device, else the
    device type (``"cpu"``).  Measured records and tuned profiles carry
    it."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    return "gpu" if dev.type == "cuda" else dev.type


def h2d(a: np.ndarray, device: str | torch.device, stats: dict | None = None) -> torch.Tensor:
    """``torch.from_numpy(a).to(device)`` inside a ``device.h2d`` span with
    attribute ``bytes``; with ``stats``, the span's seconds and the bytes
    are added to its ``h2d_secs`` and ``h2d_bytes``.  From pageable memory
    the copy has ended when this returns.  ``a`` is taken as it is (cast
    and made contiguous before the call), so the span times the copy
    alone."""
    host = torch.from_numpy(a)
    with timed_span("device.h2d", stats, "h2d_secs", bytes=a.nbytes):
        out = host.to(device)
    if stats is not None:
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + a.nbytes
    return out


def put_stats() -> dict:
    """A fresh stats dict for a put of a graph (``ops.put_graph``'s
    ``stats``): its copies' seconds and bytes (:func:`h2d`) and its plan
    builds' seconds, the fields a driver's ``put_graph`` record carries
    (``ops.put_graph`` adds ``derived_on`` and ``device_bytes``)."""
    return {"h2d_secs": 0.0, "h2d_bytes": 0, "plan_secs": 0.0}
