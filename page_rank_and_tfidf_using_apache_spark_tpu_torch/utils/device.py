"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU.  It never
moves to the CPU on its own: asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch

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
