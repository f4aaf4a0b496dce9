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
