"""The device a port entry point runs on.

The port's entry points run on the card unless the caller asks for the CPU:
their ``device`` defaults to ``"cuda"``, and ``"cpu"`` runs the kernels'
plain PyTorch versions.  A request for the card where there is none raises;
nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """The device ``name`` names; ``cuda`` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested, but "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' (--device cpu) to run the plain "
                           f"PyTorch versions")
    return device
