"""The device a port entry point runs on.

The port's entry points run on the card unless the caller asks for the CPU:
their ``device`` defaults to ``"cuda"``, and ``"cpu"`` runs the kernels'
plain PyTorch versions.  A request for the card where there is none raises;
nothing falls back to the CPU.  ``device_record`` names the device a run
used, for its JSON record.
"""

from __future__ import annotations

import subprocess
from typing import Dict

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


def device_record(device: torch.device) -> Dict:
    """The device a run used: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    if device.type != "cuda":
        return {"type": device.type}
    index = device.index if device.index is not None else 0
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return {"type": "cuda", "name": torch.cuda.get_device_name(index),
            "power_limit": smi.rpartition(", ")[2] or None,
            "nvidia_smi": smi or None}
