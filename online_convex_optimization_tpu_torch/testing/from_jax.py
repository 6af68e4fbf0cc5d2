"""Carry the JAX package's inputs into the port unchanged.

The system has no model weights: its parameters are the inputs and
hyperparameters (z, y, lengths, eta, thresholds, flags).  They cross between
the two packages as NumPy arrays; ``to_torch`` turns the arrays a JAX test
builds into the port's tensors with the same bits, so both packages compute
on identical inputs.  ``stream_carry_from_jax`` carries a streamed game's
state across: a run begun in the JAX package finishes in the port, and
``synthetic_g_checkpoint_from_jax`` does the same for a resumable g sweep
(``parallel/sweep.py::resumable_synthetic_g``).  The packed
game (K3, K3e) and the quadratic game (K8) carry nothing across: the JAX
package exposes no carry for them and both start from zero state, so they
need no function here.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np
import torch


def _unpack_lanes(packed: np.ndarray, B: int, lanes: int = 128) -> np.ndarray:
    """``(..., S, nb*lanes)`` packed TPU lane layout -> ``(..., B)`` in
    sequence order (the JAX package's ``unpack_result``: sequence
    ``(g*S + s)*lanes + l`` sits at ``[s, g*lanes + l]``), padding dropped."""
    *lead, S, BL = packed.shape
    nb = BL // lanes
    out = (packed.reshape(*lead, S, nb, lanes)
           .swapaxes(-3, -2)
           .reshape(*lead, nb * S * lanes))
    return out[..., :B]


def stream_carry_from_jax(saved: dict, B: int) -> dict:
    """The dict of the JAX ``StreamingKernelGame.carry_state()`` -> the
    port's ``carry_state()`` dict, for ``StreamingKernelGame.resume``.

    The JAX carry holds ``theta2 (d, S, B')``, ``w (d, S, B')``,
    ``sc (2, S, B')`` (``[cum, cnt]``) and ``t`` in the packed lane layout,
    with the TPU kernels' conventions: theta doubled, losses un-halved.  The
    lanes are unpacked and the padding beyond ``B`` dropped; ``theta2`` and
    ``sc[0]`` are halved (exact in binary floating point); ``t``, the rounds
    played, is kept.  The state crosses over the way weights would."""
    theta2 = np.asarray(saved["theta2"])
    sc = np.asarray(saved["sc"])
    return {"theta": 0.5 * _unpack_lanes(theta2, B),
            "w": _unpack_lanes(np.asarray(saved["w"]), B),
            "cum": 0.5 * _unpack_lanes(sc[0], B),
            "cnt": _unpack_lanes(sc[1], B),
            "t": np.asarray(int(saved["t"]), dtype=np.int64)}


def synthetic_g_checkpoint_from_jax(path: str) -> dict:
    """A JAX ``resumable_synthetic_g`` checkpoint (``.npz``) -> the port's
    checkpoint dict ``{"g", "done", "key"}``, for ``save_pytree``.

    The JAX package saves the pytree's leaves as ``leaf_0``, ``leaf_1``, ...
    in the order its ``treedef`` (saved beside them as a string) names the
    dict's keys.  The values cross unchanged: the running per-eta max ``g``
    (float32), the blocks done, and the provenance key, which the port
    computes from the same config string (``sweep.synthetic_g_key``), so a
    sweep the JAX package began on a mesh of the same shape resumes in the
    port."""
    with np.load(path) as data:
        names = re.findall(r"'(\w+)'", str(data["treedef"]))
        leaves = {name: data[f"leaf_{i}"] for i, name in enumerate(names)}
    if sorted(leaves) != ["done", "g", "key"]:
        raise ValueError(f"{path} is not a resumable_synthetic_g checkpoint "
                         f"(leaves {sorted(leaves)})")
    return {"g": np.asarray(leaves["g"], np.float32),
            "done": np.asarray(int(leaves["done"])),
            "key": np.asarray(int(leaves["key"]), np.int64)}


def to_torch(arrays: Sequence[np.ndarray], device, dtype=None):
    """NumPy arrays -> tensors on ``device``.  Floating arrays are cast to
    ``dtype`` when it is given; integer arrays keep their type."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return tuple(out)
