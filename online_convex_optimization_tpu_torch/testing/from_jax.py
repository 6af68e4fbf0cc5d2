"""Carry the JAX package's inputs into the port unchanged.

The system has no model weights: its parameters are the inputs and
hyperparameters (z, y, lengths, eta, thresholds, flags).  They cross between
the two packages as NumPy arrays; ``to_torch`` turns the arrays a JAX test
builds into the port's tensors with the same bits, so both packages compute
on identical inputs.  ``stream_carry_from_jax`` carries a streamed game's
state across: a run begun in the JAX package finishes in the port, and
``synthetic_g_checkpoint_from_jax`` does the same for a resumable g sweep
(``parallel/sweep.py::resumable_synthetic_g``), and
``admm_state_from_jax`` for an all-prefix exact-FTL ADMM solve.  The packed
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
    played, is kept.  The carry is float32 whatever the chunks' storage; a
    bf16 game (``StreamingKernelGame(dtype=jnp.bfloat16)``) packs 16
    sublanes instead of 8, which the unpacking reads from the shapes.  The
    state crosses over the way weights would."""
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


def admm_state_from_jax(state, B: int, T: int, d: int):
    """A JAX all-prefix ADMM state -> the port's K10 state ``(s, u, x, w,
    v)`` as float32 NumPy arrays (``s``, ``u`` ``(B*T, T)``, ``x``, ``w``,
    ``v`` ``(B*T, d)``), for ``ops/admm.py::admm_all_prefixes_l2(...,
    state0=...)``, so a solve begun in the JAX package continues in the
    port.

    ``state`` is either the JAX kernel's ``(s1, u1, vec1)``
    (``ops/pallas_admm.py``: rows and columns padded to ``tp = ceil(T/128)
    * 128``, row ``b*tp + p``; ``vec1`` packs x in lanes 0..d-1, w in 8..,
    v in 16..) or the XLA path's ``(X, S, U, W, V)`` of
    ``models/exact_ftl.py::_admm_all_prefixes`` on all T prefixes, one
    replicate ``(T, ...)`` or a batch of them ``(B, T, ...)``.  Padding
    rows and columns are dropped; entries past a row's length are zero in
    both packages."""
    if len(state) == 3:
        s1, u1, vec1 = (np.asarray(a) for a in state)
        tp = s1.shape[-1]
        s = s1.reshape(B, tp, tp)[:, :T, :T].reshape(B * T, T)
        u = u1.reshape(B, tp, tp)[:, :T, :T].reshape(B * T, T)
        vec = vec1.reshape(B, tp, -1)[:, :T]
        x, w, v = (vec[..., lane:lane + d].reshape(B * T, d)
                   for lane in (0, 8, 16))
    elif len(state) == 5:
        X, S, U, W, V = (np.asarray(a) for a in state)
        s, u = S.reshape(B * T, T), U.reshape(B * T, T)
        x, w, v = (a.reshape(B * T, d) for a in (X, W, V))
    else:
        raise ValueError("expected the JAX kernel's (s1, u1, vec1) or the "
                         "XLA path's (X, S, U, W, V)")
    return tuple(np.array(a, dtype=np.float32, order="C")
                 for a in (s, u, x, w, v))


def _from_numpy(a) -> torch.Tensor:
    """A NumPy array -> a CPU tensor with the same bits.  bfloat16 arrays
    (``ml_dtypes``, what ``np.asarray`` makes of a JAX bf16 array), which
    ``torch.from_numpy`` refuses, cross as their 16-bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(arrays: Sequence[np.ndarray], device, dtype=None):
    """NumPy arrays -> tensors on ``device`` with the same bits.  Floating
    arrays (bfloat16 among them) are cast to ``dtype`` when it is given;
    integer arrays (int8 labels among them) keep their type."""
    out = []
    for a in arrays:
        t = _from_numpy(a).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return tuple(out)
