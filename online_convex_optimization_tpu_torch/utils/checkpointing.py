"""Checkpointing of streaming carries and sweep state as ``.npz`` files.

Counterpart of ``online_convex_optimization_tpu/utils/checkpointing.py``
(``save_pytree`` / ``load_pytree``, ``.npz`` route).  A tree here is a flat
dict of tensors, NumPy arrays or numbers, such as
``StreamingKernelGame.carry_state()``.  The write is atomic (a temporary
file, then ``os.replace``), as in the JAX package: a kill during the save
leaves the previous checkpoint intact, never a truncated file.  No orbax.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_pytree(path: str, tree: Mapping[str, object]) -> None:
    """Save a flat dict of arrays to ``path`` (which must end in ``.npz``)
    atomically."""
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path must end in .npz, got {path!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _to_numpy(v) for k, v in tree.items()})
    os.replace(tmp, path)


def load_pytree(path: str) -> Dict[str, np.ndarray]:
    """Load a dict saved by ``save_pytree``: NumPy arrays, bits unchanged."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
