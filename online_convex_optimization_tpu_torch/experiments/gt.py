"""Empirical worst-case g(T) estimation with a provenance-keyed cache.

Counterpart of ``online_convex_optimization_tpu/experiments/gt.py``
``estimate_g`` (with ``_load_g_cache`` / ``_save_g_cache``); reference
algorithms.py:135-171.  Per horizon, all runs go through FTRL as device
batches of at most ``chunk`` sequences, and the maximum regret is kept with
the reference's 0.0 floor.  Horizons are not padded to the grid's largest
as in the JAX package, where padding let the grid share one compiled
program: here nothing is compiled per shape.  The table is checkpointed
per horizon with the value-determining config as provenance, so an
interrupted sweep resumes and a sweep under another config recomputes.

``check=True`` is the port's form of the JAX package's checkify guard: a
non-finite regret raises ``FloatingPointError`` (``utils/debug.py``) and
names its horizon.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.sequences import sample_g_instance
from online_convex_optimization_tpu_torch.models.linear import simulate_linear_batch
from online_convex_optimization_tpu_torch.utils.debug import assert_finite


def _load_g_cache(cache_path: Optional[str], key: dict) -> Dict[int, float]:
    """Resume a {T: g} table from ``cache_path`` iff its recorded provenance
    equals ``key``; a mismatch recomputes from scratch with a warning, a
    table without provenance is accepted with a warning."""
    if not (cache_path and os.path.exists(cache_path)):
        return {}
    with open(cache_path) as f:
        data = json.load(f)
    meta = data.pop("_meta", None)
    log = logging.getLogger("oco")
    if meta is None:
        log.warning("g(T) cache %s has no provenance (_meta); assuming it "
                    "matches the current config", cache_path)
    elif meta.get("key") != key:
        log.warning("g(T) cache %s provenance mismatch (cached %s != current "
                    "%s); recomputing from scratch", cache_path,
                    meta.get("key"), key)
        return {}
    return {int(k): float(v) for k, v in data.items()}


def _save_g_cache(cache_path: str, g: Dict[int, float], key: dict,
                  info: dict) -> None:
    """Write the table with its provenance (``key`` is compared on resume;
    ``info`` records context)."""
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    payload: dict = {str(k): v for k, v in sorted(g.items())}
    payload["_meta"] = {"key": key, "info": info}
    with open(cache_path, "w") as f:
        json.dump(payload, f, indent=1)


def estimate_g(
    T_grid,
    *,
    runs: int,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    dtype=np.float64,
    chunk: int = 4096,
    cache_path: Optional[str] = None,
    progress: bool = True,
    check: bool = True,
    device="cuda",
) -> Dict[int, float]:
    """g(T) table on ``device``, resuming from ``cache_path`` when its
    provenance matches.  ``dtype`` (NumPy) is the working precision: the
    instances are generated in it and keep it on the device."""
    meta_key = {"kind": "g_plain", "runs": int(runs),
                "base_seed": int(base_seed), "eta0": float(eta0),
                "dtype": np.dtype(dtype).name,
                "device": torch.device(device).type}
    g = _load_g_cache(cache_path, meta_key)
    todo = [int(t) for t in T_grid if int(t) not in g]
    iterator = todo
    if progress and todo:
        try:
            from tqdm import tqdm
            iterator = tqdm(todo, desc="Estimating g(T) on random sequences")
        except ImportError:
            pass

    for T in iterator:
        max_regret = 0.0
        for start in range(0, runs, chunk):
            n = min(chunk, runs - start)
            z = np.empty((n, T, 5), dtype=dtype)
            y = np.empty((n, T), dtype=dtype)
            for i in range(n):
                z[i], y[i] = sample_g_instance(base_seed, T, start + i,
                                               dtype=dtype)
            res = simulate_linear_batch(torch.from_numpy(z).to(device),
                                        torch.from_numpy(y).to(device),
                                        0, eta0)
            if check:
                assert_finite(res.regret, f"FTRL regret of the g(T) batch "
                              f"at T={T} (runs {start}..{start + n - 1})")
            max_regret = max(max_regret, float(res.regret.max()))
        g[T] = max_regret
        if cache_path:
            _save_g_cache(cache_path, g, meta_key,
                          {"chunk": int(chunk), "check": bool(check)})
    return {int(t): g[int(t)] for t in T_grid}
