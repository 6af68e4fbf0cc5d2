"""Empirical worst-case g(T) estimation with a provenance-keyed cache.

Counterpart of ``online_convex_optimization_tpu/experiments/gt.py``
``estimate_g`` and ``estimate_g_exact`` (with ``_load_g_cache`` /
``_save_g_cache``); reference algorithms.py:135-171 and
exact_ftl_driver.py:64-117.  The runs of every missing horizon go through
FTRL together, padded to the largest missing horizon with a per-sequence
length, in device batches of at most ``chunk`` sequences (one K1 launch
for the whole reference table), and each horizon's maximum regret is kept
with the reference's 0.0 floor.  The table is checkpointed
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

from online_convex_optimization_tpu_torch.data.sequences import (
    sample_g_batch,
    sample_g_instance,
)
from online_convex_optimization_tpu_torch.models.linear import simulate_linear_batch
from online_convex_optimization_tpu_torch.ops.game import (
    ALG_FTRL,
    in_contract,
    regret_plays,
)


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
    chunk: int = 16384,
    cache_path: Optional[str] = None,
    progress: bool = True,
    check: bool = True,
    device="cuda",
) -> Dict[int, float]:
    """g(T) table on ``device``, resuming from ``cache_path`` when its
    provenance matches.  ``dtype`` (NumPy) is the working precision: the
    instances are generated in it and keep it on the device.

    Every missing horizon's runs go through FTRL together: the instances,
    horizon after horizon, zero-padded to the largest missing horizon with
    a per-sequence length, in launches of at most ``chunk`` sequences (one
    launch for the reference's 10 x 1,000), and each horizon's maximum is
    taken on the device."""
    meta_key = {"kind": "g_plain", "runs": int(runs),
                "base_seed": int(base_seed), "eta0": float(eta0),
                "dtype": np.dtype(dtype).name,
                "device": torch.device(device).type}
    g = _load_g_cache(cache_path, meta_key)
    todo = [int(t) for t in T_grid if int(t) not in g]
    if runs < 1:
        g.update((T, 0.0) for T in todo)
        todo = []
    if not todo:
        return {int(t): g[int(t)] for t in T_grid}
    # Instance k is run k % runs of horizon todo[k // runs].
    n_all = len(todo) * runs
    T_pad = max(todo)
    starts = range(0, n_all, chunk)
    if progress:
        try:
            from tqdm import tqdm
            starts = tqdm(starts, desc="Estimating g(T) on random sequences")
        except ImportError:
            pass
    best = torch.zeros(len(todo), dtype=torch.float64)
    for start in starts:
        n = min(chunk, n_all - start)
        z = np.zeros((n, T_pad, 5), dtype=dtype)
        y = np.zeros((n, T_pad), dtype=dtype)
        horizon = np.empty(n, np.int64)
        for i in range(n):
            h, run = divmod(start + i, runs)
            T = todo[h]
            z[i, :T], y[i, :T] = sample_g_instance(base_seed, T, run,
                                                   dtype=dtype)
            horizon[i] = h
        lengths = np.asarray(todo)[horizon]
        zd, yd = torch.from_numpy(z).to(device), torch.from_numpy(y).to(device)
        ld = torch.from_numpy(lengths.astype(np.int32)).to(device)
        cum, comp, _ = regret_plays(zd, yd, (ALG_FTRL,), eta0, ld,
                                    not in_contract(zd, yd, ld))
        regret = (cum[0] - comp[0]).double()
        hd = torch.from_numpy(horizon).to(device)
        if check:
            bad = torch.zeros(len(todo), dtype=torch.int64, device=device)
            bad.index_add_(0, hd, (~torch.isfinite(regret)).to(torch.int64))
            for h in np.flatnonzero(bad.cpu().numpy()):
                lo = max(start, h * runs) - h * runs
                hi = min(start + n, (h + 1) * runs) - 1 - h * runs
                raise FloatingPointError(
                    f"FTRL regret of the g(T) batch at T={todo[h]} (runs "
                    f"{lo}..{hi}): {int(bad[h])} of {hi - lo + 1} entries "
                    f"are not finite")
        # Each horizon's maximum over this launch's runs, floored at 0.0 as
        # the reference's running maximum is.
        part = torch.zeros(len(todo), dtype=torch.float64, device=device)
        part.scatter_reduce_(0, hd, regret, reduce="amax")
        best = torch.maximum(best, part.cpu())
        done = [h for h in range(len(todo)) if (h + 1) * runs <= start + n
                and (h + 1) * runs > start]
        for h in done:
            g[todo[h]] = float(best[h])
        if cache_path and done:
            _save_g_cache(cache_path, g, meta_key,
                          {"chunk": int(chunk), "check": bool(check)})
    return {int(t): g[int(t)] for t in T_grid}


def estimate_g_exact(
    T_grid,
    *,
    runs: int,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    norm: str = "l2",
    iters: int = 2000,
    dtype=np.float64,
    cache_path: Optional[str] = None,
    progress: bool = True,
    admm_precision: str = "highest",
    solver: str = "auto",
    device="cuda",
) -> Dict[int, float]:
    """g(T) with the exact comparator (reference exact_ftl_driver.py:
    64-117): regret = FTRL cum_loss - loss of the exact full-sequence
    minimizer, maximized over ``runs`` instances per horizon.

    ``solver='auto'`` takes each run's comparator from the certified
    closed form (``models/linear_regime.py``; the g sampler's data is
    contract data) and scores FTRL on the host in f64; only uncertified
    runs go to the ADMM.  ``solver='linear'`` raises on an uncertified
    run; any other value solves every comparator by the ADMM
    (``models/exact_ftl.py::_admm_full``, batched on ``device``, with one
    continuation at twice the budget for unconverged runs) and plays FTRL
    through K1 on ``device``.  ADMM solutions are polished on the host, and
    every comparator loss is computed there in f64; a run whose solve
    diverges is dropped from the maximum with a warning."""
    from online_convex_optimization_tpu_torch.experiments.evaluate import (
        _host_ftrl_cum_loss)
    from online_convex_optimization_tpu_torch.models.exact_ftl import (
        _admm_full, check_precision)
    from online_convex_optimization_tpu_torch.models.linear_regime import (
        certified_full_solution_batch)
    from online_convex_optimization_tpu_torch.models.polish import (
        polish_solution)
    from online_convex_optimization_tpu_torch.utils.devices import (
        resolve_device)

    check_precision(admm_precision)
    try_linear = solver in ("auto", "linear")
    meta_key = {"kind": "g_exact", "runs": int(runs),
                "base_seed": int(base_seed), "eta0": float(eta0),
                "norm": norm, "dtype": np.dtype(dtype).name,
                "device": torch.device(device).type}
    meta_info = {"solver": solver, "iters": int(iters),
                 "admm_precision": admm_precision}
    g = _load_g_cache(cache_path, meta_key)
    todo = [int(t) for t in T_grid if int(t) not in g]
    iterator = todo
    if progress and todo:
        try:
            from tqdm import tqdm
            iterator = tqdm(todo, desc="Estimating g(T) with exact FTRL")
        except ImportError:
            pass
    device = resolve_device(device)

    def solve(zc, yc, st=None, budget=iters):
        return _admm_full(zc, yc, norm=norm, iters=budget, tol=2e-4,
                          precision=admm_precision, state0=st)

    T_max = max(int(t) for t in T_grid)
    for T in iterator:
        z, y = sample_g_batch(base_seed, T, runs, dtype=dtype)
        # Zero-padded to T_max: padded rows are inert in the FTRL game and
        # in the exact solve.
        if T < T_max:
            z = np.concatenate(
                [z, np.zeros((runs, T_max - T, z.shape[2]), z.dtype)], axis=1)
            y = np.concatenate(
                [y, np.zeros((runs, T_max - T), y.dtype)], axis=1)
        if try_linear:
            cum = _host_ftrl_cum_loss(z[:, :T], y[:, :T], eta0)
        else:
            cum = simulate_linear_batch(
                torch.from_numpy(z).to(device), torch.from_numpy(y).to(device),
                0, eta0, T).cum_loss.cpu().numpy()
        max_regret = 0.0
        chunk = 50  # divides the reference's 200-run default
        for start in range(0, runs, chunk):
            n = min(chunk, runs - start)
            x_np = np.full((n, z.shape[2]), np.nan)
            ok_mask = np.zeros(n, bool)
            if try_linear:
                x_lin, ok_lin = certified_full_solution_batch(
                    z[start:start + chunk, :T], y[start:start + chunk, :T],
                    norm)
                x_np[ok_lin] = x_lin[ok_lin]
                ok_mask |= ok_lin
                if solver == "linear" and not ok_lin.all():
                    raise RuntimeError(
                        "solver='linear': uncertified g(T) run at "
                        f"T={T}, chunk={start}")
            need = ~ok_mask
            if need.any():
                # The whole chunk goes to the ADMM; certified members'
                # results are ignored.
                zc = torch.from_numpy(z[start:start + chunk]).to(device)
                yc = torch.from_numpy(y[start:start + chunk]).to(device)
                x_c, res, st = solve(zc, yc)
                x_dev = x_c.cpu().numpy().astype(np.float64)
                ok_dev = res.cpu().numpy() <= 1e-3
                if not (ok_dev | ~need).all():
                    # Continue from the state with twice the budget; a
                    # recovered run stays a candidate for the maximum.
                    x2, res2, _ = solve(zc, yc, st, 2 * iters)
                    x2 = x2.cpu().numpy().astype(np.float64)
                    ok2 = res2.cpu().numpy() <= 1e-3
                    take = (~ok_dev) & ok2
                    x_dev[take] = x2[take]
                    ok_dev = ok_dev | ok2
                del st
                for i in np.flatnonzero(need & ok_dev):  # host polish
                    x_dev[i] = polish_solution(z[start + i], y[start + i],
                                               x_dev[i], norm)
                    x_np[i] = x_dev[i]
                ok_mask |= need & ok_dev
            # Comparator losses in host f64.
            zh = np.asarray(z[start:start + chunk, :T], np.float64)
            yh = np.asarray(y[start:start + chunk, :T], np.float64)
            comp = 0.5 * np.abs(
                np.einsum("ntd,nd->nt", zh, x_np) - yh).sum(axis=-1)
            regs = cum[start:start + chunk] - comp
            finite = np.isfinite(regs)
            n_ok = int(finite.sum())
            if n_ok < regs.shape[0]:
                logging.getLogger("oco").warning(
                    "estimate_g_exact T=%d: dropped %d/%d diverged solves",
                    T, regs.shape[0] - n_ok, regs.shape[0])
            if n_ok:
                max_regret = max(max_regret, float(regs[finite].max()))
        g[T] = max_regret
        if cache_path:
            _save_g_cache(cache_path, g, meta_key, meta_info)
    return {int(t): g[int(t)] for t in T_grid}
