"""Per-case regret evaluation: the batched form of the reference's
run/T/replicate loops (driver.py:70-129, exact_ftl_driver.py:120-206).

Counterpart of ``online_convex_optimization_tpu/experiments/evaluate.py``
(``evaluate_stream_with_stats``, ``evaluate_stream_golden``, ``_pad_T``,
and the exact mode: ``evaluate_stream_exact``, ``_band_programs``,
``_host_ftrl_cum_loss``).  For one case, every (run, T, replicate) scenario
is generated on the host with the reference's seed schedule, padded to the
largest horizon with a per-sequence length, and evaluated in chunks of
``batch_chunk`` sequences (by default the whole case, up to 16,384): FTRL
and FTL as two plays of one K1 launch (``ops/game.py::regret_plays``),
SMART(sqrt(2T)) and SMART(g(T)) as two thresholds of one K2 launch
(``ops/smart.py::smart_plays``), both reading one copy of the chunk after
one contract check.  Aggregation reproduces the reference: mean over
replicates per run, then mean +- 1.96 * SEM across runs.  The JAX
package's double-buffered uploads (built for a slow link to the TPU) are
not ported, nor is its compile prewarming of the exact mode
(``warm_exact_fallback``).
"""

from __future__ import annotations

import functools
import logging
import math
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.rng import run_seed_schedule
from online_convex_optimization_tpu_torch.data.sequences import stack_replicates
from online_convex_optimization_tpu_torch.models.linear import simulate_linear_batch
from online_convex_optimization_tpu_torch.ops.actions import sum_last
from online_convex_optimization_tpu_torch.ops.game import (
    ALG_FTL,
    ALG_FTRL,
    in_contract,
    regret_plays,
)
from online_convex_optimization_tpu_torch.ops.hinge import normalized_hinge
from online_convex_optimization_tpu_torch.ops.smart import smart_plays
from online_convex_optimization_tpu_torch.utils.stats import mean_ci

ALGO_KEYS = ("FTRL", "FTL", "SMART", "EMP")  # driver.py:43

Stats = Dict[str, Tuple[np.ndarray, np.ndarray]]


def _host_ftrl_cum_loss(z: np.ndarray, y: np.ndarray,
                        eta0: float) -> np.ndarray:
    """Batched f64 FTRL cumulative loss with the reference exact driver's
    semantics (exact_ftl.py:230-277 runs its FTRL loop in f64 NumPy):
    scale eta0/sqrt(max(1, t)), project iff ||x||^2 > 1, tie-exact
    subgradient.  Padded (z = 0, y = 0) rounds are inert.  Scores the
    certified cells, which need no device work."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    B, T, d = z.shape
    theta = np.zeros((B, d))
    cum = np.zeros(B)
    for t in range(T):
        x = (-(eta0 / math.sqrt(max(1, t + 1)))) * theta
        nsq = np.einsum("bd,bd->b", x, x)
        over = nsq > 1.0
        if over.any():
            x[over] *= 1.0 / np.sqrt(nsq[over])[:, None]
        q = np.einsum("bd,bd->b", z[:, t], x)
        diff = q - y[:, t]
        cum += 0.5 * np.abs(diff)
        theta += (0.5 * np.sign(diff))[:, None] * z[:, t]
    return cum


def _pad_T(z: np.ndarray, y: np.ndarray, T_max: int):
    T = z.shape[1]
    if T == T_max:
        return z, y
    pz = np.zeros((z.shape[0], T_max, z.shape[2]), dtype=z.dtype)
    py = np.zeros((y.shape[0], T_max), dtype=y.dtype)
    pz[:, :T] = z
    py[:, :T] = y
    return pz, py


def evaluate_stream_golden(
    stream_builder: Callable,
    T_grid,
    g_emp: Mapping[int, float],
    *,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
) -> Stats:
    """Deterministic-family evaluation through the f64 golden oracle.

    The two adversarial families are 1 run x 1 replicate but
    ulp-degenerate: z = e1 every round makes exact ties q == y reachable,
    and f32 flips tie subgradients (0.26 regret units on "Switching
    leaders" FTRL in the JAX package).  Used under ``precision="f32"``.
    """
    from online_convex_optimization_tpu_torch.testing.golden import (
        golden_simulate_alg,
        golden_simulate_smart,
    )

    sampler = stream_builder(run_seed=run_seed_schedule(base_seed, 0))
    curves = {k: [] for k in ALGO_KEYS}
    for T in (int(t) for t in T_grid):
        z, y = (np.asarray(a, np.float64) for a in sampler(T, 0)[:2])
        curves["FTRL"].append(golden_simulate_alg(z, y, 0, eta0))
        curves["FTL"].append(golden_simulate_alg(z, y, 1, eta0))
        curves["SMART"].append(
            golden_simulate_smart(z, y, math.sqrt(2.0 * T), eta0))
        curves["EMP"].append(golden_simulate_smart(z, y, g_emp[T], eta0))
    return {k: (np.asarray(v), np.zeros(len(v)))
            for k, v in curves.items()}


def evaluate_stream_with_stats(
    stream_builder: Callable,
    T_grid,
    g_emp: Mapping[int, float],
    *,
    runs: int = 1,
    replicates: int = 1,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    dtype=np.float64,
    batch_chunk: int = 16384,
    stream_name: str = "",
    progress: bool = True,
    device="cuda",
) -> Stats:
    """Mean regret and 95% CI per algorithm per horizon for one case;
    ``dtype`` (NumPy) is the working precision on ``device``."""
    if runs == 1 and replicates == 1 and np.dtype(dtype) != np.float64:
        # Tie-degenerate deterministic family in f32: the golden oracle.
        return evaluate_stream_golden(stream_builder, T_grid, g_emp,
                                      base_seed=base_seed, eta0=eta0)
    T_grid = [int(t) for t in T_grid]
    T_max = max(T_grid)

    # ---- the full scenario batch, host-side and seed-exact ----
    all_z, all_y, all_T = [], [], []
    for run in range(runs):
        sampler = stream_builder(run_seed=run_seed_schedule(base_seed, run))
        for T in T_grid:
            z, y = stack_replicates(sampler, T, replicates, dtype=dtype)
            z, y = _pad_T(z, y, T_max)
            all_z.append(z)
            all_y.append(y)
            all_T.extend([T] * replicates)
    z = np.concatenate(all_z)                 # (B, T_max, d)
    y = np.concatenate(all_y)                 # (B, T_max)
    lengths = np.asarray(all_T)
    B = z.shape[0]
    thresh_theory = np.sqrt(2.0 * lengths).astype(dtype)
    thresh_emp = np.asarray([g_emp[t] for t in all_T], dtype=dtype)

    # ---- device evaluation: four algorithms, one K1 and one K2 launch a
    # chunk ----
    regrets = {k: np.empty(B) for k in ALGO_KEYS}
    starts = range(0, B, batch_chunk)
    iterator = starts
    if progress and B > batch_chunk:
        try:
            from tqdm import tqdm
            iterator = tqdm(starts, desc=f"{stream_name:>24} | B={B}")
        except ImportError:
            pass
    for s in iterator:
        e = min(s + batch_chunk, B)
        zd = torch.from_numpy(z[s:e]).to(device)
        yd = torch.from_numpy(y[s:e]).to(device)
        ld = torch.from_numpy(lengths[s:e].astype(np.int32)).to(device)
        replay = not in_contract(zd, yd, ld)
        cum, comp, _ = regret_plays(zd, yd, (ALG_FTRL, ALG_FTL), eta0, ld,
                                    replay)
        ths = torch.from_numpy(np.stack([thresh_theory[s:e],
                                         thresh_emp[s:e]])).to(device)
        cum_s, comp_s, _, _ = smart_plays(zd, yd, ths, eta0, ld, replay)
        out = torch.cat([cum - comp, cum_s - comp_s]).cpu().numpy()
        for k, row in zip(ALGO_KEYS, out):
            regrets[k][s:e] = row

    # ---- failure containment: a non-finite scenario is dropped, with a
    # warning, instead of poisoning a mean ----
    n_bad = sum(int((~np.isfinite(regrets[k])).sum()) for k in ALGO_KEYS)
    if n_bad:
        logging.getLogger("oco").warning(
            "evaluate[%s]: dropped %d non-finite scenario results",
            stream_name, n_bad)

    # ---- reference aggregation: reps -> run mean -> mean +- CI ----
    stats: Stats = {}
    nT = len(T_grid)
    for k in ALGO_KEYS:
        r = regrets[k].reshape(runs, nT, replicates)
        run_means = np.nanmean(np.where(np.isfinite(r), r, np.nan), axis=2)
        means, cis = [], []
        for ti in range(nT):
            vals = run_means[:, ti]
            mu, ci = mean_ci(vals[np.isfinite(vals)])
            means.append(mu)
            cis.append(ci)
        stats[k] = (np.asarray(means), np.asarray(cis))
    return stats


# ------------------------------------------------------------ exact mode

# SSN Newton-step budget of a band's first attempt (the escalation
# continues with twice as many): converged prefixes take 27-49 steps, and
# rows still uncertified at 80 essentially never certify with more.
_SSN_NEWTON_BUDGET = 80


@functools.lru_cache(maxsize=16)
def _band_programs(T_max: int, norm: str, iters: int, admm_precision: str,
                   use_ssn: bool):
    """Band-solver closures ``(prefix_solve, prefix_solve_hard, band_los)``
    of the banded ADMM (``models/exact_ftl.py::_admm_all_prefixes``) or,
    with ``use_ssn``, of the semismooth Newton (``models/ssn.py``, l2,
    float64).

    The per-prefix problems are independent, so the ``T_max`` rows split
    into 256-row bands (one band below ``T_max = 512``), each stopping at
    its own convergence.  ``prefix_solve(zz, yy)`` solves every band of a
    ``(B, T_max, d)`` batch, each replicate stopping on its own, and
    returns ``(X (n_bands, B, rows, d), res (n_bands, B, rows), states)``
    with one state per band; ``prefix_solve_hard(zz, yy, state, lo)``
    continues one band from its state with 3x the budget (6x in all; the
    SSN: twice its first budget of ``_SSN_NEWTON_BUDGET`` Newton steps).
    The ADMM solves the bands one after another; the SSN solves all of them
    in one batch, every (band, replicate) member stopping on its own.
    """
    from online_convex_optimization_tpu_torch.models import ssn
    from online_convex_optimization_tpu_torch.models.exact_ftl import (
        _admm_all_prefixes)

    band_rows = 256 if T_max >= 512 else T_max
    band_los = sorted({min(b * band_rows, T_max - band_rows)
                       for b in range(-(-T_max // band_rows))})

    if use_ssn:
        def prefix_solve(zz, yy):
            X, res, (Xs, mu) = ssn.ssn_all_prefixes(
                zz, yy, iters=_SSN_NEWTON_BUDGET, tol=2e-4, band_lo=band_los,
                band_rows=band_rows, norm=norm)
            return X, res, [(Xs[bi], mu[bi]) for bi in range(len(band_los))]

        def prefix_solve_hard(zz, yy, st, lo):
            return ssn.ssn_all_prefixes(
                zz, yy, iters=2 * _SSN_NEWTON_BUDGET, tol=2e-4, state0=st,
                band_lo=lo, band_rows=band_rows, norm=norm)

        return prefix_solve, prefix_solve_hard, band_los

    def _band(zz, yy, lo, st=None, budget=None):
        return _admm_all_prefixes(
            zz, yy, norm=norm, iters=(3 * iters if budget is None
                                      else budget), tol=2e-4,
            precision=admm_precision, state0=st, band_lo=lo,
            band_rows=band_rows)

    def prefix_solve(zz, yy):
        outs = [_band(zz, yy, lo) for lo in band_los]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]), [o[2] for o in outs])

    def prefix_solve_hard(zz, yy, st, lo):
        return _band(zz, yy, lo, st=st, budget=3 * iters)

    return prefix_solve, prefix_solve_hard, band_los


def evaluate_stream_exact(
    stream_builder: Callable,
    T_grid,
    *,
    runs: int = 1,
    replicates: int = 1,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    norm: str = "l2",
    iters: int = 2000,
    dtype=np.float64,
    stream_name: str = "",
    progress: bool = True,
    polish: bool = True,
    fail_tol: float = 1e-3,
    admm_precision: str = "highest",
    solver: str = "auto",
    selection: str = "committed",
    audit_out: Optional[dict] = None,
    timing_out: Optional[dict] = None,
    device="cuda",
) -> Stats:
    """Exact-FTL comparison mode (reference exact_ftl_driver.py:120-206):
    per scenario, every prefix is solved once (all prefixes at once on
    ``device`` + host active-set polish), then FTRL and exact FTL are
    scored against the same exact comparator.

    ``solver``: "auto" takes the certified closed form
    (``models/linear_regime.py``) where the optimality certificate holds;
    of the uncertified cells, an l2 cell with rows outside the unit ball
    goes to the semismooth Newton (``models/ssn.py``) and the in-contract
    ones (the deterministic w = 0 families) to the banded ADMM, whose
    committed statistics depend on that path.  "linear" requires the
    certificate; "xla" forces the banded ADMM on every cell; "ssn" (l2)
    forces the semismooth Newton on every cell; "kernel" (l2, float32)
    forces kernel K10 (``ops/admm.py``) on each horizon's own rows,
    continuing a cell's state once for unconverged replicates.  The
    semismooth Newton solves in float64 whatever ``dtype`` is.
    Certified and canonical cells are scored on the host in f64, general
    cells on ``device`` with the polished actions in f64 and FTRL through
    K1 in ``dtype``.

    ``selection``: "committed" keeps the solver's selection on degenerate
    optima; "canonical" solves the structured (deterministic) families by
    the LP-verified closed forms of ``models/canonical.py`` once per
    replicate at ``T_max`` and canonicalizes the general cells after the
    polish.

    Replicates whose residual stays above ``fail_tol`` after the
    escalation become NaN sentinels, dropped from the aggregation with a
    warning.  ``audit_out`` receives the solver-path accounting: cells by
    route and replicate escalation / recovery / drop counts.
    ``timing_out`` receives the host's seconds by step: ``prepare`` (data,
    certificates, canonical closed forms, launching the solves; the
    semismooth Newton's solves, which read every Newton step's convergence
    test on the host, run here),
    ``solve_wait`` (waiting for the device solves, escalations included),
    ``polish`` (the polish and canonicalization of general cells),
    ``score`` (scoring general cells on the device) and
    ``certified_score`` (scoring certified cells on the host).
    """
    from online_convex_optimization_tpu_torch.models.exact_ftl import (
        check_precision)
    from online_convex_optimization_tpu_torch.models.polish import (
        polish_prefix_actions)
    from online_convex_optimization_tpu_torch.utils.devices import (
        resolve_device)

    T_grid = [int(t) for t in T_grid]
    T_max = max(T_grid)
    labels = ("FTRL", "FTL (exact)")
    by_T = {k: np.empty((runs, len(T_grid), replicates)) for k in labels}
    n_dropped = 0
    log = logging.getLogger("oco")

    if solver not in ("auto", "linear", "xla", "kernel", "ssn"):
        raise ValueError(f"unknown solver {solver!r}")
    use_kernel = solver == "kernel"
    try_linear = solver in ("auto", "linear")
    require_linear = solver == "linear"
    if try_linear:
        from online_convex_optimization_tpu_torch.models.linear_regime import (
            certified_prefix_actions_batch)
    if use_kernel and (norm != "l2" or np.dtype(dtype) != np.float32):
        raise ValueError("solver='kernel' supports norm='l2' with "
                         "float32 data only")
    use_ssn = solver == "ssn"
    if use_ssn and norm != "l2":
        raise ValueError("solver='ssn' supports norm='l2' only in the "
                         "pipeline (linf SSN: use ExactFTL(method='ssn', "
                         "norm='linf'); see docs/BENCHMARKS.md)")
    check_precision(admm_precision)
    device = resolve_device(device)
    if use_kernel:
        from online_convex_optimization_tpu_torch.ops.admm import (
            admm_all_prefixes_l2, feasible_actions)

        def prefix_solve(zz, yy):
            return admm_all_prefixes_l2(zz, yy, iters=3 * iters, tol=2e-4)

        def prefix_continue(zz, yy, st):
            return admm_all_prefixes_l2(zz, yy, iters=3 * iters, tol=2e-4,
                                        state0=st)

        prefix_solve_hard = None    # the kernel route continues instead
        band_los = []
    else:
        prefix_solve, prefix_solve_hard, band_los = _band_programs(
            T_max, norm, int(iters), admm_precision, use_ssn)

    def horizon(zz, yy, T):
        # K10 solves each horizon at its own length: a row's result does
        # not depend on T, so rows p < T equal the padded launch's bit for
        # bit, and the padded rows' work is saved.  The banded ADMM keeps
        # one shape at T_max, as the JAX package does.
        if not use_kernel:
            return zz, yy
        return zz[:, :T].contiguous(), yy[:, :T].contiguous()

    auto_ssn = solver == "auto" and norm == "l2"

    def _general_programs(z_cell, T):
        # Out-of-contract l2 cells (rows outside the unit ball) go to the
        # semismooth Newton under "auto" as well.
        if auto_ssn and bool(np.any(
                np.linalg.norm(z_cell[:, :T], axis=-1) > 1.0 + 1e-9)):
            return _band_programs(T_max, norm, int(iters), admm_precision,
                                  True)[:2] + ("ssn",)
        return prefix_solve, prefix_solve_hard, (
            "ssn" if use_ssn else ("kernel" if use_kernel else "admm"))

    audit = {"cells": 0, "cells_certified": 0, "cells_canonical": 0,
             "cells_admm": 0, "cells_ssn": 0, "cells_kernel": 0,
             "replicates_escalated": 0, "replicates_recovered": 0,
             "replicates_dropped": 0}

    if selection not in ("committed", "canonical"):
        raise ValueError(f"unknown selection {selection!r}")
    use_canonical = selection == "canonical"
    if use_canonical:
        from online_convex_optimization_tpu_torch.models.canonical import (
            canonical_prefix_actions, canonicalize)

    run_iter = range(runs)
    if progress:
        try:
            from tqdm import tqdm
            run_iter = tqdm(run_iter,
                            desc=f"{stream_name:>24} | exact runs={runs}")
        except ImportError:
            pass

    def prepare(run):
        # Every horizon's solve of one run is launched up front: the kernel
        # launches are asynchronous, so the card works through them while
        # the host polishes the cells already solved.
        sampler = stream_builder(run_seed=run_seed_schedule(base_seed, run))
        # selection='canonical': every horizon of a deterministic family
        # is a prefix of the longest, so the canonical solver runs once per
        # replicate at T_max and shorter horizons slice its trajectory.
        canon_cache = None
        if use_canonical:
            zf, yf = stack_replicates(sampler, T_max, replicates,
                                      dtype=np.float64)
            accs = [canonical_prefix_actions(zf[b], yf[b], norm)
                    for b in range(replicates)]
            if all(a is not None for a in accs):
                canon_cache = (zf, yf, np.stack(accs))   # (B, T_max+1, d)
        pending = []
        for T in T_grid:
            z, y = stack_replicates(sampler, T, replicates, dtype=dtype)
            z, y = _pad_T(z, y, T_max)
            if try_linear:
                # Certified on the true horizon slice; padded rows are
                # inert duplicates of prefix T.
                X_lin = certified_prefix_actions_batch(z[:, :T], y[:, :T],
                                                       norm)
                if X_lin is not None:
                    audit["cells"] += 1
                    audit["cells_certified"] += 1
                    pending.append((T, z, y, None, None,
                                    ("linear", X_lin), None))
                    continue
                if require_linear:
                    raise RuntimeError(
                        f"solver='linear': cell (run={run}, T={T}) failed "
                        "the closed-form optimality certificate")
            if canon_cache is not None:
                zf, yf, accs = canon_cache
                if ((np.asarray(z[:, :T], np.float64) == zf[:, :T]).all()
                        and (np.asarray(y[:, :T], np.float64)
                             == yf[:, :T]).all()):
                    audit["cells"] += 1
                    audit["cells_canonical"] += 1
                    pending.append((T, z, y, None, None,
                                    ("linear", accs[:, 1:T + 1]), None))
                    continue
            zj = torch.from_numpy(z).to(device)
            yj = torch.from_numpy(y).to(device)
            solve, hard, kind = _general_programs(z, T)
            audit["cells"] += 1
            audit["cells_" + kind] += 1
            pending.append((T, z, y, zj, yj, solve(*horizon(zj, yj, T)),
                            hard))
        return pending

    # Two runs in flight keep two runs' ADMM states alive ((reps, T, T) S/U
    # per horizon on the kernel route, T = T_max on the banded ADMM's; the
    # SSN's states are (X, mu) only); above ~4 GB of state, one run at a
    # time.
    lengths = T_grid if use_kernel else [T_max] * len(T_grid)
    state_bytes = (2 * replicates * 2 * sum(t * t for t in lengths)
                   * np.dtype(dtype).itemsize)
    prefetch = state_bytes <= (4 << 30)

    seconds = dict.fromkeys(("prepare", "solve_wait", "polish", "score",
                             "certified_score"), 0.0)

    def timed_prepare(run):
        t0 = time.perf_counter()
        out = prepare(run)
        seconds["prepare"] += time.perf_counter() - t0
        return out

    mixed_warned = False
    pend_next = timed_prepare(0) if runs else []
    for run in run_iter:
        pending = pend_next
        if prefetch and run + 1 < runs:
            pend_next = timed_prepare(run + 1)
        lin_cells = []
        for ti in range(len(pending)):
            T, z, y, zj, yj, solved, escalate = pending[ti]
            pending[ti] = None  # release the ADMM states early
            if isinstance(solved[0], str) and solved[0] == "linear":
                # Certified or canonical: scored below, host f64.
                lin_cells.append((ti, T, z, y, solved[1]))
                continue
            B = zj.shape[0]
            d_dim = zj.shape[2]
            t0 = time.perf_counter()
            if use_kernel:
                X_dev, res_dev, st_dev = solved
                X = feasible_actions(X_dev)                  # (B, T, d)
                # NaN-safe direction: a NaN residual counts as bad.
                bad = ~(res_dev.cpu().numpy().max(axis=1) <= fail_tol)
                if bad.any():
                    audit["replicates_escalated"] += int(bad.sum())
                    X2, res2, _ = prefix_continue(*horizon(zj, yj, T),
                                                  st_dev)
                    X2 = feasible_actions(X2)
                    bad2 = ~(res2.cpu().numpy().max(axis=1) <= fail_tol)
                    take = bad & ~bad2          # recovered replicates
                    audit["replicates_recovered"] += int(take.sum())
                    X[take] = X2[take]
                    bad = bad & bad2
                # Back to T_max by repeating row T - 1: a padded launch's
                # rows past T solve the same problem, and X[:, T:] is
                # pinned to the polished row T - 1 below.  (The residuals
                # are only read through their maximum, which the repeated
                # row does not change.)
                X = np.concatenate(
                    [X, np.repeat(X[:, T - 1:T], T_max - T, axis=1)], axis=1)
            else:
                X_dev, res_dev, st_dev = solved
                X_all = X_dev.cpu().numpy().astype(np.float64)
                res_all = res_dev.cpu().numpy()     # (n_bands, B, rows)
                X = np.empty((B, T_max, d_dim))
                bad = np.zeros(B, bool)              # per replicate
                for bi, lo in enumerate(band_los):
                    Xb = X_all[bi]
                    bad_b = ~(res_all[bi].max(axis=1) <= fail_tol)
                    if bad_b.any():
                        audit["replicates_escalated"] += int(bad_b.sum())
                        Xb2, resb2, _ = escalate(zj, yj, st_dev[bi], lo)
                        Xb2 = Xb2.cpu().numpy().astype(np.float64)
                        bad_b2 = ~(resb2.cpu().numpy().max(axis=1)
                                   <= fail_tol)
                        take = bad_b & ~bad_b2   # recovered replicates
                        audit["replicates_recovered"] += int(take.sum())
                        Xb[take] = Xb2[take]
                        bad_b = bad_b & bad_b2
                    # An overlapping tail band overwrites rows both solved.
                    X[:, lo:lo + Xb.shape[1]] = Xb
                    bad |= bad_b
            del solved, st_dev, X_dev, res_dev  # release the ADMM state
            n_dropped += int(bad.sum())
            X[bad] = np.nan
            t1 = time.perf_counter()
            seconds["solve_wait"] += t1 - t0
            if polish:
                for b in np.flatnonzero(~bad):
                    acts = np.concatenate([np.zeros((1, X.shape[2])), X[b]])
                    acts = polish_prefix_actions(z[b], y[b], acts, norm,
                                                 lengths=range(1, T + 1))
                    X[b] = acts[1:]
                    if use_canonical:
                        zb = np.asarray(z[b], np.float64)
                        yb = np.asarray(y[b], np.float64)
                        for ti_ in range(1, T + 1):
                            X[b, ti_ - 1] = canonicalize(
                                zb[:ti_], yb[:ti_], X[b, ti_ - 1], norm)
            # Prefixes past the true horizon solve the same (zero-padded)
            # problem as prefix T: pin them to the polished prefix-T row so
            # the comparator X[:, -1] is the exact full-sequence action.
            X[:, T:] = X[:, T - 1][:, None, :]
            t2 = time.perf_counter()
            seconds["polish"] += t2 - t1
            # Scored on the device with the polished f64 actions; the
            # action of round t is the prefix-t solution (prefix 0: zero).
            Xj = torch.from_numpy(X).to(device)
            X_play = torch.cat([Xj.new_zeros((B, 1, d_dim)), Xj[:, :-1]],
                               dim=1)
            cum_exact = normalized_hinge(sum_last(zj * X_play), yj).sum(-1)
            q_c = sum_last(zj * Xj[:, -1][:, None, :])
            comp = normalized_hinge(q_c, yj).sum(-1)
            by_T["FTL (exact)"][run, ti] = (cum_exact - comp).cpu().numpy()
            # FTRL with the shared exact comparator (K1 on the card).
            lin = simulate_linear_batch(zj, yj, 0, eta0, T)
            by_T["FTRL"][run, ti] = (lin.cum_loss.cpu().numpy()
                                     - comp.cpu().numpy())
            seconds["score"] += time.perf_counter() - t2
        if lin_cells:
            t0 = time.perf_counter()
            if (not mixed_warned and len(lin_cells) < len(by_T["FTRL"][run])
                    and np.dtype(dtype) != np.float64):
                mixed_warned = True
                log.info("evaluate_stream_exact[%s]: mixed scoring "
                         "arithmetic (certified cells host-f64, general "
                         "cells %s)", stream_name, np.dtype(dtype).name)
            # Certified cells: replay, comparator and FTRL in one batched
            # host f64 pass per run (the reference exact driver's
            # arithmetic, exact_ftl.py:230-333).
            zs = np.concatenate([np.asarray(c[2], np.float64)
                                 for c in lin_cells])
            ys = np.concatenate([np.asarray(c[3], np.float64)
                                 for c in lin_cells])
            cum_ftrl = _host_ftrl_cum_loss(zs, ys, eta0)
            ofs = 0
            for ti, T, zc, yc, X in lin_cells:
                B = X.shape[0]
                zc = np.asarray(zc, np.float64)[:, :T]
                yc = np.asarray(yc, np.float64)[:, :T]
                X_play = np.concatenate(
                    [np.zeros((B, 1, X.shape[2])), X[:, :T - 1]], axis=1)
                q = np.einsum("btd,btd->bt", zc, X_play)
                cum_exact = 0.5 * np.abs(q - yc).sum(axis=1)
                q_c = np.einsum("btd,bd->bt", zc, X[:, T - 1])
                comp = 0.5 * np.abs(q_c - yc).sum(axis=1)
                by_T["FTL (exact)"][run, ti] = cum_exact - comp
                by_T["FTRL"][run, ti] = cum_ftrl[ofs:ofs + B] - comp
                ofs += B
            seconds["certified_score"] += time.perf_counter() - t0
        if not prefetch and run + 1 < runs:
            pend_next = timed_prepare(run + 1)

    if n_dropped:
        log.warning("evaluate_stream_exact[%s]: dropped %d diverged "
                    "replicates", stream_name, n_dropped)
    audit["replicates_dropped"] = n_dropped
    if audit_out is not None:
        audit_out.update(audit)
    if timing_out is not None:
        timing_out.update(seconds)

    stats: Stats = {}
    for k in labels:
        run_means = np.nanmean(by_T[k], axis=2)      # sentinel-aware
        means, cis = [], []
        for ti in range(len(T_grid)):
            mu, ci = mean_ci(run_means[:, ti])
            means.append(mu)
            cis.append(ci)
        stats[k] = (np.asarray(means), np.asarray(cis))
    return stats
