"""Canonical selection on degenerate exact-FTL optima (l2/linf/l1 balls).

Copy of ``online_convex_optimization_tpu/models/canonical.py`` (host NumPy
and scipy HiGHS; the port never imports the JAX package).

THE PROBLEM (docs/DESIGN.md "Canonical selection"): on the deterministic
w = 0 families (label flips, switching leaders — the reference's own
adversarial streams, sequence_generation.py:24-60) the prefix programs

    minimize_{||x|| <= 1}  f_t(x) = 0.5 sum_{i<=t} |<z_i, x> - y_i|

have NON-UNIQUE minimizer sets (interpolation flats, 0-slabs), so "the"
exact-FTL trajectory depends on which point the iterative solver lands
on — historically whatever the banded ADMM + polish happened to select,
which pins the committed artifacts to one solver configuration.

THE CONTRACT: the canonical action is the MINIMUM-l2-NORM point of the
optimal face.  It is solver-independent, idempotent, and (on the
structures below) computable in closed form from the data alone:

  *  interpolation faces (f* = 0 or a kink face with active rows A):
     the lstsq minimum-norm interpolant of  z_A x = y_A;
  *  0-flats (w = sum y_i z_i = 0 slabs): the zero vector;
  *  unique optima: the face has one point; canonicalization is the
     identity.

RIGOR: a candidate is accepted only if EXACT first-order optimality is
verifiable — feasibility of the subgradient system

    sum_{i notin A} 0.5 sign(r_i) z_i  +  sum_{i in A} u_i z_i
        + lam * x  =  0,     u in [-1/2, 1/2]^A,  lam >= 0
    (lam = 0 unless ||x|| = 1)

checked by a small linear program (scipy linprog, d equality rows).  No
objective-value oracle is needed, so the canonical solve runs host-side
in f64 with NO device solver at all — which is what unlocks the
T_max-prefix dedup for the deterministic families in the exact pipeline
(every horizon of a deterministic family is a prefix of the longest
cell; see experiments/evaluate.py).

Reference parity: the reference simply returns whatever CVXPY/ECOS
selects on these degenerate programs (reference exact_ftl.py:
119-128) — a solver-version-dependent point; the canonical contract is
strictly stronger.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from online_convex_optimization_tpu_torch.models.polish import objective

_TAUS = (1e-9, 1e-7, 1e-5, 1e-3)


def _ball_norm(x: np.ndarray, norm: str) -> float:
    if norm == "l2":
        return float(np.linalg.norm(x))
    if norm == "linf":
        return float(np.abs(x).max(initial=0.0))
    if norm == "l1":
        return float(np.abs(x).sum())
    raise ValueError(norm)


def _optimality_lp(z: np.ndarray, y: np.ndarray, x: np.ndarray,
                   active: np.ndarray, tol: float = 1e-9,
                   norm: str = "l2") -> bool:
    """Exact first-order optimality of ``x`` with kink set ``active``:
    feasibility of the subgradient system above, as an LP with slack
    minimization (optimal slack ~ 0 iff feasible).

    The ball's normal cone at ``x`` is norm-specific and LP-
    representable in all three cases (reference exact_ftl.py:
    95-102 treats the same three balls):

      l2    {lam * x : lam >= 0}                  (boundary only)
      linf  {sum_j mu_j sign(x_j) e_j : mu >= 0, j with |x_j| = 1}
      l1    {v : v_j = t*sign(x_j) on supp(x), |v_j| <= t off-support,
             t >= 0}                              (boundary only)
    """
    from scipy.optimize import linprog

    d = z.shape[1]
    r = z @ x - y
    out = ~active
    g_out = 0.5 * (np.sign(r[out])[:, None] * z[out]).sum(axis=0) \
        if out.any() else np.zeros(d)
    zA = z[active]
    nA = int(active.sum())
    boundary = _ball_norm(x, norm) > 1.0 - 1e-9

    # Normal-cone variable block: cone_cols (d, k) with bounds, plus
    # optional A_ub coupling rows (the l1 |v_j| <= t constraints).
    cone_cols = np.zeros((d, 0))
    cone_bounds = []
    ub_rows = None                    # rows over the cone block only
    if boundary:
        if norm == "l2":
            cone_cols = x[:, None]
            cone_bounds = [(0, None)]
        elif norm == "linf":
            J = np.flatnonzero(np.abs(x) > 1.0 - 1e-9)
            cone_cols = np.zeros((d, J.size))
            for k, j in enumerate(J):
                cone_cols[j, k] = np.sign(x[j])
            cone_bounds = [(0, None)] * J.size
        elif norm == "l1":
            supp = np.abs(x) > 1e-12
            off = np.flatnonzero(~supp)
            # vars: [t, r_off...]; v = t*sign(x) on supp, r_j off.
            cone_cols = np.zeros((d, 1 + off.size))
            cone_cols[supp, 0] = np.sign(x[supp])
            for k, j in enumerate(off):
                cone_cols[j, 1 + k] = 1.0
            cone_bounds = [(0, None)] + [(None, None)] * off.size
            if off.size:
                # |r_j| <= t  ->  r_j - t <= 0 and -r_j - t <= 0.
                ub_rows = np.zeros((2 * off.size, 1 + off.size))
                for k in range(off.size):
                    ub_rows[2 * k, 0] = -1.0
                    ub_rows[2 * k, 1 + k] = 1.0
                    ub_rows[2 * k + 1, 0] = -1.0
                    ub_rows[2 * k + 1, 1 + k] = -1.0
        else:
            raise ValueError(norm)
    nC = cone_cols.shape[1]

    # Variables: u (nA), cone (nC), s+ (d), s- (d).
    n_var = nA + nC + 2 * d
    # Equalities: zA^T u + cone_cols @ mu + s+ - s- = -g_out
    A_eq = np.zeros((d, n_var))
    if nA:
        A_eq[:, :nA] = zA.T
    if nC:
        A_eq[:, nA:nA + nC] = cone_cols
    A_eq[:, nA + nC:nA + nC + d] = np.eye(d)
    A_eq[:, nA + nC + d:] = -np.eye(d)
    b_eq = -g_out
    c = np.zeros(n_var)
    c[nA + nC:] = 1.0               # minimize total slack
    bounds = ([(-0.5, 0.5)] * nA + cone_bounds
              + [(0, None)] * (2 * d))
    A_ub = b_ub = None
    if ub_rows is not None:
        A_ub = np.zeros((ub_rows.shape[0], n_var))
        A_ub[:, nA:nA + nC] = ub_rows
        b_ub = np.zeros(ub_rows.shape[0])
    res = linprog(c, A_eq=A_eq, b_eq=b_eq, A_ub=A_ub, b_ub=b_ub,
                  bounds=bounds, method="highs")
    return bool(res.success) and float(res.fun) <= tol


def canonicalize(z: np.ndarray, y: np.ndarray, x: np.ndarray,
                 norm: str = "l2") -> np.ndarray:
    """Map an optimal ``x`` to the canonical (min-l2-norm) point of its
    optimal face.  Identity when no strictly-smaller-norm optimal
    candidate verifies (unique optima; faces outside the covered
    structures).  Never degrades the objective (candidates must match
    f(x) to 1e-9).

    All three reference balls are supported (l2/linf/l1 —
    reference exact_ftl.py:95-102): feasibility uses the ball
    norm, while the canonical point of a face is its min-l2-norm
    element for every ball (the selection must only be deterministic
    and solver-independent; min-l2 is the natural strictly-convex
    tiebreak)."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    f_x = objective(z, y, x)
    best = x
    best_n = float(np.linalg.norm(x))
    for cand in _candidates(z, y, x, norm):
        n = float(np.linalg.norm(cand))
        if n >= best_n - 1e-12:
            continue
        if objective(z, y, cand) <= f_x + 1e-9:
            best, best_n = cand, n
    return best


def _candidates(z, y, x, norm="l2"):
    d = z.shape[1]
    yield np.zeros(d)                        # 0-flat
    r = z @ x - y
    for tau in _TAUS:
        active = np.abs(r) <= tau
        if active.any():
            zA, yA = z[active], y[active]
            x_par, *_ = np.linalg.lstsq(zA, yA, rcond=None)
            if np.max(np.abs(zA @ x_par - yA), initial=0.0) > 1e-9:
                continue
            if norm == "l2":
                # Scaling into the ball keeps the direction; the
                # objective guard in canonicalize re-verifies.
                if np.linalg.norm(x_par) <= 1.0 + 1e-12:
                    yield x_par / max(np.linalg.norm(x_par), 1.0)
            elif _ball_norm(x_par, norm) <= 1.0 + 1e-12:
                # Non-l2 balls: scaling would break interpolation AND
                # ball geometry — only in-ball interpolants qualify.
                yield x_par


def canonical_prefix_actions(z: np.ndarray, y: np.ndarray,
                             norm: str = "l2") -> Optional[np.ndarray]:
    """All-prefix canonical actions computed host-side WITHOUT a device
    solver: per prefix, propose the structural candidates (0-point, the
    lstsq min-norm interpolants of growing kink sets) and accept the
    smallest-norm candidate whose EXACT optimality verifies by the
    subgradient LP.  Returns (T+1, d) with row 0 = 0, or None if any
    prefix has no verifiable candidate (caller falls back to the
    iterative solver path).

    Candidate generation exploits the deterministic families' structure:
    their rows repeat in a handful of DISTINCT (row, label) groups, and
    every optimal face is the interpolation set of some subset of
    groups (or the 0-flat).  All 2^K - 1 subset interpolants (K <= 6
    distinct groups; more returns None) plus the zero vector are
    proposed smallest-norm-first; the first LP-verified candidate wins.
    General unstructured data is out of scope BY DESIGN — those cells
    keep the iterative solver and get ``canonicalize`` applied after.
    All three balls are supported; candidate feasibility and the
    optimality LP's normal cone are norm-aware (_optimality_lp)."""
    if norm not in ("l2", "linf", "l1"):
        return None
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    T, d = z.shape
    acts = np.zeros((T + 1, d))
    # Distinct (row, label) groups over the WHOLE sequence (prefix
    # groups are subsets; group count is the structure bound).
    keys = np.round(np.concatenate([z, y[:, None]], axis=1), 12)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    if inv.max() + 1 > 6:
        return None
    from itertools import combinations

    for t in range(1, T + 1):
        zt, yt = z[:t], y[:t]
        gids = sorted(set(inv[:t].tolist()))
        reps = {g: int(np.flatnonzero(inv[:t] == g)[0]) for g in gids}
        cands = [np.zeros(d)]
        for k in range(1, len(gids) + 1):
            for sub in combinations(gids, k):
                rows = [reps[g] for g in sub]
                zA, yA = zt[rows], yt[rows]
                x_par, *_ = np.linalg.lstsq(zA, yA, rcond=None)
                if (np.max(np.abs(zA @ x_par - yA), initial=0.0) <= 1e-9
                        and _ball_norm(x_par, norm) <= 1.0 + 1e-12):
                    cands.append(x_par)
        cands.sort(key=lambda c: float(np.linalg.norm(c)))
        found = None
        for cand in cands:
            rr = zt @ cand - yt
            for tau in (1e-9, 1e-7):
                active = np.abs(rr) <= tau
                if _optimality_lp(zt, yt, cand, active, norm=norm):
                    found = cand
                    break
            if found is not None:
                break
        if found is None:
            return None
        acts[t] = found
    return acts
