"""Certified closed-form exact FTL for the binary-label data regime.

Copy of ``online_convex_optimization_tpu/models/linear_regime.py`` (host
NumPy; the port never imports the JAX package).

THEOREM (the data-contract identity, turned into a per-solve certificate).
For a label y in {-1, +1} and ANY prediction q,

    |q - y|  >=  1 - q*y,        with equality  iff  |q| <= 1,

and for a padded row (y == 0, z == 0): |q - 0| >= 0 with equality iff
q == 0 (automatic, since q = <0, x> = 0).  Summing over a prefix, for
EVERY x (feasible or not):

    f_t(x) = 0.5 * sum_{i<=t} |<z_i, x> - y_i|
           >= 0.5 * (cnt_t - <w_t, x>)            =: flin_t(x),

with running sufficient statistics w_t = sum_{i<=t} y_i z_i and
cnt_t = sum_{i<=t} y_i^2.  flin_t is LINEAR in x, so its minimizer over a
unit norm ball is closed-form:

    l2    x*_t = w_t / ||w_t||_2
    linf  x*_t = sign(w_t)
    l1    x*_t = sign(w_tj) e_j,  j = argmax_j |w_tj|

CERTIFICATE: if  max_{i<=t} |<z_i, x*_t>| <= 1,  then
f_t(x*_t) = flin_t(x*_t) <= flin_t(x) <= f_t(x) for every feasible x, so
x*_t is an EXACT global minimizer of the nonsmooth program — zero
iterations, f64 rounding only.  When w_t != 0 the linear argmin is unique,
hence x*_t is the UNIQUE minimizer of f_t and this path returns the same
point the general solver + active-set polish converges to.

Why this matters: the reference's production data satisfies the contract
by construction — sequence rows are CLIPPED to the unit l2 ball and labels
are +-1 (reference sequence_generation.py:54-70, 72-90;
reference algorithms.py:158-163 for the g(T) sampler) — so the
reference's CVXPY interior-point solves (reference exact_ftl.py:
119-128) were, unknowingly, solving linear programs with closed-form
solutions.  The certificate makes exploiting that OBSERVABLE and SAFE:

  - it is checked, per prefix, on the actual data (one masked matvec) —
    never assumed; clipping performed in f32 leaves f64 row norms at
    1 +- 1e-7 and the certificate still decides exactly (it bounds the
    predictions, not the row norms);
  - out-of-contract data (e.g. the reference's own smoke test with
    unclipped Gaussian rows, exact_ftl.py:460-475) fails the certificate
    and falls back to the general ADMM + active-set-polish solver;
  - w_t = 0 prefixes (the deterministic adversarial families) make the
    minimizer NON-unique, so they are routed to the general solver too —
    replayed trajectories are selection-dependent there and must keep the
    general solver's (reference-matching) selection.

Everything here is host-side f64 NumPy: the closed form is a cumulative
sum and a normalization; the certificate is one (T, d) x (d, T) BLAS
matmul per sequence — microseconds to milliseconds, versus thousands of
device ADMM iterations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Uniqueness guard: below this scale the linear objective is numerically
# flat and the argmin selection (not its objective) becomes solver-
# dependent, so we defer to the general solver to keep replayed
# trajectories reproducible.  At 1e-6 the closed form's direction error
# from f64 cumsum rounding is ~1e-7 — far inside the polish accuracy bar.
_UNIQUE_TOL = 1e-6

# Certificate slack: the prediction <z_i, x*_t> is computed in f64 with
# ~d*eps rounding, so a true prediction of exactly 1 (a clipped row
# parallel to w — every length-1 prefix!) can evaluate to 1 + 1 ulp.
# Accepting |q| <= 1 + 1e-14 bounds the possible true excess per row by
# ~2e-14, hence the objective suboptimality of the certified solution by
# 2e-14 * T  (= 2e-11 at T = 1000) — far inside the general path's 1e-9
# polish accuracy.  The slack is an ACCURACY bound, not an assumption.
_CERT_SLACK = 1e-14


def _contract_ok(z: np.ndarray, y: np.ndarray) -> bool:
    """Rows must carry labels in {-1, +1}, or be inert padding (y == 0 AND
    z == 0).  Shapes: z (..., T, d), y (..., T)."""
    pm1 = np.abs(y) == 1.0
    padded = (y == 0.0) & (np.abs(z).max(axis=-1) == 0.0)
    return bool(np.all(pm1 | padded))


def _linear_argmin(w: np.ndarray, norm: str):
    """Closed-form argmin of -<w, x> over the unit ``norm`` ball, batched
    over leading axes.  Returns (x, unique) with ``unique`` a boolean mask
    of the leading shape; non-unique entries invalidate the fast path."""
    if norm == "l2":
        n = np.linalg.norm(w, axis=-1, keepdims=True)
        x = w / np.maximum(n, 1e-300)
        return x, n[..., 0] > _UNIQUE_TOL
    if norm == "linf":
        x = np.sign(w)
        return x, np.abs(w).min(axis=-1) > _UNIQUE_TOL
    if norm == "l1":
        a = np.abs(w)
        j = np.argmax(a, axis=-1)
        x = np.zeros_like(w)
        idx = np.indices(j.shape)
        x[(*idx, j)] = np.sign(np.take_along_axis(w, j[..., None],
                                                  axis=-1))[..., 0]
        top = np.take_along_axis(a, j[..., None], axis=-1)[..., 0]
        a2 = np.array(a, copy=True)
        np.put_along_axis(a2, j[..., None], -np.inf, axis=-1)
        second = a2.max(axis=-1)
        return x, (top - second) > _UNIQUE_TOL
    raise ValueError(norm)


def certified_prefix_actions(z: np.ndarray, y: np.ndarray,
                             norm: str = "l2") -> Optional[np.ndarray]:
    """Exact prefix-action trajectory via the certified closed form, or
    ``None`` if any prefix is uncertified (caller falls back to the
    general solver).  Returns (T+1, d) f64; row 0 is the zero action."""
    X = certified_prefix_actions_batch(z[None], y[None], norm)
    if X is None:
        return None
    T, d = z.shape[-2], z.shape[-1]
    return np.concatenate([np.zeros((1, d)), X[0]])


def _ball_norm(x: np.ndarray, norm: str) -> float:
    if norm == "l2":
        return float(np.linalg.norm(x))
    if norm == "linf":
        return float(np.abs(x).max())
    if norm == "l1":
        return float(np.abs(x).sum())
    raise ValueError(norm)


def _l2_certificate_violations(z: np.ndarray, X: np.ndarray) -> np.ndarray:
    """(B, T) mask of prefixes t with |<z_i, x*_t>| > 1 + slack for some
    i <= t, computed in O(B T log T) instead of the naive O(B T^2 d)
    prediction matrix (which is memory-bandwidth-bound and dominates the
    exact pipeline's host time at T = 1000).

    Geometry: x*_t is l2-UNIT (w_t != 0 prefixes; w_t = 0 is flagged by
    the uniqueness mask independently), so by Cauchy-Schwarz a row with
    ||z_i|| <= 1 can never violate, and a row with n_i = ||z_i|| > 1
    violates only if x*_t lies within angle theta_i = sqrt(2(1 - 1/n_i))
    of +-z_i/n_i — for f32-clipped production rows (n_i <= 1 + 1e-7)
    that is a ~3.5e-4 cone.  Any coordinate difference bounds the chord,
    so candidate (i, t) pairs are found by a sorted first-coordinate
    window search and only those few pairs get exact f64 dot checks."""
    B, T, d = z.shape
    bad = np.zeros((B, T), bool)
    n_rows = np.linalg.norm(z, axis=-1)                  # (B, T)
    over_any = n_rows > 1.0
    if not over_any.any():
        return bad
    # Chord bound: ||x - s z_i/n_i||^2 = 2(1 - |cos|) <= 2(1 - 1/n_i).
    theta = np.sqrt(np.maximum(2.0 * (1.0 - 1.0 /
                                      np.maximum(n_rows, 1.0)), 0.0))
    theta = theta + 1e-9                                 # f64 slack
    for b in range(B):
        oi = np.flatnonzero(over_any[b])
        if oi.size == 0:
            continue
        u = X[b, :, 0]                                   # (T,)
        order = np.argsort(u, kind="stable")
        us = u[order]
        zi0 = z[b, oi, 0] / n_rows[b, oi]
        th = theta[b, oi]
        for sgn in (1.0, -1.0):
            lo = np.searchsorted(us, sgn * zi0 - th, side="left")
            hi = np.searchsorted(us, sgn * zi0 + th, side="right")
            counts = hi - lo
            nz = np.flatnonzero(counts > 0)
            if nz.size == 0:
                continue
            rows_rep = np.repeat(oi[nz], counts[nz])
            t_idx = order[np.concatenate(
                [np.arange(lo[k], hi[k]) for k in nz])]
            keep = t_idx >= rows_rep                     # i <= t only
            if not keep.any():
                continue
            ii, tt = rows_rep[keep], t_idx[keep]
            q = np.einsum("kd,kd->k", z[b, ii], X[b, tt])
            viol = np.abs(q) > 1.0 + _CERT_SLACK
            bad[b, tt[viol]] = True
    return bad


def _l1_certificate_violations(z: np.ndarray, w: np.ndarray,
                               X: np.ndarray) -> np.ndarray:
    """(B, T) violation mask for the l1 closed form x*_t = sign(w_tj) e_j.

    The prediction is a single coordinate, |<z_i, x*_t>| = |z_i[j_t]|, so
    the certificate is a per-coordinate running max M_j(t) =
    max_{i<=t} |z_ij| gathered at j_t — O(B T d) time, O(B T d) memory,
    no (B, T, T) prediction matrix.  For contract data this certifies
    ALWAYS up to f32-clip slack: |z_ij| <= ||z_i||_2 <= 1 + 1e-7."""
    M = np.maximum.accumulate(np.abs(z), axis=-2)        # (B, T, d)
    j = np.argmax(np.abs(w), axis=-1)                    # (B, T)
    mj = np.take_along_axis(M, j[..., None], axis=-1)[..., 0]
    return mj > 1.0 + _CERT_SLACK


def _linf_certificate_violations(z: np.ndarray,
                                 X: np.ndarray) -> np.ndarray:
    """(B, T) violation mask for the linf closed form x*_t = sign(w_t),
    in O(T) extra memory (vs the old (B, T, T) prediction matrix).

    sign(w_t) is piecewise-constant in t: it changes only when a
    coordinate of the running sum w crosses zero.  Within a constant
    segment [a, e) the certificate max_{i<=t} |<z_i, x>| is a running
    max of ONE (segment) prediction vector, and a row can only violate
    if ||z_i||_1 > 1 (Hoelder), so rows are screened first.  Worst-case
    time O(nseg * T * d) — degrading gracefully on adversarial sign
    oscillation while production-like data has O(d log T) segments."""
    B, T, d = z.shape
    bad = np.zeros((B, T), bool)
    l1_rows = np.abs(z).sum(axis=-1)                     # (B, T)
    for b in range(B):
        cand = np.flatnonzero(l1_rows[b] > 1.0 + _CERT_SLACK)
        if cand.size == 0:
            continue
        S = X[b]                                         # (T, d) signs
        change = np.any(S[1:] != S[:-1], axis=1)
        starts = np.concatenate([[0], np.flatnonzero(change) + 1])
        ends = np.concatenate([starts[1:], [T]])
        for a, e in zip(starts, ends):
            ii = cand[cand < e]
            if ii.size == 0:
                continue
            q = z[b, ii] @ S[a]
            viol = ii[np.abs(q) > 1.0 + _CERT_SLACK]
            if viol.size == 0:
                continue
            lo = max(a, int(viol.min()))                 # i <= t only
            bad[b, lo:e] = True
    return bad


def certified_prefix_actions_batch(z: np.ndarray, y: np.ndarray,
                                   norm: str = "l2",
                                   max_rescue: int = 64
                                   ) -> Optional[np.ndarray]:
    """Batched certified closed form: z (B, T, d), y (B, T) -> (B, T, d)
    f64 prefix minimizers (row t minimizes the length-(t+1) prefix), or
    ``None`` if any (replicate, prefix) cannot be certified.

    Two certificates are tried per prefix:

    1. LINEAR-BOUND: |<z_i, x*_t>| <= 1 (+f64 slack) for all i <= t
       certifies x*_t = argmax <w_t, x> as the exact global minimizer.
    2. INTERPOLATION: where (1) fails — in production only tiny prefixes
       whose f32-clipped rows carry f64 norms of 1 + O(1e-7), where the
       true optimum interpolates — the min-norm least-squares interpolant
       with residual ~0 and ball norm <= 1 has objective ~0 >= the global
       lower bound 0, hence is certified optimal.  This is also the
       selection the general path's active-set polish makes on fully
       interpolated prefixes (models/polish.py::_candidate_l2 with an
       empty inactive set), keeping the two paths statistically aligned.

    More than ``max_rescue`` rescue attempts (or any failed rescue)
    returns None and the caller uses the general solver for the batch."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    if z.ndim != 3 or z.shape[-2] == 0:
        return None
    if not _contract_ok(z, y):
        return None
    w = np.cumsum(y[..., None] * z, axis=-2)             # (B, T, d)
    X, unique = _linear_argmin(w, norm)                  # (B, T, d), (B, T)
    # Certificate 1: |<z_i, x*_t>| <= 1 for every i <= t.
    if norm == "l2":
        bad = _l2_certificate_violations(z, X) | ~unique
    elif norm == "l1":
        bad = _l1_certificate_violations(z, w, X) | ~unique
    else:  # linf
        bad = _linf_certificate_violations(z, X) | ~unique
    if bad.any():
        idx = np.argwhere(bad)
        if idx.shape[0] > max_rescue:
            return None
        for b, t in idx:
            # Certificate 2: exact interpolation.
            x_int, *_ = np.linalg.lstsq(z[b, :t + 1], y[b, :t + 1],
                                        rcond=None)
            if np.max(np.abs(z[b, :t + 1] @ x_int - y[b, :t + 1])) > 1e-12:
                return None
            if _ball_norm(x_int, norm) > 1.0:
                return None
            X[b, t] = x_int
    return X


def certified_full_solution_batch(z: np.ndarray, y: np.ndarray,
                                  norm: str = "l2"):
    """Full-sequence minimizers (the exact comparator) for a batch:
    z (B, T, d), y (B, T) -> (X (B, d) f64, certified (B,) bool).
    Per-replicate certification (cheap here: one matvec each), so callers
    can solve only the uncertified remainder with the general solver."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    B, T, d = z.shape
    ok = np.array([_contract_ok(z[b], y[b]) for b in range(B)])
    w = (y[..., None] * z).sum(axis=-2)                  # (B, d)
    X, unique = _linear_argmin(w, norm)
    ok &= unique
    q = np.einsum("btd,bd->bt", z, X)
    ok &= (np.abs(q) <= 1.0 + _CERT_SLACK).all(axis=-1)
    return X, ok


def certified_full_solution(z: np.ndarray, y: np.ndarray,
                            norm: str = "l2") -> Optional[np.ndarray]:
    """Single-sequence certified comparator, or None if uncertified."""
    X, ok = certified_full_solution_batch(np.asarray(z)[None],
                                          np.asarray(y)[None], norm)
    return X[0] if bool(ok[0]) else None
