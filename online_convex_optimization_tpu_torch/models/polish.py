"""Active-set polish: interior-point-grade accuracy from ADMM solutions.

Copy of ``online_convex_optimization_tpu/models/polish.py`` (host NumPy;
the port never imports the JAX package, whose ``__init__`` imports jax).

The device ADMM (models/exact_ftl.py) plateaus around 1e-5 objective
accuracy on the nonsmooth exact-FTL program

    minimize_{||x||_p <= 1}   f(x) = 0.5 * sum_i |<z_i, x> - y_i|,

while the reference's CVXPY/ECOS solves are ~1e-8-exact
(reference exact_ftl.py:119-128).  At 1e-5 the ADMM iterate has
already IDENTIFIED the combinatorial structure of the optimum (which
residuals are zero, which ball faces are active, the signs of the rest) —
the remaining error is pure drift along the optimal face.  Given that
structure, the exact optimum solves a TINY (<= d+1 square) linear system:

  - zero-residual ("interpolated") rows i in A:   <z_i, x> = y_i
  - nonzero residuals keep their signs, so their contribution to f is the
    LINEAR function <g, x> with g = 0.5 * sum_{i not in A} sign(r_i) z_i
  - the ball constraint contributes, per norm:
      l2    x = x_par + N t with N = null(Z_A); minimizing <g, x> over
            ||x||<=1 on the affine set has the closed form
            t = -sqrt(1 - ||x_par||^2) * N^T g / ||N^T g||
      linf  coordinates at +-1 are pinned; the free ones solve the
            square interpolation system
      l1    off-support coordinates are 0; the active face adds the row
            sum_j sign(x_j) x_j = 1 when the ball is tight

Every candidate is verified: exact feasibility (with an exact rescale/clip
of <= 1e-9 slack) and the true objective f are evaluated in f64, and the
polish is kept only when it does not lose to the ADMM iterate — so the
polish can only improve the solution, never corrupt it.  Several
active-set tolerances are tried because the identification threshold is
instance-dependent.

All host-side f64 NumPy: the systems are at most (d+1) x (d+1) with d<=8,
a few microseconds per prefix — negligible next to the device solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_ACTIVE_TOLS = (3e-3, 1e-3, 3e-4, 1e-4, 1e-5)


def objective(z: np.ndarray, y: np.ndarray, x: np.ndarray) -> float:
    return 0.5 * float(np.sum(np.abs(z @ x - y)))


def _null_space(a: np.ndarray, d: int) -> np.ndarray:
    """Orthonormal basis of null(a) for an (m, d) matrix (m may be 0)."""
    if a.size == 0:
        return np.eye(d)
    _, sv, vt = np.linalg.svd(a, full_matrices=True)
    rank = int(np.sum(sv > max(a.shape) * np.finfo(np.float64).eps *
                      (sv[0] if sv.size else 1.0)))
    return vt[rank:].T


def _candidate_l2(z, y, active, g, d):
    za, ya = z[active], y[active]
    if za.size:
        x_par, *_ = np.linalg.lstsq(za, ya, rcond=None)
        if np.max(np.abs(za @ x_par - ya), initial=0.0) > 1e-9:
            return None  # inconsistent interpolation set
    else:
        x_par = np.zeros(d)
    room = 1.0 - float(x_par @ x_par)
    if room < -1e-12:
        return None
    n_basis = _null_space(za, d)
    if n_basis.size:
        gn = n_basis.T @ g
        ngn = float(np.linalg.norm(gn))
        if ngn > 1e-12 and room > 0.0:
            x = x_par - n_basis @ (gn / ngn) * np.sqrt(max(room, 0.0))
        else:
            x = x_par
    else:
        x = x_par
    nx = float(np.linalg.norm(x))
    if nx > 1.0 + 1e-9:
        return None
    return x / max(nx, 1.0)


def _candidate_linf(z, y, active, x0, d, pin_tol=1e-6):
    za, ya = z[active], y[active]
    pinned = np.abs(x0) > 1.0 - pin_tol
    free = ~pinned
    b = np.sign(x0[pinned])
    rhs = ya - (za[:, pinned] @ b if za.size else 0.0)
    nf = int(np.sum(free))
    x = np.zeros(d)
    x[pinned] = b
    if nf:
        m = za[:, free]
        if m.shape[0] < nf:
            return None  # under-determined face; keep ADMM
        xf, *_ = np.linalg.lstsq(m, rhs, rcond=None)
        if m.size and np.max(np.abs(m @ xf - rhs), initial=0.0) > 1e-9:
            return None
        x[free] = xf
    elif za.size and np.max(np.abs(za[:, pinned] @ b - ya),
                            initial=0.0) > 1e-9:
        return None
    if np.max(np.abs(x), initial=0.0) > 1.0 + 1e-9:
        return None
    return np.clip(x, -1.0, 1.0)


def _candidate_l1(z, y, active, x0, d):
    za, ya = z[active], y[active]
    support = np.abs(x0) > 1e-6
    ns = int(np.sum(support))
    if ns == 0:
        return np.zeros(d) if not za.size else None
    s = np.sign(x0[support])
    ball_tight = float(np.sum(np.abs(x0))) > 1.0 - 1e-6
    m = za[:, support]
    rhs = ya
    if ball_tight:
        m = np.vstack([m, s[None, :]]) if m.size else s[None, :].copy()
        rhs = np.concatenate([rhs, [1.0]])
    if m.shape[0] < ns:
        return None
    xs, *_ = np.linalg.lstsq(m, rhs, rcond=None)
    if np.max(np.abs(m @ xs - rhs), initial=0.0) > 1e-9:
        return None
    x = np.zeros(d)
    x[support] = xs
    l1 = float(np.sum(np.abs(x)))
    if l1 > 1.0 + 1e-9:
        return None
    if l1 > 1.0:
        x /= l1
    return x


def polish_solution(z: np.ndarray, y: np.ndarray, x_admm: np.ndarray,
                    norm: str = "l2") -> np.ndarray:
    """Best feasible candidate among the ADMM iterate and its active-set
    polishes (objective compared exactly in f64; polish never loses)."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    x_admm = np.asarray(x_admm, np.float64)
    d = z.shape[1]
    r = z @ x_admm - y
    best_x, best_f = x_admm, objective(z, y, x_admm)
    for tol in _ACTIVE_TOLS:
        active = np.abs(r) <= tol
        sigma = np.sign(r[~active])
        g = 0.5 * (z[~active].T @ sigma) if sigma.size else np.zeros(d)
        if norm == "l2":
            cands = [_candidate_l2(z, y, active, g, d)]
        elif norm == "linf":
            # Pinning-threshold ladder: an ADMM iterate within ~1e-6 of
            # the fixed point can leave a truly-pinned coordinate just
            # outside a single fixed threshold; extra candidates are free
            # (the objective comparison below keeps only improvements).
            cands = [_candidate_linf(z, y, active, x_admm, d, pin_tol=pt)
                     for pt in (1e-6, 1e-5, 1e-4)]
        elif norm == "l1":
            cands = [_candidate_l1(z, y, active, x_admm, d)]
        else:
            raise ValueError(norm)
        for cand in cands:
            if cand is None:
                continue
            f = objective(z, y, cand)
            if f < best_f:
                best_x, best_f = cand, f
    return best_x


def _polish_prefix_actions_loop(z, y, actions, norm="l2", lengths=None):
    """Scalar per-prefix reference implementation (kept as the oracle the
    batched path is tested against)."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    out = np.array(actions, np.float64, copy=True)
    T = z.shape[0]
    ps = range(1, T + 1) if lengths is None else lengths
    for p in ps:
        out[p] = polish_solution(z[:p], y[:p], out[p], norm)
    return out


# ---------------------------------------------------------------------
# Batched polish: all prefixes at once.
#
# The per-prefix loop above costs ~0.3 ms of Python per prefix — at the
# exact-experiment scale (reps x sum_T T ~ 88k prefixes per run) it is
# ~80% of the whole exact pipeline's wall time.  The batched path below
# does the identical candidate construction for EVERY prefix at once:
#   - one (n, T) residual matmul identifies all active sets,
#   - active-row Gram matrices for all prefixes come from one masked
#     (n, T) @ (T, d^2) BLAS matmul (running-sufficient-statistics form),
#   - the tiny least-squares systems are solved with batched eigh-based
#     pseudo-inverses (+ one iterative-refinement step),
#   - every candidate is verified exactly as in polish_solution
#     (feasibility + true f64 objective), so the polish still never loses.
# ---------------------------------------------------------------------

_EPS = float(np.finfo(np.float64).eps)


def _batch_pinv_apply(G, rhs, rows, cols):
    """Min-norm least-squares solve for n stacked systems given their
    normal matrices G (n, d, d) and right-hand sides M^T b = rhs (n, d).

    ``rows``/``cols`` give each system's row/column counts for the
    lstsq-compatible singular-value cutoff eps * max(rows, cols) * smax.
    Returns (x, null_mask, V) where null_mask (n, d) marks eigenvectors
    treated as null space and V holds the eigenvectors.
    """
    lam, V = np.linalg.eigh(G)
    lam = np.maximum(lam, 0.0)
    # Rank cutoff in EIGENVALUE space: a formed Gram matrix carries
    # O(eps * lam_max) rounding noise in its spectrum, so the lstsq-style
    # singular-value cutoff (eps * max(m,n) * smax, i.e. eps^2-relative on
    # lam) would keep pure-noise eigenvalues and amplify them by 1/lam.
    cut = _EPS * np.maximum(rows, cols) * lam[:, -1]
    keep = lam > cut[:, None]
    inv_lam = np.where(keep, np.divide(1.0, lam, out=np.ones_like(lam),
                                       where=lam > 0.0), 0.0)

    def apply(b):
        return np.einsum("nij,nj->ni", V, inv_lam * np.einsum(
            "nij,ni->nj", V, b))

    x = apply(rhs)
    # One iterative-refinement step (the normal equations square the
    # condition number; refinement recovers most of the lost digits).
    x = x + apply(rhs - np.einsum("nij,nj->ni", G, x))
    return x, ~keep, V


def _masked_max(mask, vals):
    return np.where(mask, vals, 0.0).max(axis=1) if vals.size else \
        np.zeros(vals.shape[0])


def polish_prefix_actions(z: np.ndarray, y: np.ndarray, actions: np.ndarray,
                          norm: str = "l2",
                          lengths: Optional[np.ndarray] = None) -> np.ndarray:
    """Polish a (T+1, d) prefix-action trajectory (row 0 is the zero action
    and stays), all prefixes batched; each prefix's result is verified in
    f64 and can only improve on the input action."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    out = np.array(actions, np.float64, copy=True)
    T_all = z.shape[0]
    d = z.shape[1]
    P = np.arange(1, T_all + 1) if lengths is None \
        else np.asarray(list(lengths), np.int64)
    if P.size == 0:
        return out
    T = int(P.max())                      # padded tail rows never enter
    z = z[:T]
    y = y[:T]

    X0 = out[P]                                          # (n, d)
    n = X0.shape[0]
    zT = np.ascontiguousarray(z.T)
    R = X0 @ zT - y[None, :]                             # (n, T)
    absR = np.abs(R)
    Vm = np.arange(T)[None, :] < P[:, None]              # valid rows per prefix
    best_f = 0.5 * np.where(Vm, absR, 0.0).sum(axis=1)
    best_x = X0.copy()
    ZZ = (z[:, :, None] * z[:, None, :]).reshape(T, d * d)

    # Active-set masks are NESTED across the decreasing tolerance ladder,
    # so a prefix whose active-row count equals the previous rung's has an
    # IDENTICAL mask — its candidate was already considered.  Each rung
    # therefore processes only the changed rows (first rung: all rows).
    counts = np.stack([((absR <= tol) & Vm).sum(axis=1)
                       for tol in _ACTIVE_TOLS])         # (n_tols, n)

    for ti, tol in enumerate(_ACTIVE_TOLS):
        idx = np.flatnonzero(counts[ti] != counts[ti - 1]) if ti else \
            np.arange(n)
        if idx.size == 0:
            continue
        Rs = R[idx]
        Vms = Vm[idx]
        X0s = X0[idx]
        A = Vms & (np.abs(Rs) <= tol)                    # active rows
        Af = A.astype(np.float64)
        m_rows = counts[ti, idx].astype(np.float64)
        G = (Af @ ZZ).reshape(idx.size, d, d)            # sum_active z z^T
        zy = (Af * y[None, :]) @ z                       # sum_active y z

        def consider(xc, valid, idx=idx, Vms=Vms):
            """Exact verification: true objective, keep improvements only."""
            f = 0.5 * np.where(Vms, np.abs(xc @ zT - y[None, :]),
                               0.0).sum(axis=1)
            take = valid & (f < best_f[idx])
            rows = idx[take]
            best_x[rows] = xc[take]
            best_f[rows] = f[take]

        if norm == "l2":
            sig = np.where(Vms & ~A, np.sign(Rs), 0.0)
            g = 0.5 * (sig @ z)                          # linear part on the face
            x_par, nullm, V = _batch_pinv_apply(G, zy, m_rows, float(d))
            cons = _masked_max(A, np.abs(x_par @ zT - y[None, :])) <= 1e-9
            room = 1.0 - np.einsum("ni,ni->n", x_par, x_par)
            ok = cons & (room >= -1e-12)
            cg = np.where(nullm, np.einsum("nij,ni->nj", V, g), 0.0)
            ngn = np.linalg.norm(cg, axis=1)
            move = (ngn > 1e-12) & (room > 0.0)
            step = np.where(move, np.sqrt(np.maximum(room, 0.0)) /
                            np.maximum(ngn, 1e-300), 0.0)
            xc = x_par - np.einsum("nij,nj->ni", V, cg) * step[:, None]
            nx = np.linalg.norm(xc, axis=1)
            ok &= nx <= 1.0 + 1e-9
            xc = xc / np.maximum(nx, 1.0)[:, None]
            consider(xc, ok)

        elif norm == "linf":
            for pt in (1e-6, 1e-5, 1e-4):
                pinned = np.abs(X0s) > 1.0 - pt          # (m, d)
                free = ~pinned
                b = np.where(pinned, np.sign(X0s), 0.0)
                nf = free.sum(axis=1).astype(np.float64)
                fo = free[:, :, None] & free[:, None, :]
                Gf = np.where(fo, G, 0.0)
                rhs = np.where(free, zy - np.einsum("nij,nj->ni", G, b), 0.0)
                xf, _, _ = _batch_pinv_apply(Gf, rhs, m_rows, nf)
                xc = b + np.where(free, xf, 0.0)
                ok = m_rows >= nf                        # else under-determined face
                ok &= _masked_max(A, np.abs(xc @ zT - y[None, :])) <= 1e-9
                ok &= np.abs(xc).max(axis=1) <= 1.0 + 1e-9
                consider(np.clip(xc, -1.0, 1.0), ok)

        elif norm == "l1":
            support = np.abs(X0s) > 1e-6
            ns = support.sum(axis=1).astype(np.float64)
            s = np.where(support, np.sign(X0s), 0.0)
            tight = np.abs(X0s).sum(axis=1) > 1.0 - 1e-6
            tf = tight.astype(np.float64)
            so = support[:, :, None] & support[:, None, :]
            Gs = np.where(so, G + tf[:, None, None] * s[:, :, None] *
                          s[:, None, :], 0.0)
            rhs = np.where(support, zy + tf[:, None] * s, 0.0)
            xs, _, _ = _batch_pinv_apply(Gs, rhs, m_rows + tf, ns)
            xc = np.where(support, xs, 0.0)
            ok = (m_rows + tf) >= ns                     # row-count check
            ok &= _masked_max(A, np.abs(xc @ zT - y[None, :])) <= 1e-9
            ok &= ~tight | (np.abs(np.einsum("ni,ni->n", s, xc) - 1.0)
                            <= 1e-9)
            # ns == 0: the zero action, valid only with no active rows.
            empty = ns == 0
            xc[empty] = 0.0
            ok = np.where(empty, m_rows == 0, ok)
            l1 = np.abs(xc).sum(axis=1)
            ok &= l1 <= 1.0 + 1e-9
            xc = xc / np.maximum(l1, 1.0)[:, None]
            consider(xc, ok)

        else:
            raise ValueError(norm)

    out[P] = best_x
    return out
