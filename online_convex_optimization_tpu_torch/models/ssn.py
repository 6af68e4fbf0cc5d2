"""Semismooth Newton (Huber continuation) exact-FTL solver, l2/linf balls.

Counterpart of ``online_convex_optimization_tpu/models/ssn.py``: the
general-path alternative to the banded ADMM (``models/exact_ftl.py``) for
data outside the certified linear regime (``models/linear_regime.py``).  It
solves, for every prefix length at once,

    minimize_{||x|| <= 1}  f(x) = 0.5 * sum_i m_i |<z_i, x> - y_i|

by (1) Huber smoothing with continuation (``mu`` starts at the data scale and
shrinks by ``_MU_SHRINK`` once a row's step is stationary at ``mu``'s
scale), (2) two ball-constrained Newton candidates a step (the IRLS
majorizer and the Huber-zone Hessian) from a safeguarded More-Sorensen
secular iteration (l2) or a projected-Newton box solve (linf), and (3) a
batched line search over a geometric step ladder.  ``res`` is a rigorous
normalized duality gap ``min(f - D(u), f) / (1 + f)`` at a feasible dual
candidate ``u`` of the norm-ball LAD dual.

Differences from the JAX package:

  - **float64 only.**  Inputs are upcast to float64 and ``X`` and ``res``
    come back in float64 on every device: the card computes f64 natively,
    so the JAX package's float32 "comp mode" (the compensated
    multi-candidate certificate and ``ops/df32.py``, which exist because the
    TPU has no f64) is not ported.  A float32 caller gets the f64 solve of
    its values.
  - **Batched members.**  ``z`` and ``y`` take leading batch axes, and
    ``band_lo`` may be a sequence of band starts, stacked on a new leading
    axis: every (band, batch) member runs its own Newton loop and keeps its
    carry once its worst row is at or below ``tol``, as under the JAX
    package's ``vmap`` of its ``while_loop`` (its ``lax.map`` over bands
    runs them one after another; the members are independent, so stacking
    them changes no member's result).  The loop tests every member after
    every Newton step, exactly the JAX condition
    ``it < iters and not (max(res) <= tol)``.
  - **Dispatches.**  Eager PyTorch runs one kernel per operation, so the
    step is written to need few: the d x d Cholesky and triangular solves
    stay d-unrolled elementwise operations (never ``torch.linalg`` on tiny
    batched matrices), but each operates on a column slice of every matrix
    at once, keeping the JAX package's order of operations within each
    entry; the two candidates share one ball step and one line search, and
    the 20 ladder candidates are one stacked tensor.  On the card the
    Newton step is captured once as a CUDA graph and replayed.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch

# Step ladder of the batched line search (t = 0 keeps the incumbent).
_LADDER = (1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64, 1 / 128,
           1 / 512, 0.0)
_MU_SHRINK = 0.125          # continuation factor per solved stage
_SECULAR_ITERS = 24         # More-Sorensen iterations per Newton step

_BOX_SWEEPS = 8
_BOX_STEPS = (1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 64, 1 / 256)
_LINF_DUAL_K = 12       # free rows in the linf dual coordinate polish
_LINF_DUAL_SWEEPS = 4
_LINF_TAUS = (1e-2, 1e-4, 1e-6)


@functools.lru_cache(maxsize=None)
def _constants(values, dtype, device) -> torch.Tensor:
    """A step-length table as a tensor on ``device``, made once (a copy
    from the host inside every Newton step would wait for the card)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _chol_unrolled(A: torch.Tensor, d: int):
    """Cholesky of (..., d, d) PSD matrices, d-unrolled: column i of L is
    computed from columns < i by elementwise operations on the (..., d - i)
    slices, each entry in the JAX package's order.  The pivot floor is
    relative to the matrix scale (a singular matrix gives large but finite
    solves).  Returns ``(diag, off)``: ``diag[i]`` is L[..., i, i:i + 1] and
    ``off[i]`` is L[..., i + 1:, i]."""
    floor = (torch.finfo(A.dtype).eps
             * torch.diagonal(A, dim1=-2, dim2=-1).amax(-1, keepdim=True)
             + 1e-30)
    cols = A.unbind(-1)
    diag, off = [], []
    for i in range(d):
        t = cols[i][..., i:]
        for k in range(i):
            t = t - off[k][..., i - k - 1:] * off[k][..., i - k - 1:i - k]
        diag.append(torch.sqrt(torch.maximum(t[..., :1], floor)))
        off.append(t[..., 1:] / diag[i])
    return diag, off


def _solve_lower(L, b: torch.Tensor, d: int):
    """L w = b for b (..., d), column by column; returns the columns of w,
    each (..., 1)."""
    diag, off = L
    w = []
    r = b
    for i in range(d):
        w.append(r[..., :1] / diag[i])
        if i + 1 < d:
            r = r[..., 1:] - off[i] * w[i]
    return w


def _solve_upper(L, w, d: int):
    """L^T v = w (w a list of (..., 1) columns), back substitution; returns
    v (..., d)."""
    diag, off = L
    v = [None] * d
    for i in reversed(range(d)):
        s = w[i]
        for k in range(i + 1, d):
            s = s - off[i][..., k - i - 1:k - i] * v[k]
        v[i] = s / diag[i]
    return torch.cat(v, dim=-1)


def _ball_newton_step(H: torch.Tensor, b: torch.Tensor, d: int):
    """Batched min_{||v||_2 <= 1} 0.5 v^T H v + b^T v with H PSD (..., d, d),
    b (..., d): the interior solution when it is feasible, else a
    safeguarded More-Sorensen secular Newton on h(lam) = 1/||v(lam)|| - 1
    from below, with a [lo, hi] bracket, a NaN-safe bracket test, geometric
    bisection on wide brackets and the floor lift of hi.  Returns
    ``(v, lam)``, v rescaled into the ball."""
    dtype = H.dtype
    bn = torch.linalg.vector_norm(b, dim=-1)
    eye = torch.eye(d, dtype=dtype, device=H.device)
    nb = -b

    def solve_at(lam):
        L = _chol_unrolled(H + lam[..., None, None] * eye, d)
        v = _solve_upper(L, _solve_lower(L, nb, d), d)
        q = _solve_lower(L, v, d)
        # ||q||^2 summed in index order, as the JAX package's sum() does.
        qn2 = q[0] * q[0]
        for qi in q[1:]:
            qn2 = qn2 + qi * qi
        return v, qn2[..., 0]

    v0, _ = solve_at(torch.zeros_like(bn))
    interior = torch.linalg.vector_norm(v0, dim=-1) <= 1.0
    trH = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    floor = (torch.finfo(dtype).eps ** 0.5) * (1.0 + trH / d + bn)
    lam, lo, hi, v = floor, torch.zeros_like(bn), torch.maximum(bn, floor), v0
    for _ in range(_SECULAR_ITERS):
        v, qn2 = solve_at(lam)
        n = torch.linalg.vector_norm(v, dim=-1)
        lo = torch.where(n > 1.0, torch.maximum(lo, lam), lo)
        hi = torch.where(n < 1.0, torch.minimum(hi, lam), hi)
        lam_n = lam + n * n * (n - 1.0) / torch.clamp(qn2, min=1e-30)
        lo_f = torch.maximum(lo, floor)
        mid = torch.where(hi > 100.0 * lo_f, torch.sqrt(lo_f * hi),
                          0.5 * (lo + hi))
        bad = ~((lam_n >= lo) & (lam_n <= hi))
        stall = (n > 1.25) & (lam_n < lo + 0.01 * (hi - lo))
        lam_n = torch.where(bad | stall, mid, lam_n)
        lam = torch.where(interior, lam, lam_n)
    v = torch.where(interior[..., None], v0, v)
    lam = torch.where(interior, torch.zeros_like(lam), lam)
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(vn, min=1.0), lam


def _box_newton_step(H: torch.Tensor, b: torch.Tensor, d: int):
    """Batched min_{||v||_inf <= 1} 0.5 v^T H v + b^T v by projected Newton
    with masked-identity reduced solves: each sweep takes the best of
    {stay, the projected Newton arc at seven step lengths, two
    projected-gradient steps} on the model, then one exact cyclic
    coordinate-descent pass.  Returns ``(v, 0)``."""
    dtype = H.dtype
    eye = torch.eye(d, dtype=dtype, device=H.device)
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    damp = torch.finfo(dtype).eps * (tr / d + 1.0) + 1e-30
    Hd = H + damp[..., None, None] * eye
    diag = torch.clamp(torch.diagonal(Hd, dim1=-2, dim2=-1), min=1e-30)
    steps = _constants(_BOX_STEPS, dtype, H.device).reshape(
        (-1,) + (1,) * b.ndim)

    def hv(u):
        return torch.matmul(Hd, u[..., None])[..., 0]

    v = torch.clamp(-b / diag, -1.0, 1.0)
    for _ in range(_BOX_SWEEPS):
        grad = hv(v) + b
        clamped = (((v >= 1.0 - 1e-12) & (grad < 0.0))
                   | ((v <= -1.0 + 1e-12) & (grad > 0.0)))
        Mf = (~clamped).to(dtype)
        MM = Mf[..., :, None] * Mf[..., None, :]
        L = _chol_unrolled(Hd * MM + (1.0 - MM) * eye, d)
        s = _solve_upper(L, _solve_lower(L, -(grad * Mf), d), d) * Mf
        s_pg = -grad / diag
        cands = torch.cat([
            v[None], torch.clamp(v + steps * s, -1.0, 1.0),
            torch.clamp(v + s_pg, -1.0, 1.0)[None],
            torch.clamp(v + 0.25 * s_pg, -1.0, 1.0)[None]])
        ms = 0.5 * (hv(cands) * cands).sum(-1) + (b * cands).sum(-1)
        best = torch.argmin(ms, dim=0)
        v = torch.take_along_dim(cands, best[None, ..., None], dim=0)[0]
        g = hv(v) + b
        cols = list(v.unbind(-1))
        for j in range(d):
            vj = torch.clamp(cols[j] - g[..., j] / diag[..., j], -1.0, 1.0)
            g = g + (vj - cols[j])[..., None] * Hd[..., :, j]
            cols[j] = vj
        v = torch.stack(cols, dim=-1)
    return v, torch.zeros_like(b[..., 0])


def _first_k_smallest(score: torch.Tensor, K: int) -> torch.Tensor:
    """Indices of the K smallest entries of the last axis, ties in index
    order: ``jax.lax.top_k(-score, K)``'s selection and order."""
    return torch.sort(score, dim=-1, stable=True).indices[..., :K]


def _dual_polish_linf(u, z, y, R, mask, X, d: int):
    """Repair the linf-ball LAD dual candidate, D(u) = -u^T y - ||Z^T u||_1
    over |u_i| <= 1/2, on the K smallest-|r| in-prefix rows: KKT
    least-squares inits at three kink thresholds, then exact coordinate
    sweeps from those inits and from the incoming candidate (the four
    starts stacked); the best final D wins per row, earliest start first on
    ties.  Every candidate is feasible, so the gap stays rigorous."""
    dtype = u.dtype
    T = z.shape[-2]
    K = min(_LINF_DUAL_K, T)
    mask = mask.expand_as(R)
    score = torch.where(mask > 0, torch.abs(R), torch.inf)
    idx = _first_k_smallest(score, K)                       # (..., rows, K)
    m_A = torch.gather(mask, -1, idx)
    rows = R.shape[-2]
    z_rows = z.unsqueeze(-3).expand(*R.shape[:-2], rows, T, d)
    Z_A = torch.gather(z_rows, -2, idx[..., None].expand(*idx.shape, d))
    y_A = torch.gather(y.unsqueeze(-2).expand_as(R), -1, idx) * m_A
    u_out = (0.5 * torch.sign(R) * mask).scatter(-1, idx, 0.0)
    q = torch.matmul(u_out, z)                              # (..., rows, d)

    r_A = torch.gather(R, -1, idx)
    u_pin = 0.5 * torch.sign(r_A) * m_A
    P = (torch.abs(X) < 1.0 - 1e-9).to(dtype)
    ZP = Z_A * P[..., None, :]
    G0 = torch.matmul(ZP, Z_A.transpose(-1, -2))           # (..., rows, K, K)
    eyeK = torch.eye(K, dtype=dtype, device=u.device)
    trG = torch.diagonal(G0, dim1=-2, dim2=-1).sum(-1)
    ridge = (1e-10 * (trG / K + 1.0))[..., None, None] * eyeK
    scale = torch.clamp(torch.abs(R).amax(-1, keepdim=True), min=1.0)

    # KKT inits, the three thresholds stacked on a leading axis.
    tau = _constants(_LINF_TAUS, dtype, u.device).reshape(
        (-1,) + (1,) * r_A.ndim)
    F = (torch.abs(r_A) <= tau * scale).to(dtype) * m_A
    q_eff = q + (((1.0 - F) * u_pin)[..., None] * Z_A).sum(-2)
    FF = F[..., :, None] * F[..., None, :]
    G = G0 * FF + (1.0 - FF) * eyeK + ridge
    rhs = -torch.matmul(ZP, q_eff[..., None])[..., 0] * F
    L = _chol_unrolled(G, K)
    uA = torch.clamp(_solve_upper(L, _solve_lower(L, rhs, K), K), -0.5, 0.5)
    inits = (F * uA + (1.0 - F) * u_pin) * m_A

    uA = torch.cat([(torch.gather(u, -1, idx) * m_A)[None], inits])
    safe = torch.abs(Z_A) > 1e-30
    den = torch.where(safe, Z_A, torch.ones_like(Z_A))
    half = torch.full_like(uA[..., :1], 0.5)
    for _ in range(_LINF_DUAL_SWEEPS):
        g = q + (uA[..., None] * Z_A).sum(-2)
        cols = list(uA.unbind(-1))
        for k in range(K):
            zk, yk = Z_A[..., k, :], y_A[..., k, None]
            gb = g - cols[k][..., None] * zk
            tj = torch.clamp(torch.where(safe[..., k, :], -gb / den[..., k, :],
                                         0.0), -0.5, 0.5)
            cands = torch.cat([-half, half, cols[k][..., None], tj], dim=-1)
            hs = -cands * yk - torch.abs(
                gb[..., None, :] + cands[..., None] * zk[..., None, :]).sum(-1)
            tn = torch.take_along_dim(
                cands, torch.argmax(hs, dim=-1, keepdim=True),
                dim=-1)[..., 0] * m_A[..., k]
            g = gb + tn[..., None] * zk
            cols[k] = tn
        uA = torch.stack(cols, dim=-1)

    uf = u_out.expand(uA.shape[0], *u_out.shape).scatter_add(
        -1, idx.expand(uA.shape), uA * m_A)
    D = (-(uf * (y[..., None, :] * mask)).sum(-1)
         - torch.abs(torch.matmul(uf, z)).sum(-1))
    best_D, best_u = D[0], uf[0]
    for s in range(1, uA.shape[0]):
        take = D[s] > best_D
        best_D = torch.where(take, D[s], best_D)
        best_u = torch.where(take[..., None], uf[s], best_u)
    return best_u


# On the card every Newton step is replayed from one CUDA graph, captured
# after a warm-up step: the same kernels on the same inputs, so the same
# bits as eager steps, at ~23 ms a step where the eager launches take
# ~43-52 ms at the pipeline's width (H100, PERF.md).  False runs the steps
# eagerly, to count their operations.
_CUDA_GRAPHS = True


def _graphed(fn, *args):
    """``fn`` captured as one CUDA graph on copies of ``args``, after a
    warm-up call on a side stream; the returned callable copies its
    arguments in, replays the graph and returns the graph's outputs (valid
    until the next replay)."""
    static = [a.clone() for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def replay(*new):
        for a, n in zip(static, new):
            a.copy_(n)
        graph.replay()
        return out
    return replay


def _band_mask(T: int, rows: int, lo, lead: int, device):
    """The (rows, T) prefix mask of a band starting at ``lo``, or with a
    leading band axis (and ``lead`` unit batch axes) for a sequence."""
    t = torch.arange(T, device=device)
    k = torch.arange(rows, device=device)
    if isinstance(lo, int):
        return t[None, :] <= (lo + k)[:, None]
    los = torch.as_tensor(list(lo), device=device)
    m = t[None, None, :] <= (los[:, None] + k[None, :])[..., None]
    return m.reshape(len(los), *([1] * lead), rows, T)


@torch.inference_mode()
def ssn_all_prefixes(
    z: torch.Tensor,
    y: torch.Tensor,
    *,
    iters: int = 80,
    tol: float = 2e-4,
    state0=None,
    band_lo: Union[None, int, Sequence[int]] = None,
    band_rows: Optional[int] = None,
    norm: str = "l2",
    counts: Optional[dict] = None,
):
    """Solve the norm-ball exact-FTL program for every prefix at once by
    Huber-continuation semismooth Newton (interface of
    ``models/exact_ftl.py::_admm_all_prefixes``).

    Args:
      z: ``(..., T, d)``; y: ``(..., T)``; leading axes are a batch, and
        both are upcast to float64.
      iters: the cap on Newton steps of each member.
      tol: a member stops once every one of its rows has ``res <= tol``.
      state0: ``(X, mu)`` of an earlier call (the iteration is Markov in
        it).
      band_lo / band_rows: solve only the prefix lengths ``band_lo + 1 ..
        band_lo + band_rows``; a sequence of ``band_lo`` solves those bands
        at once, on a new leading axis.
      norm: ``"l2"`` or ``"linf"``.
      counts: if given, ``counts["steps"]`` receives the Newton steps run.

    Returns:
      ``(X (..., rows, d), res (..., rows), (X, mu))``, float64; ``res`` is
      the normalized duality gap.
    """
    if norm not in ("l2", "linf"):
        raise NotImplementedError(
            f"ssn_all_prefixes: norm={norm!r} unsupported (l2/linf)")
    ball_step = _ball_newton_step if norm == "l2" else _box_newton_step
    dtype = torch.float64
    z = z.to(dtype)
    y = y.to(dtype)
    *lead, T, d = z.shape
    device = z.device
    if band_rows is None:
        rows, lo = T, 0
    else:
        rows = int(band_rows)
        lo = ([int(b) for b in band_lo]
              if isinstance(band_lo, (list, tuple)) else int(band_lo))
    mask = _band_mask(T, rows, lo, len(lead), device).to(dtype)
    shape = torch.broadcast_shapes(mask.shape[:-1], (*lead, rows))
    zT = z.transpose(-1, -2)
    yr = y[..., None, :]
    ym = yr * mask
    zz = (z[..., :, :, None] * z[..., None, :]).reshape(*lead, T, d * d)
    ladder = _constants(_LADDER, dtype, device).reshape(
        (1, -1) + (1,) * len(shape))
    mu_floor = 0.1 * tol

    def f_mu(R, mu):
        a = torch.abs(R)
        quad = a * a / (2.0 * mu)
        lin = a - 0.5 * mu
        return 0.5 * (torch.where(a <= mu, quad, lin) * mask).sum(-1)

    def newton(X, mu):
        # The Huber model at (X, mu).
        Q = torch.matmul(X, zT)                            # (..., rows, T)
        R = (Q - yr) * mask
        psi = torch.clamp(R / mu, -1.0, 1.0) * mask
        g = 0.5 * torch.matmul(psi, z)
        w_irls = mask / (2.0 * torch.maximum(torch.abs(R), mu))
        w_hub = ((torch.abs(R) <= mu).to(dtype) * mask) / (2.0 * mu)
        # Both model candidates in one ball step: the IRLS majorizer and
        # the Huber-zone Hessian, stacked on a leading axis.
        H = torch.matmul(torch.stack([w_irls, w_hub]), zz).reshape(
            2, *shape, d, d)
        v, _ = ball_step(H, g - torch.matmul(H, X[..., None])[..., 0], d)
        # Line search on the true Huber objective over both candidates'
        # ladders (v1's ten rungs, then v2's): predictions are affine in t.
        Qv = torch.matmul(v, zT)                           # (2, ..., rows, T)
        t = ladder[..., None]
        cand_Q = (1 - t) * Q + t * Qv[:, None]
        cand_f = f_mu((cand_Q - yr) * mask, mu).reshape(-1, *shape)
        best = torch.argmin(cand_f, dim=0)                 # (..., rows)
        cand_X = (X + t * (v[:, None] - X)).reshape(-1, *shape, d)
        X_new = torch.take_along_dim(cand_X, best[None, ..., None], dim=0)[0]
        Q_new = torch.take_along_dim(cand_Q.reshape(-1, *shape, T),
                                     best[None, ..., None], dim=0)[0]
        del cand_Q
        # The duality gap at the IRLS model's KKT dual candidate.
        R_new = (Q_new - yr) * mask
        f_new = 0.5 * (torch.abs(R_new) * mask).sum(-1)
        u = torch.clamp(w_irls * (Qv[0] - Q) + 0.5 * psi, -0.5, 0.5) * mask
        if norm == "l2":
            pen = torch.linalg.vector_norm(torch.matmul(u, z), dim=-1)
        else:
            u = _dual_polish_linf(u, z, y, R, mask, X_new, d)
            pen = torch.abs(torch.matmul(u, z)).sum(-1)
        D = -(u * ym).sum(-1) - pen
        gap = torch.minimum(f_new - D, f_new)
        res = torch.clamp(gap, min=0.0) / (1.0 + f_new)
        # Continuation: shrink mu once the step is stationary at mu-scale.
        solved = torch.abs(X_new - X).amax(-1) <= 0.1 * mu[..., 0]
        mu = torch.where(solved[..., None],
                         torch.clamp(mu * _MU_SHRINK, min=mu_floor), mu)
        return X_new, mu, res

    if state0 is None:
        X = z.new_zeros((*shape, d))
        mu0 = torch.clamp(torch.abs(y).amax(-1), min=1.0)
        mu = mu0.reshape(*lead, 1, 1).expand(*shape, 1).clone()
    else:
        X, mu = (a.to(dtype) for a in state0)
    res = z.new_full(shape, torch.inf)
    active = torch.full(shape[:-1], iters > 0, dtype=torch.bool,
                        device=device)
    step = newton
    if device.type == "cuda" and iters > 0 and _CUDA_GRAPHS:
        step = _graphed(newton, X, mu)
    steps = 0
    while steps < iters and bool(active.any()):
        X_n, mu_n, res_n = step(X, mu)
        keep = active[..., None, None]
        X = torch.where(keep, X_n, X)
        mu = torch.where(keep, mu_n, mu)
        res = torch.where(active[..., None], res_n, res)
        # NaN-safe: a NaN residual keeps its member iterating.
        active = active & ~(res.amax(-1) <= tol)
        steps += 1
    if counts is not None:
        counts["steps"] = counts.get("steps", 0) + steps
    return X, res, (X, mu)


def ssn_full(z, y, *, iters: int = 80, tol: float = 2e-4, state0=None,
             norm: str = "l2"):
    """Single full-sequence solve (the exact comparator), same method, on
    ``(..., T, d)`` / ``(..., T)``.  Returns ``(x (..., d), res (...),
    state)``."""
    X, res, state = _ssn_rows_full(z, y, iters=iters, tol=tol,
                                   state0=state0, norm=norm)
    return X[..., 0, :], res[..., 0], state


def _ssn_rows_full(z, y, *, iters, tol, state0, norm="l2"):
    # A one-row band covering only the final prefix.
    T = z.shape[-2]
    return ssn_all_prefixes(z, y, iters=iters, tol=tol, state0=state0,
                            band_lo=T - 1, band_rows=1, norm=norm)
