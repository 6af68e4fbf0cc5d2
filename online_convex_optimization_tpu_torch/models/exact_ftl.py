"""Exact follow-the-leader oracle.

Counterpart of ``online_convex_optimization_tpu/models/exact_ftl.py``
(reference exact_ftl.py): per prefix length p the exact FTL action solves

    minimize_{||x||_p <= 1}   0.5 * sum_{i < p} | <z_i, x> - y_i |

(l2, linf or l1 ball).  Every prefix is solved at once by a consensus ADMM
(residual copy ``s`` with a soft threshold, ball copy ``w`` with the
projection, over-relaxed) whose x-step reuses the Cholesky factors of the
cumulative Gram matrices, or, with ``method="ssn"`` (l2 and linf), by the
semismooth Newton of ``models/ssn.py``; a host active-set polish
(``models/polish.py``) then reaches ~1e-9 objective accuracy, and on
binary-label contract data the certified closed form
(``models/linear_regime.py``) replaces the solve.

The three XLA formulations of the JAX package are plain PyTorch here, on the
tensors' device: ``_admm_all_prefixes`` (with prefix banding),
``_admm_masked_warm`` and ``_admm_full``.  They take leading batch axes: a
batch member stops on its own residual, as under the JAX package's
``vmap`` of its ``while_loop``.  Their products run through
``torch.matmul``; in float32 on a card they must be IEEE products, so a
call raises when TF32 is enabled (``torch.backends.cuda.matmul.allow_tf32``
or a float32 matmul precision other than ``"highest"``), the card's form of
the TPU's bf16-truncated default (``_HI`` in the JAX module).  The
iterate-precision option ``"high"`` (bf16x3 MXU passes on the TPU) has no
IEEE counterpart on the card and raises.  The semismooth Newton solves in
float64 on every device, as the JAX package does off the TPU; its TPU-only
float32 certificate and host pinning of f64 solves are not carried over:
the card computes f64.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from online_convex_optimization_tpu_torch.models.base import RunResult
from online_convex_optimization_tpu_torch.models.linear import simulate_linear
from online_convex_optimization_tpu_torch.models.linear_regime import (
    certified_full_solution,
    certified_prefix_actions,
)
from online_convex_optimization_tpu_torch.models.polish import (
    polish_prefix_actions,
    polish_solution,
)
from online_convex_optimization_tpu_torch.models.ssn import (
    ssn_all_prefixes,
    ssn_full,
)
from online_convex_optimization_tpu_torch.ops.actions import (
    project_l1_ball,
    project_l2_ball,
    project_linf_ball,
    sum_last,
)
from online_convex_optimization_tpu_torch.ops.hinge import normalized_hinge
from online_convex_optimization_tpu_torch.utils.devices import resolve_device

Norm = Literal["l2", "linf", "l1"]

_PROJECT = {
    "l2": project_l2_ball,
    "linf": project_linf_ball,
    "l1": project_l1_ball,
}


def check_precision(precision: str) -> None:
    """Accept the iterate precision ``"highest"`` (IEEE products) only."""
    if precision == "highest":
        return
    if precision == "high":
        raise ValueError(
            "iterate precision 'high' is the TPU's bf16x3 MXU mode, which "
            "has no IEEE counterpart on the card (TF32 keeps ~3 digits and "
            "stalls the ADMM, as bf16 dots did on the TPU); use 'highest'")
    raise ValueError(f"unknown precision {precision!r}")


def check_ieee_matmul(t: torch.Tensor) -> None:
    """Raise if a float32 product on ``t``'s device would run in TF32."""
    if t.device.type == "cuda" and t.dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the exact-FTL ADMM needs IEEE float32 products: disable TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest'))")


def _soft_threshold(v: torch.Tensor, kappa: float) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(torch.abs(v) - kappa, min=0.0)


def _run_blocks(body, residual, state, *, iters: int, tol: float,
                check_every: int, lead: int):
    """Run ``body`` on ``state`` ``iters`` times (``tol == 0``), or in blocks
    of ``check_every`` until every batch member's worst residual is not
    above ``tol`` (at most ``ceil(iters / check_every)`` blocks).  A member
    that stopped keeps its state, as under ``vmap`` of the JAX
    ``while_loop``; a NaN residual stops its member.  ``residual(state)``
    has the ``lead`` batch axes first."""
    if tol <= 0.0:
        for _ in range(iters):
            state = body(state)
        return state
    active = None
    for _ in range(-(-iters // check_every)):
        start = state
        for _ in range(check_every):
            state = body(state)
        if active is not None:
            state = tuple(
                torch.where(active.reshape(active.shape + (1,) * (
                    a.ndim - lead)), a, b) for a, b in zip(state, start))
        res = residual(state)
        worst = res.reshape(res.shape[:lead] + (-1,)).amax(dim=-1)
        now = worst > tol
        active = now if active is None else active & now
        if not bool(active.any()):
            break
    return state


def _admm_all_prefixes(z: torch.Tensor, y: torch.Tensor, *,
                       norm: Norm = "l2", iters: int = 600, rho: float = 1.0,
                       alpha: float = 1.7, tol: float = 0.0,
                       check_every: int = 100, precision: str = "highest",
                       state0=None, band_lo: Optional[int] = None,
                       band_rows: Optional[int] = None):
    """Solve the exact-FTL program for every prefix length at once.

    Args:
      z: ``(..., T, d)``; y: ``(..., T)``; leading axes are a batch.
      tol: when > 0, stop a batch member once every one of its prefixes
        has a residual <= tol (checked every ``check_every`` iterations);
        ``iters`` stays the cap.
      state0: the state of an earlier call on the same data (continuation).
      band_lo / band_rows: solve only the ``band_rows`` prefix lengths
        ``band_lo + 1 .. band_lo + band_rows``.

    Returns:
      ``(X, res, state)``: X ``(..., rows, d)`` (row k minimizes the
      length-``(band_lo + k + 1)`` prefix), res ``(..., rows)``, state
      ``(X, S, U, W, V)``.
    """
    check_precision(precision)
    check_ieee_matmul(z)
    *lead, T, d = z.shape
    dtype, device = z.dtype, z.device
    project = _PROJECT[norm]
    rows, lo = (T, 0) if band_rows is None else (int(band_rows),
                                                   int(band_lo))
    mask = (torch.arange(T, device=device)[None, :]
            <= (lo + torch.arange(rows, device=device))[:, None]).to(dtype)
    outers = z[..., :, :, None] * z[..., :, None, :]            # (..., T, d, d)
    gram = torch.cumsum(outers, dim=-3)[..., lo:lo + rows, :, :]
    chol = torch.linalg.cholesky(gram + torch.eye(d, dtype=dtype,
                                                  device=device))
    kappa = 0.5 / rho
    zt = z.transpose(-1, -2)
    yr = y[..., None, :]

    def body(state):
        X, S, U, W, V = state
        rhs = torch.matmul(mask * ((yr + S) - U), z) + (W - V)
        X = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        R = mask * (torch.matmul(X, zt) - yr)
        R_hat = alpha * R + (1.0 - alpha) * S
        S = _soft_threshold(R_hat + U, kappa) * mask
        U = ((U + R_hat) - S) * mask
        X_hat = alpha * X + (1.0 - alpha) * W
        W = project(X_hat + V)
        V = (V + X_hat) - W
        return (X, S, U, W, V)

    def residuals(state):
        X, S, _, W, _ = state
        R = mask * (torch.matmul(X, zt) - yr)
        pri = torch.amax(torch.abs(R - S), dim=-1)
        cons = torch.amax(torch.abs(X - W), dim=-1)
        return torch.maximum(pri, cons)                          # (..., rows)

    if state0 is None:
        zeros_T = z.new_zeros((*lead, rows, T))
        zeros_d = z.new_zeros((*lead, rows, d))
        state = (zeros_d, zeros_T, zeros_T, zeros_d, zeros_d)
    else:
        state = tuple(state0)
    state = _run_blocks(body, residuals, state, iters=iters, tol=tol,
                        check_every=check_every, lead=len(lead))
    return state[3], residuals(state), state


def _admm_masked_warm(z, y, m, state, *, norm: Norm = "l2", iters: int = 80,
                      rho: float = 1.0, alpha: float = 1.7,
                      precision: str = "highest"):
    """Warm-startable single solve over the masked prefix ``m`` (0/1,
    ``(T_max,)``): ``state = (x (d,), s (T_max,), u (T_max,), w (d,),
    v (d,))`` carried across appends.  Returns ``(state, residual)``."""
    check_precision(precision)
    check_ieee_matmul(z)
    d = z.shape[1]
    project = _PROJECT[norm]
    zm = m[:, None] * z
    A = torch.matmul(zm.T, z) + torch.eye(d, dtype=z.dtype, device=z.device)
    chol = torch.linalg.cholesky(A)
    kappa = 0.5 / rho
    x, s, u, w, v = state
    for _ in range(iters):
        rhs = torch.matmul(zm.T, (y + s) - u) + (w - v)
        x = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
        r = m * (torch.matmul(z, x) - y)
        r_hat = alpha * r + (1.0 - alpha) * s
        s = _soft_threshold(r_hat + u, kappa) * m
        u = ((u + r_hat) - s) * m
        x_hat = alpha * x + (1.0 - alpha) * w
        w = project((x_hat + v)[None, :])[0]
        v = (v + x_hat) - w
    r = m * (torch.matmul(z, x) - y)
    res = torch.maximum(torch.amax(torch.abs(r - s)),
                        torch.amax(torch.abs(x - w)))
    return (x, s, u, w, v), res


def _admm_full(z, y, *, norm: Norm = "l2", iters: int = 600,
               rho: float = 1.0, alpha: float = 1.7, tol: float = 0.0,
               check_every: int = 100, precision: str = "highest",
               state0=None):
    """Full-sequence solve (the comparator oracle), same splitting, on
    ``(..., T, d)`` / ``(..., T)`` with leading batch axes.  Returns
    ``(x (..., d), residual (...), state)``."""
    check_precision(precision)
    check_ieee_matmul(z)
    *lead, T, d = z.shape
    project = _PROJECT[norm]
    zt = z.transpose(-1, -2)
    A = torch.matmul(zt, z) + torch.eye(d, dtype=z.dtype, device=z.device)
    chol = torch.linalg.cholesky(A)
    kappa = 0.5 / rho

    def body(state):
        x, s, u, w, v = state
        rhs = torch.matmul(zt, ((y + s) - u)[..., None])[..., 0] + (w - v)
        x = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        r = torch.matmul(z, x[..., None])[..., 0] - y
        r_hat = alpha * r + (1.0 - alpha) * s
        s = _soft_threshold(r_hat + u, kappa)
        u = (u + r_hat) - s
        x_hat = alpha * x + (1.0 - alpha) * w
        w = project(x_hat + v)
        v = (v + x_hat) - w
        return (x, s, u, w, v)

    def residual(state):
        x, s, _, w, _ = state
        r = torch.matmul(z, x[..., None])[..., 0] - y
        return torch.maximum(torch.amax(torch.abs(r - s), dim=-1),
                             torch.amax(torch.abs(x - w), dim=-1))

    if state0 is None:
        zd = z.new_zeros((*lead, d))
        zT = z.new_zeros((*lead, T))
        state = (zd, zT, zT, zd, zd)
    else:
        state = tuple(state0)
    state = _run_blocks(body, residual, state, iters=iters, tol=tol,
                        check_every=check_every, lead=len(lead))
    return state[3], residual(state), state


@dataclasses.dataclass
class ExactFTL:
    """Build-once/solve-many exact-FTL oracle (reference ExactFTLNoClip,
    exact_ftl.py:62-193), solving every prefix in one batched program on
    ``device``.

    The reference's incremental surface (``reset_buffers`` /
    ``append_row`` / ``solve_prefix`` / ``solve_prefix_from_full``) is
    kept, ``append_row`` warm-started from the previous prefix's state
    (``warm_iters``).  Solutions are active-set-polished (``polish``);
    residuals above ``fail_tol`` raise ``RuntimeError`` or, with
    ``on_fail='sentinel'``, become NaN.  ``last_info`` holds the residual
    telemetry of the latest solve.  ``allow_linear`` tries the certified
    closed form first.  ``method='ssn'`` (l2, linf) solves the general
    path by semismooth Newton in float64, with a cap of at least 2000
    Newton steps and a gap tolerance of at least 1e-6.
    """

    d: int
    T_max: int
    norm: Norm = "l2"
    iters: int = 600
    rho: float = 1.0
    alpha: float = 1.7
    warm_iters: int = 80
    polish: bool = True
    fail_tol: float = 1e-3
    on_fail: str = "raise"  # or "sentinel"
    stop_tol: float = 1e-5  # residual-based early exit; iters stays the cap
    iter_precision: str = "highest"
    allow_linear: bool = True
    method: str = "admm"
    device: str = "cuda"

    def __post_init__(self):
        if self.method not in ("admm", "ssn"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.method == "ssn" and self.norm not in ("l2", "linf"):
            raise ValueError("method='ssn' supports norm in {'l2','linf'}")
        check_precision(self.iter_precision)
        self._device = resolve_device(self.device)
        self._z_buf = np.zeros((self.T_max, self.d))
        self._y_buf = np.zeros(self.T_max)
        self._length = 0
        self._state = None  # warm-start ADMM state for append_row
        # Prefix length the state was solved at: certified early returns
        # advance _length without the state, and a stale state takes the
        # full iteration budget.
        self._state_length = 0
        self.last_info: dict = {}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self._device)

    def _band_solve(self, z, y, lo, rows, state0=None, iters=None):
        """General-path all-prefix band solve via the configured method."""
        iters = self.iters if iters is None else iters
        if self.method == "ssn":
            # Newton steps: slow-tail rows need ~1e3; converged members
            # stop early, so the generous cap costs nothing.
            return ssn_all_prefixes(
                z, y, iters=max(iters, 2000), tol=max(self.stop_tol, 1e-6),
                state0=state0, band_lo=lo, band_rows=rows, norm=self.norm)
        return _admm_all_prefixes(
            z, y, norm=self.norm, iters=iters, rho=self.rho,
            alpha=self.alpha, tol=self.stop_tol,
            precision=self.iter_precision, state0=state0,
            band_lo=lo, band_rows=rows)

    def _full_solve(self, z, y, state0=None, iters=None):
        """General-path full-sequence solve via the configured method."""
        iters = self.iters if iters is None else iters
        if self.method == "ssn":
            return ssn_full(z, y, iters=max(iters, 2000),
                            tol=max(self.stop_tol, 1e-6), state0=state0,
                            norm=self.norm)
        return _admm_full(z, y, norm=self.norm, iters=iters, rho=self.rho,
                          alpha=self.alpha, tol=self.stop_tol,
                          precision=self.iter_precision, state0=state0)

    def reset_buffers(self) -> None:
        """Clear cached rows for a new sequence (exact_ftl.py:130-138)."""
        self._z_buf[:] = 0.0
        self._y_buf[:] = 0.0
        self._length = 0
        self._state = None
        self._state_length = 0

    def _zero_state(self):
        zd = torch.zeros((self.d,), dtype=torch.float64, device=self._device)
        zT = torch.zeros((self.T_max,), dtype=torch.float64,
                         device=self._device)
        return (zd, zT, zT, zd, zd)

    def _handle_failure(self, res: float, where: str):
        # <=-negation so a NaN residual counts as a failure.
        self.last_info["converged"] = res <= self.fail_tol
        if not (res <= self.fail_tol):
            if self.on_fail == "raise":
                raise RuntimeError(
                    f"exact-FTL ADMM failed to converge in {where}: "
                    f"residual {res:.3e} > fail_tol {self.fail_tol:.1e}")
            return False
        return True

    def append_row(self, z_row: np.ndarray, y_val: float) -> np.ndarray:
        """Append one example and return the new prefix minimizer
        (exact_ftl.py:140-149), warm-started from the previous prefix."""
        if self._length >= self.T_max:
            raise ValueError("sequence longer than T_max")
        self._z_buf[self._length] = z_row
        self._y_buf[self._length] = y_val
        self._length += 1
        if self.allow_linear:
            x_lin = certified_full_solution(
                self._z_buf[:self._length], self._y_buf[:self._length],
                self.norm)
            if x_lin is not None:
                self.last_info = {"residual": 0.0, "iters": 0,
                                  "length": self._length, "converged": True,
                                  "solver": "certified-linear"}
                return x_lin
        if self._state is None:
            self._state = self._zero_state()
        m = np.zeros(self.T_max)
        m[:self._length] = 1.0
        # The warm budget assumes the state is exactly one row behind; a
        # stale state (after a certified streak) takes the full budget.
        fresh = self._state_length == self._length - 1
        iters = (self.warm_iters if fresh and self._length > 1
                 else self.iters)
        zt, yt, mt = (self._tensor(a) for a in (self._z_buf, self._y_buf, m))
        state, res = _admm_masked_warm(
            zt, yt, mt, self._state, norm=self.norm, iters=iters,
            rho=self.rho, alpha=self.alpha, precision=self.iter_precision)
        res_f = float(res)
        if res_f > self.fail_tol and iters < self.iters:
            # Escalate a hard prefix to a full-length refinement once.
            state, res = _admm_masked_warm(
                zt, yt, mt, state, norm=self.norm, iters=self.iters,
                rho=self.rho, alpha=self.alpha,
                precision=self.iter_precision)
            res_f = float(res)
        self._state = state
        self._state_length = self._length
        self.last_info = {"residual": res_f, "iters": iters,
                          "length": self._length}
        x = state[3].cpu().numpy().astype(np.float64)
        if not self._handle_failure(res_f, "append_row"):
            return np.full(self.d, np.nan)
        if self.polish:
            x = polish_solution(self._z_buf[:self._length],
                                self._y_buf[:self._length], x, self.norm)
        return x

    def solve_prefix_from_full(self, z_full, y_full, length: int) -> np.ndarray:
        """Minimizer over the first ``length`` rows (exact_ftl.py:171-181)."""
        if length < 0 or length > self.T_max:
            raise ValueError("length must be between 0 and T_max inclusive")
        z = np.asarray(z_full)[:length]
        y = np.asarray(y_full)[:length]
        self._z_buf[:length] = z
        self._y_buf[:length] = y
        self._length = length
        if length == 0:
            return np.zeros(self.d)
        return self.solve_full(z, y)

    def solve_prefix(self, z_prefix, y_prefix) -> np.ndarray:
        """Solve for explicitly supplied prefix arrays (exact_ftl.py:183-193)."""
        z = np.asarray(z_prefix)
        t, d = z.shape
        if d != self.d:
            raise ValueError(f"Expected {self.d}-dimensional data, got {d}")
        if t > self.T_max:
            raise ValueError("prefix longer than T_max")
        return self.solve_prefix_from_full(z, y_prefix, t)

    def prefix_actions(self, z: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Exact FTL actions for every prefix 0..T; row 0 is the zero vector
        (exact_ftl.py:294-297).  Active-set-polished; residual-checked."""
        # The polish builds its systems from the caller's full-precision
        # data, whatever precision the device solve ran in.
        z_host = np.asarray(z, np.float64)
        y_host = np.asarray(y, np.float64)
        T, d = z_host.shape
        if d != self.d:
            raise ValueError(f"expected d={self.d}, got {d}")
        if T > self.T_max:
            raise ValueError("sequence longer than T_max")
        if self.allow_linear:
            acts = certified_prefix_actions(z_host, y_host, self.norm)
            if acts is not None:
                self.last_info = {"residual": 0.0, "n_unconverged": 0,
                                  "converged": True,
                                  "solver": "certified-linear"}
                return acts
        zt, yt = self._tensor(z), self._tensor(y)
        # Banding (T >= 512): independent prefix rows in 256-row bands,
        # each exiting at its own convergence; a hard band continues from
        # its state with twice the budget before failing.
        if T >= 512:
            rows = 256
            los = sorted({min(b * rows, T - rows)
                          for b in range(-(-T // rows))})
        else:
            rows, los = None, [None]
        X = np.empty((T, d))
        res = np.empty(T)
        for lo in los:
            Xb, rb, st = self._band_solve(zt, yt, lo, rows)
            rb_host = rb.cpu().numpy()
            # NaN-safe direction: a NaN residual counts as unconverged.
            if rb_host.size and not float(rb_host.max()) <= self.fail_tol:
                Xb, rb, st = self._band_solve(zt, yt, lo, rows, state0=st,
                                              iters=2 * self.iters)
            nb = Xb.shape[0]
            start = 0 if lo is None else lo
            X[start:start + nb] = Xb.cpu().numpy()
            res[start:start + nb] = rb.cpu().numpy()
        worst = float(res.max()) if res.size else 0.0
        self.last_info = {"residual": worst,
                          "n_unconverged": int((res > self.fail_tol).sum())}
        ok = self._handle_failure(worst, "prefix_actions")
        if not ok:  # sentinel mode: NaN out only the unconverged prefixes
            X[res > self.fail_tol] = np.nan
        actions = np.concatenate([np.zeros((1, d)), X])
        if self.polish:
            good = np.flatnonzero(~np.isnan(X).any(axis=1)) + 1
            actions = polish_prefix_actions(z_host, y_host,
                                            actions, self.norm, lengths=good)
        return actions

    def solve_full(self, z: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Minimizer over the whole sequence (the exact comparator)."""
        if self.allow_linear:
            x_lin = certified_full_solution(np.asarray(z, np.float64),
                                            np.asarray(y, np.float64),
                                            self.norm)
            if x_lin is not None:
                self.last_info = {"residual": 0.0, "converged": True,
                                  "solver": "certified-linear"}
                return x_lin
        zt, yt = self._tensor(z), self._tensor(y)
        x, res, state = self._full_solve(zt, yt)
        res_f = float(res)
        if res_f > self.fail_tol:
            x, res, state = self._full_solve(zt, yt, state0=state,
                                             iters=2 * self.iters)
            res_f = float(res)
        self.last_info = {"residual": res_f}
        x = x.cpu().numpy().astype(np.float64)
        if not self._handle_failure(res_f, "solve_full"):
            return np.full(self.d, np.nan)
        if self.polish:
            x = polish_solution(np.asarray(z), np.asarray(y), x, self.norm)
        return x


# ------------------------------------------------------------------
# Reference-compatible front ends (exact_ftl.py:280-453)
# ------------------------------------------------------------------

def compute_prefix_actions(solver: ExactFTL, z, y) -> np.ndarray:
    return solver.prefix_actions(z, y)


def replay_exact_ftl(z, y, actions, *, device="cuda") -> RunResult:
    """Score a precomputed action trajectory (exact_ftl.py:306-333) on
    ``device``; the fields are Python floats and ``x_last`` a NumPy
    array, as in the JAX package."""
    dev = resolve_device(device)
    z = torch.as_tensor(np.asarray(z), device=dev)
    y = torch.as_tensor(np.asarray(y), device=dev)
    actions = torch.as_tensor(np.asarray(actions), dtype=z.dtype, device=dev)
    T, d = z.shape
    if actions.shape != (T + 1, d):
        raise ValueError("actions must have shape (T+1, d)")
    q = sum_last(z * actions[:T])
    cum_loss = float(normalized_hinge(q, y).sum())
    q_c = sum_last(z * actions[T])
    comp_loss = float(normalized_hinge(q_c, y).sum())
    return RunResult(cum_loss=cum_loss, regret=cum_loss - comp_loss,
                     comp_loss=comp_loss,
                     x_last=actions[T].cpu().numpy())


def run_ftl_exact(z, y, *, norm: Norm = "l2",
                  solver: Optional[ExactFTL] = None,
                  prefix_actions: Optional[np.ndarray] = None,
                  return_actions: bool = False, iters: int = 600,
                  device="cuda"):
    """Exact-FTL run (exact_ftl.py:423-453)."""
    z = np.asarray(z)
    y = np.asarray(y)
    T, d = z.shape
    if solver is None:
        solver = ExactFTL(d=d, T_max=T, norm=norm, iters=iters,
                          device=device)
    actions = prefix_actions if prefix_actions is not None \
        else solver.prefix_actions(z, y)
    result = replay_exact_ftl(z, y, actions, device=device)
    if return_actions:
        return result, actions
    return result


def run_ftrl(z, y, *, eta0: float = 1.0, norm: Norm = "l2",
             comparator_action: Optional[np.ndarray] = None,
             comparator_solver: Optional[ExactFTL] = None,
             iters: int = 600, device="cuda") -> RunResult:
    """FTRL with the exact comparator (exact_ftl.py:230-277, 399-420): the
    online loop is ``simulate_linear`` (K1 on a card); only the comparator
    differs (the exact minimizer, not the final FTL action)."""
    dev = resolve_device(device)
    z_arr = torch.as_tensor(np.asarray(z), device=dev)
    y_arr = torch.as_tensor(np.asarray(y), device=dev)
    T, d = z_arr.shape
    base = simulate_linear(z_arr, y_arr, 0, eta0)
    if comparator_action is None:
        solver = comparator_solver
        if solver is None:
            solver = ExactFTL(d=d, T_max=T, norm=norm, iters=iters,
                              device=device)
        comp_vec = solver.solve_full(np.asarray(z), np.asarray(y))
    else:
        comp_vec = np.asarray(comparator_action)
    q_c = sum_last(z_arr * torch.as_tensor(comp_vec, dtype=z_arr.dtype,
                                           device=dev))
    comp_loss = float(normalized_hinge(q_c, y_arr).sum())
    cum_loss = float(base.cum_loss)
    return RunResult(cum_loss=cum_loss, regret=cum_loss - comp_loss,
                     comp_loss=comp_loss, x_last=base.x_last.cpu().numpy())


def simulate(z, y, *, algo: Literal["ftrl", "ftl_exact"] = "ftl_exact",
             eta0: float = 1.0, norm: Norm = "l2",
             ftl_solver: Optional[ExactFTL] = None,
             comparator_solver: Optional[ExactFTL] = None,
             prefix_actions: Optional[np.ndarray] = None,
             comparator_action: Optional[np.ndarray] = None,
             device="cuda") -> RunResult:
    """Unified front end dispatching on ``algo`` (exact_ftl.py:336-392)."""
    if algo == "ftl_exact":
        return run_ftl_exact(z, y, norm=norm, solver=ftl_solver,
                             prefix_actions=prefix_actions, device=device)
    if algo == "ftrl":
        return run_ftrl(z, y, eta0=eta0, norm=norm,
                        comparator_action=comparator_action,
                        comparator_solver=comparator_solver, device=device)
    raise ValueError("algo must be either 'ftrl' or 'ftl_exact'")
