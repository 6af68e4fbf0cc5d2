"""Quadratic-loss online game (BASELINE.json config 1: FTL on generated
quadratic losses).

Counterpart of ``online_convex_optimization_tpu/models/quadratic.py``:

    loss_t(x) = 0.5 * (<z_t, x> - y_t)^2,       ||x||_2 <= 1.

The prefix objective is ``0.5 x^T A_t x - b_t^T x + c_t / 2`` with running
statistics ``A_t = sum z z^T``, ``b_t = sum y z``, ``c_t = sum y^2``; the
exact FTL action is the ball-constrained least-squares (trust-region)
solution, and the comparator's loss needs no replay:
``0.5 (x^T A x - 2 b^T x + c)``.

On a CUDA tensor ``simulate_quadratic_batch`` is one launch of kernel K8
(``ops/trs.py::quadratic_regrets``), which plays FTL or FTRL per sequence
and returns the whole ``RunResult``; ``ball_ls_action`` is kernel K9
(``trs_solve``).  On a CPU tensor each runs its plain version.  The JAX
package's TPU path runs the FTL track in its fused kernel and the FTRL
track as a scan; its CPU/x64 path solves by bisection.  The port solves by
the TPU kernels' Newton on every device (``ops/trs.py`` says why), which
agrees with the JAX x64 bisection to ~1e-15 on full-rank prefixes.  On the
singular first rounds (t < d) the f64 answer's null-space part is rounding
noise amplified ~1e12 by the ridge floor, so the FTL losses there, and
with them the FTL cum, differ from the JAX package's by up to ~1e-5.
"""

from __future__ import annotations

import torch

from online_convex_optimization_tpu_torch.models.base import RunResult
from online_convex_optimization_tpu_torch.ops.actions import sum_last
from online_convex_optimization_tpu_torch.ops.game import ALG_FTL, ALG_FTRL
from online_convex_optimization_tpu_torch.ops.trs import (
    quadratic_regrets,
    trs_solve,
)
from online_convex_optimization_tpu_torch.utils.devices import resolve_device


def ball_ls_action(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``argmin_{||x|| <= 1} 0.5 x^T A x - b^T x`` for PSD ``A``
    ``(..., d, d)`` and ``b`` ``(..., d)``, batched; kernel K9 on a CUDA
    tensor, its plain version on a CPU tensor."""
    d = b.shape[-1]
    x = trs_solve(A.reshape(-1, d, d), b.reshape(-1, d))
    return x.reshape(b.shape)


def quadratic_comparator_loss(A, b, c, x):
    """``sum_i 0.5 (<z_i, x> - y_i)^2`` from the carried statistics (no
    replay): ``0.5 (x^T A x - 2 b^T x + c)``, with elementwise products and
    index-order sums (no TF32 matmul)."""
    xa = sum_last(A * x[..., None, :])
    return 0.5 * (sum_last(x * xa) - 2.0 * sum_last(b * x) + c)


def simulate_quadratic_batch(z: torch.Tensor, y: torch.Tensor, alg_flag,
                             eta0) -> RunResult:
    """Batched quadratic-loss regret evaluation.

    Args:
      z: ``(B, T, d)`` float32/float64; y: ``(B, T)``.
      alg_flag: 0 = FTRL (projected gradient leader), 1 = exact FTL; a
        scalar or ``(B,)``.
      eta0: FTRL step scale, a scalar or ``(B,)``.

    Returns:
      ``RunResult`` of ``(B,)`` tensors and ``x_last`` ``(B, d)``; the
      comparator is the exact full-sequence ball-constrained least-squares
      minimizer, scored from the statistics.
    """
    z_tm = z.permute(1, 2, 0).contiguous()
    y_tm = y.t().contiguous()
    cum, comp, _, x_last = quadratic_regrets(z_tm, y_tm, alg_flag, eta0)
    return RunResult(cum_loss=cum, regret=cum - comp, comp_loss=comp,
                     x_last=x_last.t())


def simulate_quadratic(z, y, *, alg: str = "ftl", eta0: float = 1.0,
                       device="cuda") -> RunResult:
    """Single-sequence front end (BASELINE config 1: one sequence,
    T = 10^4).  ``z`` ``(T, d)`` and ``y`` ``(T,)`` (NumPy or tensors) run
    in float64 on ``device``; ``alg`` is ``"ftl"`` (exact) or ``"ftrl"``.
    Returns Python floats and a NumPy ``x_last``."""
    if alg not in ("ftl", "ftrl"):
        raise ValueError("alg must be 'ftl' or 'ftrl'")
    device = resolve_device(device)
    zt = torch.as_tensor(z, dtype=torch.float64, device=device)
    yt = torch.as_tensor(y, dtype=torch.float64, device=device)
    res = simulate_quadratic_batch(zt[None], yt[None],
                                   ALG_FTL if alg == "ftl" else ALG_FTRL,
                                   eta0)
    return RunResult(cum_loss=float(res.cum_loss[0]),
                     regret=float(res.regret[0]),
                     comp_loss=float(res.comp_loss[0]),
                     x_last=res.x_last[0].cpu().numpy())
