"""Hyperparameter sweep front-ends (BASELINE.json config 2: "FTRL with L2
regularization, learning-rate sweep over 64 settings via vmap").

Counterpart of ``online_convex_optimization_tpu/models/sweep_api.py``
(``ftrl_eta_sweep``, ``smart_threshold_sweep``): the same signatures and
outputs, ``[b, e]`` the regret of sequence b at setting e.  A sweep is one
launch over the (sequence x setting) cross product that duplicates no data:
kernel K5 (``ops/game.py::eta_sweep``) and kernel K6
(``ops/smart.py::smart_sweep``) on a CUDA tensor, their plain versions on a
CPU tensor.  The JAX routing knobs ``use_kernel`` / ``interpret`` have no
counterpart: the tensor's device decides.
"""

from __future__ import annotations

from typing import Optional

import torch

from online_convex_optimization_tpu_torch.ops.game import (
    ALG_FTL,
    ALG_FTRL,
    compute_dtype,
    eta_sweep,
    regrets_fused,
    settings_grid,
)
from online_convex_optimization_tpu_torch.ops.smart import smart_sweep


def ftrl_eta_sweep(z, y, eta_grid, *, alg_flag: int = ALG_FTRL,
                   length: Optional[object] = None) -> torch.Tensor:
    """Regret of every (sequence, eta0) pair.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)`` (tensors, or arrays taken to the CPU);
        eta_grid: ``(E,)``.
      alg_flag: 0 = FTRL (kernel K5), 1 = FTL.  FTL does not use eta, so it
        runs kernel K1 once on the B sequences and repeats the result over
        the E columns, the value the JAX scan route returns.
      length: optional scalar or ``(B,)`` valid horizon.

    Returns:
      ``(B, E)`` regrets on z's device.
    """
    z, y = torch.as_tensor(z), torch.as_tensor(y)
    if alg_flag == ALG_FTRL:
        return eta_sweep(z, y, eta_grid, length)
    if alg_flag == ALG_FTL:
        E = settings_grid(eta_grid, compute_dtype(z), z.device,
                          "eta_grid").shape[0]
        cum, comp, _ = regrets_fused(z, y, ALG_FTL, 1.0, length)
        return (cum - comp)[:, None].repeat(1, E)
    raise ValueError(f"alg_flag must be 0 (FTRL) or 1 (FTL), got {alg_flag}")


def smart_threshold_sweep(z, y, thresh_grid, *, eta0: float,
                          length: Optional[object] = None) -> torch.Tensor:
    """Regret of every (sequence, theta_thresh) pair -> ``(B, G)`` (kernel
    K6; ``ops/smart.py::smart_sweep`` also returns the switch rounds)."""
    z, y = torch.as_tensor(z), torch.as_tensor(y)
    regret, _ = smart_sweep(z, y, thresh_grid, eta0, length)
    return regret
