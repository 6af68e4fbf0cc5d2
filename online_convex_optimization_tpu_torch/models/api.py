"""Reference-compatible functional API (drop-in surface).

Counterpart of ``online_convex_optimization_tpu/models/api.py``:

  - ``simulate_alg(z, y, alg_flag, eta0)``           : algorithms.py:28-54
  - ``simulate_SMART_like(z, y, theta_thresh, eta0)`` : algorithms.py:65-120
  - ``simulate_SMART(z, y, *, eta0=sqrt(2))``         : algorithms.py:123-125
  - ``simulate_empirical_g_SMART(z, y, theta_emp)``   : algorithms.py:127-128
  - ``empirical_worst_case_thresholds(T_grid, ...)``  : algorithms.py:135-171

Each takes NumPy inputs (a ``(T, d)`` sequence or a ``(B, T, d)`` batch)
and a ``device``: ``"cuda"``, the default, runs the kernels (and raises
without a card), ``"cpu"`` the plain PyTorch versions.  Each computes in
float64, the reference's precision: unlike the
JAX package, whose precision follows its global x64 flag, the port has f64
on every device it runs on.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.sequences import sample_g_batch
from online_convex_optimization_tpu_torch.models.linear import simulate_linear_batch
from online_convex_optimization_tpu_torch.models.smart import simulate_smart_batch
from online_convex_optimization_tpu_torch.utils.devices import resolve_device


def _as_batch(z, y, device):
    device = resolve_device(device)
    z = torch.as_tensor(np.asarray(z, dtype=np.float64), device=device)
    y = torch.as_tensor(np.asarray(y, dtype=np.float64), device=device)
    if z.ndim == 2:
        return z[None], y[None], True
    return z, y, False


def _out(regret: torch.Tensor, single: bool):
    reg = regret.cpu().numpy()
    return float(reg[0]) if single else reg


def simulate_alg(z, y, alg_flag: int, eta0: float, *, device="cuda"):
    """Regret of FTRL (``alg_flag == 0``) / FTL (``alg_flag == 1``): a float
    for one ``(T, d)`` sequence, a ``(B,)`` array for a batch."""
    zb, yb, single = _as_batch(z, y, device)
    res = simulate_linear_batch(zb, yb, int(alg_flag), float(eta0))
    return _out(res.regret, single)


def simulate_SMART_like(z, y, theta_thresh: float, eta0: float, *,
                        device="cuda"):
    """Single-switch SMART: FTL until its regret lead reaches
    ``theta_thresh``, then an independent FTRL track."""
    zb, yb, single = _as_batch(z, y, device)
    res = simulate_smart_batch(zb, yb, float(theta_thresh), float(eta0))
    return _out(res.regret, single)


def simulate_SMART(z, y, *, eta0: float = math.sqrt(2), device="cuda"):
    """SMART with the theoretical threshold ``sqrt(2T)``."""
    T = np.asarray(z).shape[-2]
    return simulate_SMART_like(z, y, theta_thresh=math.sqrt(2 * T),
                               eta0=eta0, device=device)


def simulate_empirical_g_SMART(z, y, theta_emp: float, *,
                               eta0: float = math.sqrt(2), device="cuda"):
    """SMART with an empirically estimated threshold g(T)."""
    return simulate_SMART_like(z, y, theta_thresh=theta_emp, eta0=eta0,
                               device=device)


def empirical_worst_case_thresholds(
    T_grid,
    *,
    runs: int = 5,
    base_seed: int = 0,
    eta0: float = math.sqrt(2),
    d: int = 5,
    progress: bool = False,
    device="cuda",
) -> Dict[int, float]:
    """Empirical worst-case FTRL regret g(T) per horizon: ``runs`` instances
    with the reference's seed schedule, run as one batch, max regret with
    the reference's 0.0 floor (algorithms.py:151,166-169)."""
    iterator = np.asarray(T_grid)
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(iterator, desc="Estimating g(T) on random sequences")
        except ImportError:
            pass

    g_emp: Dict[int, float] = {}
    for T_val in iterator:
        T = int(T_val)
        z, y = sample_g_batch(base_seed, T, runs, d=d, dtype=np.float64)
        zb, yb, _ = _as_batch(z, y, device)
        res = simulate_linear_batch(zb, yb, 0, float(eta0))
        g_emp[T] = float(max(0.0, float(res.regret.max())))
    return g_emp
