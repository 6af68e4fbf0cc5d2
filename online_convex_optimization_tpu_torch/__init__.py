"""PyTorch and CUDA port of the online convex optimization framework.

The counterpart of ``online_convex_optimization_tpu`` (JAX on a TPU), for
one NVIDIA H100: FTL, FTRL, single-switch SMART and empirical-g SMART
evaluated for cumulative regret across the reference's four sequence
families, plus the empirical g(T) curve; eta and SMART-threshold sweeps;
long-horizon streaming with checkpoint/resume; the packed game API
(``ops.simulate_linear_auto``); the quadratic-loss track (exact
least-squares FTL and FTRL, ``models.quadratic`` and
``experiments.quadratic_study``); the exact-FTL track (all-prefix ADMM with
kernel K10, active-set polish, certified and canonical closed forms,
``models.exact_ftl`` and the driver's ``--exact``).  It imports ``torch`` and never
``jax``; the JAX package stays the reference it is tested against.

- ``ops``        : step math and the hand-written CUDA kernels (``csrc/``)
                   with their plain PyTorch versions.
- ``models``     : simulators, the reference-compatible API, the sweeps,
                   the streamed games and the exact-FTL oracle.
- ``data``       : host-NumPy sequence families with the reference's PCG64
                   seed schedules, bitwise equal to the JAX package's, and
                   on-device generation.
- ``experiments``: config/CLI, g(T) estimation, per-case evaluation,
                   figures, the experiment driver, the quadratic study.
- ``utils``      : stats, logging, checkpointing, the CUDA build, the
                   device entry points default to (``cuda``).
- ``testing``    : f64 golden oracle and the helpers from the JAX package.
- ``examples``   : the sweep and streaming examples (``python -m``).
"""

from online_convex_optimization_tpu_torch.models.api import (
    empirical_worst_case_thresholds,
    simulate_alg,
    simulate_empirical_g_SMART,
    simulate_SMART,
    simulate_SMART_like,
)
from online_convex_optimization_tpu_torch.models.base import RunResult

__version__ = "0.1.0"

__all__ = [
    "simulate_alg",
    "simulate_SMART",
    "simulate_SMART_like",
    "simulate_empirical_g_SMART",
    "empirical_worst_case_thresholds",
    "RunResult",
    "__version__",
]
