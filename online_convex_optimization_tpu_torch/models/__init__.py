"""Algorithm simulators (counterpart of ``online_convex_optimization_tpu/models``):
FTRL/FTL and SMART, each one pass of a CUDA kernel on the card; the eta
and threshold sweeps; the streamed game for long horizons; the
quadratic-loss track (exact least-squares FTL and FTRL, one pass of
kernel K8); the exact-FTL oracle (all-prefix ADMM, certified closed form,
canonical selection, active-set polish)."""

from online_convex_optimization_tpu_torch.models.base import RunResult
from online_convex_optimization_tpu_torch.models.exact_ftl import (
    ExactFTL,
    compute_prefix_actions,
    replay_exact_ftl,
    run_ftl_exact,
    run_ftrl,
    simulate,
)
from online_convex_optimization_tpu_torch.models.linear import (
    ALG_FTL,
    ALG_FTRL,
    simulate_linear,
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.models.quadratic import (
    ball_ls_action,
    quadratic_comparator_loss,
    simulate_quadratic,
    simulate_quadratic_batch,
)
from online_convex_optimization_tpu_torch.models.smart import (
    SmartRunResult,
    simulate_smart,
    simulate_smart_batch,
)
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingGame,
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)

__all__ = [
    "RunResult",
    "SmartRunResult",
    "simulate_linear",
    "simulate_linear_batch",
    "simulate_smart",
    "simulate_smart_batch",
    "ALG_FTRL",
    "ALG_FTL",
    "ftrl_eta_sweep",
    "smart_threshold_sweep",
    "StreamingGame",
    "StreamingKernelGame",
    "ball_ls_action",
    "quadratic_comparator_loss",
    "simulate_quadratic",
    "simulate_quadratic_batch",
    "ExactFTL",
    "compute_prefix_actions",
    "replay_exact_ftl",
    "run_ftl_exact",
    "run_ftrl",
    "simulate",
]
