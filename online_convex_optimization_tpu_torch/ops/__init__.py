"""Step math (hinge loss, tie-exact subgradient, FTL/FTRL actions, ball
projections) and the CUDA kernels with their plain PyTorch versions
(counterpart of ``online_convex_optimization_tpu/ops``): the hinge game
(K1-K6, with the packed API K3/K3e), the generation-fused game (K7) and
the quadratic track (K8, K9)."""

from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    ftrl_action_scaled,
    project_l1_ball,
    project_l2_ball,
    project_linf_ball,
)
from online_convex_optimization_tpu_torch.ops.game import (
    StreamCarry,
    eta_sweep,
    eta_sweep_reference,
    ftrl_scales,
    kernel_envelope,
    play_packed,
    play_packed_eta,
    play_packed_eta_reference,
    play_packed_reference,
    play_stream,
    play_stream_many,
    play_stream_reference,
    regrets_fused,
    regrets_fused_reference,
    regrets_packed,
    regrets_packed_eta,
    simulate_linear_auto,
    simulate_linear_packed,
    stream_result,
    synthetic_regrets,
    synthetic_regrets_reference,
    synthetic_stream,
    validate_stream_chunk,
    zero_stream_carry,
)
from online_convex_optimization_tpu_torch.ops.hinge import (
    hinge_subgradient,
    normalized_hinge,
)
from online_convex_optimization_tpu_torch.ops.smart import (
    smart_regrets,
    smart_regrets_reference,
    smart_sweep,
    smart_sweep_reference,
)
from online_convex_optimization_tpu_torch.ops.trs import (
    quadratic_regrets,
    quadratic_regrets_reference,
    trs_solve,
    trs_solve_reference,
)

__all__ = [
    "ftl_action",
    "ftrl_action",
    "ftrl_action_scaled",
    "project_l1_ball",
    "project_l2_ball",
    "project_linf_ball",
    "regrets_fused",
    "regrets_fused_reference",
    "eta_sweep",
    "eta_sweep_reference",
    "StreamCarry",
    "zero_stream_carry",
    "play_stream",
    "play_stream_many",
    "play_stream_reference",
    "stream_result",
    "validate_stream_chunk",
    "ftrl_scales",
    "play_packed",
    "play_packed_reference",
    "play_packed_eta",
    "play_packed_eta_reference",
    "regrets_packed",
    "regrets_packed_eta",
    "kernel_envelope",
    "simulate_linear_packed",
    "simulate_linear_auto",
    "synthetic_regrets",
    "synthetic_regrets_reference",
    "synthetic_stream",
    "hinge_subgradient",
    "normalized_hinge",
    "smart_regrets",
    "smart_regrets_reference",
    "smart_sweep",
    "smart_sweep_reference",
    "trs_solve",
    "trs_solve_reference",
    "quadratic_regrets",
    "quadratic_regrets_reference",
]
