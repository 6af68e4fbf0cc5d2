"""Step math (hinge loss, tie-exact subgradient, FTL/FTRL actions, ball
projections) and the CUDA kernels with their plain PyTorch versions
(counterpart of ``online_convex_optimization_tpu/ops``)."""

from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    project_l1_ball,
    project_l2_ball,
    project_linf_ball,
)
from online_convex_optimization_tpu_torch.ops.game import (
    StreamCarry,
    eta_sweep,
    eta_sweep_reference,
    play_stream,
    play_stream_many,
    play_stream_reference,
    regrets_fused,
    regrets_fused_reference,
    stream_result,
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

__all__ = [
    "ftl_action",
    "ftrl_action",
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
    "hinge_subgradient",
    "normalized_hinge",
    "smart_regrets",
    "smart_regrets_reference",
    "smart_sweep",
    "smart_sweep_reference",
]
