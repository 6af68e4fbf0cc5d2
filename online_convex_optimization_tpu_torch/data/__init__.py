"""Sequence generation: host-NumPy builders with the reference's PCG64 seed
schedules, and on-device generation on a ``torch.Generator`` (counterpart
of ``online_convex_optimization_tpu/data``)."""

from online_convex_optimization_tpu_torch.data.device import (
    random_game_batch,
    random_time_major_batch,
    regression_stream_batch,
    separable_stream_batch,
    shard_generators,
)
from online_convex_optimization_tpu_torch.data.rng import rng_stream, run_seed_schedule
from online_convex_optimization_tpu_torch.data.sequences import (
    CASES,
    RUNS_BY_TITLE,
    REPLICATES_BY_TITLE,
    flip_sequence,
    switching_two_leaders_sequence,
    make_random_iid_stream,
    make_noisy_iid_stream,
    make_flip_stream,
    make_switching_two_leaders_stream,
    make_regression_stream,
    sample_g_instance,
    sample_g_batch,
    stack_replicates,
)

__all__ = [
    "rng_stream",
    "run_seed_schedule",
    "CASES",
    "RUNS_BY_TITLE",
    "REPLICATES_BY_TITLE",
    "flip_sequence",
    "switching_two_leaders_sequence",
    "make_random_iid_stream",
    "make_noisy_iid_stream",
    "make_flip_stream",
    "make_switching_two_leaders_stream",
    "make_regression_stream",
    "sample_g_instance",
    "sample_g_batch",
    "stack_replicates",
    "random_game_batch",
    "random_time_major_batch",
    "regression_stream_batch",
    "separable_stream_batch",
    "shard_generators",
]
