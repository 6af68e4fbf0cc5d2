"""Parity oracles: the f64 golden restatement of the reference semantics
(counterpart of ``online_convex_optimization_tpu/testing``), and the
helpers that carry the JAX package's inputs and stream state into the port
(``from_jax``)."""

from online_convex_optimization_tpu_torch.testing.golden import (
    golden_empirical_thresholds,
    golden_simulate_alg,
    golden_simulate_smart,
)

__all__ = [
    "golden_simulate_alg",
    "golden_simulate_smart",
    "golden_empirical_thresholds",
]
