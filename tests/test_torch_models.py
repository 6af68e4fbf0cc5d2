"""The port's simulators and reference API against the JAX package (x64).

``simulate_linear``/``simulate_linear_batch``, ``simulate_smart``/
``simulate_smart_batch`` and the ``models/api.py`` surface, on the same
NumPy inputs as the JAX package's counterparts, bound 1e-9; the
deterministic ``z = e1`` families at T in {200, 800} (integer thresholds
sqrt(2T) = 20 and 40: exact ties) against the golden oracle, SMART included.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import online_convex_optimization_tpu as jax_oco
import online_convex_optimization_tpu_torch as pt_oco
from online_convex_optimization_tpu.models.linear import (
    simulate_linear as jax_linear,
    simulate_linear_batch as jax_linear_batch,
)
from online_convex_optimization_tpu.models.smart import (
    simulate_smart as jax_smart,
    simulate_smart_batch as jax_smart_batch,
)
from online_convex_optimization_tpu.testing import golden as jax_golden
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.models import (
    RunResult,
    SmartRunResult,
    simulate_linear,
    simulate_linear_batch,
    simulate_smart,
    simulate_smart_batch,
)
from online_convex_optimization_tpu_torch.testing import golden as pt_golden
from online_convex_optimization_tpu_torch.testing.from_jax import to_torch

torch.set_num_threads(1)

TOL = 1e-9
ETA = math.sqrt(2.0)


def _batch(B=48, T=60, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return z, y, rng.integers(1, T + 1, size=B)


def _close_fields(got, want, names):
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)


def test_simulate_linear_batch_and_single_match_jax():
    z, y, lengths = _batch()
    flags = np.arange(48) % 2
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    got = simulate_linear_batch(zt, yt, flags, 1.2, lengths)
    assert isinstance(got, RunResult)
    want = jax_linear_batch(jnp.asarray(z), jnp.asarray(y), jnp.asarray(flags),
                            1.2, jnp.asarray(lengths))
    _close_fields(got, want, ("cum_loss", "regret", "comp_loss", "x_last"))
    one = simulate_linear(zt[3], yt[3], 1, 1.2, int(lengths[3]))
    want_one = jax_linear(jnp.asarray(z[3]), jnp.asarray(y[3]), 1, 1.2,
                          int(lengths[3]))
    _close_fields(one, want_one, ("cum_loss", "regret", "comp_loss", "x_last"))


def test_simulate_smart_batch_and_single_match_jax():
    z, y, lengths = _batch(seed=1)
    thresh = np.where(np.arange(48) % 2 == 0, 1.5, 3.0)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    got = simulate_smart_batch(zt, yt, thresh, ETA, lengths)
    assert isinstance(got, SmartRunResult)
    want = jax_smart_batch(jnp.asarray(z), jnp.asarray(y), jnp.asarray(thresh),
                           ETA, jnp.asarray(lengths))
    _close_fields(got, want, ("cum_loss", "regret", "comp_loss", "x_last"))
    np.testing.assert_array_equal(got.switch_t.numpy(),
                                  np.asarray(want.switch_t))
    one = simulate_smart(zt[0], yt[0], 2.0, ETA)
    want_one = jax_smart(jnp.asarray(z[0]), jnp.asarray(y[0]), 2.0, ETA)
    _close_fields(one, want_one, ("cum_loss", "regret", "comp_loss", "x_last"))
    assert int(one.switch_t) == int(want_one.switch_t)


def test_api_matches_jax_api():
    sampler_args = {"run_seed": 2025}
    z, y, _ = CASES["Massart noise 10%"](**sampler_args)(150, rep=2)
    for flag in (0, 1):
        assert abs(pt_oco.simulate_alg(z, y, flag, ETA, device="cpu") -
                   jax_oco.simulate_alg(z, y, flag, ETA)) <= TOL
    assert abs(pt_oco.simulate_SMART(z, y, device="cpu") - jax_oco.simulate_SMART(z, y)) <= TOL
    assert abs(pt_oco.simulate_empirical_g_SMART(z, y, 4.5, device="cpu") -
               jax_oco.simulate_empirical_g_SMART(z, y, 4.5)) <= TOL
    assert abs(pt_oco.simulate_SMART_like(z, y, 2.5, 0.8, device="cpu") -
               jax_oco.simulate_SMART_like(z, y, 2.5, 0.8)) <= TOL
    zb, yb, _ = _batch(B=6, T=40, seed=4)
    np.testing.assert_allclose(pt_oco.simulate_alg(zb, yb, 0, ETA, device="cpu"),
                               jax_oco.simulate_alg(zb, yb, 0, ETA),
                               rtol=0, atol=TOL)
    got = pt_oco.empirical_worst_case_thresholds([50, 120], runs=7,
                                               device="cpu")
    want = jax_oco.empirical_worst_case_thresholds([50, 120], runs=7)
    assert got.keys() == want.keys()
    for T in got:
        assert abs(got[T] - want[T]) <= TOL


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, an entry point called without a device raises; it
    does not quietly run on the CPU."""
    from online_convex_optimization_tpu_torch.models.streaming import (
        StreamingKernelGame)
    from online_convex_optimization_tpu_torch.ops import game

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z, y, _ = _batch(B=2, T=8, seed=1)
    for call in (lambda: pt_oco.simulate_alg(z[0], y[0], 0, 1.0),
                 lambda: pt_oco.simulate_SMART(z, y),
                 lambda: StreamingKernelGame(2, 5),
                 lambda: game.zero_stream_carry(2, 5)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
@pytest.mark.parametrize("T", [200, 800])
def test_deterministic_families_equal_golden(title, T):
    z, y, _ = CASES[title](run_seed=2025)(T)
    for flag in (0, 1):
        assert abs(pt_oco.simulate_alg(z, y, flag, ETA, device="cpu") -
                   pt_golden.golden_simulate_alg(z, y, flag, ETA)) <= TOL
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    for thr in (math.sqrt(2.0 * T), 10.0, 2.75):
        res = simulate_smart(zt, yt, thr, ETA)
        want, want_tau = pt_golden.golden_simulate_smart(
            z, y, thr, ETA, return_switch=True)
        assert abs(float(res.regret) - want) <= TOL
        assert int(res.switch_t) == want_tau


def test_golden_copy_equals_jax_golden():
    z, y, _ = _batch(B=1, T=90, seed=9)
    z, y = z[0], y[0]
    for flag in (0, 1):
        assert (pt_golden.golden_simulate_alg(z, y, flag, 1.1) ==
                jax_golden.golden_simulate_alg(z, y, flag, 1.1))
    assert (pt_golden.golden_simulate_smart(z, y, 2.0, 1.1, return_switch=True)
            == jax_golden.golden_simulate_smart(z, y, 2.0, 1.1,
                                                return_switch=True))
    assert (pt_golden.golden_empirical_thresholds([30, 60], runs=3) ==
            jax_golden.golden_empirical_thresholds([30, 60], runs=3))
