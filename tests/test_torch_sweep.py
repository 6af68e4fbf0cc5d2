"""The port's eta and SMART-threshold sweeps (kernels K5 and K6, plain
versions on the CPU) against the JAX package.

Three references on the same NumPy inputs:

- the JAX scan route (``ftrl_eta_sweep`` / ``smart_threshold_sweep`` with
  ``use_kernel=False``, x64), with ragged lengths, FTL, and data outside the
  identity contract, bound 1e-9;
- the JAX Pallas kernels in interpret mode (``eta_sweep_packed``,
  ``smart_sweep_packed``) on f32 inputs, bound 5e-4: the TPU kernels fold
  the FTRL projection into ``rsqrt(max(.., 1))``, the port divides by a
  correctly rounded sqrt;
- the port's own one-shot plain versions (``regrets_fused_reference``,
  ``smart_regrets_reference``) on the explicit cross product, bit for bit in
  f64: the sweep's settings axis must change nothing in the arithmetic.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_convex_optimization_tpu.models.sweep_api import (
    ftrl_eta_sweep as jax_eta_sweep,
    smart_threshold_sweep as jax_threshold_sweep,
)
from online_convex_optimization_tpu.ops.pallas_game import (
    pack_sequences,
    unpack_result,
)
from online_convex_optimization_tpu.ops.pallas_smart import smart_sweep_packed
from online_convex_optimization_tpu_torch.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.testing.from_jax import to_torch

torch.set_num_threads(1)

X64_TOL = 1e-9
F32_TOL = 5e-4
ETA = math.sqrt(2.0)
# Threshold 0.5 is ulp-degenerate on +-1 data (a lead of exactly 0.5 is
# common), so it stays out of every cross-implementation comparison.
THRESHOLDS = np.array([1.0, 2.5, 6.0, 10.0])


def _batch(B, T, d=5, seed=0, *, contract=True, ragged=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        z *= 1.5                                 # rows with ||z|| > 1
        y = rng.normal(size=(B, T))              # real-valued labels
    lengths = rng.integers(1, T + 1, size=B) if ragged else np.full(B, T)
    lengths[0] = T
    return z, y, lengths


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


# ------------------------------------------------------ JAX scans in x64

@pytest.mark.parametrize("alg_flag,contract,ragged", [
    (0, True, True), (0, True, False), (1, True, True), (0, False, True)])
def test_eta_sweep_matches_jax_scan_x64(alg_flag, contract, ragged):
    z, y, lengths = _batch(12, 60, seed=3, contract=contract, ragged=ragged)
    grid = np.array([0.05, 0.3, 1.0, ETA, 4.0])
    length = lengths if ragged else None
    want = jax_eta_sweep(z, y, grid, alg_flag=alg_flag, length=length,
                         use_kernel=False)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    got = ftrl_eta_sweep(zt, yt, grid, alg_flag=alg_flag, length=length)
    assert got.shape == (12, 5)
    _close(got, want, X64_TOL)
    if alg_flag == 1:                    # FTL: one K1 run, repeated over eta
        assert torch.equal(got, got[:, :1].expand(-1, 5))


@pytest.mark.parametrize("contract,ragged", [
    (True, True), (True, False), (False, True)])
def test_threshold_sweep_matches_jax_scan_x64(contract, ragged):
    z, y, lengths = _batch(12, 70, seed=4, contract=contract, ragged=ragged)
    length = lengths if ragged else None
    want = jax_threshold_sweep(z, y, THRESHOLDS, eta0=ETA, length=length,
                               use_kernel=False)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    got = smart_threshold_sweep(zt, yt, THRESHOLDS, eta0=ETA, length=length)
    assert got.shape == (12, 4)
    _close(got, want, X64_TOL)


# ----------------------------------------------- JAX kernels, interpret mode

def test_eta_sweep_matches_jax_kernel_interpret():
    z, y, lengths = _batch(64, 48, seed=8)
    z, y = z.astype(np.float32), y.astype(np.float32)
    grid = np.linspace(0.3, 2.0, 4).astype(np.float32)
    want = jax_eta_sweep(z, y, grid, length=lengths, use_kernel=True,
                         interpret=True)
    zt, yt = to_torch((z, y), "cpu")
    got = ftrl_eta_sweep(zt, yt, grid, length=lengths)
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_threshold_sweep_matches_jax_kernel_interpret():
    z, y, lengths = _batch(64, 64, seed=9)
    # Tails zeroed, as the JAX kernel route masks them: inert rows there.
    valid = np.arange(64)[None, :] < lengths[:, None]
    z = np.where(valid[..., None], z, 0.0).astype(np.float32)
    y = np.where(valid, y, 0.0).astype(np.float32)
    grid = np.array([1.5, 3.0, 5.0], np.float32)
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    reg, tau = smart_sweep_packed(z_pack, y_pack, jnp.asarray(grid), ETA,
                                  interpret=True)
    zt, yt = to_torch((z, y), "cpu")
    got, switch_t = smart.smart_sweep(zt, yt, grid, ETA, lengths)
    for g in range(3):
        _close(got[:, g], np.asarray(unpack_result(reg[g], B)), F32_TOL)
        np.testing.assert_array_equal(
            switch_t[:, g].numpy(), np.asarray(unpack_result(tau[g], B)))
    assert (switch_t < 64).any() and (switch_t == 64).any()


# --------------------------------- plain sweeps vs plain one-shot, bitwise

@pytest.mark.parametrize("contract", [True, False])
def test_eta_sweep_reference_equals_k1_reference_on_cross_product(contract):
    z, y, lengths = _batch(9, 50, seed=11, contract=contract)
    E = 4
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    lt = torch.as_tensor(lengths, dtype=torch.int32)
    grid = torch.tensor([0.3, 1.0, ETA, 3.1], dtype=torch.float64)
    got = game.eta_sweep_reference(zt, yt, grid, lt, replay=not contract)
    cum, comp, _ = game.regrets_fused_reference(
        zt.repeat_interleave(E, 0), yt.repeat_interleave(E, 0),
        torch.zeros(9 * E, dtype=torch.int32), grid.repeat(9),
        lt.repeat_interleave(E), replay=not contract)
    assert torch.equal(got.reshape(-1), cum - comp)


@pytest.mark.parametrize("contract", [True, False])
def test_smart_sweep_reference_equals_k2_reference_on_cross_product(contract):
    z, y, lengths = _batch(9, 60, seed=12, contract=contract)
    G = len(THRESHOLDS)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    lt = torch.as_tensor(lengths, dtype=torch.int32)
    th = torch.as_tensor(THRESHOLDS)
    eta = torch.tensor(ETA, dtype=torch.float64)
    reg, tau = smart.smart_sweep_reference(zt, yt, th, eta, lt,
                                           replay=not contract)
    cum, comp, _, tau1 = smart.smart_regrets_reference(
        zt.repeat_interleave(G, 0), yt.repeat_interleave(G, 0), th.repeat(9),
        torch.full((9 * G,), ETA, dtype=torch.float64),
        lt.repeat_interleave(G), replay=not contract)
    assert torch.equal(reg.reshape(-1), cum - comp)
    assert torch.equal(tau.reshape(-1), tau1)
    assert (tau < 60).any()


def test_sweeps_on_the_deterministic_families_match_golden():
    from online_convex_optimization_tpu_torch.data.sequences import CASES
    from online_convex_optimization_tpu_torch.testing.golden import (
        golden_simulate_alg,
        golden_simulate_smart,
    )
    for title in ("Label flips", "Switching leaders"):
        z, y, _ = CASES[title](run_seed=2025)(200)
        zt, yt = to_torch((z[None], y[None]), "cpu", torch.float64)
        grid = [1.0, ETA]
        reg = ftrl_eta_sweep(zt, yt, grid)
        for e, eta in enumerate(grid):
            assert abs(float(reg[0, e]) -
                       golden_simulate_alg(z, y, 0, eta)) <= X64_TOL
        th = [math.sqrt(2.0 * 200), 10.0]
        reg, tau = smart.smart_sweep(zt, yt, th, ETA)
        for g, thr in enumerate(th):
            want, want_tau = golden_simulate_smart(z, y, thr, ETA,
                                                   return_switch=True)
            assert abs(float(reg[0, g]) - want) <= X64_TOL
            assert int(tau[0, g]) == want_tau


def test_sweep_wrappers_reject_bad_grids():
    z = torch.zeros((2, 4, 5), dtype=torch.float64)
    y = torch.ones((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="eta_grid"):
        game.eta_sweep(z, y, [])
    with pytest.raises(ValueError, match="eta_grid"):
        game.eta_sweep(z, y, [[0.5, 1.0]])
    with pytest.raises(ValueError, match="thresholds"):
        smart.smart_sweep(z, y, torch.ones((2, 2)), 1.0)
    with pytest.raises(ValueError, match="alg_flag"):
        ftrl_eta_sweep(z, y, [1.0], alg_flag=2)
    with pytest.raises(ValueError):
        game.eta_sweep(z, y, [1.0], [5, 4])              # length > T
