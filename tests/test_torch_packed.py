"""The packed game API (kernels K3 and K3e, their plain versions on the CPU)
against the JAX package, and the port's envelope past d = 64.

- float32 against the JAX Pallas kernels in interpret mode on
  ``pack_sequences`` layouts, atol 2e-4 (tests/test_pallas_game_v2.py's
  bound for these kernels at T <= 64);
- float64 against the JAX x64 scan ``simulate_linear_batch``, 1e-12;
- d = 96 and 256 against the JAX VMEM-state kernel (``regrets_fused``,
  ``state="vmem"``, interpret mode) at B = 256, T = 8;
- K3 with ``ftrl_scales`` and K3e against K1's plain version, bit for bit
  in float64 and float32 (the CUDA kernels are held to the same on the
  card by tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_convex_optimization_tpu.models.linear import (
    simulate_linear_batch as jax_linear_batch,
)
from online_convex_optimization_tpu.ops import pallas_game as jpg
from online_convex_optimization_tpu_torch.ops import game
from online_convex_optimization_tpu_torch.testing.from_jax import to_torch

torch.set_num_threads(1)

F32_TOL = 2e-4
X64_TOL = 1e-12


def _batch(B, T, d=5, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return z, y


def _packed(z, y):
    """The same f32 batch as JAX packs it and as the port lays it out."""
    z32, y32 = z.astype(np.float32), y.astype(np.float32)
    zp, yp, B = jpg.pack_sequences(jnp.asarray(z32), jnp.asarray(y32))
    z_tm, y_tm = game.time_major(*to_torch((z32, y32), "cpu"))
    return zp, yp, B, z_tm, y_tm


def _unpack_theta(theta, B):
    return np.stack([np.asarray(jpg.unpack_result(theta[j], B))
                     for j in range(theta.shape[0])])


def test_ftrl_scales_values():
    """The table in float32 against the JAX one and in float64 against the
    formula, within 2 ulps (torch's CPU sqrt can be one ulp off, and the
    quotient rounds once more), and equal to the scale K1's plain FTRL
    action computes."""
    sc = game.ftrl_scales(300, 2.0, device="cpu")
    assert sc.dtype == torch.float32 and sc.shape == (300,)
    np.testing.assert_array_max_ulp(sc.numpy(),
                                    np.asarray(jpg.ftrl_scales(300, 2.0)), 2)
    t = np.arange(1, 301, dtype=np.float64)
    sc64 = game.ftrl_scales(300, 1.3, dtype=torch.float64, device="cpu")
    np.testing.assert_array_max_ulp(sc64.numpy(), -(1.3 / np.sqrt(t)), 2)
    theta = torch.ones((300, 1), dtype=torch.float64) * 1e-3
    x = game.ftrl_action(theta, torch.from_numpy(t), 1.3)
    assert torch.equal(x[:, 0], sc64 * 1e-3)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_play_packed_matches_jax_kernel_interpret(alg_flag):
    z, y = _batch(jpg.SEQ_TILE, 32, seed=3 + alg_flag)
    zp, yp, B, z_tm, y_tm = _packed(z, y)
    scales = jpg.ftrl_scales(32, 1.3)
    cum_j, th_j = jpg.play_packed(zp, yp, scales, alg_flag=alg_flag,
                                  interpret=True)
    cum, theta = game.play_packed(z_tm, y_tm, torch.from_numpy(
        np.asarray(scales)), alg_flag=alg_flag)
    np.testing.assert_allclose(cum.numpy(), np.asarray(
        jpg.unpack_result(cum_j, B)), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(theta.numpy(), _unpack_theta(th_j, B), rtol=0,
                               atol=F32_TOL)
    reg_j = jpg.regrets_packed(zp, yp, scales, alg_flag=alg_flag,
                               interpret=True)
    reg = game.regrets_packed(z_tm, y_tm, np.asarray(scales),
                              alg_flag=alg_flag)
    np.testing.assert_allclose(reg.numpy(), np.asarray(
        jpg.unpack_result(reg_j, B)), rtol=0, atol=F32_TOL)


def test_play_packed_eta_matches_jax_kernel_interpret():
    z, y = _batch(jpg.SEQ_TILE, 32, seed=7)
    zp, yp, B, z_tm, y_tm = _packed(z, y)
    etas = np.linspace(0.2, 3.0, B).astype(np.float32)
    eta_pack = jpg.pack_per_seq(jnp.asarray(etas), zp.shape[2])
    cum_j, th_j = jpg.play_packed_eta(zp, yp, eta_pack, interpret=True)
    cum, theta = game.play_packed_eta(z_tm, y_tm, torch.from_numpy(etas))
    np.testing.assert_allclose(cum.numpy(), np.asarray(
        jpg.unpack_result(cum_j, B)), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(theta.numpy(), _unpack_theta(th_j, B), rtol=0,
                               atol=F32_TOL)
    want = np.asarray(jpg.unpack_result(jpg.regrets_packed_eta(
        zp, yp, eta_pack, interpret=True), B))
    np.testing.assert_allclose(
        game.regrets_packed_eta(z_tm, y_tm, torch.from_numpy(etas)).numpy(),
        want, rtol=0, atol=F32_TOL)
    got = game.simulate_linear_auto(*to_torch((z, y), "cpu", torch.float32),
                                    0, torch.from_numpy(etas))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("alg_flag,per_seq_eta", [(0, False), (1, False),
                                                  (0, True)])
def test_packed_front_end_matches_jax_scan_x64(alg_flag, per_seq_eta):
    z, y = _batch(96, 80, seed=20 + alg_flag)
    eta = np.linspace(0.3, 2.5, 96) if per_seq_eta else 1.3
    want = jax_linear_batch(jnp.asarray(z), jnp.asarray(y), alg_flag,
                            jnp.asarray(eta)).regret
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    eta_t = torch.as_tensor(eta) if per_seq_eta else eta
    got = game.simulate_linear_packed(zt, yt, alg_flag, eta_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=X64_TOL)
    np.testing.assert_array_equal(
        game.simulate_linear_auto(zt, yt, alg_flag, eta_t).numpy(),
        got.numpy())


@pytest.mark.parametrize("d", [96, 256])
def test_large_d_matches_jax_vmem_kernel(d):
    """Past the port's old d <= 64: K1's, K2's and K3's plain versions at
    d = 96 and 256 against the JAX VMEM-state kernel (interpret mode)."""
    z, y = _batch(256, 8, d=d, seed=31 + d)
    z32, y32 = z.astype(np.float32), y.astype(np.float32)
    zp, yp, Bp = jpg.pack_sequences(jnp.asarray(z32), jnp.asarray(y32))
    want = np.asarray(jpg.unpack_result(jpg.regrets_fused(
        zp, yp, 1.1, state="vmem", interpret=True), Bp))
    zt, yt = to_torch((z32, y32), "cpu")
    cum, comp, _ = game.regrets_fused(zt, yt, 0, 1.1)
    np.testing.assert_allclose((cum - comp).numpy(), want, rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(
        game.simulate_linear_auto(zt, yt, 0, 1.1).numpy(), want, rtol=0,
        atol=F32_TOL)


def test_kernel_envelope_boundaries():
    assert game.kernel_envelope(131_072, 1024, 5) is None
    assert game.kernel_envelope(8, 8, 512, torch.float64) is None
    # K3e has the large-d instance too: no register-only limit.
    assert game.kernel_envelope(8, 8, 256, per_lane_eta=True) is None
    reason = game.kernel_envelope(8, 8, 513)
    assert reason is not None and "512" in reason
    # bf16 z is a storage the kernels take; float16 is not.
    assert game.kernel_envelope(8, 8, 5, torch.bfloat16) is None
    assert game.kernel_envelope(8, 8, 5, torch.float16) is not None
    # On the CPU the plain version runs past the envelope.
    zt, yt = to_torch(_batch(3, 4, d=513, seed=1), "cpu", torch.float64)
    assert bool(torch.isfinite(game.simulate_linear_auto(zt, yt, 0, 1.0)).all())
    with pytest.raises(ValueError, match="FTRL-only"):
        game.simulate_linear_packed(zt, yt, 1, torch.ones(3))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_packed_equals_k1_bit_for_bit(dtype):
    """K3 with ftrl_scales, and K3e, play K1's FTRL rounds: equal cum; FTL
    through K3 equals K1's FTL; zero rows past a horizon are inert."""
    z, y = _batch(64, 50, seed=5)
    z[:, 40:], y[:, 40:] = 0.0, 0.0
    zt, yt = to_torch((z, y), "cpu", dtype)
    z_tm, y_tm = game.time_major(zt, yt)
    etas = torch.linspace(0.05, 4.0, 64, dtype=dtype)
    for flag in (0, 1):
        cum, _ = game.play_packed(
            z_tm, y_tm, game.ftrl_scales(50, 1.3, dtype=dtype, device="cpu"),
            alg_flag=flag)
        want, _, _ = game.regrets_fused(zt, yt, flag, 1.3, 40)
        assert torch.equal(cum, want)
    cum, _ = game.play_packed_eta(z_tm, y_tm, etas)
    want, _, _ = game.regrets_fused(zt, yt, 0, etas)
    assert torch.equal(cum, want)
