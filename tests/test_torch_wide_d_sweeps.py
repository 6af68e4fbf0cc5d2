"""The port past d = 512 on the sweeps (K5, K6a + K6b), the packed game
(K3, K3e) and the generation-fused game (K7), whose wide instances (K5w,
K6aw, K6bw, K3w, K3ew, K7w) run them on the card, against the JAX package.

The port's plain versions (what its wrappers run on a CPU tensor; the
kernels equal them bit for bit on the card, ``tests/test_torch_cuda.py``)
are held on the same NumPy inputs at d = 513 and 640 against:

- JAX ``ftrl_eta_sweep`` and ``smart_threshold_sweep`` on their scan
  route (``use_kernel=False``, the vmap cross product), and
  ``simulate_smart_batch``'s switch rounds on that cross product: x64,
  within 1e-9, switch rounds equal; ragged lengths, contract and replay
  data;
- the JAX x64 scan ``simulate_linear_batch`` for ``play_packed`` (FTRL,
  FTL) and ``play_packed_eta``: cum and the regret through the comparator
  epilogue (which reads theta's direction), within 1e-9; and, at d = 513
  on its smallest packed batch in float32, JAX ``play_packed`` in
  interpret mode (its VMEM-state twin), cum and theta within 5e-4;
- for K7 at d = 513 and 1,024 (Philox calls k = 0..4 and 0..8 a round,
  past the four calls, k <= 3, that any d < 512 needs): the stream's bits
  against an independent NumPy Philox, the row scale
  against the JAX kernel's ``1.0 / float(np.sqrt(d))`` in float32, the
  plain K7 against K1's plain version on the stream bit for bit, and
  against the JAX x64 scan within 1e-9 (FTRL in float32 within 5e-4).

Also K6's split (the plain mirror of K6a then K6b) against the one-pass
plain version bit for bit at d = 513.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_convex_optimization_tpu.models.linear import (
    simulate_linear_batch as jax_linear_batch,
)
from online_convex_optimization_tpu.models.smart import (
    simulate_smart_batch as jax_smart_batch,
)
from online_convex_optimization_tpu.models.sweep_api import (
    ftrl_eta_sweep as jax_eta_sweep,
    smart_threshold_sweep as jax_smart_sweep,
)
from online_convex_optimization_tpu.ops import pallas_game as jpg
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
B, T = 8, 40


def _batch(d, seed, *, contract=True, B=B, T=T):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        y = rng.normal(size=(B, T))
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return z, y, lengths


# -------------------------------------------------------------- K5: eta sweep

@pytest.mark.parametrize("d,contract", [(513, True), (640, True),
                                        (513, False)])
def test_eta_sweep_matches_jax_scan(d, contract):
    z, y, lengths = _batch(d, seed=d + 40, contract=contract)
    grid = np.linspace(0.1, 3.0, 5)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    assert game.in_contract(zt, yt, torch.as_tensor(lengths)) == contract
    got = ftrl_eta_sweep(zt, yt, grid, length=lengths)
    want = jax_eta_sweep(jnp.asarray(z), jnp.asarray(y), jnp.asarray(grid),
                         length=jnp.asarray(lengths), use_kernel=False)
    assert got.shape == (B, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=X64_TOL)


# --------------------------------------------------- K6a + K6b: SMART sweep

@pytest.mark.parametrize("d,contract", [(513, True), (640, True),
                                        (513, False)])
def test_smart_sweep_matches_jax_scan(d, contract):
    z, y, lengths = _batch(d, seed=d + 50, contract=contract)
    # Thresholds some pairs pass early, some late and some never.  Not 0.5:
    # after the first round the lead is 0.5 ||z_0||, which is 0.5 up to an
    # ulp on rows clipped to the unit ball, so a 0.5 threshold is decided
    # by the summation order (the port's index order, XLA's in JAX).
    grid = np.array([0.7, 1.5, 3.0, 1e6])
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    got = smart_threshold_sweep(zt, yt, grid, eta0=ETA, length=lengths)
    want = jax_smart_sweep(jnp.asarray(z), jnp.asarray(y), jnp.asarray(grid),
                           eta0=ETA, length=jnp.asarray(lengths),
                           use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=X64_TOL)
    # The switch rounds against the JAX simulator on the cross product.
    G = grid.shape[0]
    regret, tau = smart.smart_sweep(zt, yt, grid, ETA, lengths)
    assert torch.equal(regret, got)
    res = jax_smart_batch(jnp.repeat(jnp.asarray(z), G, axis=0),
                          jnp.repeat(jnp.asarray(y), G, axis=0),
                          jnp.tile(jnp.asarray(grid), B),
                          jnp.full((B * G,), ETA),
                          jnp.repeat(jnp.asarray(lengths), G))
    np.testing.assert_array_equal(tau.numpy(),
                                  np.asarray(res.switch_t).reshape(B, G))
    switched = tau.numpy() < T
    assert switched.any() and not switched.all()


def test_smart_split_equals_one_pass_bit_for_bit():
    """The plain mirror of K6a then K6b (what K6aw and K6bw compute) equals
    the one-pass plain version in every bit at d = 513, ragged lengths."""
    z, y, lengths = _batch(513, seed=77)
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    ln = torch.as_tensor(lengths)
    grid = torch.tensor([0.4, 1.0, 2.5, 1e6], dtype=torch.float64)
    eta = torch.tensor(ETA, dtype=torch.float64)
    want = smart.smart_sweep_reference(zt, yt, grid, eta, ln)
    got = smart.smart_sweep_split_reference(zt, yt, grid, eta, ln)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool((got[1] < T).any())


# ------------------------------------------------------ K3, K3e: packed game

@pytest.mark.parametrize("d", [513, 640])
@pytest.mark.parametrize("alg_flag,per_seq_eta", [(0, False), (1, False),
                                                  (0, True)])
def test_packed_matches_jax_scan(d, alg_flag, per_seq_eta):
    z, y, lengths = _batch(d, seed=d + 60 + alg_flag + 2 * per_seq_eta)
    # Zero rows past each horizon are inert padding in the packed API.
    valid = np.arange(T)[None, :] < lengths[:, None]
    z, y = np.where(valid[..., None], z, 0.0), np.where(valid, y, 0.0)
    eta = np.linspace(0.3, 2.5, B) if per_seq_eta else 1.3
    zt, yt = to_torch((z, y), "cpu", torch.float64)
    z_tm, y_tm = game.time_major(zt, yt)
    if per_seq_eta:
        cum, theta = game.play_packed_eta(z_tm, y_tm, torch.as_tensor(eta))
    else:
        scales = game.ftrl_scales(T, eta, dtype=torch.float64, device="cpu")
        cum, theta = game.play_packed(z_tm, y_tm, scales, alg_flag=alg_flag)
    assert theta.shape == (d, B)
    want = jax_linear_batch(jnp.asarray(z), jnp.asarray(y), alg_flag,
                            jnp.asarray(eta), jnp.asarray(lengths))
    np.testing.assert_allclose(cum.numpy(), np.asarray(want.cum_loss),
                               rtol=0, atol=X64_TOL)
    regret = game.comparator_epilogue(z_tm, y_tm, cum, theta)
    np.testing.assert_allclose(regret.numpy(), np.asarray(want.regret),
                               rtol=0, atol=X64_TOL)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_play_packed_matches_jax_kernel_interpret_past_512(alg_flag):
    """JAX ``play_packed`` (its VMEM-state twin past d = 128) in interpret
    mode at d = 513 on one packed tile of sequences, T = 4, float32."""
    Tk, d = 4, 513
    z, y, _ = _batch(d, seed=90 + alg_flag, B=jpg.SEQ_TILE, T=Tk)
    z32, y32 = z.astype(np.float32), y.astype(np.float32)
    zp, yp, Bp = jpg.pack_sequences(jnp.asarray(z32), jnp.asarray(y32))
    scales = jpg.ftrl_scales(Tk, 1.3)
    cum_j, th_j = jpg.play_packed(zp, yp, scales, alg_flag=alg_flag,
                                  interpret=True)
    z_tm, y_tm = game.time_major(*to_torch((z32, y32), "cpu"))
    cum, theta = game.play_packed(z_tm, y_tm,
                                  torch.from_numpy(np.asarray(scales)),
                                  alg_flag=alg_flag)
    np.testing.assert_allclose(cum.numpy(), np.asarray(
        jpg.unpack_result(cum_j, Bp)), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(
        theta.numpy(),
        np.stack([np.asarray(jpg.unpack_result(th_j[j], Bp))
                  for j in range(d)]), rtol=0, atol=F32_TOL)


# ------------------------------------------- K7: the generation-fused game

def _np_philox_words(seed, T, Bn, calls):
    """Philox4x32-10 of counters (t, b, k, 0), written in NumPy uint64
    from the paper, independently of ``ops/philox.py``: (T, Bn, 4 calls)."""
    t, b, k = np.meshgrid(np.arange(T), np.arange(Bn), np.arange(calls),
                          indexing="ij")
    c = [t.astype(np.uint64), b.astype(np.uint64), k.astype(np.uint64),
         np.zeros_like(t, dtype=np.uint64)]
    mask = np.uint64(0xFFFFFFFF)
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64(seed >> 32)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & mask
            k1 = (k1 + np.uint64(0xBB67AE85)) & mask
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
    return np.stack(c, axis=-1).reshape(T, Bn, 4 * calls)


@pytest.mark.parametrize("d", [513, 1024])
def test_k7_stream_bits_past_the_fourth_call(d):
    """Each round of d = 513 needs Philox calls k = 0..4 and of d = 1,024
    calls k = 0..8 (bit d, the label, is bit 0 of the last): the stream's
    signs are those calls' bits, and its magnitude is the JAX kernel's
    float32 ``1.0 / float(np.sqrt(d))``."""
    seed, Tk, lane_batch = (5 << 20) + 3, 3, 1
    Bn = 8 * lane_batch
    z, y = game.synthetic_stream(seed, T=Tk, lane_batch=lane_batch, d=d,
                                 device="cpu")
    calls = d // 128 + 1
    assert calls == {513: 5, 1024: 9}[d]
    words = _np_philox_words(seed, Tk, Bn, calls)
    j = np.arange(d + 1)
    bits = (words[..., j // 32] >> (j % 32).astype(np.uint64)) & 1
    np.testing.assert_array_equal((z.numpy() > 0).transpose(1, 0, 2),
                                  bits[..., :d] == 1)
    np.testing.assert_array_equal((y.numpy() > 0).T, bits[..., d] == 1)
    c = np.float32(1.0 / float(np.sqrt(d)))
    assert game.synthetic_row_scale(d) == float(c)
    assert set(np.abs(z.numpy()).ravel().tolist()) == {float(c)}


@pytest.mark.parametrize("d", [513, 1024])
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_plain_k7_past_512(d, alg_flag):
    """The plain K7 is K1's plain version on the stream bit for bit, and
    the JAX x64 scan's regret on those rows within 1e-9 (the port's K1
    plain in float64); FTRL in float32 within 5e-4 of it."""
    Tk, lane_batch = 24, 1
    got = game.synthetic_regrets(13, ETA, T=Tk, lane_batch=lane_batch, d=d,
                                 alg_flag=alg_flag, device="cpu")
    assert got.shape == (8, lane_batch) and got.dtype == torch.float32
    z, y = game.synthetic_stream(13, T=Tk, lane_batch=lane_batch, d=d,
                                 device="cpu")
    cum, comp, _ = game.regrets_fused(z, y, alg_flag, ETA)
    assert torch.equal(got.reshape(-1), cum - comp)
    eta32 = float(np.float32(ETA))
    z64, y64 = z.double(), y.double()
    want64 = np.asarray(jax_linear_batch(jnp.asarray(z64.numpy()),
                                         jnp.asarray(y64.numpy()), alg_flag,
                                         eta32).regret)
    cum, comp, _ = game.regrets_fused(z64, y64, alg_flag, eta32)
    np.testing.assert_allclose((cum - comp).numpy(), want64, rtol=0,
                               atol=X64_TOL)
    if alg_flag == 0:
        np.testing.assert_allclose(got.reshape(-1).numpy(), want64, rtol=0,
                                   atol=F32_TOL)
