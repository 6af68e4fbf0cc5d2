"""Kernel K7's plain version (the generation-fused synthetic game) on the
CPU, against an independent NumPy Philox and the JAX package.

Tolerances:

- The Philox words and the stream's bits: exact (integers).
- The plain K7 against the port's ``regrets_fused_reference`` on the same
  materialized stream: bit for bit (it is that function on that stream).
- Against the JAX ``simulate_linear_batch`` scan on the same materialized
  stream: 1e-9 in x64 (the port's plain K1 in float64 on the same rows),
  and 5e-4 in float32 for the plain K7 itself under FTRL (f32 rounding
  against the JAX scan's, the port's f32 bound elsewhere).  FTL is held
  to JAX in x64 only: its action is a unit vector, and where theta is
  parallel to z_t (often, on +-1/sqrt(d) rows) q = <z_t, x> ties y_t up
  to an ulp of ||z_t||, so f32 rounding orders of two implementations flip
  the tie subgradient (the f32 tie trap of ROADMAP.md queue 3).
- The regret distribution against ``jax.random.rademacher`` + scan (other
  bits, same law), as ``tests/test_synthetic_kernel.py`` does on a TPU:
  means within 4 standard errors, standard deviations within 15%.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.models.linear import (
    simulate_linear_batch as jax_simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.ops import game, philox

torch.set_num_threads(1)

X64_TOL = 1e-9
F32_TOL = 5e-4
ETA = math.sqrt(2.0)


def _np_mulhilo(a, m):
    prod = a.astype(np.uint64) * np.uint64(m)
    return prod >> np.uint64(32), prod & np.uint64(0xFFFFFFFF)


def _np_philox(ctr, key):
    """Philox4x32-10 in NumPy uint64, written from the paper independently
    of ``ops/philox.py``: ``ctr`` (..., 4), ``key`` (..., 2)."""
    c = [ctr[..., i].astype(np.uint64) for i in range(4)]
    k = [key[..., i].astype(np.uint64) for i in range(2)]
    mask = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & mask,
                 (k[1] + np.uint64(0xBB67AE85)) & mask]
        hi0, lo0 = _np_mulhilo(c[0], 0xD2511F53)
        hi1, lo1 = _np_mulhilo(c[2], 0xCD9E8D57)
        c = [hi1 ^ c[1] ^ k[0], lo1, hi0 ^ c[3] ^ k[1], lo0]
    return np.stack(c, axis=-1)


def _torch_philox(ctr, key):
    out = philox.philox4x32_10(*(torch.from_numpy(ctr[:, i].astype(np.int64))
                                 for i in range(4)), key)
    return np.stack([o.numpy() for o in out], axis=-1).astype(np.uint64)


def test_philox_known_answers():
    """The Random123 known-answer vectors of Philox4x32-10."""
    m = 0xFFFFFFFF
    cases = [((0, 0, 0, 0), 0,
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((m, m, m, m), (m << 32) | m,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0x299F31D0 << 32) | 0xA4093822,
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = _torch_philox(np.asarray([ctr], np.uint64), key)[0]
        assert [int(v) for v in got] == list(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_philox_matches_numpy_uint64(seed):
    rng = np.random.default_rng(seed)
    ctr = rng.integers(0, 2 ** 32, size=(4096, 4), dtype=np.uint64)
    key = int(rng.integers(0, 2 ** 63)) * 2 + 1
    key_words = np.asarray([key & 0xFFFFFFFF, key >> 32], np.uint64)
    want = _np_philox(ctr, np.broadcast_to(key_words, (4096, 2)))
    np.testing.assert_array_equal(_torch_philox(ctr, key), want)


@pytest.mark.parametrize("d", [5, 3, 130])
def test_stream_bits_are_numpy_philox_bits(d):
    """``round_bits``: bit j of round t of sequence b is bit j % 128 of
    Philox((t, b, j // 128, 0), seed), word-major; the stream's signs are
    those bits (1 -> +)."""
    seed, T, lane_batch = (3 << 20) + 7, 6, 2
    B = 8 * lane_batch
    z, y = game.synthetic_stream(seed, T=T, lane_batch=lane_batch, d=d,
                                 device="cpu")
    t, b, k = np.meshgrid(np.arange(T), np.arange(B),
                          np.arange((d + 128) // 128), indexing="ij")
    ctr = np.stack([t, b, k, np.zeros_like(t)], -1).astype(np.uint64)
    key = np.asarray([seed & 0xFFFFFFFF, seed >> 32], np.uint64)
    words = _np_philox(ctr, np.broadcast_to(key, ctr.shape[:-1] + (2,)))
    words = words.reshape(T, B, -1)
    j = np.arange(d + 1)
    bits = (words[..., j // 32] >> (j % 32).astype(np.uint64)) & 1
    np.testing.assert_array_equal((z.numpy() > 0).transpose(1, 0, 2),
                                  bits[..., :d] == 1)
    np.testing.assert_array_equal((y.numpy() > 0).T, bits[..., d] == 1)


@pytest.mark.parametrize("d", [5, 3, 130])
def test_stream_properties(d):
    T, lane_batch = 40, 4
    z, y = game.synthetic_stream(11, T=T, lane_batch=lane_batch, d=d,
                                 device="cpu")
    c = np.float32(1.0 / float(np.sqrt(d)))
    assert z.shape == (8 * lane_batch, T, d) and y.shape == (8 * lane_batch,
                                                              T)
    assert z.dtype == y.dtype == torch.float32
    assert set(np.unique(z.numpy()).tolist()) == {float(-c), float(c)}
    assert set(np.unique(y.numpy()).tolist()) == {-1.0, 1.0}
    # The rows' f32 squared norms sit within the contract's tolerance.
    assert game.in_contract(z, y, torch.full((8 * lane_batch,), T))
    z2, y2 = game.synthetic_stream(11, T=T, lane_batch=lane_batch, d=d,
                                   device="cpu")
    assert torch.equal(z, z2) and torch.equal(y, y2)
    z3, _ = game.synthetic_stream(12, T=T, lane_batch=lane_batch, d=d,
                                  device="cpu")
    assert not torch.equal(z, z3)
    assert not torch.equal(z[0], z[1])
    # A larger lane_batch extends the same population.
    z4, y4 = game.synthetic_stream(11, T=T, lane_batch=2 * lane_batch, d=d,
                                   device="cpu")
    assert torch.equal(z4[:8 * lane_batch], z)
    assert torch.equal(y4[:8 * lane_batch], y)
    # Signs are balanced (each bit is fair).
    assert abs(float((z > 0).double().mean()) - 0.5) < 0.05
    assert abs(float((y > 0).double().mean()) - 0.5) < 0.05


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_plain_k7_is_k1_plain_on_the_stream_bitwise(alg_flag):
    T, lane_batch = 64, 8
    got = game.synthetic_regrets(5, 1.3, T=T, lane_batch=lane_batch,
                                 alg_flag=alg_flag, device="cpu")
    assert got.shape == (8, lane_batch) and got.dtype == torch.float32
    z, y = game.synthetic_stream(5, T=T, lane_batch=lane_batch,
                                 device="cpu")
    cum, comp, _ = game.regrets_fused(z, y, alg_flag, 1.3)
    assert torch.equal(got.reshape(-1), cum - comp)
    ref = game.synthetic_regrets_reference(5, 1.3, T=T, lane_batch=lane_batch,
                                           alg_flag=alg_flag, device="cpu")
    assert torch.equal(got, ref)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_plain_k7_matches_jax_scan(alg_flag):
    T, lane_batch = 96, 8
    z, y = game.synthetic_stream(9, T=T, lane_batch=lane_batch,
                                 device="cpu")
    got = game.synthetic_regrets(9, ETA, T=T, lane_batch=lane_batch,
                                 alg_flag=alg_flag, device="cpu")
    eta32 = float(np.float32(ETA))
    z64, y64 = z.double(), y.double()
    want64 = np.asarray(jax_simulate_linear_batch(
        jnp.asarray(z64.numpy()), jnp.asarray(y64.numpy()), alg_flag,
        eta32).regret)
    cum, comp, _ = game.regrets_fused(z64, y64, alg_flag, eta32)
    np.testing.assert_allclose((cum - comp).numpy(), want64, rtol=0,
                               atol=X64_TOL)
    if alg_flag == 0:
        want32 = np.asarray(jax_simulate_linear_batch(
            jnp.asarray(z.numpy()), jnp.asarray(y.numpy()), alg_flag,
            jnp.float32(eta32)).regret)
        np.testing.assert_allclose(got.reshape(-1).numpy(), want32, rtol=0,
                                   atol=F32_TOL)
        np.testing.assert_allclose(got.reshape(-1).numpy(), want64, rtol=0,
                                   atol=F32_TOL)


def test_regret_distribution_matches_jax_rademacher_scan():
    T, lane_batch = 300, 512
    syn = game.synthetic_regrets(7, ETA, T=T, lane_batch=lane_batch,
                                 device="cpu").double().numpy()
    kz, ky = jax.random.split(jax.random.key(0))
    B = 4096
    z = jax.random.rademacher(kz, (B, T, 5), jnp.float32) / np.sqrt(5.0)
    y = jax.random.rademacher(ky, (B, T), jnp.float32)
    ref = np.asarray(jax_simulate_linear_batch(z, y, 0, ETA).regret)
    assert syn.mean() == pytest.approx(ref.mean(),
                                       abs=4 * ref.std() / np.sqrt(B))
    assert syn.std() == pytest.approx(ref.std(), rel=0.15)


def test_ftl_ignores_eta_and_differs_from_ftrl():
    """alg_flag 1 plays FTL: eta plays no part, the regrets differ from
    FTRL's, and they are FTL regrets (the JAX x64 scan's on the same rows,
    up to the f32 tie flips of the module docstring, within 1.0 each)."""
    T, lane_batch = 128, 4
    ftl = game.synthetic_regrets(21, ETA, T=T, lane_batch=lane_batch,
                                 alg_flag=1, device="cpu")
    ftl_other_eta = game.synthetic_regrets(21, 0.1, T=T,
                                           lane_batch=lane_batch,
                                           alg_flag=1, device="cpu")
    ftrl = game.synthetic_regrets(21, ETA, T=T, lane_batch=lane_batch,
                                  device="cpu")
    assert torch.equal(ftl, ftl_other_eta)       # FTL ignores eta
    assert not torch.equal(ftl, ftrl)
    z, y = game.synthetic_stream(21, T=T, lane_batch=lane_batch,
                                 device="cpu")
    res = jax_simulate_linear_batch(jnp.asarray(z.double().numpy()),
                                    jnp.asarray(y.double().numpy()), 1, 1.0)
    diff = np.abs(ftl.reshape(-1).double().numpy() - np.asarray(res.regret))
    assert np.median(diff) < F32_TOL and diff.max() < 1.0


def test_horizon_4096_in_one_call():
    out = game.synthetic_regrets(11, ETA, T=4096, lane_batch=2, device="cpu")
    assert out.shape == (8, 2)
    assert bool(torch.isfinite(out).all())
    assert 0.0 < float(out.mean()) < 10.0 * math.sqrt(4096.0)


def test_seed_is_a_64_bit_key():
    """JAX int32 seeds past 2^31 arrive negative; the port takes the seed
    modulo 2^64, so a negative seed and its two's complement agree and
    seeds 2^32 apart differ."""
    a = game.synthetic_stream(-5, T=4, lane_batch=1, device="cpu")[0]
    b = game.synthetic_stream(2 ** 64 - 5, T=4, lane_batch=1,
                              device="cpu")[0]
    c = game.synthetic_stream(2 ** 32 - 5, T=4, lane_batch=1,
                              device="cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_entry_checks_its_arguments_and_runs_on_the_card_by_default():
    before = game.SYNTHETIC_LAUNCHES
    game.synthetic_regrets(1, 1.0, T=8, lane_batch=1, device="cpu")
    assert game.SYNTHETIC_LAUNCHES == before   # the CPU launches nothing
    for bad in ({"T": 0}, {"T": 2 ** 32}, {"lane_batch": 0}, {"d": 0},
                {"alg_flag": 2}):
        kwargs = {"T": 8, "lane_batch": 1, **bad}
        with pytest.raises(ValueError):
            game.synthetic_regrets(1, 1.0, device="cpu", **kwargs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            game.synthetic_regrets(1, 1.0, T=8, lane_batch=1)
