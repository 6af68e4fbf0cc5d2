"""The port's streamed game (kernel K4's plain version on the CPU) against the
port's one-shot simulator and the JAX package's streaming classes.

- Fed in chunks, ``StreamingKernelGame`` ends with the carry that the
  one-shot K1 plain version reaches, so its regret is bit for bit the
  one-shot regret in f64.  ``StreamingGame`` has the same cum loss and
  comparator action bit for bit; its replayed comparator loss sums each
  chunk with ``torch.sum`` (as the JAX package's ``jnp.sum`` does), another
  order than the one-shot's running sum, hence a 1e-12 bound on its regret.
- Against the JAX ``StreamingGame`` in x64: 1e-9.
- Against the JAX ``StreamingKernelGame`` in interpret mode, f32: 5e-4
  (the TPU kernel folds the FTRL projection into ``rsqrt(max(.., 1))``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from online_convex_optimization_tpu.models.linear import (
    simulate_linear_batch as jax_simulate_linear_batch,
)
from online_convex_optimization_tpu.models.streaming import (
    StreamingGame as JaxStreamingGame,
    StreamingKernelGame as JaxStreamingKernelGame,
)
from online_convex_optimization_tpu_torch.models.linear import (
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingGame,
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.ops import game
from online_convex_optimization_tpu_torch.testing.from_jax import (
    stream_carry_from_jax,
)
from online_convex_optimization_tpu_torch.utils.checkpointing import (
    load_pytree,
    save_pytree,
)

torch.set_num_threads(1)

X64_TOL = 1e-9
F32_TOL = 5e-4
REPLAY_SUM_TOL = 1e-12
ETA = math.sqrt(2.0)


def _contract_batch(B, T, d=5, seed=0, dtype=np.float64):
    """Rows clipped into the unit ball, labels +-1: the identity contract."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return z.astype(dtype), y.astype(dtype)


def _chunks(z, y, bounds):
    """Time-major ``(CT, B, d)`` / ``(CT, B)`` chunks between the bounds."""
    ztm, ytm = z.transpose(1, 0, 2), y.T
    return [(ztm[lo:hi], ytm[lo:hi]) for lo, hi in zip(bounds, bounds[1:])]


def _one_shot(z, y, alg_flag, eta):
    zt = torch.as_tensor(z)
    return simulate_linear_batch(zt, torch.as_tensor(y), alg_flag, eta)


# ------------------------------------------- against the one-shot simulator

@pytest.mark.parametrize("alg_flag", [0, 1])
def test_kernel_game_chunked_equals_one_shot_bitwise(alg_flag):
    z, y = _contract_batch(24, 90, seed=1)
    kg = StreamingKernelGame(24, 5, alg_flag=alg_flag, eta0=ETA,
                             dtype=torch.float64, device="cpu")
    for zc, yc in _chunks(z, y, (0, 32, 64, 90)):
        kg.feed(zc, yc)
    assert kg.t == 90
    got, want = kg.result(), _one_shot(z, y, alg_flag, ETA)
    assert torch.equal(got.regret, want.regret)
    assert torch.equal(got.cum_loss, want.cum_loss)
    assert torch.equal(got.comp_loss, want.comp_loss)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_streaming_game_replay_matches_one_shot(alg_flag):
    z, y = _contract_batch(20, 80, seed=2)
    sg = StreamingGame(20, 5, alg_flag=alg_flag, eta0=ETA, dtype=torch.float64, device="cpu")
    feed = _chunks(z, y, (0, 40, 80))
    for zc, yc in feed:
        sg.feed(zc, yc)
    got, want = sg.result(feed), _one_shot(z, y, alg_flag, ETA)
    assert torch.equal(got.cum_loss, want.cum_loss)
    np.testing.assert_allclose(got.regret.numpy(), want.regret.numpy(),
                               rtol=0, atol=REPLAY_SUM_TOL)


def test_d8_odd_chunk_lengths():
    z, y = _contract_batch(16, 70, d=8, seed=31)
    kg = StreamingKernelGame(16, 8, eta0=1.3, dtype=torch.float64, device="cpu")
    for zc, yc in _chunks(z, y, (0, 25, 70)):       # chunks of 25 and 45 rows
        kg.feed(zc, yc)
    got = kg.result()
    assert torch.equal(got.regret, _one_shot(z, y, 0, 1.3).regret)
    want = jax_simulate_linear_batch(jnp.asarray(z), jnp.asarray(y), 0, 1.3)
    np.testing.assert_allclose(got.regret.numpy(), np.asarray(want.regret),
                               rtol=0, atol=X64_TOL)


def test_zero_sequences_stay_inert():
    z, y = _contract_batch(6, 40, seed=5)
    z[2], y[2] = 0.0, 0.0                    # an all-zero padding sequence
    kg = StreamingKernelGame(6, 5, eta0=ETA, dtype=torch.float64,
                             validate=True, device="cpu")
    for zc, yc in _chunks(z, y, (0, 17, 40)):
        kg.feed(zc, yc)
    for t in kg.carry:
        assert float(t[..., 2].abs().max()) == 0.0
    res = kg.result()
    assert float(res.regret[2]) == 0.0
    # The one-shot simulator scores a batch holding a y = 0 row by replay,
    # so the other sequences are held against it without the zero one.
    keep = [0, 1, 3, 4, 5]
    assert torch.equal(res.regret[keep],
                       _one_shot(z[keep], y[keep], 0, ETA).regret)


# ---------------------------------------------------- against the JAX package

@pytest.mark.parametrize("alg_flag", [0, 1])
def test_matches_jax_streaming_game_x64(alg_flag):
    z, y = _contract_batch(12, 75, seed=3)
    feed = _chunks(z, y, (0, 30, 60, 75))
    jg = JaxStreamingGame(12, 5, alg_flag=alg_flag, eta0=ETA,
                          dtype=jnp.float64)
    sg = StreamingGame(12, 5, alg_flag=alg_flag, eta0=ETA, dtype=torch.float64, device="cpu")
    kg = StreamingKernelGame(12, 5, alg_flag=alg_flag, eta0=ETA,
                             dtype=torch.float64, device="cpu")
    for zc, yc in feed:
        jg.feed(zc, yc)
        sg.feed(zc, yc)
        kg.feed(zc, yc)
    want = jg.result(feed)
    for got in (sg.result(feed), kg.result()):
        for field in ("regret", "cum_loss", "comp_loss", "x_last"):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)),
                                       rtol=0, atol=X64_TOL)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_matches_jax_kernel_game_interpret_f32(alg_flag):
    z, y = _contract_batch(40, 64, seed=4, dtype=np.float32)
    feed = _chunks(z, y, (0, 32, 64))
    jg = JaxStreamingKernelGame(40, 5, alg_flag=alg_flag, eta0=1.3,
                                interpret=True)
    kg = StreamingKernelGame(40, 5, alg_flag=alg_flag, eta0=1.3, device="cpu")
    for zc, yc in feed:
        jg.feed(zc, yc)
        kg.feed(zc, yc)
    got, want = kg.result(), jg.result()
    assert got.regret.dtype == torch.float32
    for field in ("regret", "cum_loss", "comp_loss"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=F32_TOL)


def test_carry_from_jax_finishes_in_the_port():
    B = 72                                   # not a multiple of 1,024 lanes
    z, y = _contract_batch(B, 64, seed=6, dtype=np.float32)
    first, second = _chunks(z, y, (0, 32, 64))
    jg = JaxStreamingKernelGame(B, 5, eta0=1.1, interpret=True)
    jg.feed(*first)
    saved = jg.carry_state()
    kg = StreamingKernelGame(B, 5, eta0=1.1, device="cpu")
    kg.resume(stream_carry_from_jax(saved, B))
    assert kg.t == 32
    jg.feed(*second)
    kg.feed(*second)
    got, want = kg.result(), jg.result()
    for field in ("regret", "cum_loss", "comp_loss"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=F32_TOL)


# ------------------------------------------------ checkpoint, stacks, validate

@pytest.mark.parametrize("cls", [StreamingKernelGame, StreamingGame])
def test_checkpoint_resume_is_bitwise(tmp_path, cls):
    z, y = _contract_batch(16, 96, seed=22)
    feed = _chunks(z, y, (0, 32, 64, 96))
    full = cls(16, 5, eta0=0.9, dtype=torch.float64, device="cpu")
    for zc, yc in feed:
        full.feed(zc, yc)
    first = cls(16, 5, eta0=0.9, dtype=torch.float64, device="cpu")
    for zc, yc in feed[:2]:
        first.feed(zc, yc)
    path = str(tmp_path / "ckpt" / "carry.npz")
    save_pytree(path, first.carry_state())
    second = cls(16, 5, eta0=0.9, dtype=torch.float64, device="cpu")
    second.resume(load_pytree(path))
    assert second.t == 64
    second.feed(*feed[2])
    for a, b in zip(second.carry, full.carry):
        assert torch.equal(a, b)
    assert second.t == full.t


def test_resume_rejects_a_carry_of_another_shape():
    kg = StreamingKernelGame(8, 5, device="cpu")
    state = StreamingKernelGame(9, 5, device="cpu").carry_state()
    with pytest.raises(ValueError, match="theta"):
        kg.resume(state)


def test_feed_many_packed_equals_sequential_feeds():
    z, y = _contract_batch(16, 96, seed=41, dtype=np.float32)
    ztm = torch.as_tensor(z).permute(1, 2, 0).contiguous()   # (T, d, B)
    ytm = torch.as_tensor(y).t().contiguous()
    a = StreamingKernelGame(16, 5, eta0=1.2, device="cpu")
    for c in range(0, 96, 32):
        a.feed_packed(ztm[c:c + 32], ytm[c:c + 32])
    b = StreamingKernelGame(16, 5, eta0=1.2, device="cpu")
    b.feed_many_packed(ztm.reshape(3, 32, 5, 16), ytm.reshape(3, 32, 16))
    assert a.t == b.t == 96
    for u, v in zip(a.carry, b.carry):
        assert torch.equal(u, v)
    many = game.play_stream_many(ztm.reshape(3, 32, 5, 16),
                                 ytm.reshape(3, 32, 16), 1.2, 0,
                                 game.zero_stream_carry(16, 5, device="cpu"))
    assert torch.equal(game.stream_result(many)[0], a.result().regret)


def test_validate_rejects_rows_outside_the_contract():
    z, y = _contract_batch(8, 32, seed=23)
    (zc, yc), = _chunks(z, y, (0, 32))
    kg = StreamingKernelGame(8, 5, dtype=torch.float64, validate=True, device="cpu")
    with pytest.raises(ValueError, match="unit L2 ball"):
        kg.feed(3.0 * zc, yc)
    with pytest.raises(ValueError, match="labels"):
        kg.feed(zc, 0.5 * yc)
    y_zero = yc.copy()
    y_zero[4, 3] = 0.0                       # label 0 on a non-zero row
    with pytest.raises(ValueError, match="labels"):
        kg.feed(zc, y_zero)
    assert kg.t == 0                          # nothing was played
    loose = StreamingKernelGame(8, 5, dtype=torch.float64, device="cpu")
    loose.feed(3.0 * zc, yc)                  # without validate: caller's
    assert loose.t == 32


def test_feed_many_packed_validates_every_chunk_before_playing():
    z, y = _contract_batch(8, 64, seed=24)
    ztm = torch.as_tensor(z).permute(1, 2, 0).contiguous()   # (T, d, B)
    ytm = torch.as_tensor(y).t().contiguous()
    z_stack = ztm.reshape(2, 32, 5, 8).clone()
    z_stack[1, 7] *= 3.0                      # second chunk leaves the ball
    kg = StreamingKernelGame(8, 5, dtype=torch.float64, validate=True, device="cpu")
    with pytest.raises(ValueError, match="unit L2 ball"):
        kg.feed_many_packed(z_stack, ytm.reshape(2, 32, 8))
    assert kg.t == 0                          # not even the first chunk
    assert all(not bool(t.any()) for t in kg.carry)
    kg.feed_many_packed(ztm.reshape(2, 32, 5, 8), ytm.reshape(2, 32, 8))
    assert kg.t == 64


def test_play_stream_checks_its_carry():
    carry = game.zero_stream_carry(4, 5, torch.float64, device="cpu")
    z = torch.zeros((3, 5, 4), dtype=torch.float64)
    y = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="carry"):
        game.play_stream(z, y, 1.0, 0, game.zero_stream_carry(4, 6,
                                                              torch.float64, device="cpu"))
    with pytest.raises(ValueError, match="carry"):
        game.play_stream(z.float(), y.float(), 1.0, 0, carry)
    with pytest.raises(ValueError, match="t0"):
        game.play_stream(z, y, 1.0, -1, carry)
    with pytest.raises(TypeError):
        game.zero_stream_carry(4, 5, torch.float16, device="cpu")


def test_play_stream_round_index_is_global():
    """Row k of a chunk is round t0 + k + 1: playing rows [32, 64) from the
    carry after [0, 32) equals the one-pass plain version over [0, 64)."""
    z, y = _contract_batch(10, 64, seed=7)
    ztm = torch.as_tensor(z).permute(1, 2, 0).contiguous()
    ytm = torch.as_tensor(y).t().contiguous()
    carry = game.zero_stream_carry(10, 5, torch.float64, device="cpu")
    whole = game.play_stream(ztm, ytm, ETA, 0, carry)
    half = game.play_stream(ztm[:32], ytm[:32], ETA, 0, carry)
    rest = game.play_stream(ztm[32:], ytm[32:], ETA, 32, half)
    for a, b in zip(rest, whole):
        assert torch.equal(a, b)
    off = game.play_stream(ztm[32:], ytm[32:], ETA, 0, half)
    assert not torch.equal(off.cum, whole.cum)
