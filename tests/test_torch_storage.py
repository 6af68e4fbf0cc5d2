"""Narrow storage of the hinge-game kernels K1-K6 (bf16 z, int8 or bf16 y,
float32 z with int8 y), as the JAX package stores them
(``pack_sequences(dtype, y_dtype=)``, ``StreamingKernelGame(dtype=)``).

- The port's entries on the same stored values as the JAX entries, at one
  bf16 tile of the JAX packing (B = 2048), T = 16, d = 5 (and d = 3, and
  d = 130 through the JAX VMEM-state kernels), JAX in interpret mode:
  atol 2e-4 for the packed game (tests/test_torch_packed.py's bound),
  5e-4 elsewhere (tests/test_pallas_game_v2.py's bf16 bound).
- Every narrow pair in the port equals the float32 run on the upcast
  values in every bit (the kernels convert on read; the CPU wrappers
  upcast), outputs in float32.
- ``in_contract`` forms bf16 rows' norms in float32: rows that rounding put
  past the ball are scored by replay, the golden regret of the stored
  values.
- The bf16 device generators keep every stored row's float32 norm at most 1.
- Pairs outside ``game.STORAGE`` raise ``TypeError``.

The CUDA instances are held to the same by tests/test_torch_cuda.py and
chip_smoke.py phase 13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.models.streaming import (
    StreamingKernelGame as JaxStreamingKernelGame,
)
from online_convex_optimization_tpu.ops import pallas_game as jpg
from online_convex_optimization_tpu.ops import pallas_smart as jps
from online_convex_optimization_tpu_torch.data import device
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingGame,
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.testing.from_jax import (
    stream_carry_from_jax,
    to_torch,
)
from online_convex_optimization_tpu_torch.testing.golden import (
    golden_simulate_alg,
)

torch.set_num_threads(1)

PACKED_TOL = 2e-4
F32_TOL = 5e-4
B_TILE = jpg.LANES * jpg.SUBLANES_BF16      # 2048: one bf16 tile
ETA = 1.3
# (JAX z, JAX y, port z, port y) for each new storage pair.
PAIRS = {
    "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16, torch.bfloat16),
    "bf16i8": (jnp.bfloat16, jnp.int8, torch.bfloat16, torch.int8),
    "f32i8": (jnp.float32, jnp.int8, torch.float32, torch.int8),
}


def _batch(B, T, d, seed):
    """Rows inside the ball by a margin that bf16 rounding cannot cross
    (the port's bf16 deflation), labels +-1, float32."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z *= (1.0 - 2.0 ** -8) / np.maximum(
        1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return z.astype(np.float32), y.astype(np.float32)


def _stored(name, z, y):
    """The batch packed as JAX stores it and the same stored values in the
    port's (B, T, d) layout, carried across bit for bit."""
    jz, jy, _, _ = PAIRS[name]
    zp, yp, B = jpg.pack_sequences(jnp.asarray(z), jnp.asarray(y), jz,
                                   y_dtype=jy)
    zs = np.asarray(jnp.asarray(z).astype(jz))
    ys = np.asarray(jnp.asarray(y).astype(jy))
    zt, yt = to_torch((zs, ys), "cpu")
    assert (zt.dtype, yt.dtype) == PAIRS[name][2:]
    return zp, yp, B, zt, yt


def _unpack(a, B):
    return np.asarray(jpg.unpack_result(a, B))


def _unpack_theta(theta, B):
    return np.stack([_unpack(theta[j], B) for j in range(theta.shape[0])])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=0,
                               atol=tol)


# -------------------------------------------- the port against the JAX kernels

@pytest.mark.parametrize("name", PAIRS)
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_k1_regrets_fused_matches_jax(name, alg_flag):
    z, y = _batch(B_TILE, 16, 5, 1 + alg_flag)
    zp, yp, B, zt, yt = _stored(name, z, y)
    want = _unpack(jpg.regrets_fused(zp, yp, ETA, alg_flag=alg_flag,
                                     interpret=True), B)
    cum, comp, _ = game.regrets_fused(zt, yt, alg_flag, ETA)
    assert cum.dtype == torch.float32
    _close(cum - comp, want, F32_TOL)
    cum, comp, _ = game.regret_plays(
        zt, yt, (alg_flag,), ETA, game.per_sequence_lengths(None, B, 16, "cpu"),
        False)
    _close(cum[0] - comp[0], want, F32_TOL)


@pytest.mark.parametrize("name", PAIRS)
def test_k2_smart_matches_jax(name):
    z, y = _batch(B_TILE, 16, 5, 3)
    zp, yp, B, zt, yt = _stored(name, z, y)
    S = zp.shape[2]
    thresh = np.linspace(0.5, 4.0, B).astype(np.float32)
    reg, tau = jps.smart_regrets_packed(
        zp, yp, jpg.pack_per_seq(jnp.asarray(thresh), S),
        jpg.pack_per_seq(jnp.full((B,), 1.2, jnp.float32), S),
        interpret=True)
    cum, comp, _, t = smart.smart_regrets(zt, yt, torch.from_numpy(thresh),
                                          1.2)
    _close(cum - comp, _unpack(reg, B), F32_TOL)
    np.testing.assert_array_equal(t.numpy(), _unpack(tau, B).astype(np.int64))
    # The evaluation's entry: G = 2 thresholds a sequence.
    two = torch.stack([torch.from_numpy(thresh), torch.full((B,), 2.0)])
    cum2, comp2, _, t2 = smart.smart_plays(
        zt, yt, two, 1.2, game.per_sequence_lengths(None, B, 16, "cpu"),
        False)
    assert torch.equal(cum2[0], cum) and torch.equal(t2[0], t)


@pytest.mark.parametrize("name", PAIRS)
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_k3_play_packed_matches_jax(name, alg_flag):
    z, y = _batch(B_TILE, 16, 5, 5 + alg_flag)
    zp, yp, B, zt, yt = _stored(name, z, y)
    scales = jpg.ftrl_scales(16, ETA)
    cum_j, th_j = jpg.play_packed(zp, yp, scales, alg_flag=alg_flag,
                                  interpret=True)
    reg_j = jpg.regrets_packed(zp, yp, scales, alg_flag=alg_flag,
                               interpret=True)
    z_tm, y_tm = game.time_major(zt, yt)
    sc = torch.from_numpy(np.asarray(scales))
    cum, theta = game.play_packed(z_tm, y_tm, sc, alg_flag=alg_flag)
    assert cum.dtype == theta.dtype == torch.float32
    _close(cum, _unpack(cum_j, B), PACKED_TOL)
    _close(theta, _unpack_theta(th_j, B), PACKED_TOL)
    _close(game.regrets_packed(z_tm, y_tm, sc, alg_flag=alg_flag),
           _unpack(reg_j, B), PACKED_TOL)
    _close(game.simulate_linear_packed(zt, yt, alg_flag, ETA),
           _unpack(reg_j, B), PACKED_TOL)


@pytest.mark.parametrize("name", PAIRS)
def test_k3e_play_packed_eta_matches_jax(name):
    z, y = _batch(B_TILE, 16, 5, 7)
    zp, yp, B, zt, yt = _stored(name, z, y)
    etas = np.linspace(0.2, 3.0, B).astype(np.float32)
    eta_pack = jpg.pack_per_seq(jnp.asarray(etas), zp.shape[2])
    cum_j, th_j = jpg.play_packed_eta(zp, yp, eta_pack, interpret=True)
    reg_j = jpg.regrets_packed_eta(zp, yp, eta_pack, interpret=True)
    z_tm, y_tm = game.time_major(zt, yt)
    et = torch.from_numpy(etas)
    cum, theta = game.play_packed_eta(z_tm, y_tm, et)
    _close(cum, _unpack(cum_j, B), PACKED_TOL)
    _close(theta, _unpack_theta(th_j, B), PACKED_TOL)
    _close(game.regrets_packed_eta(z_tm, y_tm, et), _unpack(reg_j, B),
           PACKED_TOL)
    _close(game.simulate_linear_auto(zt, yt, 0, et), _unpack(reg_j, B),
           PACKED_TOL)


@pytest.mark.parametrize("name", PAIRS)
def test_k5_eta_sweep_matches_jax(name):
    z, y = _batch(B_TILE, 16, 5, 9)
    zp, yp, B, zt, yt = _stored(name, z, y)
    grid = np.asarray([0.3, 1.0, 1.3, 2.5], dtype=np.float32)
    want = np.asarray(jpg.eta_sweep_packed(zp, yp, jnp.asarray(grid),
                                           interpret=True))
    got = game.eta_sweep(zt, yt, torch.from_numpy(grid))
    for e in range(len(grid)):
        _close(got[:, e], _unpack(want[e], B), F32_TOL)
    _close(ftrl_eta_sweep(zt, yt, grid), got, 0.0)


@pytest.mark.parametrize("name", PAIRS)
def test_k6_smart_sweep_matches_jax(name):
    z, y = _batch(B_TILE, 16, 5, 11)
    zp, yp, B, zt, yt = _stored(name, z, y)
    grid = np.asarray([0.5, 1.5, 3.0], dtype=np.float32)
    reg_j, tau_j = jps.smart_sweep_packed(zp, yp, jnp.asarray(grid), 1.2,
                                          interpret=True)
    reg, tau = smart.smart_sweep(zt, yt, torch.from_numpy(grid), 1.2)
    for g in range(len(grid)):
        _close(reg[:, g], _unpack(np.asarray(reg_j)[g], B), F32_TOL)
        np.testing.assert_array_equal(
            tau[:, g].numpy(),
            _unpack(np.asarray(tau_j)[g], B).astype(np.int64))
    _close(smart_threshold_sweep(zt, yt, grid, eta0=1.2), reg, 0.0)


def test_k4_bf16_stream_matches_jax_and_resumes_from_it():
    """StreamingKernelGame(dtype=bf16) in both packages on the same chunks;
    a JAX game's carry after the first chunk (16 sublanes) finishes in the
    port with the JAX game's result."""
    B, T, d = B_TILE, 32, 5
    z, y = _batch(B, T, d, 13)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    jgame = JaxStreamingKernelGame(B, d, eta0=1.2, dtype=jnp.bfloat16,
                                   interpret=True)
    jgame.feed(ztm[:16], ytm[:16])
    saved = jgame.carry_state()
    jgame.feed(ztm[16:], ytm[16:])
    want = np.asarray(jgame.result().regret)
    for y_dtype in (torch.bfloat16, torch.int8):
        pgame = StreamingKernelGame(B, d, eta0=1.2, dtype=torch.bfloat16,
                                    y_dtype=y_dtype, device="cpu",
                                    validate=True)
        pgame.feed(ztm[:16], ytm[:16])
        pgame.feed(ztm[16:], ytm[16:])
        assert pgame.carry.cum.dtype == torch.float32
        _close(pgame.result().regret, want, F32_TOL)
        resumed = StreamingKernelGame(B, d, eta0=1.2, dtype=torch.bfloat16,
                                      y_dtype=y_dtype, device="cpu")
        resumed.resume(stream_carry_from_jax(saved, B))
        assert resumed.t == 16
        resumed.feed(ztm[16:], ytm[16:])
        _close(resumed.result().regret, want, F32_TOL)


@pytest.mark.parametrize("d", [3, 130])
def test_other_d_match_jax(d):
    """bf16 z, int8 y at d = 3 (register-state) and d = 130 (the JAX
    VMEM-state d-loop kernels): K1 and K3."""
    T = 16 if d == 3 else 8
    z, y = _batch(B_TILE, T, d, 15 + d)
    zp, yp, B, zt, yt = _stored("bf16i8", z, y)
    want = _unpack(jpg.regrets_fused(zp, yp, ETA, interpret=True), B)
    cum, comp, _ = game.regrets_fused(zt, yt, 0, ETA)
    _close(cum - comp, want, F32_TOL)
    scales = jpg.ftrl_scales(T, ETA)
    cum_j, _ = jpg.play_packed(zp, yp, scales, interpret=True)
    z_tm, y_tm = game.time_major(zt, yt)
    cum, _ = game.play_packed(z_tm, y_tm, torch.from_numpy(np.asarray(scales)))
    _close(cum, _unpack(cum_j, B), PACKED_TOL)


# ------------------------------------- every pair against f32 on upcast values

def _entries(z, y, lengths):
    """Every storage entry of the slice on one (B, T, d) batch; each
    returns a tuple of tensors."""
    B, T, d = z.shape
    z_tm, y_tm = game.time_major(z, y)
    flags = torch.arange(B) % 2
    etas = torch.linspace(0.3, 2.5, B)
    thr = torch.linspace(0.5, 6.0, B)
    carry = game.zero_stream_carry(B, d, device="cpu")
    return {
        "regrets_fused": lambda: game.regrets_fused(z, y, flags, etas,
                                                    lengths),
        "regret_plays": lambda: game.regret_plays(z, y, (0, 1), ETA, lengths,
                                                  True),
        "smart_regrets": lambda: smart.smart_regrets(z, y, thr, 1.2,
                                                     lengths),
        "smart_plays": lambda: smart.smart_plays(
            z, y, torch.stack([thr, thr + 1.0]), 1.2, lengths, False),
        "play_packed": lambda: game.play_packed(
            z_tm, y_tm, game.ftrl_scales(T, ETA, device="cpu")),
        "play_packed_ftl": lambda: game.play_packed(
            z_tm, y_tm, game.ftrl_scales(T, ETA, device="cpu"), alg_flag=1),
        "regrets_packed": lambda: (game.regrets_packed(
            z_tm, y_tm, game.ftrl_scales(T, ETA, device="cpu")),),
        "play_packed_eta": lambda: game.play_packed_eta(z_tm, y_tm, etas),
        "regrets_packed_eta": lambda: (game.regrets_packed_eta(
            z_tm, y_tm, etas),),
        "simulate_linear_auto": lambda: (game.simulate_linear_auto(
            z, y, 1, ETA),),
        "play_stream": lambda: game.play_stream(z_tm, y_tm, etas, 7, carry,
                                                alg_flag=flags),
        "play_stream_many": lambda: game.play_stream_many(
            z_tm.reshape(2, T // 2, d, B), y_tm.reshape(2, T // 2, B), ETA,
            3, carry),
        "eta_sweep": lambda: (game.eta_sweep(z, y, [0.5, 1.3, 2.0],
                                             lengths),),
        "smart_sweep": lambda: smart.smart_sweep(z, y, [0.5, 2.0, 5.0], 1.2,
                                                 lengths),
    }


@pytest.mark.parametrize("name", PAIRS)
@pytest.mark.parametrize("d", [3, 5, 130])
def test_pairs_equal_f32_on_upcast_values(name, d):
    B, T = 48, 32
    z, y = _batch(B, T, d, 20 + d)
    _, _, tz, ty = PAIRS[name]
    zs, ys = torch.from_numpy(z).to(tz), torch.from_numpy(y).to(ty)
    lengths = torch.from_numpy(
        np.random.default_rng(d).integers(1, T + 1, size=B)).int()
    narrow = _entries(zs, ys, lengths)
    wide = _entries(zs.float(), ys.float(), lengths)
    for entry, fn in narrow.items():
        got, want = fn(), wide[entry]()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), entry
            if a.is_floating_point():
                assert a.dtype == torch.float32, entry


@pytest.mark.parametrize("name", PAIRS)
def test_streaming_games_store_and_replay_narrow(name):
    """The streaming games store the chunks in their pair and play what is
    stored: equal to the f32 games fed the upcast chunks, carries in f32;
    StreamingGame's replay scores the stored rows."""
    B, T, d = 40, 24, 5
    z, y = _batch(B, T, d, 31)
    _, _, tz, ty = PAIRS[name]
    ztm, ytm = z.transpose(1, 0, 2), y.T
    zr = torch.from_numpy(ztm).to(tz).float().numpy()
    for cls in (StreamingKernelGame, StreamingGame):
        a = cls(B, d, eta0=1.2, dtype=tz, y_dtype=ty, device="cpu")
        b = cls(B, d, eta0=1.2, device="cpu")
        for c in range(0, T, 8):
            a.feed(ztm[c:c + 8], ytm[c:c + 8])
            b.feed(zr[c:c + 8], ytm[c:c + 8])
        assert all(torch.equal(u, v) for u, v in zip(a.carry, b.carry))
        assert a.carry.theta.dtype == torch.float32
        ra = (a.result() if cls is StreamingKernelGame
              else a.result([(ztm, ytm)]))
        rb = (b.result() if cls is StreamingKernelGame
              else b.result([(zr, ytm)]))
        assert torch.equal(ra.regret, rb.regret)
    a = StreamingKernelGame(B, d, dtype=tz, y_dtype=ty, device="cpu")
    a.feed_packed(*game.time_major(torch.from_numpy(z).to(tz),
                                   torch.from_numpy(y).to(ty)))
    saved = a.carry_state()
    c = StreamingKernelGame(B, d, dtype=tz, y_dtype=ty, device="cpu")
    c.resume(saved)
    assert all(torch.equal(u, v) for u, v in zip(a.carry, c.carry))


# ---------------------------------------------------- the comparator's contract

def _rows_just_past_the_ball(n, d, seed):
    """Unit rows (float64 norm 1 - 1e-7) whose bf16 rounding puts their
    float32 squared norm above 1 + CONTRACT_TOL."""
    rng = np.random.default_rng(seed)
    rows = []
    while len(rows) < n:
        v = rng.normal(size=(4096, d))
        v *= (1.0 - 1e-7) / np.linalg.norm(v, axis=-1, keepdims=True)
        r = torch.from_numpy(v).to(torch.bfloat16)
        nsq = (r.float() ** 2).sum(-1)
        rows.extend(r[nsq > 1.0 + 2 * game.CONTRACT_TOL])
    return torch.stack(rows[:n])


def test_in_contract_sees_bf16_rows_past_the_ball():
    B, T, d = 6, 20, 5
    z = _rows_just_past_the_ball(B * T, d, 40).reshape(B, T, d)
    y = torch.from_numpy(np.where(
        np.random.default_rng(41).random((B, T)) < 0.5, -1, 1)).to(torch.int8)
    lengths = game.per_sequence_lengths(None, B, T, "cpu")
    # The rounded rows lie outside the ball in float32; in bf16 arithmetic
    # the norm rounds to 1 and the check would pass.
    assert not game.in_contract(z, y, lengths)
    assert bool((torch.linalg.vector_norm(z, dim=-1) ** 2 <= 1.0).all())
    for flag in (0, 1):
        cum, comp, _ = game.regrets_fused(z, y, flag, ETA)
        want = [golden_simulate_alg(z[b].double().numpy(),
                                    y[b].double().numpy(), flag, ETA)
                for b in range(B)]
        _close(cum - comp, want, F32_TOL)
    # Inside the ball by the generators' margin, the same rows are in it.
    inside = (z.float() * (1.0 - 2.0 ** -8)).to(torch.bfloat16)
    assert game.in_contract(inside, y, lengths)


# ----------------------------------------------------------- the generators

def test_bf16_generators_keep_rows_in_the_ball():
    gen = torch.Generator().manual_seed(50)
    B, T, d = 400, 256, 5                       # 102,400 rows each
    z, y = device.random_game_batch(gen, B, T, d, dtype=torch.bfloat16,
                                    y_dtype=torch.int8)
    zs, ys, u = device.separable_stream_batch(
        gen, B, T, d, 0.1, dtype=torch.bfloat16, y_dtype=torch.int8)
    z_tm, y_tm = device.random_time_major_batch(gen, T, B, d,
                                                dtype=torch.bfloat16)
    lengths = game.per_sequence_lengths(None, B, T, "cpu")
    for zz, yy, dim in ((z, y, -1), (zs, ys, -1), (z_tm, y_tm, 1)):
        assert zz.dtype == torch.bfloat16 and zz.numel() // d >= 100_000
        nsq = torch.sum(zz.float() ** 2, dim=dim)
        assert float(nsq.max()) <= 1.0
        assert bool((yy.abs() == 1).all())
    assert y.dtype == ys.dtype == torch.int8 and y_tm.dtype == torch.bfloat16
    assert game.in_contract(z, y, lengths)
    assert game.in_contract(zs, ys, lengths)
    # The bf16 rows are rounded from the float32 draw: most stay near the
    # ball's surface (the clip) and none leaves it.
    assert float(torch.sum(z.float() ** 2, -1).max()) > 0.99
    # Separable labels are those of the stored rows (before the flips).
    zc, yc, uc = device.separable_stream_batch(
        torch.Generator().manual_seed(51), 64, 32, d, dtype=torch.bfloat16,
        y_dtype=torch.int8)
    q = (zc.float() * uc[:, None, :]).sum(-1)
    assert torch.equal(yc, torch.where(q >= 0, 1, -1).to(torch.int8))


def test_f32_generators_unchanged_by_the_storage_arguments():
    for fn, args in ((device.random_game_batch, (3, 7, 5)),
                     (device.random_time_major_batch, (7, 3, 5))):
        a = fn(torch.Generator().manual_seed(3), *args)
        b = fn(torch.Generator().manual_seed(3), *args,
               dtype=torch.float32, y_dtype=torch.float32)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


# ------------------------------------------------------------ refused pairs

@pytest.mark.parametrize("z_dtype,y_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16), (torch.float64, torch.float32),
    (torch.float64, torch.int8)])
def test_unsupported_pairs_raise(z_dtype, y_dtype):
    z = torch.zeros((4, 6, 5), dtype=z_dtype)
    y = torch.ones((4, 6), dtype=y_dtype)
    with pytest.raises(TypeError, match=r"\(bfloat16, int8\)"):
        game.regrets_fused(z, y, 0, ETA)
    with pytest.raises(TypeError, match="unsupported storage"):
        smart.smart_regrets(z, y, 1.0, ETA)
    with pytest.raises(TypeError, match="unsupported storage"):
        game.play_packed(*game.time_major(z, y), torch.ones(6))
    with pytest.raises(TypeError, match="unsupported storage"):
        StreamingKernelGame(4, 5, dtype=z_dtype, y_dtype=y_dtype,
                            device="cpu")
    with pytest.raises(TypeError, match="unsupported storage"):
        device.random_game_batch(torch.Generator(), 4, 6, dtype=z_dtype,
                                 y_dtype=y_dtype)


def test_storage_table_and_compute_dtype():
    assert game.STORAGE[(torch.bfloat16, torch.int8)] == "bf16i8"
    assert game.compute_dtype(torch.zeros(1, dtype=torch.bfloat16)) \
        == torch.float32
    assert game.compute_dtype(torch.float64) == torch.float64
    # The envelope holds bf16 z and refuses float16.
    assert game.kernel_envelope(131_072, 1024, 5, torch.bfloat16) is None
    assert game.kernel_envelope(8, 8, 5, torch.float16) is not None


def test_to_torch_carries_bf16_bit_for_bit():
    vals = np.asarray(jnp.asarray(np.linspace(-1, 1, 257, dtype=np.float32))
                      .astype(jnp.bfloat16))
    labels = np.asarray(jnp.asarray([1, -1, 0], jnp.int8))
    t, lab = to_torch((vals, labels), "cpu")
    assert t.dtype == torch.bfloat16 and lab.dtype == torch.int8
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  vals.view(np.int16))
    assert to_torch((vals,), "cpu", torch.float32)[0].dtype == torch.float32
