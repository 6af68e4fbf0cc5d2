"""The port past d = 512, where K1, K2 and K4 run their wide instances on
the card (K1w, K2w, K4w), against the JAX package's scans in x64.

The JAX package simulates any d with ``lax.scan``s (``models/linear.py``,
``models/smart.py``, ``models/streaming.py``), and its
``simulate_linear_auto`` routes past its kernel envelope to the linear
scan.  Here the port's plain versions (what its wrappers run on a CPU
tensor; the kernels equal them bit for bit on the card,
``tests/test_torch_cuda.py``) are held against them at d = 513 and 640, on
the same NumPy inputs, within 1e-9 (switch rounds equal); a streamed game
fed in chunks, and its checkpoint round trip bit for bit.  Also the host
arithmetic of the wide instances: the state buffer each launch needs and
which kernels take d past 512.
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
from online_convex_optimization_tpu.models.streaming import (
    StreamingGame as JaxStreamingGame,
)
from online_convex_optimization_tpu.ops.pallas_game import (
    simulate_linear_auto as jax_linear_auto,
)
from online_convex_optimization_tpu_torch.models import (
    simulate_linear_batch,
    simulate_smart_batch,
)
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingGame,
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.utils import cuda_build
from online_convex_optimization_tpu_torch.utils.checkpointing import (
    load_pytree,
    save_pytree,
)

torch.set_num_threads(1)

TOL = 1e-9
ETA = math.sqrt(2.0)
B, T = 8, 40


def _batch(d, seed, *, contract=True):
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


def _close(got, want, names):
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("d,contract", [(513, True), (640, True),
                                        (513, False)])
def test_linear_batch_matches_jax_scan(d, contract):
    z, y, lengths = _batch(d, seed=d, contract=contract)
    flags = np.arange(B) % 2
    eta = np.linspace(0.4, 2.2, B)
    got = simulate_linear_batch(torch.as_tensor(z), torch.as_tensor(y),
                                flags, torch.as_tensor(eta), lengths)
    want = jax_linear_batch(jnp.asarray(z), jnp.asarray(y),
                            jnp.asarray(flags), jnp.asarray(eta),
                            jnp.asarray(lengths))
    _close(got, want, ("cum_loss", "regret", "comp_loss", "x_last"))


@pytest.mark.parametrize("d", [513, 640])
def test_smart_batch_matches_jax_scan(d):
    z, y, lengths = _batch(d, seed=d + 1)
    # Thresholds some sequences pass early, some late and some never.
    thresh = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 1e6])
    got = simulate_smart_batch(torch.as_tensor(z), torch.as_tensor(y),
                               torch.as_tensor(thresh), ETA, lengths)
    want = jax_smart_batch(jnp.asarray(z), jnp.asarray(y),
                           jnp.asarray(thresh), ETA, jnp.asarray(lengths))
    _close(got, want, ("cum_loss", "regret", "comp_loss", "x_last"))
    np.testing.assert_array_equal(got.switch_t.numpy(),
                                  np.asarray(want.switch_t))
    switched = got.switch_t.numpy() < T
    assert switched.any() and not switched.all()


def _feed(z, y, bounds):
    ztm, ytm = z.transpose(1, 0, 2), y.T
    return [(ztm[lo:hi], ytm[lo:hi]) for lo, hi in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_streaming_game_matches_jax_scan(alg_flag):
    z, y, _ = _batch(513, seed=7 + alg_flag)
    feed = _feed(z, y, (0, 13, 27, T))
    jg = JaxStreamingGame(B, 513, alg_flag=alg_flag, eta0=ETA,
                          dtype=jnp.float64)
    sg = StreamingGame(B, 513, alg_flag=alg_flag, eta0=ETA,
                       dtype=torch.float64, device="cpu")
    kg = StreamingKernelGame(B, 513, alg_flag=alg_flag, eta0=ETA,
                             dtype=torch.float64, device="cpu")
    for zc, yc in feed:
        jg.feed(zc, yc)
        sg.feed(zc, yc)
        kg.feed(zc, yc)
    want = jg.result(feed)
    for got in (sg.result(feed), kg.result()):
        _close(got, want, ("regret", "cum_loss", "comp_loss", "x_last"))
    # Fed in chunks, the carry ends where the one-shot simulator's does.
    one = simulate_linear_batch(torch.as_tensor(z), torch.as_tensor(y),
                                alg_flag, ETA)
    assert torch.equal(kg.result().regret, one.regret)


@pytest.mark.parametrize("cls", [StreamingKernelGame, StreamingGame])
def test_stream_checkpoint_round_trip_is_bitwise(tmp_path, cls):
    z, y, _ = _batch(513, seed=11)
    feed = _feed(z, y, (0, 16, 29, T))
    full = cls(B, 513, eta0=0.9, dtype=torch.float64, device="cpu")
    for zc, yc in feed:
        full.feed(zc, yc)
    first = cls(B, 513, eta0=0.9, dtype=torch.float64, device="cpu")
    for zc, yc in feed[:2]:
        first.feed(zc, yc)
    path = str(tmp_path / "carry.npz")
    save_pytree(path, first.carry_state())
    second = cls(B, 513, eta0=0.9, dtype=torch.float64, device="cpu")
    second.resume(load_pytree(path))
    assert second.t == 29
    second.feed(*feed[2])
    for a, b in zip(second.carry, full.carry):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alg_flag,per_seq_eta", [(0, False), (1, False),
                                                  (0, True)])
def test_linear_auto_past_the_envelope_matches_jax(alg_flag, per_seq_eta):
    z, y, _ = _batch(513, seed=21 + alg_flag)
    eta = np.linspace(0.3, 2.5, B) if per_seq_eta else 1.3
    assert game.kernel_envelope(B, T, 513, torch.float64) is not None
    want = jax_linear_auto(jnp.asarray(z), jnp.asarray(y), alg_flag,
                           jnp.asarray(eta))
    eta_t = torch.as_tensor(eta) if per_seq_eta else eta
    got = game.simulate_linear_auto(torch.as_tensor(z), torch.as_tensor(y),
                                    alg_flag, eta_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    # Past the envelope the route is the simulator's (K1's).
    cum, comp, _ = game.regrets_fused(torch.as_tensor(z), torch.as_tensor(y),
                                      alg_flag, eta_t)
    assert torch.equal(got, cum - comp)


# ------------------------------------------------------ the host arithmetic

@pytest.mark.parametrize("d", [5, 64, 512])
def test_no_state_buffer_up_to_512(d):
    for kernel in game.WIDE_KERNELS:
        assert game.wide_state_elems(kernel, 1000, d, 4) == 0
        assert game.wide_state(kernel, 10, d, 2, torch.float64, "cpu") is None


@pytest.mark.parametrize("d", [513, 1024, 8192])
def test_state_buffer_sizes_past_512(d):
    # K1w: theta, w, x a play; K2w: theta, x for the FTL track and each
    # tail, w once; K4w: x (theta, w are the output carry).
    assert game.wide_state_elems("K1", 1024, d, 2) == 3 * d * 2 * 1024
    assert game.wide_state_elems("K1", 77, d, 1) == 3 * d * 77
    assert game.wide_state_elems("K2", 1024, d, 2) == 7 * d * 1024
    assert game.wide_state_elems("K2", 77, d, 4) == 11 * d * 77
    assert game.wide_state_elems("K4", 2048, d, 1) == d * 2048
    # The slots reach 2^31 elements at B = 262,144, d = 8,192: the kernels
    # index in 64 bits.
    assert game.wide_state_elems("K4", 262_144, 8192) == 2 ** 31
    buf = game.wide_state("K2", 3, d, 2, torch.float32, "cpu")
    assert buf.shape == (7 * d * 3,) and buf.dtype == torch.float32
    with pytest.raises(ValueError, match="K5 has no wide instance"):
        game.wide_state_elems("K5", 8, d)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4"])
def test_wide_kernels_take_any_d(kernel):
    for d in (1, 512, 513, 4096, 100_000):
        game.check_kernel_d(d, kernel)


@pytest.mark.parametrize("kernel", ["K3", "K3e", "K5", "K6a", "K6b", "K7"])
def test_other_kernels_refuse_d_past_512(kernel):
    game.check_kernel_d(cuda_build.MAX_D, kernel)
    with pytest.raises(ValueError,
                       match=f"kernel {kernel}'s limit d <= 512") as err:
        game.check_kernel_d(cuda_build.MAX_D + 1, kernel)
    assert "K1, K2, K4" in str(err.value)


def test_launchers_refuse_before_the_library():
    """Past 512 the still-limited launchers raise before they build or load
    the library (none exists here), naming their kernel."""
    z = torch.zeros((2, 4, 513), dtype=torch.float64)
    y = torch.ones((2, 4), dtype=torch.float64)
    lengths = torch.full((2,), 4, dtype=torch.int32)
    order = game.length_order(lengths)
    scales = game.sweep_scales(torch.ones(1, dtype=torch.float64), 4)
    z_tm, y_tm = game.time_major(z, y)
    calls = {
        "K5": lambda: game.launch_eta_sweep(z, y, scales, order, lengths,
                                            False),
        "K3": lambda: game.launch_play_packed(z_tm, y_tm, scales[0], 0),
        "K3e": lambda: game.launch_play_packed_eta(
            z_tm, y_tm, torch.ones(2, dtype=torch.float64)),
        "K7": lambda: game.launch_synthetic(0, 1.0, 4, 1, 513, 0,
                                            torch.device("cpu")),
        "K6a": lambda: smart.launch_smart_prefix(
            z, y, torch.ones((1, 2), dtype=torch.float64),
            torch.zeros((1, 2), dtype=torch.int32), order, lengths, False),
        "K6b": lambda: smart.launch_smart_tails(
            z, y, scales, order, lengths,
            torch.zeros((1, 2), dtype=torch.int64),
            torch.zeros(2, dtype=torch.float64),
            torch.zeros((1, 2), dtype=torch.float64)),
    }
    for kernel, call in calls.items():
        with pytest.raises(ValueError, match=f"kernel {kernel}'s limit"):
            call()
