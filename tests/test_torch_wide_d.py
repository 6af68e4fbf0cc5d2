"""The port past d = 512, where K1, K2 and K4 run their wide instances on
the card (K1w, K2w, K4w), against the JAX package's scans in x64 (the
sweeps, the packed game and K7 past 512: tests/test_torch_wide_d_sweeps.py).

The JAX package simulates any d with ``lax.scan``s (``models/linear.py``,
``models/smart.py``, ``models/streaming.py``), and its
``simulate_linear_auto`` routes past its kernel envelope to the linear
scan.  Here the port's plain versions (what its wrappers run on a CPU
tensor; the kernels equal them bit for bit on the card,
``tests/test_torch_cuda.py``) are held against them at d = 513 and 640, on
the same NumPy inputs, within 1e-9 (switch rounds equal); a streamed game
fed in chunks, and its checkpoint round trip bit for bit.  Also the host
arithmetic of the wide instances of all nine hinge kernel bodies: the
state buffer each launch needs, and each launcher handing the library any
d with that buffer (a stand-in library records the calls).
"""

import contextlib
import math
import types

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
def test_state_buffer_sizes_past_512(monkeypatch, d):
    # K1w, K2w and K4w: what the library's plans ask for, none where a
    # block's state fits shared memory, else the plays' thetas and w (K1w),
    # theta and w (K4w), or K2w's two launches' (its FTL track's theta and
    # w a sequence, then each tail's theta a (threshold, sequence) pair).
    up4 = -(-d // 4) * 4
    for shared in (True, False):
        _stand_in_plans(monkeypatch, shared)
        for B, plays in ((1024, 2), (77, 1), (77, 8)):
            assert game.wide_state_elems("K1", B, d, plays) == (
                0 if shared else (plays + 1) * up4 * B)
        assert game.wide_state_elems("K4", 2048, d, 1) == (
            0 if shared else 2 * up4 * 2048)
        for B, G in ((1024, 2), (77, 4)):
            assert game.wide_state_elems("K2", B, d, G) == (
                0 if shared else (2 + G) * up4 * B)
    # The slots reach 2^31 elements at B = 131,072, d = 8,192: the kernels
    # index in 64 bits.
    assert game.wide_state_elems("K4", 131_072, 8192) == 2 ** 31
    buf = game.wide_state("K2", 3, d, 2, torch.float32, "cpu")
    assert buf.shape == (4 * up4 * 3,) and buf.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown kernel K8"):
        game.wide_state_elems("K8", 8, d)


def _k7_plan(d, shared):
    """A stand-in for the library's K7w plan (``oco_synthetic_plan``): its
    state floats a sequence, theta and w (each padded to 4 floats) and the
    round's Philox words, or none where the lines fit shared memory."""
    state = 2 * (-(-d // 4) * 4) + 4 * (d // 128 + 1)
    return {"warps": 2, "smem_bytes": 0, "shared": shared,
            "state": 0 if shared else state, "max_shared_d": 0}


def _seq_plan(state, shared):
    """A stand-in for a warp-a-sequence plan (``oco_packed_plan``,
    ``oco_stream_plan``, ``oco_smart_prefix_plan``, ``oco_regret_plan``):
    ``state`` elements a sequence, or none where the sequence's state fits
    shared memory."""
    return {"warps": 8, "smem_bytes": 0, "shared": shared,
            "state": 0 if shared else state, "max_shared_d": 0}


def _k3_plan(d, shared):
    """K3w's and K3ew's: theta, padded to 4 elements; K6bw's the same a
    (threshold, sequence) pair."""
    return _seq_plan(-(-d // 4) * 4, shared)


def _k6a_plan(d, shared):
    """K6aw's and K4w's: theta and w, each padded to 4 elements."""
    return _seq_plan(2 * (-(-d // 4) * 4), shared)


def _k1_plan(d, plays, shared):
    """K1w's: the plays' thetas and the sequence's w, each padded to 4
    elements."""
    return _seq_plan((plays + 1) * (-(-d // 4) * 4), shared)


def _stand_in_plans(monkeypatch, shared):
    monkeypatch.setattr(game, "regret_plan",
                        lambda dd, plays, dtype=torch.float64: _k1_plan(
                            dd, plays, shared))
    monkeypatch.setattr(game, "stream_plan",
                        lambda dd, dtype=torch.float32: _k6a_plan(dd,
                                                                  shared))
    monkeypatch.setattr(game, "synthetic_plan",
                        lambda dd, alg_flag=0: _k7_plan(dd, shared))
    monkeypatch.setattr(game, "packed_plan",
                        lambda dd, dtype=torch.float32: _k3_plan(dd, shared))
    monkeypatch.setattr(game, "prefix_plan",
                        lambda dd, dtype=torch.float64: _k6a_plan(dd,
                                                                  shared))
    monkeypatch.setattr(game, "tail_plan",
                        lambda dd, dtype=torch.float64: _k3_plan(dd, shared))

    def plays_plan(dd, dtype, tails):
        return (_k3_plan if tails else _k6a_plan)(dd, shared)

    monkeypatch.setattr(game, "plays_plan", plays_plan)
    monkeypatch.setattr(smart, "plays_plan", plays_plan)


@pytest.mark.parametrize("d", [513, 1024, 8192])
def test_new_state_buffer_sizes_past_512(monkeypatch, d):
    # K5w: theta a (sequence, setting) pair and w a sequence for each
    # group of 16 settings (no x); K1w, K3w, K3ew, K4w, K6aw, K6bw, K7w:
    # what the library's plan asks for, none where a block's state fits
    # shared memory (K3ew K3w's plan; K6bw theta a (sequence, threshold)
    # pair past it).
    assert game.SWEEP_WARPS == 16
    assert game.wide_state_elems("K5", 1024, d, 64) == (64 + 4) * d * 1024
    assert game.wide_state_elems("K5", 77, d, 11) == (11 + 1) * d * 77
    assert game.wide_state_elems("K5", 77, d, 17) == (17 + 2) * d * 77
    for shared in (True, False):
        _stand_in_plans(monkeypatch, shared)
        assert game.wide_state_elems("K3e", 2048, d) == (
            _k3_plan(d, shared)["state"] * 2048)
        assert game.wide_state_elems("K6b", 1024, d, 16) == (
            _k3_plan(d, shared)["state"] * 16 * 1024)
        assert game.wide_state_elems("K7", 16_384, d) == (
            _k7_plan(d, shared)["state"] * 16_384)
        assert game.wide_state_elems("K3", 2048, d) == (
            _k3_plan(d, shared)["state"] * 2048)
        assert game.wide_state_elems("K6a", 1024, d, 16) == (
            _k6a_plan(d, shared)["state"] * 1024)
        assert game.wide_state_elems("K4", 2048, d) == (
            _k6a_plan(d, shared)["state"] * 2048)
        assert game.wide_state_elems("K1", 1024, d, 2) == (
            _k1_plan(d, 2, shared)["state"] * 1024)
    assert _k7_plan(d, True)["state"] == 0
    assert _k3_plan(d, False)["state"] == -(-d // 4) * 4
    assert _k6a_plan(d, False)["state"] == 2 * (-(-d // 4) * 4)


# --------------------------- every launcher hands the library any d >= 1

class _Library:
    """A stand-in for the CUDA library: records each C entry's arguments;
    every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _launch(kernel, d):
    """Calls the launcher of ``kernel`` at feature dimension ``d`` on CPU
    tensors (B = 2, T = 4); returns its C entry's name prefix and the
    launch counter's module and name."""
    B, T = 2, 4
    f64 = torch.float64
    z = torch.zeros((B, T, d), dtype=f64)
    y = torch.ones((B, T), dtype=f64)
    lengths = torch.full((B,), T, dtype=torch.int32)
    order = game.length_order(lengths)
    scales = game.sweep_scales(torch.ones(3, dtype=f64), T)
    eidx = torch.zeros((B,), dtype=torch.int32)
    z_tm, y_tm = game.time_major(z, y)
    flags = torch.zeros((2, B), dtype=torch.int32)
    return {
        "K1": lambda: game.launch_regrets(z, y, flags, scales, eidx, lengths,
                                          False),
        "K2": lambda: smart.launch_smart(z, y, torch.ones((2, B), dtype=f64),
                                         scales, eidx, lengths, False),
        "K3": lambda: game.launch_play_packed(z_tm, y_tm, scales[0], 0),
        "K3e": lambda: game.launch_play_packed_eta(
            z_tm, y_tm, torch.ones(B, dtype=f64)),
        "K4": lambda: game.launch_stream_time_major(
            z_tm, y_tm, flags[0], torch.ones(B, dtype=f64), 0,
            game.zero_stream_carry(B, d, f64, "cpu")),
        "K5": lambda: game.launch_eta_sweep(z, y, scales, order, lengths,
                                            False),
        "K6a": lambda: smart.launch_smart_prefix(
            z, y, torch.ones(2, dtype=f64), torch.arange(2, dtype=torch.int32),
            order, lengths, False),
        "K6b": lambda: smart.launch_smart_tails(
            z, y, scales[:1], torch.arange(2, dtype=torch.int32), order,
            lengths, torch.zeros((2, B), dtype=torch.int64),
            torch.zeros(B, dtype=f64), torch.zeros((2, B), dtype=f64)),
        "K7": lambda: game.launch_synthetic(0, 1.0, T, 1, d, 0,
                                            torch.device("cpu")),
    }[kernel]


# (C entry, plays the launcher passes wide_state, sequences, counter).
ENTRIES = {
    "K1": ("oco_regrets_fused_f64", 2, 2, (game, "LAUNCHES")),
    "K2": ("oco_smart_regrets_f64", 2, 2, (smart, "LAUNCHES")),
    "K3": ("oco_play_packed_f64", 1, 2, (game, "PACKED_LAUNCHES")),
    "K3e": ("oco_play_packed_eta_f64", 1, 2, (game, "PACKED_ETA_LAUNCHES")),
    "K4": ("oco_play_stream_f64", 1, 2, (game, "STREAM_LAUNCHES")),
    "K5": ("oco_eta_sweep_f64", 3, 2, (game, "SWEEP_LAUNCHES")),
    "K6a": ("oco_smart_prefix_f64", 1, 2, (smart, "SWEEP_LAUNCHES")),
    "K6b": ("oco_smart_tails_f64", 2, 2, (smart, "SWEEP_TAIL_LAUNCHES")),
    "K7": ("oco_synthetic_regrets_f32", 1, 8, (game, "SYNTHETIC_LAUNCHES")),
}


@pytest.mark.parametrize("d", [512, 513])
@pytest.mark.parametrize("kernel", game.WIDE_KERNELS)
def test_wide_kernels_take_any_d(monkeypatch, kernel, d):
    """Each launcher of the nine hinge kernel bodies hands its C entry the
    caller's d: past 512 with a state buffer of ``wide_state_elems``
    elements allocated before the call, at 512 a null one; the launch
    counter rises.  Nothing raises a d limit."""
    lib = _Library()
    buffers = []
    allocate = game.wide_state

    def spy(*args):
        buf = allocate(*args)
        buffers.append((args, buf))
        return buf

    monkeypatch.setattr(cuda_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(smart, "wide_state", spy)
    monkeypatch.setattr(game, "wide_state", spy)
    # K1w's, K3w's, K3ew's, K4w's, K6aw's, K6bw's and K7w's buffers follow
    # the library's plans: here ones that keep the state in device memory
    # (the plans that keep it on the chip need none:
    # tests/test_torch_wide_redesign.py,
    # tests/test_torch_wide_redesign_k1k4.py and
    # tests/test_torch_wide_redesign_k3e_k6b.py).
    _stand_in_plans(monkeypatch, False)
    name, plays, seqs, (module, counter) = ENTRIES[kernel]
    before = getattr(module, counter)
    _launch(kernel, d)()
    if kernel == "K2":
        # The thin K2 keeps no state; K2w is two launches, the FTL track's
        # and the tails', on the two parts of one buffer.
        wide = d > cuda_build.MAX_D
        assert getattr(module, counter) == before + 1 + wide
        assert [c[0] for c in lib.calls] == (
            ["oco_smart_plays_ftl_f64", "oco_smart_plays_tails_f64"] if wide
            else [name])
        assert all(d in args for _, args in lib.calls)
        if not wide:
            assert not buffers
            return
        ((k, n, dd, p, dtype, _), buf), = buffers
        assert (k, n, dd, p) == (kernel, seqs, d, plays)
        n_ftl = _k6a_plan(d, False)["state"] * seqs
        assert buf.numel() == game.wide_state_elems(kernel, seqs, d, plays)
        assert buf.numel() > n_ftl > 0 and buf.dtype == torch.float64
        assert lib.calls[0][1][-2] == buf.data_ptr()
        assert lib.calls[1][1][-2] == buf.data_ptr() + 8 * n_ftl
        return
    assert getattr(module, counter) == before + 1
    assert [c[0] for c in lib.calls] == [name]
    args = lib.calls[0][1]
    assert d in args
    assert len(buffers) == 1
    (k, n, dd, p, dtype, _), buf = buffers[0]
    assert (k, n, dd, p) == (kernel, seqs, d, plays)
    if d <= cuda_build.MAX_D:
        assert buf is None and args[-2] is None
    else:
        assert buf.numel() == game.wide_state_elems(kernel, seqs, d, plays)
        assert buf.dtype == (torch.float32 if kernel == "K7"
                             else torch.float64)
        assert args[-2] == buf.data_ptr()
