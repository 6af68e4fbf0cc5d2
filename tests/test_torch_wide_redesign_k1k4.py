"""The premises of K1w's and K4w's designs past d = 512, held bit for bit
against the plain versions on the CPU (the kernels themselves run on the
card only: tests/test_torch_cuda.py).

- K4w (``csrc/stream_kernel.cu`` ``stream_wide_kernel``) plays a sequence
  on a warp, as K3w does, from the same time-major tiles: x is never
  stored, formed from theta and the round's scale where a product needs
  it; an FTRL round takes -(eta_b / sqrt(t)) at the global index
  t = t0 + k + 1, sums ||x||^2 and <z_t, x> side by side and <z_t, f x>
  again where it projects; FTL sums ||theta||^2 (before its row lands),
  then q; w += y_t z_t and cnt += y_t^2 enter no sum.  A PyTorch mirror of that schedule, fed in
  chunks (t0 > 0), equals ``play_stream_reference`` in every bit.
- K1w (``csrc/regret_kernel.cu`` ``regret_wide_kernel``) plays each play
  of a sequence on a warp, the plays sharing one staged row and one w:
  the same round (the FTRL scale from the (E, T) table), x_last written
  in a play's last round, the identity comparator <x_c, w> from the
  sequence's one w, the replay comparator's rows each summed in index
  order.  A mirror with P = 2 and 3 plays, ragged lengths (len = 0
  included) and both comparator modes equals ``regret_plays_reference``
  in every bit.
- Cases: d = 513 and 640, f64 and f32, contract, replay and z = e1 tie
  batches, with projections firing.  At d = 513 both mirrors stay within
  1e-9 of the JAX package's x64 scans (``simulate_linear_batch``, its
  ``StreamingGame`` fed in chunks).
- The host side: ``regret_plan`` and ``stream_plan`` read the library's
  plans in order, the launchers allocate what they ask for, and the
  plans' block sizes from the sources' constants.

Every sum is one lane's index-order sum from -0 (``oco_warp.cuh``); here
it is ``np.add.accumulate`` over the products in their dtype, which adds
in index order from the first product (-0 + p_0 is p_0 in every bit).
"""

import contextlib
import math
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.models.linear import (
    simulate_linear_batch as jax_linear_batch,
)
from online_convex_optimization_tpu.models.streaming import (
    StreamingGame as JaxStreamingGame,
)
from online_convex_optimization_tpu_torch.ops import game
from online_convex_optimization_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "online_convex_optimization_tpu_torch", "csrc")
X64_TOL = 1e-9
BLOCK_SMEM = 232448


def _line_sum(p: torch.Tensor) -> torch.Tensor:
    """A warp's sum of products over the last axis: in index order from
    -0, in the products' dtype."""
    return torch.from_numpy(
        np.add.accumulate(p.numpy(), axis=-1)[..., -1].copy())


def _inv_sqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` by a true divide where ``v > 0`` (else 1, masked by
    the callers)."""
    return torch.reciprocal(torch.sqrt(torch.where(v > 0, v, 1.0)))


def _ftrl_q(theta, z, sc):
    """An FTRL round's q and action as the warps form them: x = sc theta,
    ||x||^2 and <z_t, x> side by side, <z_t, f x> again where ||x||^2 > 1.
    ``sc`` is one scale a row of theta.  Returns ``(q, x, projected)``."""
    sc = sc[:, None]
    x = sc * theta
    nsq = _line_sum(x * x)
    q = _line_sum(z * (sc * theta))
    proj = nsq > 1.0
    f = _inv_sqrt(nsq)[:, None]
    q = torch.where(proj, _line_sum(z * (f * (sc * theta))), q)
    x = torch.where(proj[:, None], f * (sc * theta), x)
    return q, x, proj


def _ftl_q(theta, z):
    """An FTL round's q and action: ||theta||^2, then <z_t, s theta>."""
    nsq = _line_sum(theta * theta)
    s = torch.where(nsq > 0, -_inv_sqrt(nsq), 0.0)[:, None]
    return _line_sum(z * (s * theta)), s * theta


def k4w_mirror(z_tm, y_tm, flags, eta, t0, carry):
    """K4w's warp schedule over one time-major ``(CT, d, B)`` chunk from a
    carry at global round t0; returns the advanced ``StreamCarry`` and the
    FTRL rounds that projected."""
    theta, w = carry.theta.t(), carry.w.t()
    cum, cnt = carry.cum, carry.cnt
    ftrl = flags == game.ALG_FTRL
    fired = 0
    for k in range(z_tm.shape[0]):
        z, yt = z_tm[k].t(), y_tm[k]
        t = torch.tensor(float(t0 + k + 1), dtype=theta.dtype)
        sc = -(eta / torch.sqrt(t))
        q_r, _, proj = _ftrl_q(theta, z, sc)
        q_l, _ = _ftl_q(theta, z)
        q = torch.where(ftrl, q_r, q_l)
        fired += int((proj & ftrl).sum())
        diff = q - yt
        cum = cum + 0.5 * torch.abs(diff)
        theta = theta + (0.5 * torch.sign(diff))[:, None] * z
        w = w + yt[:, None] * z
        cnt = cnt + yt * yt
    return game.StreamCarry(theta.t().contiguous(), w.t().contiguous(), cum,
                            cnt), fired


def k1w_mirror(z, y, flags, eta, lengths, *, replay):
    """K1w's warp schedule on ``(B, T, d)`` rows: play p of sequence b on a
    warp, the FTRL scale from the (E, T) table (``eta_table``), each play
    over its sequence's own rounds, x_last written in the last one, w one
    a sequence; the comparator x_c = s theta scored by <x_c, w> or by a
    replay of the sequence's rows.  Returns ``regret_plays_reference``'s
    ``(cum, comp, x_last)`` and the FTRL rounds that projected."""
    B, T, d = z.shape
    P = flags.shape[0]
    scales, eidx = game.eta_table(eta, B, T, z.dtype, "cpu")
    theta = z.new_zeros((P, B, d))
    w = z.new_zeros((B, d))
    cum = z.new_zeros((P, B))
    x_last = z.new_zeros((P, B, d))
    lengths = lengths.to(torch.int64)
    fired = 0
    for t in range(int(lengths.max())):
        on = lengths > t
        zt, yt = z[:, t], y[:, t]
        for p in range(P):
            ftrl = flags[p] == game.ALG_FTRL
            q_r, x_r, proj = _ftrl_q(theta[p], zt, scales[eidx.long(), t])
            q_l, x_l = _ftl_q(theta[p], zt)
            q = torch.where(ftrl, q_r, q_l)
            x = torch.where(ftrl[:, None], x_r, x_l)
            fired += int((proj & ftrl & on).sum())
            x_last[p] = torch.where((lengths == t + 1)[:, None], x,
                                    x_last[p])
            diff = q - yt
            cum[p] = torch.where(on, cum[p] + 0.5 * torch.abs(diff), cum[p])
            theta[p] = torch.where(
                on[:, None], theta[p] + (0.5 * torch.sign(diff))[:, None] * zt,
                theta[p])
        w = torch.where(on[:, None], w + yt[:, None] * zt, w)
    comp = z.new_zeros((P, B))
    for p in range(P):
        _, x_c = _ftl_q(theta[p], z[:, 0])
        if replay:
            for t in range(int(lengths.max())):
                qc = _line_sum(z[:, t] * x_c)
                comp[p] = torch.where(
                    lengths > t, comp[p] + 0.5 * torch.abs(qc - y[:, t]),
                    comp[p])
        else:
            comp[p] = 0.5 * (lengths.to(z.dtype) - _line_sum(x_c * w))
    return (cum, comp, x_last), fired


def _batch(B, T, d, seed, dtype, *, contract, zero_len=False):
    """Rows in the unit ball with labels +-1 (contract) or rows of norm up
    to 1.5 with normal labels (replay), ragged lengths in [1, T] (and a
    len = 0 sequence with ``zero_len``)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    if contract:
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        z *= 1.5
        y = rng.normal(size=(B, T))
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    if zero_len:
        lengths[-1] = 0
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _e1_batch(B, T, d, seed, dtype):
    """The z = e1 family: every row e1, labels +-1 from the seed; FTL's
    q = y ties."""
    rng = np.random.default_rng(seed)
    z = np.zeros((B, T, d))
    z[..., 0] = 1.0
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    lengths = rng.integers(T // 2, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _mirror_batches(d, dtype):
    """(name, z, y, lengths, replay) for the mirrors: a contract batch with
    a len = 0 sequence, a replay batch and the tie family."""
    return [
        ("contract", *_batch(6, 12, d, d + 1, dtype, contract=True,
                             zero_len=True), False),
        ("replay", *_batch(5, 10, d, d + 2, dtype, contract=False), True),
        ("e1 ties", *_e1_batch(4, 120, d, d + 3, dtype), False),
    ]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 640])
def test_k4w_warp_schedule_equals_plain(d, dtype):
    """K4w's schedule equals ``play_stream_reference`` in every bit, mixed
    flags and per-sequence eta (up to 4, so that rounds project), fed in
    three chunks from a zero carry (t0 = 0, then t0 > 0), on a contract
    batch, a replay batch and the z = e1 ties."""
    fired = 0
    for name, z, y, _, _ in _mirror_batches(d, dtype):
        B, T, _ = z.shape
        z_tm, y_tm = game.time_major(z, y)
        flags = torch.as_tensor(np.arange(B) % 2, dtype=torch.int32)
        eta = torch.linspace(0.5, 4.0, B, dtype=dtype)
        got = want = game.zero_stream_carry(B, d, dtype, "cpu")
        cuts = (0, T // 3, T - T // 3, T)
        for lo, hi in zip(cuts, cuts[1:]):
            got, n = k4w_mirror(z_tm[lo:hi], y_tm[lo:hi], flags, eta, lo,
                                got)
            want = game.play_stream_reference(z_tm[lo:hi], y_tm[lo:hi],
                                              flags, eta, lo, want)
            fired += n
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                name, lo)
    assert fired > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 640])
def test_k1w_warp_schedule_equals_plain(d, dtype):
    """K1w's schedule equals ``regret_plays_reference`` in every bit with
    P = 2 (FTRL, FTL) and P = 3 (FTL, FTRL, FTL) plays, eta = 4 (rounds
    project), ragged lengths with a len = 0 sequence, the identity
    comparator and the replay one, and the z = e1 ties."""
    fired = 0
    for name, z, y, ln, replay in _mirror_batches(d, dtype):
        B = z.shape[0]
        for plays in ((0, 1), (1, 0, 1)):
            flags = torch.tensor([[f] * B for f in plays], dtype=torch.int32)
            got, n = k1w_mirror(z, y, flags, 4.0, ln, replay=replay)
            want = game.regret_plays_reference(
                z, y, flags, game.per_sequence(4.0, B, dtype, "cpu"), ln,
                replay=replay)
            fired += n
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                name, plays)
        if name == "contract":
            assert bool((want[2][:, -1] == 0).all())   # len = 0: x_last 0
    assert fired > 0


def test_k1w_k4w_mirrors_match_jax_x64():
    """At d = 513 the mirrors against the JAX package's scans in x64, the
    routes it takes past its kernels' d: K1w's (one play a sequence,
    mixed flags, per-sequence eta, ragged lengths) against
    ``simulate_linear_batch``, K4w's fed in three chunks against its
    ``StreamingGame`` fed the same chunks; cum, comparator, regret and
    x_last within 1e-9."""
    B, T, d = 8, 40, 513
    z, y, ln = _batch(B, T, d, 200, torch.float64, contract=True)
    flags = np.arange(B) % 2
    eta = np.linspace(0.4, 2.2, B)
    (cum, comp, x_last), _ = k1w_mirror(
        z, y, torch.as_tensor(flags[None], dtype=torch.int32),
        torch.as_tensor(eta), ln, replay=False)
    want = jax_linear_batch(jnp.asarray(z.numpy()), jnp.asarray(y.numpy()),
                            jnp.asarray(flags), jnp.asarray(eta),
                            jnp.asarray(ln.numpy()))
    for got, name in ((cum[0], "cum_loss"), (comp[0], "comp_loss"),
                      (cum[0] - comp[0], "regret"), (x_last[0], "x_last")):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=X64_TOL, err_msg=name)
    for alg_flag in (0, 1):
        jg = JaxStreamingGame(B, d, alg_flag=alg_flag, eta0=math.sqrt(2.0),
                              dtype=jnp.float64)
        carry = game.zero_stream_carry(B, d, torch.float64, "cpu")
        z_tm, y_tm = game.time_major(z, y)
        fl = torch.full((B,), alg_flag, dtype=torch.int32)
        et = torch.full((B,), math.sqrt(2.0), dtype=torch.float64)
        feed = []
        for lo, hi in ((0, 13), (13, 27), (27, T)):
            carry, _ = k4w_mirror(z_tm[lo:hi], y_tm[lo:hi], fl, et, lo,
                                  carry)
            chunk = (z.numpy()[:, lo:hi].transpose(1, 0, 2),
                     y.numpy()[:, lo:hi].T)
            jg.feed(*chunk)
            feed.append(chunk)
        res = game.stream_result(carry)
        want = jg.result(feed)
        for got, name in zip(res, ("regret", "cum_loss", "comp_loss")):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=0, atol=X64_TOL, err_msg=name)


# ------------------------------------------------------------- the host side

class _Library:
    """A stand-in for the CUDA library: records each C entry's arguments;
    its plans write ``plan`` into the caller's array; every launch
    succeeds."""

    def __init__(self, plan):
        self.plan = plan
        self.calls = []

    def _plan(self, name, args, out):
        self.calls.append((name, args))
        for i, v in enumerate(self.plan):
            out[i] = v
        return 0

    def oco_regret_plan(self, storage, plays, d, out):
        return self._plan("oco_regret_plan", (storage, plays, d), out)

    def oco_stream_plan(self, storage, d, out):
        return self._plan("oco_stream_plan", (storage, d), out)

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _stand_in(monkeypatch, lib):
    monkeypatch.setattr(cuda_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


@pytest.mark.parametrize("storage", [torch.float64, torch.float32,
                                     torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_k1w_k4w_launchers_follow_the_plans(monkeypatch, kernel, shared,
                                            storage):
    """``regret_plan`` and ``stream_plan`` read the library's plan for z's
    storage (0 f32, 1 f64, 2 bf16; K1w with the launch's plays) in its
    order, and the launchers hand the library a null state where the plan
    keeps the state in shared memory, else a buffer of the plan's elements
    a sequence in the compute dtype."""
    d, B, T, plays = 1024, 5, 4, 3
    state = 0 if shared else ((plays + 1) if kernel == "K1" else 2) * d
    lib = _Library((plays if kernel == "K1" else 8, 106_880, int(shared),
                    state, 2_333))
    _stand_in(monkeypatch, lib)
    code = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}[storage]
    if kernel == "K1":
        plan, entry = game.regret_plan(d, plays, storage), "oco_regret_plan"
        args = (code, plays, d)
    else:
        plan, entry = game.stream_plan(d, storage), "oco_stream_plan"
        args = (code, d)
    assert plan == {"warps": plays if kernel == "K1" else 8,
                    "smem_bytes": 106_880, "shared": shared, "state": state,
                    "max_shared_d": 2_333}
    assert lib.calls == [(entry, args)]
    buffers = []
    allocate = game.wide_state

    def spy(*a):
        buffers.append(allocate(*a))
        return buffers[-1]

    monkeypatch.setattr(game, "wide_state", spy)
    y_dtype = torch.int8 if storage == torch.bfloat16 else storage
    z = torch.zeros((B, T, d), dtype=storage)
    y = torch.ones((B, T), dtype=y_dtype)
    ln = torch.full((B,), T, dtype=torch.int32)
    compute = game.compute_dtype(storage)
    if kernel == "K1":
        before = game.LAUNCHES
        flags = torch.zeros((plays, B), dtype=torch.int32)
        game.launch_regrets(z, y, flags, *game.eta_table(1.0, B, T, compute,
                                                         "cpu"), ln, False)
        assert game.LAUNCHES == before + 1
    else:
        z_tm, y_tm = game.time_major(z, y)
        before = game.STREAM_LAUNCHES
        game.launch_stream_time_major(
            z_tm, y_tm, torch.zeros(B, dtype=torch.int32),
            torch.ones(B, dtype=compute), 0,
            game.zero_stream_carry(B, d, compute, "cpu"))
        assert game.STREAM_LAUNCHES == before + 1
    name, launch_args = lib.calls[-1]
    assert name.startswith("oco_regrets_fused_" if kernel == "K1"
                           else "oco_play_stream_") and d in launch_args
    assert lib.calls[-2] == (entry, args)
    (buf,) = buffers
    if shared:
        assert buf is None and launch_args[-2] is None
    else:
        assert buf.numel() == state * B and buf.dtype == compute
        assert launch_args[-2] == buf.data_ptr()


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _up4(d):
    return -(-d // 4) * 4


def _k1w_block(d, plays, z_bytes, s_bytes, line):
    """K1w's block as regret_kernel.cu sizes it: the plays' thetas and w,
    two stages of the 16-byte window around a row, a line a play."""
    stage = ((d * z_bytes + 15) // 16) * 16 + 16
    return ((plays + 1) * _up4(d) * s_bytes + 2 * stage
            + plays * (line + 16 // s_bytes) * s_bytes)


def _k4w_block(d, z_bytes, s_bytes, line):
    """K4w's block as stream_kernel.cu and oco_warp.cuh size it: W = 32 /
    sizeof(z) warps, one transposed stage, W thetas, W ws and W lines."""
    w = 32 // z_bytes
    unit = 8 if z_bytes == 8 else 4
    units = w * z_bytes // unit + (1 if z_bytes < unit else 0)
    pitch = -(-d // 32) * 32 + 4
    return (units * pitch * unit + 2 * w * _up4(d) * s_bytes
            + w * (line + 16 // s_bytes) * s_bytes)


def test_k1w_k4w_blocks_and_shared_boundaries():
    """K1w's and K4w's shared memory as the sources size it: K1w's lines
    of 512 products in f64 and 256 in f32, its block of two plays at d =
    1,024 49,216 bytes in f64 (four blocks, 8 warps, an SM: the path's
    1,024 sequences in two waves on 132 SMs) and 22,592 in f32 (nine
    blocks); K4w's lines of 512, its block of 8 warps in f32 at d = 1,024
    114,944 bytes (two blocks, 16 warps, an SM, the path's 2,048 sequences
    in one wave).  Each boundary lies past the path's d: K1w f64 with two
    plays 5,604 (d = 2,048's 90,176 bytes: two blocks an SM), K4w f32
    2,240."""
    lines = re.search(r"constexpr int kPlayLine = sizeof\(S\) == 4 \? (\d+) "
                      r": (\d+);", _source("regret_kernel.cu"))
    k1_f32, k1_f64 = int(lines.group(1)), int(lines.group(2))
    k4_line = int(re.search(r"constexpr int kStreamLine = (\d+);",
                            _source("stream_kernel.cu")).group(1))
    assert (k1_f32, k1_f64, k4_line) == (256, 512, 512)
    assert "constexpr int kMaxPlays = 8;" in _source("regret_kernel.cu")
    sm = 233_472

    assert _k1w_block(1024, 2, 8, 8, k1_f64) == 49_216
    assert sm // (49_216 + 1024) == 4 and 4 * 132 < 1024 <= 2 * 4 * 132
    assert _k1w_block(1024, 2, 4, 4, k1_f32) == 22_592
    assert sm // (22_592 + 1024) == 9
    assert _k1w_block(2048, 2, 8, 8, k1_f64) == 90_176
    assert _k4w_block(1024, 4, 4, k4_line) == 114_944
    assert 2 * (114_944 + 1024) <= sm and 2 * 8 * 132 >= 2048
    for block, fits in ((lambda d: _k1w_block(d, 2, 8, 8, k1_f64), 5604),
                        (lambda d: _k1w_block(d, 2, 4, 4, k1_f32), 11516),
                        (lambda d: _k1w_block(d, 8, 8, 8, k1_f64), 2264),
                        (lambda d: _k4w_block(d, 4, 4, k4_line), 2240),
                        (lambda d: _k4w_block(d, 8, 8, k4_line), 2240),
                        (lambda d: _k4w_block(d, 2, 4, k4_line), 1212)):
        assert block(fits) <= BLOCK_SMEM < block(fits + 1)
        assert fits > 1024
