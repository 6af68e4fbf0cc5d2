"""The premises of K5w's and K7w's designs past d = 512, held bit for bit
against the plain versions on the CPU (the kernels themselves run on the
card only: tests/test_torch_cuda.py).

- K5w (``csrc/sweep_kernel.cu`` ``sweep_wide_body``, ``PassQ`` /
  ``PassU``) plays a round in two passes over theta and keeps no x: q
  from x formed again from theta (times 1/sqrt(nsq) iff the round
  projects), then the update, which also sums the next round's ||x||^2
  from the new theta; the final FTL action is written over theta for the
  comparator.  A PyTorch mirror of that schedule equals
  ``eta_sweep_reference`` in every bit, with projections firing.
- K7w (``csrc/synthetic_kernel.cu`` ``synthetic_wide_kernel``) plays a
  sequence on a warp: call k of a round's Philox stream on lane k % 32,
  element j on lane j % 32 taking bit j % 32 of word j // 32, and each sum
  written to a line of at most 1,024 products that one lane adds in index
  order from -0 (an FTRL round's ||x||^2 and <z_t, x> side by side on
  lanes 0 and 1, <z_t, x> again where it projects).  A NumPy/PyTorch
  mirror of that split (its Philox words
  from an independent NumPy Philox) equals ``synthetic_regrets_reference``
  in every bit, and its rows equal ``synthetic_stream``'s.
- K7w's host side: the launcher allocates the buffer the library's plan
  asks for (none where a warp's lines fit shared memory), and the plan's
  layout from the source's constants.
"""

import contextlib
import math
import os
import re
import types

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.ops import game
from online_convex_optimization_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "online_convex_optimization_tpu_torch", "csrc")
ETA = math.sqrt(2.0)


def _neg_zero_sum(p: torch.Tensor) -> torch.Tensor:
    """``((-0 + p_0) + p_1) + ...`` over the last axis: the fused passes'
    sums, which start from -0, the additive identity."""
    acc = torch.full(p.shape[:-1], -0.0, dtype=p.dtype)
    for j in range(p.shape[-1]):
        acc = acc + p[..., j]
    return acc


def _inv_sqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` by a true divide where ``v > 0`` (else 1, masked by
    the callers)."""
    return torch.reciprocal(torch.sqrt(torch.where(v > 0, v, 1.0)))


# ------------------------------------------------------------------ K5w


def k5w_mirror(z, y, eta_grid, lengths, *, replay):
    """K5w's schedule on ``(B, T, d)`` rows with the ``(E, T)`` scale
    table: pass Q (q from x = scale theta, projected by the last pass U's
    nsq), pass U (theta, w and the next round's nsq), a sequence's rounds
    ending at its length; the final FTL action written over theta.
    Returns ``(B, E)`` regrets and whether any round projected."""
    B, T, d = z.shape
    E = eta_grid.shape[0]
    scales = game.sweep_scales(eta_grid, T)
    theta = z.new_zeros((B, E, d))
    w = z.new_zeros((B, d))
    cum = z.new_zeros((B, E))
    nsq = z.new_zeros((B, E))          # round 0: theta = 0
    fired = False
    for t in range(int(lengths.max())):
        on = lengths > t
        z_t, y_t = z[:, t][:, None, :], y[:, t][:, None]
        proj = nsq > 1.0
        fired |= bool((proj & on[:, None]).any())
        x = scales[:, t][None, :, None] * theta
        x = torch.where(proj[..., None], _inv_sqrt(nsq)[..., None] * x, x)
        diff = _neg_zero_sum(z_t * x) - y_t
        cum = torch.where(on[:, None], cum + 0.5 * torch.abs(diff), cum)
        g = 0.5 * torch.sign(diff)
        new = theta + g[..., None] * z_t
        theta = torch.where(on[:, None, None], new, theta)
        w = torch.where(on[:, None], w + y[:, t][:, None] * z[:, t], w)
        nxt = scales[:, t + 1] if t + 1 < T else torch.zeros_like(eta_grid)
        u = nxt[None, :, None] * new
        nsq = torch.where(on[:, None], _neg_zero_sum(u * u), nsq)
    norm = _neg_zero_sum(theta * theta)
    scale = torch.where(norm > 0, -_inv_sqrt(norm), 0.0)
    theta = scale[..., None] * theta              # x_c over theta
    if replay:
        comp = z.new_zeros((B, E))
        for t in range(int(lengths.max())):
            q = _neg_zero_sum(z[:, t][:, None, :] * theta)
            comp = torch.where((lengths > t)[:, None],
                               comp + 0.5 * torch.abs(q - y[:, t][:, None]),
                               comp)
    else:
        comp = 0.5 * (lengths.to(z.dtype)[:, None]
                      - _neg_zero_sum(theta * w[:, None, :]))
    return cum - comp, fired


def _sweep_batch(B, T, d, seed, contract, dtype):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        y = rng.normal(size=(B, T))
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 1024])
@pytest.mark.parametrize("contract", [True, False])
def test_k5w_two_pass_round_equals_plain(d, dtype, contract):
    """The two-pass round with no x in memory equals the plain sweep in
    every bit at ragged lengths, eta up to 4.0 (the projection fires), on
    contract data (identity comparator) and off it (replay)."""
    z, y, lengths = _sweep_batch(6, 10, d, d + int(contract), contract,
                                 dtype)
    etas = torch.tensor([0.05, 0.5, 1.3, 2.7, 4.0], dtype=dtype)
    got, fired = k5w_mirror(z, y, etas, lengths, replay=not contract)
    want = game.eta_sweep_reference(z, y, etas, lengths,
                                    replay=not contract)
    assert fired
    assert got.dtype == dtype and torch.equal(got, want)


def test_k5w_state_is_theta_and_the_groups_w():
    """K5w's buffer: theta a (sequence, setting) pair, no x, and a w a
    sequence for each group of 16 settings: 0.570 GB at the sweep path's
    shape in f64 (1.107 GB with x)."""
    B, E, d = 1024, 64, 1024
    n = game.wide_state_elems("K5", B, d, E)
    assert n == (E + math.ceil(E / game.SWEEP_WARPS)) * d * B
    assert round(n * 8 / 1e9, 3) == 0.570


# ------------------------------------------------------------------ K7w

LINE = 1024


def _np_mulhilo(a, m):
    prod = a.astype(np.uint64) * np.uint64(m)
    return prod >> np.uint64(32), prod & np.uint64(0xFFFFFFFF)


def _np_philox(ctr, key):
    """Philox4x32-10 in NumPy uint64, written from the paper independently
    of ``ops/philox.py``: ``ctr`` (..., 4), ``key`` (2,)."""
    c = [ctr[..., i].astype(np.uint64) for i in range(4)]
    k = [np.uint64(key[0]), np.uint64(key[1])]
    mask = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & mask,
                 (k[1] + np.uint64(0xBB67AE85)) & mask]
        hi0, lo0 = _np_mulhilo(c[0], 0xD2511F53)
        hi1, lo1 = _np_mulhilo(c[2], 0xCD9E8D57)
        c = [hi1 ^ c[1] ^ k[0], lo1, hi0 ^ c[3] ^ k[1], lo0]
    return np.stack(c, axis=-1)


def _warp_words(seed, t, B, d):
    """The words line of round t of every sequence: call k (drawn by lane
    k % 32) at words 4k .. 4k + 3, calls 0 .. d >> 7.  ``(B, 4 calls)``."""
    calls = (d >> 7) + 1
    b, k = np.meshgrid(np.arange(B), np.arange(calls), indexing="ij")
    lanes = k % 32
    assert lanes.max() == min(calls, 32) - 1
    ctr = np.stack([np.full_like(b, t), b, k, np.zeros_like(b)],
                   -1).astype(np.uint64)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    return _np_philox(ctr, key).reshape(B, 4 * calls)


def _line_sum(p: torch.Tensor, chunk: int = LINE) -> torch.Tensor:
    """A warp's sum of ``(B, d)`` products: a chunk of at most ``chunk``
    products at a time written to the line, one lane adding it in index
    order from -0."""
    acc = torch.full(p.shape[:-1], -0.0, dtype=p.dtype)
    for c0 in range(0, p.shape[-1], chunk):
        line = p[:, c0:c0 + chunk]
        for i in range(line.shape[-1]):
            acc = acc + line[:, i]
    return acc


def k7w_mirror(seed, eta, T, lane_batch, d, alg_flag):
    """K7w's warp split on the CPU; returns the ``(8 * lane_batch,)``
    regrets and each round's ``(B, d)`` rows and ``(B,)`` labels."""
    B = 8 * lane_batch
    c = game.synthetic_row_scale(d)
    theta = torch.zeros((B, d), dtype=torch.float32)
    w = torch.zeros_like(theta)
    cum = torch.zeros((B,), dtype=torch.float32)
    j = np.arange(d)
    lane, m = j % 32, j // 32
    rows = []
    eta32 = torch.tensor(eta, dtype=torch.float32)
    for t in range(T):
        words = _warp_words(seed, t, B, d)
        bits = (words[:, m] >> lane.astype(np.uint64)) & 1
        z = torch.where(torch.from_numpy(bits.astype(bool)),
                        torch.tensor(c), torch.tensor(-c))
        lab = (words[:, d >> 5] >> np.uint64(d & 31)) & 1
        yt = torch.where(torch.from_numpy(lab.astype(bool)),
                         torch.tensor(1.0), torch.tensor(-1.0))
        rows.append((z, yt))
        if alg_flag == game.ALG_FTRL:
            # ||x||^2 and <z_t, x> side by side (lanes 0 and 1, half
            # lines), <z_t, x> again where the round projects.
            scale = -(eta32 / torch.sqrt(torch.tensor(float(t + 1))))
            x = scale * theta
            nsq, q = _line_sum(x * x, LINE // 2), _line_sum(z * x, LINE // 2)
            proj = nsq > 1.0
            xp = _inv_sqrt(nsq)[:, None] * x
            q = torch.where(proj, _line_sum(z * xp), q)
        else:
            nsq = _line_sum(theta * theta)
            x = torch.where(nsq > 0, -_inv_sqrt(nsq), 0.0)[:, None] * theta
            q = _line_sum(z * x)
        diff = q - yt
        cum = cum + 0.5 * torch.abs(diff)
        g = 0.5 * torch.sign(diff)
        theta = theta + g[:, None] * z
        w = w + yt[:, None] * z
    nsq = _line_sum(theta * theta)
    x = torch.where(nsq > 0, -_inv_sqrt(nsq), 0.0)[:, None] * theta
    return cum - 0.5 * (float(T) - _line_sum(x * w)), rows


@pytest.mark.parametrize("d", [513, 1024, 1025])
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_k7w_warp_split_equals_plain(d, alg_flag):
    """Lane k's Philox calls (NumPy's Philox), the lane map of elements and
    bits, and the one-lane index-order sums over a line of at most 1,024
    products give the plain version's regrets in every bit; the rows and
    labels are ``synthetic_stream``'s (d = 1,024: 9 calls a round, none
    repeated; d = 1,025: the label in call 8 and a last line of 1)."""
    seed, T, lanes = (5 << 20) + d, 9, 2
    got, rows = k7w_mirror(seed, ETA, T, lanes, d, alg_flag)
    want = game.synthetic_regrets_reference(seed, ETA, T=T, lane_batch=lanes,
                                            d=d, alg_flag=alg_flag,
                                            device="cpu")
    assert torch.equal(got, want.reshape(-1))
    z, y = game.synthetic_stream(seed, T=T, lane_batch=lanes, d=d,
                                 device="cpu")
    for t, (zt, yt) in enumerate(rows):
        assert torch.equal(zt, z[:, t]) and torch.equal(yt, y[:, t])


def _source_constants():
    with open(os.path.join(CSRC, "synthetic_kernel.cu")) as f:
        src = f.read()
    return {name: int(re.search(rf"constexpr (?:int|long long) {name} = "
                                rf"(\d+);", src).group(1))
            for name in ("kWideLine", "kLineGap", "kWideWarps",
                         "kBlockSmem")}


def test_k7w_lines_and_shared_boundary():
    """A warp's lines as the source sizes them: theta and w padded to 16
    bytes, 4 words a Philox call, a product line of kWideLine floats and
    the 4-float gap between its halves; 12,448 bytes at d = 1,024 (18
    warps in an SM's 228 KB), and the d past which one warp's lines no
    longer fit a block's 227 KB lies past the path's d = 2,048 (the plan's
    max_shared_d, held against a launch on the card)."""
    k = _source_constants()
    assert k == {"kWideLine": LINE, "kLineGap": 4, "kWideWarps": 8,
                 "kBlockSmem": 232448}

    def warp_bytes(d):
        up4 = -(-d // 4) * 4
        return 4 * (2 * up4 + 4 * ((d >> 7) + 1) + LINE + 4)

    assert warp_bytes(1024) == 12_448
    assert warp_bytes(513) == 4 * (2 * 516 + 20 + 1028)
    boundary = max(d for d in range(513, 40_000)
                   if warp_bytes(d) <= k["kBlockSmem"])
    assert 2048 < boundary < 40_000 - 1
    assert warp_bytes(boundary + 1) > k["kBlockSmem"]


class _Library:
    """A stand-in for the CUDA library: records each C entry's arguments;
    its K7w plan writes ``plan`` into the caller's array; every launch
    succeeds."""

    def __init__(self, plan):
        self.plan = plan
        self.calls = []

    def oco_synthetic_plan(self, alg_flag, d, out):
        self.calls.append(("oco_synthetic_plan", (alg_flag, d)))
        for i, v in enumerate(self.plan):
            out[i] = v
        return 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("shared", [True, False])
def test_k7w_launcher_follows_the_plan(monkeypatch, shared):
    """``synthetic_plan`` reads the library's plan in its order, and the
    launcher hands the library a null state where the plan keeps theta and
    w in shared memory, else a buffer of the plan's floats a sequence."""
    d, lanes = 1024, 3
    state = 0 if shared else 2 * d + 4 * 9
    lib = _Library((2, 24_864, int(shared), state, 28_000))
    monkeypatch.setattr(cuda_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    assert game.synthetic_plan(d, 1) == {
        "warps": 2, "smem_bytes": 24_864, "shared": shared, "state": state,
        "max_shared_d": 28_000}
    assert lib.calls == [("oco_synthetic_plan", (1, d))]
    buffers = []
    allocate = game.wide_state

    def spy(*args):
        buffers.append(allocate(*args))
        return buffers[-1]

    monkeypatch.setattr(game, "wide_state", spy)
    before = game.SYNTHETIC_LAUNCHES
    game.launch_synthetic(7, ETA, 4, lanes, d, 0, torch.device("cpu"))
    assert game.SYNTHETIC_LAUNCHES == before + 1
    name, args = lib.calls[-1]
    assert name == "oco_synthetic_regrets_f32" and d in args
    (buf,) = buffers
    if shared:
        assert buf is None and args[-2] is None
    else:
        assert buf.numel() == state * 8 * lanes
        assert args[-2] == buf.data_ptr()
