"""The premises of K5w's, K7w's, K3w's and K6aw's designs past d = 512,
held bit for bit against the plain versions on the CPU (the kernels
themselves run on the card only: tests/test_torch_cuda.py).

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
- K3w (``csrc/game_kernel.cu`` ``packed_wide_kernel``) and K6aw
  (``csrc/smart_sweep_kernel.cu`` ``smart_prefix_wide_kernel``) play a
  sequence on a warp with the same lines (``oco_warp.cuh``): PyTorch
  mirrors of their schedules (x formed from theta and the round's scale,
  never stored; K3w's FTRL sums side by side and again where it projects,
  FTL's in turn; K6aw's <x, w> of round t beside <z_{t+1}, x>, the
  threshold walk) equal ``play_packed_reference`` and
  ``smart_prefix_reference`` in every bit at d = 513 and 640, f64 and
  f32, contract, replay and z = e1 tie batches; at d = 513 they stay
  within the JAX package's tolerance of JAX ``play_packed`` (interpret
  mode) and of its SMART sweep's switch rounds and prefix columns; their
  launchers allocate what the library's plans ask for.
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

from online_convex_optimization_tpu.models.smart import (
    simulate_smart_batch as jax_smart_batch,
)
from online_convex_optimization_tpu.ops import pallas_game as jpg
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "online_convex_optimization_tpu_torch", "csrc")
ETA = math.sqrt(2.0)
F32_TOL = 5e-4
X64_TOL = 1e-9


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


def _source_constants(source="synthetic_kernel.cu",
                      names=("kWideLine", "kWideWarps", "kBlockSmem")):
    """The named constants of a source (or of ``oco_warp.cuh``, which
    holds the block's shared-memory limit of every warp-a-sequence plan),
    and the gap between a line's two halves in float32 elements
    (``oco_warp.cuh``: 16 bytes)."""
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    with open(os.path.join(CSRC, "oco_warp.cuh")) as f:
        warp = f.read()

    def value(name):
        pattern = rf"constexpr (?:int|long long) {name} = (\d+);"
        found = re.search(pattern, src) or re.search(pattern, warp)
        return int(found.group(1))

    out = {name: value(name) for name in names}
    gap = re.search(r"constexpr int kLineGap = (\d+) / ", warp)
    out["kLineGap"] = int(gap.group(1)) // 4
    return out


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

    def _plan(self, name, args, out):
        self.calls.append((name, args))
        for i, v in enumerate(self.plan):
            out[i] = v
        return 0

    def oco_synthetic_plan(self, alg_flag, d, out):
        return self._plan("oco_synthetic_plan", (alg_flag, d), out)

    def oco_packed_plan(self, storage, d, out):
        return self._plan("oco_packed_plan", (storage, d), out)

    def oco_smart_prefix_plan(self, storage, d, out):
        return self._plan("oco_smart_prefix_plan", (storage, d), out)

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


# ------------------------------------------------------------ K3w, K6aw
#
# Both play a sequence on a warp with the line of oco_warp.cuh: K3w's and
# K6aw's products go to a line of 512 (two halves of 256 side by side),
# one lane adding it in index order from -0, as K7w's do.

SEQ_LINE = 512


def k3w_mirror(z_tm, y_tm, scales, alg_flag):
    """K3w's warp schedule on time-major ``(T, d, B)`` rows: x never
    stored, formed from theta and the round's scale where a product needs
    it; FTRL sums ||x||^2 and <z_t, x> side by side and <z_t, f x> again
    where the round projects; FTL sums ||theta||^2, then q; the update
    lane-parallel.  Returns ``(cum (B,), theta (d, B))`` and the share of
    FTRL rounds that projected."""
    T, d, B = z_tm.shape
    theta = z_tm.new_zeros((B, d))
    cum = z_tm.new_zeros((B,))
    fired = 0
    for t in range(T):
        z, yt = z_tm[t].t(), y_tm[t]
        if alg_flag == game.ALG_FTRL:
            sc = scales[t]
            x = sc * theta
            nsq = _line_sum(x * x, SEQ_LINE // 2)
            q = _line_sum(z * (sc * theta), SEQ_LINE // 2)
            proj = nsq > 1.0
            fired += int(proj.sum())
            f = _inv_sqrt(nsq)[:, None]
            q = torch.where(proj, _line_sum(z * (f * (sc * theta)),
                                            SEQ_LINE), q)
        else:
            nsq = _line_sum(theta * theta, SEQ_LINE)
            s = torch.where(nsq > 0, -_inv_sqrt(nsq), 0.0)[:, None]
            q = _line_sum(z * (s * theta), SEQ_LINE)
        diff = q - yt
        cum = cum + 0.5 * torch.abs(diff)
        theta = theta + (0.5 * torch.sign(diff))[:, None] * z
    return (cum, theta.t().contiguous()), fired / (T * B)


def k6aw_mirror(z, y, thresholds, lengths, *, replay):
    """K6aw's warp schedule on ``(B, T, d)`` rows with ragged lengths: x =
    s theta never stored (s the FTL scale of the last nsq, 0 at first);
    round t: the update with q (summed the round before), nsq and s, then
    round t's <x, w> beside round t + 1's <z_{t+1}, x> (only the one a
    sequence still needs: <x, w> while thresholds remain, q while rounds
    remain), then the threshold walk; the final <x, w> reused where the
    last round summed it.  Returns ``smart_prefix_reference``'s
    ``(partial, switch_t, comp)``."""
    B, T, d = z.shape
    G = thresholds.shape[0]
    ordered, perm = torch.sort(thresholds, stable=True)
    theta = z.new_zeros((B, d))
    w = z.new_zeros((B, d))
    s = z.new_zeros((B,))
    F = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    k = torch.zeros((B,), dtype=torch.int64)
    k_last = torch.zeros_like(k)
    partial = z.new_zeros((B, G))
    tau = torch.full((B, G), T, dtype=torch.int64)
    xw = z.new_zeros((B,))
    xw_final = torch.zeros((B,), dtype=torch.bool)
    lengths = lengths.to(torch.int64)
    q = _line_sum(z[:, 0] * (s[:, None] * theta), SEQ_LINE)
    for t in range(int(lengths.max())):
        on = lengths > t
        yt = y[:, t]
        diff = q - yt
        g = 0.5 * torch.sign(diff)
        theta = torch.where(on[:, None], theta + g[:, None] * z[:, t], theta)
        w = torch.where(on[:, None], w + yt[:, None] * z[:, t], w)
        F = torch.where(on, F + 0.5 * torch.abs(diff), F)
        cnt = torch.where(on, cnt + 1.0, cnt)
        more = on & (lengths > t + 1)
        nsq = _line_sum(theta * theta, SEQ_LINE)
        s = torch.where(on, torch.where(nsq > 0, -_inv_sqrt(nsq), 0.0), s)
        k_last = torch.where(lengths == t + 1, k, k_last)
        walk = on & (k < G)
        x = s[:, None] * theta
        xw = torch.where(walk, _line_sum(x * w, SEQ_LINE // 2), xw)
        if t + 1 < T:
            q = torch.where(more,
                            _line_sum(z[:, t + 1] * x, SEQ_LINE // 2), q)
        lead = F - 0.5 * (cnt - xw)
        while True:
            hit = walk & (k < G) & (lead >= ordered[k.clamp(max=G - 1)])
            if not bool(hit.any()):
                break
            rows = torch.nonzero(hit)[:, 0]
            cols = perm[k[hit]]
            tau[rows, cols] = t
            partial[rows, cols] = F[hit]
            k = k + hit.to(torch.int64)
        xw_final = torch.where(on, walk & ~more, xw_final)
    x = s[:, None] * theta
    if replay:
        comp = z.new_zeros((B,))
        for t in range(int(lengths.max())):
            qc = _line_sum(z[:, t] * x, SEQ_LINE)
            comp = torch.where(lengths > t,
                               comp + 0.5 * torch.abs(qc - y[:, t]), comp)
    else:
        xw = torch.where(xw_final, xw, _line_sum(x * w, SEQ_LINE))
        comp = 0.5 * (cnt - xw)
    sorted_pos = torch.empty_like(perm)
    sorted_pos[perm] = torch.arange(G)
    no_tail = sorted_pos[None, :] >= k_last[:, None]
    partial = torch.where(no_tail, (F - comp)[:, None], partial)
    return partial, tau, comp


def _e1_batch(B, T, d, seed, dtype):
    """The z = e1 family: every row e1, labels +-1 from the seed; FTL's
    q = y ties and integer leads (with thresholds sqrt(2T) / m at T = 200,
    sqrt(400) = 20)."""
    rng = np.random.default_rng(seed)
    z = np.zeros((B, T, d))
    z[..., 0] = 1.0
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    lengths = rng.integers(T // 2, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _mirror_batches(d, dtype):
    """(name, z, y, lengths, contract) for the mirrors: a contract batch,
    a replay batch and the tie family."""
    out = []
    for contract in (True, False):
        z, y, ln = _sweep_batch(6, 12, d, d + 7 * int(contract), contract,
                                dtype)
        out.append(("contract" if contract else "replay", z, y, ln,
                    contract))
    z, y, ln = _e1_batch(5, 200, d, d, dtype)
    out.append(("e1 ties", z, y, ln, True))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 640])
def test_k3w_warp_schedule_equals_plain(d, dtype):
    """K3w's schedule equals ``play_packed_reference`` in every bit, FTRL
    (eta up to 4, so that rounds project) and FTL, on a contract batch, a
    replay batch (zero rows past the lengths) and the z = e1 ties."""
    fired = []
    for name, z, y, ln, _ in _mirror_batches(d, dtype):
        valid = torch.arange(z.shape[1])[None, :] < ln[:, None]
        z_tm, y_tm = game.time_major(torch.where(valid[..., None], z, 0.0),
                                     torch.where(valid, y, 0.0))
        for eta, flags in ((0.5, (game.ALG_FTRL, game.ALG_FTL)),
                           (4.0, (game.ALG_FTRL,))):
            scales = game.ftrl_scales(z.shape[1], eta, dtype=dtype,
                                      device="cpu")
            for flag in flags:
                got, share = k3w_mirror(z_tm, y_tm, scales, flag)
                want = game.play_packed_reference(z_tm, y_tm, scales, flag)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    name, eta, flag)
                if flag == game.ALG_FTRL:
                    fired.append(share)
    assert max(fired) > 0.0 and min(fired) < 1.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 640])
def test_k6aw_warp_schedule_equals_plain(d, dtype):
    """K6aw's schedule (<x, w> of round t beside <z_{t+1}, x>, no stored
    x, the threshold walk) equals ``smart_prefix_reference`` in every bit
    on a contract batch, a replay batch (the replay comparator) and the z
    = e1 ties at integer thresholds, pairs switching early, late and
    never."""
    for name, z, y, ln, contract in _mirror_batches(d, dtype):
        T = z.shape[1]
        if name == "e1 ties":
            ths = torch.tensor([1.0, 2.0, 5.0, math.sqrt(2.0 * T), 1e30],
                               dtype=dtype)
        else:
            ths = torch.tensor([0.1, 0.5, 0.3, 1e30], dtype=dtype) * \
                math.sqrt(2.0 * T)
        got = k6aw_mirror(z, y, ths, ln, replay=not contract)
        want = smart.smart_prefix_reference(z, y, ths, ln,
                                            replay=not contract)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        tau = got[1]
        assert bool((tau < T).any()) and bool((tau == T).any()), name


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_k3w_mirror_matches_jax_kernel_interpret(alg_flag):
    """At d = 513 K3w's schedule against JAX ``play_packed`` (its
    VMEM-state twin) in interpret mode on one packed tile of sequences,
    T = 4, float32: cum and theta within 5e-4, the tolerance
    ``tests/test_torch_wide_d_sweeps.py`` holds the plain version to."""
    Tk, d = 4, 513
    rng = np.random.default_rng(190 + alg_flag)
    z = rng.normal(size=(jpg.SEQ_TILE, Tk, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((jpg.SEQ_TILE, Tk)) < 0.5, -1.0, 1.0)
    z32, y32 = z.astype(np.float32), y.astype(np.float32)
    zp, yp, Bp = jpg.pack_sequences(jnp.asarray(z32), jnp.asarray(y32))
    scales = jpg.ftrl_scales(Tk, 4.0)
    cum_j, th_j = jpg.play_packed(zp, yp, scales, alg_flag=alg_flag,
                                  interpret=True)
    z_tm, y_tm = game.time_major(torch.from_numpy(z32), torch.from_numpy(y32))
    (cum, theta), _ = k3w_mirror(z_tm, y_tm,
                                 torch.tensor(np.asarray(scales)),
                                 alg_flag)
    np.testing.assert_allclose(cum.numpy(), np.asarray(
        jpg.unpack_result(cum_j, Bp)), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(
        theta.numpy(),
        np.stack([np.asarray(jpg.unpack_result(th_j[j], Bp))
                  for j in range(d)]), rtol=0, atol=F32_TOL)


def test_k6aw_mirror_matches_jax_sweep_prefix_columns():
    """At d = 513 K6aw's schedule against the JAX package's SMART sweep
    in x64, ``simulate_smart_batch`` on the (sequence, threshold) cross
    product (the route ``smart_threshold_sweep`` takes off the TPU; JAX's
    ``smart_sweep_packed`` in interpret mode at d = 513 runs for many
    minutes on a CPU): every pair's switch round equal, and the regret of
    every pair without a tail (never switched, or at its last round)
    within 1e-9, the tolerance ``tests/test_torch_wide_d_sweeps.py`` holds
    the plain sweep to."""
    B, Tk, d = 8, 40, 513
    z, y, ln = _sweep_batch(B, Tk, d, 192, True, torch.float64)
    grid = np.array([0.7, 1.5, 3.0, 1e6])
    G = grid.shape[0]
    partial, tau, _ = k6aw_mirror(z, y, torch.as_tensor(grid), ln,
                                  replay=False)
    res = jax_smart_batch(jnp.repeat(jnp.asarray(z.numpy()), G, axis=0),
                          jnp.repeat(jnp.asarray(y.numpy()), G, axis=0),
                          jnp.tile(jnp.asarray(grid), B),
                          jnp.full((B * G,), ETA),
                          jnp.repeat(jnp.asarray(ln.numpy()), G))
    np.testing.assert_array_equal(tau.numpy(),
                                  np.asarray(res.switch_t).reshape(B, G))
    no_tail = tau.numpy() >= ln.numpy()[:, None] - 1
    np.testing.assert_allclose(
        partial.numpy()[no_tail],
        np.asarray(res.regret).reshape(B, G)[no_tail], rtol=0,
        atol=X64_TOL)
    assert no_tail.any() and not no_tail.all()


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
@pytest.mark.parametrize("kernel", ["K3", "K6a"])
def test_k3w_k6aw_launchers_follow_the_plans(monkeypatch, kernel, shared,
                                             storage):
    """``packed_plan`` and ``prefix_plan`` read the library's plan for z's
    storage (0 f32, 1 f64, 2 bf16) in its order, and the launchers hand
    the library a null state where the plan keeps the sequence's state in
    shared memory, else a buffer of the plan's elements a sequence in the
    compute dtype."""
    d, B, T = 1024, 5, 4
    state = 0 if shared else (1 if kernel == "K3" else 2) * d
    lib = _Library((8, 106_880, int(shared), state, 2_333))
    _stand_in(monkeypatch, lib)
    plan_fn, entry = {"K3": (game.packed_plan, "oco_packed_plan"),
                      "K6a": (game.prefix_plan, "oco_smart_prefix_plan")
                      }[kernel]
    code = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}[storage]
    assert plan_fn(d, storage) == {
        "warps": 8, "smem_bytes": 106_880, "shared": shared, "state": state,
        "max_shared_d": 2_333}
    assert lib.calls == [(entry, (code, d))]
    buffers = []
    allocate = game.wide_state

    def spy(*args):
        buffers.append(allocate(*args))
        return buffers[-1]

    monkeypatch.setattr(game, "wide_state", spy)
    monkeypatch.setattr(smart, "wide_state", spy)
    y_dtype = torch.int8 if storage == torch.bfloat16 else storage
    z = torch.zeros((B, T, d), dtype=storage)
    y = torch.ones((B, T), dtype=y_dtype)
    ln = torch.full((B,), T, dtype=torch.int32)
    compute = game.compute_dtype(storage)
    if kernel == "K3":
        z_tm, y_tm = game.time_major(z, y)
        before = game.PACKED_LAUNCHES
        game.launch_play_packed(z_tm, y_tm, torch.ones(T, dtype=compute), 0)
        assert game.PACKED_LAUNCHES == before + 1
    else:
        before = smart.SWEEP_LAUNCHES
        smart.launch_smart_prefix(z, y, torch.ones(2, dtype=compute),
                                  torch.arange(2, dtype=torch.int32),
                                  game.length_order(ln), ln, False)
        assert smart.SWEEP_LAUNCHES == before + 1
    name, args = lib.calls[-1]
    assert name.startswith("oco_play_packed_" if kernel == "K3"
                           else "oco_smart_prefix_") and d in args
    assert lib.calls[-2] == (entry, (code, d))
    (buf,) = buffers
    if shared:
        assert buf is None and args[-2] is None
    else:
        assert buf.numel() == state * B and buf.dtype == compute
        assert args[-2] == buf.data_ptr()


def test_k3w_k6aw_lines_and_shared_boundaries():
    """K3w's and K6aw's shared memory as the sources size it: lines of
    512 products (and the 16-byte gap); K3w's block of W = 32 / sizeof(z)
    warps holds two stages of 4-byte units (8-byte in f64) transposed to
    columns of d rounded up to 32 and 4 more, W thetas and W lines
    (115,072 bytes in f32 at d = 1,024: two blocks, 16 warps, in an SM's
    228 KB; bf16 172,576, one block of 16); K6aw's warp holds theta, w,
    the 16-byte window of a row and its line (28,704 bytes in f64 at d =
    1,024: 8 warps, the path's 1,024 sequences in one wave on 132 SMs).
    Each boundary lies past the path's d = 1,024."""
    k3 = _source_constants("game_kernel.cu", ("kSeqLine", "kBlockSmem"))
    k6 = _source_constants("smart_sweep_kernel.cu",
                           ("kPrefixLine", "kPrefixWarps", "kBlockSmem"))
    assert k3["kSeqLine"] == k6["kPrefixLine"] == SEQ_LINE
    assert k3["kBlockSmem"] == k6["kBlockSmem"] == 232448
    assert k6["kPrefixWarps"] == 8

    def up4(d):
        return -(-d // 4) * 4

    def k3_block(d, z_bytes):
        w = 32 // z_bytes
        unit = 8 if z_bytes == 8 else 4
        units = w * z_bytes // unit + (1 if z_bytes < unit else 0)
        pitch = -(-d // 32) * 32 + 4
        s = 8 if z_bytes == 8 else 4
        return (2 * units * pitch * unit + w * up4(d) * s
                + w * (SEQ_LINE + 16 // s) * s)

    def k6_warp(d, z_bytes, s):
        return (2 * up4(d) * s + (-(-d * z_bytes // 16)) * 16 + 16
                + (SEQ_LINE + 16 // s) * s)

    assert k3_block(1024, 4) == 115_072 and 2 * (115_072 + 1024) <= 233_472
    assert k3_block(1024, 2) == 172_576
    assert k3_block(1024, 8) == 115_008
    assert k6_warp(1024, 8, 8) == 28_704
    assert 8 * 28_704 <= k6["kBlockSmem"] and 8 * 132 >= 1024
    for block, fits in ((lambda d: k3_block(d, 4), 2240),
                        (lambda d: k3_block(d, 2), 1452),
                        (lambda d: k6_warp(d, 8, 8), 9512),
                        (lambda d: k6_warp(d, 4, 4), 19196)):
        assert block(fits) <= k3["kBlockSmem"] < block(fits + 1)
        assert fits > 1024
