"""The premises of K2w's two-launch design and of K10l's resident shape for
rows of 8,193 to 16,384 entries, held bit for bit on the CPU (the kernels
themselves run on the card only: tests/test_torch_cuda.py).

- K2w (K2 past d = 512) is K6aw's and K6bw's kernels in a K2 mode
  (``csrc/smart_sweep_kernel.cu``, ``kPlays``): the FTL launch plays a
  sequence on a warp (x = s theta never stored, round t's <x, w> beside
  round t + 1's <z_{t+1}, x>, a pointer over the sequence's own
  thresholds sorted along G), writes comp, each switch round and F at it,
  and for every pair without a tail its sum F and its action (the final
  FTL action, zeros where the switch came at the last valid round); the
  tail launch plays each switched pair's FTRL tail on a warp (K3w's round,
  ||x||^2 and <z_t, x> side by side, <z_t, f x> again where it projects)
  from F with its sequence's row of the scale table, writing the raw sum
  and the tail's last action.  A PyTorch mirror of that schedule equals
  ``smart_plays_reference`` in every bit at d = 513 and 1,100, f64 and
  f32, contract, replay and z = e1 tie batches, G = 1 to 4 with equal
  thresholds and thresholds the lead reaches exactly, and a switch at the
  last valid round; at d = 513 it stays within 1e-9 of the JAX package's
  x64 ``simulate_smart_batch``.
- K2w's host side: ``launch_smart`` past 512 reads both plans
  (``plays_plan``), allocates the one buffer they ask for (none where
  both fit shared memory), hands each launch its part, and counts two
  launches; the tail block's bytes from the source's constants fill a
  wave of 8 warps an SM at the path's d = 1,024 in f64.
- K10l's resident shape for rows of 8,193 to 16,384 entries (``Resident<D,
  1, 64>``: two rows a block, a group of 256 threads a row, t = i + 256 m)
  takes the rows between the four-row shape's and the streaming
  instance's: a NumPy float32 mirror of the three-shape schedule on a
  shrunken geometry (``tests/test_torch_k10l_layout.py``'s) gives every
  row the bits the streaming instance alone gives it.

Every warp sum is one lane's index-order sum from -0 (``oco_warp.cuh``);
here it is ``np.add.accumulate`` over the products in their dtype, which
adds in index order from the first product (-0 + p_0 is p_0 in every bit).
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
from online_convex_optimization_tpu_torch.ops import admm, game, smart
from online_convex_optimization_tpu_torch.utils import cuda_build
from test_torch_k10l_layout import Geometry, _inputs, _solve_blocks

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "online_convex_optimization_tpu_torch", "csrc")
ETA = math.sqrt(2.0)
X64_TOL = 1e-9
BLOCK_SMEM = 232448
SM_SMEM = 233472


def _line_sum(p: torch.Tensor) -> torch.Tensor:
    """A warp's sum of products over the last axis: in index order from
    -0, in the products' dtype."""
    return torch.from_numpy(
        np.add.accumulate(p.numpy(), axis=-1)[..., -1].copy())


def _inv_sqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` by a true divide where ``v > 0`` (else 1, masked by
    the callers)."""
    return torch.reciprocal(torch.sqrt(torch.where(v > 0, v, 1.0)))


def _bits(a: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (so that -0 and +0 differ)."""
    if not a.is_floating_point():
        return a
    return a.view({8: torch.int64, 4: torch.int32}[a.element_size()])


def _same(got, want) -> bool:
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


# ------------------------------------------------------------ K2w mirror

def k2w_ftl_mirror(z, y, thresholds, lengths, *, replay):
    """K2w's FTL launch: K6aw's warp schedule (x = s theta; round t's
    update, nsq and s, then <x, w> beside <z_{t+1}, x>, only the ones a
    sequence still needs) with a pointer over each sequence's thresholds
    sorted along G.  Returns ``(cum, comp, x_last, switch_t)`` as the
    launch leaves them (a tail pair's cum is F at its switch, its x_last
    unwritten: zeros here) and the switches at which the lead equalled its
    threshold."""
    B, T, d = z.shape
    G = thresholds.shape[0]
    ordered, perm = torch.sort(thresholds, dim=0, stable=True)
    theta = z.new_zeros((B, d))
    w = z.new_zeros((B, d))
    s = z.new_zeros((B,))
    F = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    k = torch.zeros((B,), dtype=torch.int64)
    k_last = torch.zeros_like(k)
    cum = z.new_zeros((G, B))
    tau = torch.full((G, B), T, dtype=torch.int64)
    x_last = z.new_zeros((G, B, d))
    xw = z.new_zeros((B,))
    xw_final = torch.zeros((B,), dtype=torch.bool)
    rows = torch.arange(B)
    lengths = lengths.to(torch.int64)
    ties = 0
    q = _line_sum(z[:, 0] * (s[:, None] * theta))
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
        nsq = _line_sum(theta * theta)
        s = torch.where(on, torch.where(nsq > 0, -_inv_sqrt(nsq), 0.0), s)
        k_last = torch.where(lengths == t + 1, k, k_last)
        walk = on & (k < G)
        x = s[:, None] * theta
        xw = torch.where(walk, _line_sum(x * w), xw)
        if t + 1 < T:
            q = torch.where(more, _line_sum(z[:, t + 1] * x), q)
        lead = F - 0.5 * (cnt - xw)
        while True:
            kk = k.clamp(max=G - 1)
            nxt = ordered[kk, rows]
            hit = walk & (k < G) & (lead >= nxt)
            if not bool(hit.any()):
                break
            ties += int((hit & (lead == nxt)).sum())
            r = rows[hit]
            cols = perm[kk[hit], r]
            tau[cols, r] = t
            cum[cols, r] = F[hit]
            k = k + hit.to(torch.int64)
        xw_final = torch.where(on, walk & ~more, xw_final)
    x = s[:, None] * theta
    if replay:
        comp = z.new_zeros((B,))
        for t in range(int(lengths.max())):
            qc = _line_sum(z[:, t] * x)
            comp = torch.where(lengths > t,
                               comp + 0.5 * torch.abs(qc - y[:, t]), comp)
    else:
        xw = torch.where(xw_final, xw, _line_sum(x * w))
        comp = 0.5 * (cnt - xw)
    # The pairs with no tail: F, and the final FTL action where the pair
    # never switched (zeros where it switched at its last valid round).
    for b in range(B):
        for m in range(int(k_last[b]), G):
            col = int(perm[m, b])
            cum[col, b] = F[b]
            if m >= int(k[b]):
                x_last[col, b] = x[b]
    return (cum, comp, x_last, tau), ties


def k2w_tails_mirror(z, y, scales, eidx, lengths, switch_t, cum, x_last):
    """K2w's tail launch on the FTL launch's outputs: each pair with
    switch_t + 1 < len plays rounds switch_t + 1 .. len - 1 from a fresh
    theta and its start sum, with its sequence's row ``eidx`` of the (E, T)
    scale table: K3w's round (x = sc theta, times f = 1 / sqrt(||x||^2)
    where it projects), the raw sum, and the action of its last round.
    Returns ``(cum, x_last)`` and the tail rounds that projected."""
    B, T, d = z.shape
    ln = lengths.to(torch.int64)[None, :]
    tail = switch_t + 1 < ln
    theta = z.new_zeros(switch_t.shape + (d,))
    cum, x_last = cum.clone(), x_last.clone()
    sc_rows = scales[eidx.long()]
    fired = 0
    for t in range(int(lengths.max())):
        on = tail & (t > switch_t) & (t < ln)
        if not bool(on.any()):
            continue
        zt, yt = z[:, t][None], y[:, t][None]
        sc = sc_rows[:, t][None, :, None]
        x = sc * theta
        nsq = _line_sum(x * x)
        q = _line_sum(zt * (sc * theta))
        proj = nsq > 1.0
        f = _inv_sqrt(nsq)[..., None]
        xf = f * (sc * theta)
        q = torch.where(proj, _line_sum(zt * xf), q)
        fired += int((proj & on).sum())
        act = torch.where(proj[..., None], xf, sc * theta)
        x_last = torch.where((on & (ln == t + 1))[..., None], act, x_last)
        diff = q - yt
        cum = torch.where(on, cum + 0.5 * torch.abs(diff), cum)
        theta = torch.where(on[..., None],
                            theta + (0.5 * torch.sign(diff))[..., None] * zt,
                            theta)
    return (cum, x_last), fired


def k2w_mirror(z, y, thresholds, lengths, *, replay):
    """Both launches, with the scalar ETA's table as ``smart_plays``
    builds it.  Returns ``(cum, comp, x_last, switch_t)``, the FTL
    launch's exact ties and the tails' projected rounds."""
    B, T, _ = z.shape
    (cum, comp, x_last, tau), ties = k2w_ftl_mirror(z, y, thresholds,
                                                    lengths, replay=replay)
    scales, eidx = game.eta_table(ETA, B, T, z.dtype, "cpu")
    (cum, x_last), fired = k2w_tails_mirror(z, y, scales, eidx, lengths, tau,
                                            cum, x_last)
    return (cum, comp, x_last, tau), ties, fired


def _batch(B, T, d, seed, dtype, *, contract):
    """Rows in the unit ball with labels +-1 (contract), or rows of norm
    up to ~3 with Gaussian labels (replay); ragged lengths, one full."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    if contract:
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    else:
        z *= 3.0 / math.sqrt(d)
        y = rng.normal(size=(B, T))
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _e1_batch(B, T, d, seed, dtype):
    """The z = e1 family: every row e1, labels +-1 from the seed; FTL's q =
    y ties and half-integer leads, which integer thresholds meet
    exactly."""
    rng = np.random.default_rng(seed)
    z = np.zeros((B, T, d))
    z[..., 0] = 1.0
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    lengths = rng.integers(T // 2, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _thresholds(base, B, dtype):
    """Four thresholds a sequence, ``base`` spread over the sequences:
    rows 0 and 1 equal, row 3 out of reach."""
    spread = torch.linspace(0.6, 1.4, B, dtype=torch.float64)
    rows = [base[0] * spread, base[0] * spread, base[1] * spread,
            torch.full((B,), 1e30, dtype=torch.float64)]
    return torch.stack(rows).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 1100])
def test_k2w_two_launch_schedule_equals_plain(d, dtype):
    """K2w's two launches, mirrored, equal ``smart_plays_reference`` in
    every bit (cum, comp, x_last, switch_t) for G = 1, 2, 3 and 4
    thresholds a sequence (two equal, one out of reach) on a contract
    batch, a replay batch and the z = e1 ties, where integer thresholds
    are met exactly; tails project, pairs switch early, late and never."""
    eta = None
    ties = fired = 0
    for name in ("contract", "replay", "e1 ties"):
        if name == "e1 ties":
            z, y, ln = _e1_batch(5, 40, d, d, dtype)
            ths = torch.stack([torch.tensor([1.0, 1.0, 2.0, 3.0, 4.0]),
                               torch.tensor([1.0, 1.0, 3.0, 4.0, 2.0]),
                               torch.tensor([2.0, 3.0, 3.0, 1.0, 1.0]),
                               torch.full((5,), 1e30)]).to(dtype)
        else:
            z, y, ln = _batch(6, 12, d, d + 7 * (name == "contract"), dtype,
                              contract=name == "contract")
            ths = _thresholds((0.1 * math.sqrt(24.0), 0.4 * math.sqrt(24.0)),
                              6, dtype)
        replay = name == "replay"
        B, T, _ = z.shape
        eta = game.per_sequence(ETA, B, dtype, "cpu")
        for G in (1, 2, 3, 4):
            got, n_ties, n_fired = k2w_mirror(z, y, ths[:G], ln,
                                              replay=replay)
            want = smart.smart_plays_reference(z, y, ths[:G], eta, ln,
                                               replay=replay)
            assert _same(got, want), (name, G)
            ties += n_ties
            fired += n_fired
            tau = got[3]
            if G == 4:
                assert bool((tau < T).any()) and bool((tau == T).any()), \
                    name
    assert ties > 0 and fired > 0


def test_k2w_switch_at_the_last_valid_round():
    """A pair whose switch comes at its last valid round has no tail: the
    FTL launch writes its sum F and zeros for its action, in every bit as
    ``smart_plays_reference``; the sequences are cut at a switch round of
    the full-length run."""
    d, T, dtype = 513, 40, torch.float64
    z, y, ln = _batch(6, T, d, 31, dtype, contract=True)
    ln = torch.full_like(ln, T)
    ths = _thresholds((0.1 * math.sqrt(2.0 * T), 0.4 * math.sqrt(2.0 * T)),
                      6, dtype)[[0, 3]]
    eta = game.per_sequence(ETA, 6, dtype, "cpu")
    tau = smart.smart_plays_reference(z, y, ths, eta, ln)[3][0]
    cut = torch.where(tau < T - 1, tau + 1, ln).to(torch.int32)
    got, _, _ = k2w_mirror(z, y, ths, cut, replay=False)
    want = smart.smart_plays_reference(z, y, ths, eta, cut)
    assert _same(got, want)
    last = got[3][0] == cut.long() - 1
    assert int(last.sum()) >= 2
    assert bool((got[2][0][last] == 0).all())
    assert not bool(torch.signbit(got[2][0][last]).any())


def test_k2w_mirror_matches_jax_x64():
    """At d = 513 the mirror against the JAX package's x64
    ``simulate_smart_batch`` on the (threshold, sequence) pairs: switch
    rounds equal; sums, comparators and last actions within 1e-9 (JAX
    scores the comparator by replay, the mirror by the identity)."""
    d, T, B = 513, 40, 6
    z, y, ln = _batch(B, T, d, 192, torch.float64, contract=True)
    root = math.sqrt(2.0 * T)
    ths = _thresholds((0.1 * root, 0.3 * root), B, torch.float64)[[0, 2, 3]]
    G = ths.shape[0]
    (cum, comp, x_last, tau), _, _ = k2w_mirror(z, y, ths, ln, replay=False)
    res = jax_smart_batch(jnp.tile(jnp.asarray(z.numpy()), (G, 1, 1)),
                          jnp.tile(jnp.asarray(y.numpy()), (G, 1)),
                          jnp.asarray(ths.numpy().reshape(-1)),
                          jnp.full((G * B,), ETA),
                          jnp.tile(jnp.asarray(ln.numpy()), G))
    np.testing.assert_array_equal(tau.numpy().reshape(-1),
                                  np.asarray(res.switch_t))
    np.testing.assert_allclose(cum.numpy().reshape(-1),
                               np.asarray(res.cum_loss), rtol=0,
                               atol=X64_TOL)
    np.testing.assert_allclose(np.tile(comp.numpy(), G),
                               np.asarray(res.comp_loss), rtol=0,
                               atol=X64_TOL)
    np.testing.assert_allclose(x_last.numpy().reshape(G * B, d),
                               np.asarray(res.x_last), rtol=0, atol=X64_TOL)
    on = tau < ln.long()[None, :] - 1
    assert bool(on.any()) and not bool(on.all())


# ------------------------------------------------------- K2w's host side

class _Library:
    """A stand-in for the CUDA library: records each C entry's arguments;
    its plays plan writes ``plans[tails]`` into the caller's array; every
    launch succeeds."""

    def __init__(self, plans):
        self.plans = plans
        self.calls = []

    def oco_smart_plays_plan(self, storage, tails, d, out):
        self.calls.append(("oco_smart_plays_plan", (storage, tails, d)))
        for i, v in enumerate(self.plans[tails]):
            out[i] = v
        return 0

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
@pytest.mark.parametrize("ftl_shared,tail_shared",
                         [(True, True), (True, False), (False, False)])
def test_k2w_launchers_follow_the_plans(monkeypatch, storage, ftl_shared,
                                        tail_shared):
    """Past 512 ``launch_smart`` reads K2w's two plans for z's storage (0
    f32, 1 f64, 2 bf16), allocates one buffer of the FTL plan's elements a
    sequence then the tail plan's a (threshold, sequence) pair (none where
    both keep their state in shared memory), hands the FTL launch its part
    (null where it needs none) and the tail launch the rest, the
    thresholds sorted along G with their columns and the sequences'
    descending-length order; two launches, each counted.  At 512 one
    launch of the thin K2 entry, with no buffer."""
    d, B, T, G = 1024, 5, 4, 3
    up4 = -(-d // 4) * 4
    plans = {0: (8, 229_632, int(ftl_shared), 0 if ftl_shared else 2 * up4,
                 9_512),
             1: (1, 26_672, int(tail_shared), 0 if tail_shared else up4,
                 9_596)}
    lib = _Library(plans)
    _stand_in(monkeypatch, lib)
    code = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}[storage]
    assert game.plays_plan(d, storage, tails=True) == {
        "warps": 1, "smem_bytes": 26_672, "shared": tail_shared,
        "state": 0 if tail_shared else up4, "max_shared_d": 9_596}
    lib.calls.clear()
    buffers = []
    allocate = game.wide_state

    def spy(*a):
        buffers.append(allocate(*a))
        return buffers[-1]

    monkeypatch.setattr(smart, "wide_state", spy)
    y_dtype = torch.int8 if storage == torch.bfloat16 else storage
    compute = game.compute_dtype(storage)
    z = torch.zeros((B, T, d), dtype=storage)
    y = torch.ones((B, T), dtype=y_dtype)
    ln = torch.tensor([2, 4, 1, 4, 3], dtype=torch.int32)
    ths = torch.tensor([[3.0, 1.0, 2.0, 0.5, 9.0],
                        [1.0, 1.0, 2.0, 7.0, 0.0],
                        [2.0, 1.0, 0.0, 0.5, 4.0]], dtype=compute)
    scales, eidx = game.eta_table(ETA, B, T, compute, "cpu")
    before = smart.LAUNCHES
    out = smart.launch_smart(z, y, ths, scales, eidx, ln, False)
    assert smart.LAUNCHES == before + 2
    suffix = game.storage_suffix(storage, y_dtype)
    names = [c[0] for c in lib.calls]
    assert names[-2:] == [f"oco_smart_plays_ftl_{suffix}",
                          f"oco_smart_plays_tails_{suffix}"]
    assert set(names[:-2]) == {"oco_smart_plays_plan"}
    assert {c[1] for c in lib.calls[:-2]} == {(code, 0, d), (code, 1, d)}
    ftl, tails = lib.calls[-2][1], lib.calls[-1][1]
    assert ftl[6:11] == (B, G, T, d, 0) and tails[8:12] == (B, G, T, d)
    cum, comp, x_last, tau = out
    assert ftl[11:15] == (cum.data_ptr(), tau.data_ptr(), comp.data_ptr(),
                          x_last.data_ptr())
    assert tails[2:4] == (scales.data_ptr(), eidx.data_ptr())
    assert tails[4] == ftl[3] and tails[7] == tau.data_ptr()
    assert tails[12:14] == (cum.data_ptr(), x_last.data_ptr())
    (buf,) = buffers
    n_ftl = 0 if ftl_shared else 2 * up4 * B
    n_tail = 0 if tail_shared else up4 * G * B
    if ftl_shared and tail_shared:
        assert buf is None and ftl[-2] is None and tails[-2] is None
    else:
        assert buf.numel() == n_ftl + n_tail and buf.dtype == compute
        assert ftl[-2] == (None if ftl_shared else buf.data_ptr())
        assert tails[-2] == buf.data_ptr() + n_ftl * buf.element_size()
    # At 512 the thin K2: one launch, no buffer.
    lib.calls.clear()
    buffers.clear()
    zt = torch.zeros((B, T, 512), dtype=storage)
    smart.launch_smart(zt, y, ths, scales, eidx, ln, False)
    assert smart.LAUNCHES == before + 3
    assert [c[0] for c in lib.calls] == [f"oco_smart_regrets_{suffix}"]
    assert not buffers


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _tail_block(d, P, z_bytes, s_bytes, line):
    """K6bw's kernel's block as smart_sweep_kernel.cu sizes it: P thetas,
    two stages of the 16-byte window around a row, P lines."""
    up4 = -(-d // 4) * 4
    stage = ((d * z_bytes + 15) // 16) * 16 + 16
    return P * up4 * s_bytes + 2 * stage + P * (line + 16 // s_bytes) * \
        s_bytes


def test_k2w_tail_block_fills_a_wave():
    """K2w's tail launch plays one tail a block with lines of
    kPlaysTailLine = 256 products: 26,672 bytes at the path's d = 1,024 in
    f64, so that 8 blocks (the 8 warps an SM its ~205 registers allow) fit
    an SM's 228 KB with their 1 KB reserves, and 132 x 8 = 1,056 blocks
    hold the path's 1,024 tails in one wave; K6bw's lines of 512 would fit
    7 (924).  Its state lies on the chip to d = 9,596 in f64."""
    src = _source("smart_sweep_kernel.cu")
    line = int(re.search(r"constexpr int kPlaysTailLine = (\d+);",
                         src).group(1))
    assert re.search(r"kTailP = kPlays \? 1 : kTailGroup;", src)
    assert line == 256
    block = _tail_block(1024, 1, 8, 8, line)
    assert block == 26_672
    assert 8 * (block + 1024) <= SM_SMEM
    wide = _tail_block(1024, 1, 8, 8, 512)
    assert 7 * (wide + 1024) <= SM_SMEM < 8 * (wide + 1024)
    assert 132 * 8 >= 1024 > 132 * 7
    assert _tail_block(9596, 1, 8, 8, line) <= BLOCK_SMEM < _tail_block(
        9597, 1, 8, 8, line)


# ------------------------------------------- K10l's 16,384-entry shape

def _three_shape_blocks(B, T, geo, cap2):
    """K10l's blocks on a shrunken geometry with the three instances: the
    streaming one on rows past cap2, two-row resident blocks on the rows
    of cap + 1 .. cap2 entries, then four-row blocks (geo.R) on the rows
    of long_rows + 1 .. cap, longest first."""
    hi = min(T, cap2)
    blocks = [(g % B, T - g // B, 1, False)
              for g in range((T - cap2) * B) if T > cap2]
    for lo, top_max, R in ((geo.cap, cap2, 2), (geo.long_rows, geo.cap,
                                                 geo.R)):
        top0 = min(hi, top_max)
        if top0 <= lo:
            continue
        for g in range(-(-(top0 - lo) // R) * B):
            top = top0 - (g // B) * R
            blocks.append((g % B, top, min(R, top - lo), True))
    return blocks


@pytest.mark.parametrize("d,tol,iters,B", [(5, 0.0, 8, 1), (5, 0.25, 8, 2)])
def test_two_row_resident_shape_equals_streaming_schedule(d, tol, iters, B):
    """The two-row resident shape (rows of cap + 1 .. 2 cap entries, a
    group of threads a row, each thread's entries t = i + threads m in
    increasing order from the ring, the rows' warps reduced in warp order)
    beside the four-row shape and the streaming instance past 2 cap: every
    row's bits equal the streaming instance's alone; each thread read its
    entries of each pass in order."""
    geo = Geometry()
    cap2 = 2 * geo.cap
    T = cap2 + 8
    z, y = _inputs(B, T, d, seed=80 + d)
    Lpk = admm.admm_prologue(torch.from_numpy(z)).numpy()
    kw = dict(iters=iters, tol=tol, check_every=4, alpha=1.7)
    blocks = _three_shape_blocks(B, T, geo, cap2)
    assert {rows for _, _, rows, res in blocks if res} == {2, 4}
    record = []
    new = _solve_blocks(z, y, Lpk, None, geo, blocks, kw, record)
    old = _solve_blocks(z, y, Lpk, None, geo,
                        [(g % B, T - g // B, 1, False)
                         for g in range((T - geo.long_rows) * B)], kw)
    assert sorted(new) == sorted(old) == sorted(
        (b, L) for b in range(B) for L in range(geo.long_rows + 1, T + 1))
    for key in old:
        for a, c in zip(new[key], old[key]):
            assert np.array_equal(np.asarray(a), np.asarray(c),
                                  equal_nan=True), key
    seen = {}
    for b, top, p, i, t in record:
        seen.setdefault((b, top, p, i), []).append(t)
    assert any(top > geo.cap for b, top, p, i in seen)
    for (b, top, p, i), ts in seen.items():
        assert ts == list(range(i, top, geo.threads))


def test_resident_shapes_match_the_source():
    """The wrapper's row map against the CUDA source: the four-row shape
    (RG = 2, M = 32) to 8,192 entries, the two-row shape (RG = 1, M = 64)
    to 16,384, both 64 entries of s and u a thread, the one-row block past
    16,384."""
    src = _source("admm_long_kernel.cu")
    assert re.search(r"constexpr int kResidentLongRows = 16384;", src)
    assert re.search(r"using ResidentShort = Resident<D, 2, kResidentRows "
                     r"/ kThreads>;", src)
    assert re.search(r"using ResidentLong = Resident<D, 1, "
                     r"kResidentLongRows / kThreads>;", src)
    assert admm.RESIDENT_LONG_ROWS == 2 * admm.RESIDENT_ROWS == 16384
    assert 2 * (admm.RESIDENT_ROWS // 256) == admm.RESIDENT_LONG_ROWS // 256
    assert admm.instance_rows("resident_long", 9216) == (8192, 9216)
    assert admm.instance_rows("resident_long", 20000) == (8192, 16384)
    assert admm.instance_rows("resident_one", 16385) == (16384, 16385)
    assert admm.kernel_instances(9216) == ["resident_long", "resident", 16,
                                           8]
    assert admm.kernel_instances(16385) == ["resident_one", "resident_long",
                                            "resident", 16, 8]
