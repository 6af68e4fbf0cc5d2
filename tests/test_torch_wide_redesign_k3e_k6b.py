"""The premises of K3ew's and K6bw's designs past d = 512, held bit for bit
against the plain versions on the CPU (the kernels themselves run on the
card only: tests/test_torch_cuda.py).

- K3ew (``csrc/game_kernel.cu`` ``packed_wide_kernel`` with kEta) is K3w's
  warp-a-sequence kernel on the same time-major tiles with the warp's own
  FTRL scale, -(eta_b / sqrt(t + 1)) in the compute type, as
  ``ftrl_action`` forms it: ||x||^2 and <z_t, x> side by side, <z_t, f x>
  again where the round projects, the update lane-parallel.  A PyTorch
  mirror of that schedule equals ``play_packed_eta_reference`` in every
  bit.
- K6bw (``csrc/smart_sweep_kernel.cu`` ``smart_tail_wide_kernel``) plays a
  tail on a warp: a block takes P consecutive thresholds in sorted order
  (K6a's ``perm``) of one sequence and steps its warps in lockstep over
  the sequence's rows from its earliest start; a warp before its start,
  or with no tail, waits through the rounds; a block with no tail leaves
  at once.  A mirror of that schedule with P = 1, 2, 3, 4 and 8 equals
  ``smart_tails_reference`` in every bit, on K6a's outputs and on a
  constructed switch table with tails that start at different rounds in
  one group, a switch at round 0, a switch at the last valid round (no
  tail) and groups with no tail.
- Cases: d = 513 and 640, f64 and f32, contract, replay and z = e1 tie
  batches, with projections firing.  At d = 513 both mirrors stay within
  1e-9 of the JAX package's x64 scans (``simulate_linear_batch`` with a
  per-sequence eta, ``smart_threshold_sweep`` on its scan route).
- The host side: ``packed_plan`` (K3w's, which K3ew follows) and
  ``tail_plan`` read the library's plans, the launchers allocate what
  they ask for, and K6bw's block from the source's constants.

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
from online_convex_optimization_tpu.models.sweep_api import (
    smart_threshold_sweep as jax_smart_sweep,
)
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "online_convex_optimization_tpu_torch", "csrc")
X64_TOL = 1e-9
ETA = math.sqrt(2.0)
BLOCK_SMEM = 232448
GROUPS = (1, 2, 3, 4, 8)


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
    """An FTRL round's q as the warps form it (``oco::ftrl_q``): x = sc
    theta, ||x||^2 and <z_t, x> side by side, <z_t, f x> again where
    ||x||^2 > 1.  ``sc`` is one scale a row of theta.  Returns
    ``(q, projected)``."""
    sc = sc[:, None]
    x = sc * theta
    nsq = _line_sum(x * x)
    q = _line_sum(z * (sc * theta))
    proj = nsq > 1.0
    f = _inv_sqrt(nsq)[:, None]
    return torch.where(proj, _line_sum(z * (f * (sc * theta))), q), proj


def _hinge(theta, cum, q, yt, z, on):
    """The hinge step, then the update, where ``on``."""
    diff = q - yt
    cum = torch.where(on, cum + 0.5 * torch.abs(diff), cum)
    theta = torch.where(on[:, None],
                        theta + (0.5 * torch.sign(diff))[:, None] * z, theta)
    return theta, cum


def k3ew_mirror(z_tm, y_tm, eta):
    """K3ew's warp schedule on time-major ``(T, d, B)`` rows with a
    per-sequence ``eta`` ``(B,)``: the round's scale -(eta_b / sqrt(t + 1))
    formed by each warp, x never stored.  Returns ``(cum (B,), theta (d,
    B))`` and the rounds that projected."""
    T, d, B = z_tm.shape
    theta = z_tm.new_zeros((B, d))
    cum = z_tm.new_zeros((B,))
    on = torch.ones(B, dtype=torch.bool)
    fired = 0
    for t in range(T):
        z = z_tm[t].t()
        sc = -(eta / torch.sqrt(torch.tensor(float(t + 1),
                                             dtype=theta.dtype)))
        q, proj = _ftrl_q(theta, z, sc)
        fired += int(proj.sum())
        theta, cum = _hinge(theta, cum, q, y_tm[t], z, on)
    return (cum, theta.t().contiguous()), fired


def k6bw_mirror(z, y, scales, perm, order, lengths, switch_t, partial, comp,
                group):
    """K6bw's schedule on ``(B, T, d)`` rows and K6a's outputs as the
    launcher takes them (``switch_t`` and ``partial`` ``(G, B)``): block
    (grp, slot) plays sorted thresholds grp P .. grp P + P - 1 (columns
    ``perm``) of sequence ``order[slot]``, a warp each, all its warps
    stepping rounds first .. len - 1 together (first: the group's earliest
    start), each playing its tail's rounds tau + 1 .. len - 1 with the
    table's scale at the global round from a fresh theta and the starting
    sum; a block with no tail leaves.  Returns the ``(G, B)`` regrets
    (``partial`` where there is no tail) and each block's ``(first, len,
    starts, rounds stepped)``, first None where the block left."""
    B, T, d = z.shape
    G = switch_t.shape[0]
    P = group
    groups = -(-G // P)
    n_blk = groups * B
    slot = torch.arange(n_blk) % B
    grp = torch.arange(n_blk) // B
    b = order.long()[slot]
    ln = lengths.long()[b]
    k = grp[:, None] * P + torch.arange(P)[None, :]           # (blocks, P)
    real = k < G
    col = perm.long()[k.clamp(max=G - 1)]
    tau = switch_t[col, b[:, None]]
    start = torch.where(real & (tau + 1 < ln[:, None]), tau + 1,
                        ln[:, None])
    tail = start < ln[:, None]
    first = start.min(dim=1).values
    live = first < ln
    theta = z.new_zeros((n_blk * P, d))
    cum = torch.where(tail, partial[col, b[:, None]], 0.0).reshape(-1)
    stepped = torch.zeros(n_blk, dtype=torch.int64)
    for t in range(int(ln.max()) if n_blk else 0):
        block_on = live & (t >= first) & (t < ln)
        if not bool(block_on.any()):
            continue
        stepped += block_on.long()
        plays = (block_on[:, None] & (t >= start)).reshape(-1)
        zt = z[b, t].repeat_interleave(P, dim=0)
        yt = y[b, t].repeat_interleave(P)
        q, _ = _ftrl_q(theta, zt, scales[t].expand(n_blk * P))
        theta, cum = _hinge(theta, cum, q, yt, zt, plays)
    regret = partial.clone()
    cum = cum.reshape(n_blk, P)
    for i, w in torch.nonzero(tail).tolist():
        regret[col[i, w], b[i]] = cum[i, w] - comp[b[i]]
    blocks = [(int(first[i]) if bool(live[i]) else None, int(ln[i]),
               [int(s) for s, r in zip(start[i], real[i]) if bool(r)],
               int(stepped[i])) for i in range(n_blk)]
    return regret, blocks


def _batch(B, T, d, seed, dtype, *, contract):
    """Rows in the unit ball with labels +-1 (contract) or rows of norm up
    to 1.5 with normal labels (replay), ragged lengths in [1, T]."""
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
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _e1_batch(B, T, d, seed, dtype):
    """The z = e1 family: every row e1, labels +-1 from the seed; FTL's
    q = y ties and integer leads."""
    rng = np.random.default_rng(seed)
    z = np.zeros((B, T, d))
    z[..., 0] = 1.0
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    lengths = rng.integers(T // 2, T + 1, size=B)
    lengths[0] = T
    return (torch.as_tensor(z, dtype=dtype), torch.as_tensor(y, dtype=dtype),
            torch.as_tensor(lengths, dtype=torch.int32))


def _mirror_batches(d, dtype):
    """(name, z, y, lengths, replay): a contract batch, a replay batch and
    the tie family."""
    return [
        ("contract", *_batch(6, 14, d, d + 11, dtype, contract=True), False),
        ("replay", *_batch(5, 12, d, d + 12, dtype, contract=False), True),
        ("e1 ties", *_e1_batch(4, 120, d, d + 13, dtype), False),
    ]


def _padded_time_major(z, y, lengths):
    """The packed API's rows: zero rows past each length, time-major."""
    valid = torch.arange(z.shape[1])[None, :] < lengths[:, None]
    return game.time_major(torch.where(valid[..., None], z, 0.0),
                           torch.where(valid, y, 0.0))


# ------------------------------------------------------------------ K3ew

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 640])
def test_k3ew_warp_schedule_equals_plain(d, dtype):
    """K3ew's schedule equals ``play_packed_eta_reference`` in every bit,
    eta from 0.3 to 4.0 a sequence (rounds project in some sequences and
    not in others), on a contract batch, a replay batch (zero rows past
    the lengths) and the z = e1 ties."""
    fired = []
    for name, z, y, ln, _ in _mirror_batches(d, dtype):
        z_tm, y_tm = _padded_time_major(z, y, ln)
        T, _, B = z_tm.shape
        eta = torch.linspace(0.3, 4.0, B, dtype=dtype)
        got, n = k3ew_mirror(z_tm, y_tm, eta)
        want = game.play_packed_eta_reference(z_tm, y_tm, eta)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        fired.append(n / (T * B))
    assert max(fired) > 0.0 and min(fired) < 1.0


def test_k3ew_mirror_matches_jax_x64():
    """At d = 513 K3ew's schedule against the JAX package's x64 scan
    ``simulate_linear_batch`` with a per-sequence eta on the packed API's
    zero-padded rows: cum and the regret through the comparator epilogue
    within 1e-9."""
    B, T, d = 8, 40, 513
    z, y, ln = _batch(B, T, d, 210, torch.float64, contract=True)
    z_tm, y_tm = _padded_time_major(z, y, ln)
    eta = np.linspace(0.3, 2.5, B)
    (cum, theta), _ = k3ew_mirror(z_tm, y_tm, torch.as_tensor(eta))
    zp, yp = (t.numpy() for t in (z_tm.permute(2, 0, 1), y_tm.t()))
    want = jax_linear_batch(jnp.asarray(zp), jnp.asarray(yp), 0,
                            jnp.asarray(eta), jnp.asarray(ln.numpy()))
    np.testing.assert_allclose(cum.numpy(), np.asarray(want.cum_loss),
                               rtol=0, atol=X64_TOL)
    regret = game.comparator_epilogue(z_tm, y_tm, cum, theta)
    np.testing.assert_allclose(regret.numpy(), np.asarray(want.regret),
                               rtol=0, atol=X64_TOL)


# ------------------------------------------------------------------ K6bw

def _prefix(z, y, ths, ln, replay):
    """K6a's outputs as the launchers pass them on: the sorted columns
    (int32), the sequence order, and ``(G, B)`` partial and switch
    rounds."""
    partial, tau, comp = smart.smart_prefix_reference(z, y, ths, ln,
                                                      replay=replay)
    _, perm = torch.sort(ths, stable=True)
    return (perm.to(torch.int32), game.length_order(ln),
            partial.t().contiguous(), tau.t().contiguous(), comp)


def _tails(z, y, ln, scales, perm, order, tau, partial, comp):
    """``smart_tails_reference`` on the launcher's ``(G, B)`` layout."""
    return smart.smart_tails_reference(z, y, scales, ln, tau.t(), partial.t(),
                                       comp).t()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [513, 640])
def test_k6bw_lockstep_schedule_equals_plain(d, dtype):
    """K6bw's lockstep schedule with P = 1, 2, 3, 4 and 8 tails a block
    equals ``smart_tails_reference`` in every bit on K6a's outputs (eta up
    to 4, so that tail rounds project), on a contract batch, a replay
    batch and the z = e1 ties, with thresholds that switch at round 0 (a
    negative one), early, late and never; every block steps its rounds
    from its earliest start to the sequence's end."""
    for name, z, y, ln, replay in _mirror_batches(d, dtype):
        T = z.shape[1]
        ths = torch.tensor([0.3, -1.0, 0.05, 0.15, 1e30, 0.6, 0.1],
                           dtype=dtype) * math.sqrt(2.0 * T)
        if name == "e1 ties":
            ths = torch.tensor([1.0, 2.0, -1.0, 5.0, math.sqrt(2.0 * T),
                                1e30, 3.0], dtype=dtype)
        perm, order, partial, tau, comp = _prefix(z, y, ths, ln, replay)
        assert bool((tau == 0).any()) and bool((tau == T).any()), name
        for eta in (ETA, 4.0):
            scales = game.sweep_scales(torch.tensor([eta], dtype=dtype), T)[0]
            want = _tails(z, y, ln, scales, perm, order, tau, partial, comp)
            for P in GROUPS:
                got, blocks = k6bw_mirror(z, y, scales, perm, order, ln, tau,
                                          partial, comp, P)
                assert torch.equal(got, want), (name, eta, P)
                assert all(n == (0 if f is None else end - f)
                           for f, end, _, n in blocks), (name, P)


def _switch_table(T):
    """A constructed K6a output for 3 sequences and G = 7 thresholds: the
    switch rounds nondecreasing in sorted order, as K6a's pointer walk
    makes them.  Sequence 0 (len T): switches at 0, 0, 3, 9, 9, T - 1 (its
    last valid round: no tail), never; sequence 1 (len T - 5): none
    switches; sequence 2 (len 7): 2, 6 (its last round), never."""
    lengths = torch.tensor([T, T - 5, 7], dtype=torch.int32)
    by_sorted = torch.tensor([[0, 0, 3, 9, 9, T - 1, T],
                              [T] * 7,
                              [2, 6, T, T, T, T, T]], dtype=torch.int64)
    perm = torch.tensor([4, 0, 6, 2, 5, 1, 3], dtype=torch.int32)
    tau = torch.empty((7, 3), dtype=torch.int64)
    tau[perm.long()] = by_sorted.t()
    return lengths, perm, tau


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k6bw_lockstep_on_a_constructed_switch_table(dtype):
    """On a constructed switch table at d = 513 (tails that start at
    rounds 1, 1, 4, 10, 10 of one sequence, a switch at round 0, one at the
    last valid round with no tail, a sequence with none, a short one),
    every group size P = 1 .. 8 equals ``smart_tails_reference`` in every
    bit, and the schedule is the kernel's: a block with no tail leaves
    (for every P some do), a block steps from its earliest start (warps of
    one block start at different rounds for P >= 2), a warp whose pair
    switched at the last round plays nothing."""
    T, d = 24, 513
    z, y, _ = _batch(3, T, d, 214, dtype, contract=True)
    ln, perm, tau = _switch_table(T)
    order = game.length_order(ln)
    rng = np.random.default_rng(5)
    partial = torch.as_tensor(rng.normal(size=(7, 3)), dtype=dtype)
    comp = torch.as_tensor(rng.normal(size=3), dtype=dtype)
    scales = game.sweep_scales(torch.tensor([4.0], dtype=dtype), T)[0]
    want = _tails(z, y, ln, scales, perm, order, tau, partial, comp)
    no_tail = tau + 1 >= ln[None, :].long()
    assert torch.equal(want[no_tail], partial[no_tail])
    assert not bool(no_tail.all())
    for P in GROUPS:
        got, blocks = k6bw_mirror(z, y, scales, perm, order, ln, tau,
                                  partial, comp, P)
        assert torch.equal(got, want), P
        assert any(f is None for f, _, _, _ in blocks), P
        starts = [sorted({s for s in st if s < end})
                  for f, end, st, _ in blocks if f is not None]
        if P >= 2:
            assert any(len(s) >= 2 for s in starts), P
        for f, end, st, n in blocks:
            if f is not None:
                assert f == min(st) and n == end - f
    # The pair that switched at sequence 0's last round keeps its partial.
    assert want[perm[5], 0] == partial[perm[5], 0]


def test_k6bw_mirror_matches_jax_x64():
    """At d = 513 K6aw's plain prefix and K6bw's schedule (P = 4) against
    the JAX package's x64 ``smart_threshold_sweep`` on its scan route
    (``use_kernel=False``; its Pallas kernel in interpret mode at d = 513
    does not finish in minutes): every regret within 1e-9, with pairs that
    switch at round 0, pairs with tails and pairs that never switch."""
    B, T, d = 8, 40, 513
    z, y, ln = _batch(B, T, d, 215, torch.float64, contract=True)
    grid = np.array([0.7, -1.0, 1.5, 3.0, 1e6])
    ths = torch.as_tensor(grid)
    perm, order, partial, tau, comp = _prefix(z, y, ths, ln, False)
    scales = game.sweep_scales(torch.tensor([ETA], dtype=torch.float64),
                               T)[0]
    got, _ = k6bw_mirror(z, y, scales, perm, order, ln, tau, partial, comp, 4)
    want = jax_smart_sweep(jnp.asarray(z.numpy()), jnp.asarray(y.numpy()),
                           jnp.asarray(grid), eta0=ETA,
                           length=jnp.asarray(ln.numpy()), use_kernel=False)
    np.testing.assert_allclose(got.t().numpy(), np.asarray(want), rtol=0,
                               atol=X64_TOL)
    tail = tau + 1 < ln[None, :].long()
    assert bool((tau == 0).any()) and bool(tail.any())
    assert bool((tau == T).any())


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

    def oco_packed_plan(self, storage, d, out):
        return self._plan("oco_packed_plan", (storage, d), out)

    def oco_smart_tail_plan(self, storage, d, out):
        return self._plan("oco_smart_tail_plan", (storage, d), out)

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
@pytest.mark.parametrize("kernel", ["K3e", "K6b"])
def test_k3ew_k6bw_launchers_follow_the_plans(monkeypatch, kernel, shared,
                                              storage):
    """K3ew's launcher follows K3w's plan (``packed_plan``) and K6bw's
    ``tail_plan``, each read for z's storage (0 f32, 1 f64, 2 bf16) in its
    order: a null state where the plan keeps the state in shared memory,
    else a buffer of the plan's elements a sequence (K6bw: a (threshold,
    sequence) pair, G = 3) in the compute dtype; K6bw's launch takes K6a's
    perm."""
    d, B, T, G = 1024, 5, 4, 3
    state = 0 if shared else d
    lib = _Library((8 if kernel == "K3e" else 4, 106_880, int(shared), state,
                    2_333))
    _stand_in(monkeypatch, lib)
    code = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}[storage]
    plan_fn, entry = {"K3e": (game.packed_plan, "oco_packed_plan"),
                      "K6b": (game.tail_plan, "oco_smart_tail_plan")}[kernel]
    assert plan_fn(d, storage) == {
        "warps": 8 if kernel == "K3e" else 4, "smem_bytes": 106_880,
        "shared": shared, "state": state, "max_shared_d": 2_333}
    assert lib.calls == [(entry, (code, d))]
    buffers = []
    allocate = game.wide_state

    def spy(*a):
        buffers.append(allocate(*a))
        return buffers[-1]

    monkeypatch.setattr(game, "wide_state", spy)
    monkeypatch.setattr(smart, "wide_state", spy)
    y_dtype = torch.int8 if storage == torch.bfloat16 else storage
    z = torch.zeros((B, T, d), dtype=storage)
    y = torch.ones((B, T), dtype=y_dtype)
    ln = torch.full((B,), T, dtype=torch.int32)
    compute = game.compute_dtype(storage)
    perm = torch.tensor([2, 0, 1], dtype=torch.int32)
    if kernel == "K3e":
        z_tm, y_tm = game.time_major(z, y)
        before = game.PACKED_ETA_LAUNCHES
        game.launch_play_packed_eta(z_tm, y_tm, torch.ones(B, dtype=compute))
        assert game.PACKED_ETA_LAUNCHES == before + 1
    else:
        before = smart.SWEEP_TAIL_LAUNCHES
        smart.launch_smart_tails(
            z, y, torch.ones((1, T), dtype=compute), perm,
            game.length_order(ln), ln, torch.zeros((G, B), dtype=torch.int64),
            torch.zeros(B, dtype=compute), torch.zeros((G, B), dtype=compute))
        assert smart.SWEEP_TAIL_LAUNCHES == before + 1
    name, args = lib.calls[-1]
    assert name.startswith("oco_play_packed_eta_" if kernel == "K3e"
                           else "oco_smart_tails_") and d in args
    if kernel == "K6b":
        assert args[3] == perm.data_ptr()
    assert lib.calls[-2] == (entry, (code, d))
    (buf,) = buffers
    if shared:
        assert buf is None and args[-2] is None
    else:
        seqs = B if kernel == "K3e" else G * B
        assert buf.numel() == state * seqs and buf.dtype == compute
        assert args[-2] == buf.data_ptr()


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _up4(d):
    return -(-d // 4) * 4


def _k6bw_block(d, P, z_bytes, s_bytes, line):
    """K6bw's block as smart_sweep_kernel.cu sizes it: P thetas, two
    stages of the 16-byte window around a row, P lines."""
    stage = ((d * z_bytes + 15) // 16) * 16 + 16
    return P * _up4(d) * s_bytes + 2 * stage + P * (line + 16 // s_bytes) * \
        s_bytes


def test_k6bw_block_and_shared_boundary():
    """K6bw's shared memory as the source sizes it, at its group of
    kTailGroup tails (OCO_TAIL_GROUP, 2) and lines of 512 products: at d =
    1,024 41,024 bytes in f64 (five blocks an SM's shared memory holds; its
    205 registers hold four) and 20,544 in f32; its boundary
    (7,004 in f64) lies past the path's d = 1,024 for every group size the
    source allows a measurement of (1, 2, 4, 8), in f64, f32 and
    bf16."""
    src = _source("smart_sweep_kernel.cu")
    P = int(re.search(r"#define OCO_TAIL_GROUP (\d+)", src).group(1))
    line = int(re.search(r"constexpr int kTailLine = (\d+);", src).group(1))
    assert (P, line) == (2, 512)
    assert _k6bw_block(1024, P, 8, 8, line) == 41_024
    assert 5 * (41_024 + 1024) <= 233_472 < 6 * (41_024 + 1024)
    assert _k6bw_block(1024, P, 4, 4, line) == 20_544
    for group in (1, 2, 4, 8):
        for z_bytes, s_bytes in ((8, 8), (4, 4), (2, 4)):
            fits = max(dd for dd in range(513, 40_000)
                       if _k6bw_block(dd, group, z_bytes, s_bytes, line)
                       <= BLOCK_SMEM)
            assert fits > 1024, (group, z_bytes)
    assert _k6bw_block(7004, P, 8, 8, line) <= BLOCK_SMEM < _k6bw_block(
        7005, P, 8, 8, line)
