"""The premises of K8's and K7's Hopper designs, shown on the CPU.

K8 (``csrc/quad_game_kernel.cu``, ``csrc/oco_trs.cuh``):

- the Newton loop's exact exit (``trs_action_settled``, the plain mirror
  of ``oco::trs_pass``: a pass whose carry comes back unchanged, or
  equal to the carry of two passes back with the parity rule) gives the
  fixed count's action bit for bit, in float32 and float64, on the study
  stream's prefixes (singular t < d included), random PSD problems,
  interior-only and boundary problems;
- a plain mirror of the kernel's per-lane rounds (each lane hands over to
  its next round as soon as its own solve is done, through the wrapper's
  lane map) equals ``quadratic_regrets_reference`` bit for bit;
- the lane map puts every sequence on one thread, in warps of one flag;
- the study's single call gives the per-(run, horizon) calls' statistics
  bit for bit.

K7 (``csrc/synthetic_kernel.cu``, ``csrc/oco_philox.cuh``):

- the host's round keys are the keys Philox bumps to, for 64-bit seeds;
- the scale table's round index, formed from a chunk start and an offset
  in 32 bits, converts to the same float as the 64-bit ``t + 1``.

Every comparison is exact (bit for bit): each design is exact by
construction, and these tests hold the arguments that say so.
"""

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.data.sequences import (
    make_regression_stream,
)
from online_convex_optimization_tpu_torch.experiments import quadratic_study
from online_convex_optimization_tpu_torch.models.quadratic import (
    simulate_quadratic_batch,
)
from online_convex_optimization_tpu_torch.ops import philox, trs

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]


def _bitwise_equal(got, want):
    return all(bool(trs._same_bits(g, w).all()) for g, w in zip(got, want))


def _packed(A, b):
    """Lists of packed lower-triangle entries and b components."""
    d = b.shape[-1]
    rows, cols = trs.tri_index(d)
    return ([A[..., r, c] for r, c in zip(rows, cols)],
            [b[..., i] for i in range(d)])


def _problems(family, dtype):
    if family == "study":
        As, bs = [], []
        for rep in range(3):
            z, y, _ = make_regression_stream(sigma=0.1, run_seed=rep)(80,
                                                                     rep=rep)
            z, y = z.astype(np.float64), y.astype(np.float64)
            A = np.concatenate([np.zeros((1, 5, 5)),
                                np.cumsum(z[:, :, None] * z[:, None], 0)])
            b = np.concatenate([np.zeros((1, 5)),
                                np.cumsum(y[:, None] * z, 0)])
            As.append(A)
            bs.append(b)
        A, b = np.concatenate(As), np.concatenate(bs)
    else:
        rng = np.random.default_rng({"psd": 1, "interior": 2,
                                     "boundary": 3}[family])
        M = rng.normal(size=(400, 5, 5))
        A = M @ M.transpose(0, 2, 1) * rng.uniform(0.01, 10, (400, 1, 1))
        b = rng.normal(size=(400, 5)) * rng.uniform(0.1, 20, (400, 1))
        if family == "interior":
            A = A + 5.0 * np.eye(5)
            b = 0.5 * b / np.linalg.norm(b, axis=1, keepdims=True)
        elif family == "boundary":
            b = b * 100.0
    return _packed(torch.as_tensor(A, dtype=dtype),
                   torch.as_tensor(b, dtype=dtype))


@pytest.mark.parametrize("family", ["study", "psd", "interior", "boundary"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_settled_exit_equals_fixed_count(family, dtype):
    A, b = _problems(family, dtype)
    want = trs.trs_action_reference(A, b)
    got, passes = trs.trs_action_settled(A, b)
    assert _bitwise_equal(got, want)
    iters = trs.TRS_PARAMS[dtype][1]
    assert int(passes.min()) >= 1 and int(passes.max()) <= iters + 1
    assert float((passes <= iters).double().mean()) > 0.75  # exits fire
    if family == "interior":
        # the unconstrained solution: lam stays 0 and settles at pass 2
        assert bool((passes == 2).all())


def _cycle_exits(A, b):
    """For each problem, the pass k at which the carry first returns to the
    carry of two passes back (before settling), or -1."""
    d = len(b)
    eps, lam, lo, hi = trs._trs_setup(A, b)
    iters = trs.TRS_PARAMS[b[0].dtype][1]
    first = torch.full(lam.shape, -1)
    settled = torch.zeros(lam.shape, dtype=torch.bool)
    prev = None
    for k in range(iters):
        x, L = trs._ridge_x(A, b, lam + eps, d)
        new = trs._newton_step(L, x, lam, lo, hi, d)
        same = [trs._same_bits(u, v) for u, v in zip(new, (lam, lo, hi))]
        now_settled = same[0] & same[1] & same[2]
        if prev is not None:
            back = [trs._same_bits(u, v) for u, v in zip(new, prev)]
            cyc = back[0] & back[1] & back[2] & ~now_settled & ~settled & (
                first < 0)
            first = torch.where(cyc, k, first)
        settled |= now_settled & (first < 0)
        prev, (lam, lo, hi) = (lam, lo, hi), new
    return first


def test_two_cycle_exit_parity_rule():
    """The study stream's float32 prefixes hold carries that alternate from
    either parity of the passes left; on both the mirror's pick is the
    fixed count's action, bit for bit."""
    A, b = _problems("study", torch.float32)
    first = _cycle_exits(A, b)
    iters = trs.TRS_PARAMS[torch.float32][1]
    cyc = first >= 0
    even = cyc & ((iters - first + 1) % 2 == 0)
    assert int(even.sum()) > 0 and int((cyc & ~even).sum()) > 0
    got, _ = trs.trs_action_settled(A, b)
    want = trs.trs_action_reference(A, b)
    for g, w in zip(got, want):
        assert bool(trs._same_bits(g[cyc], w[cyc]).all())


def _lane_schedule(z_tm, y_tm, flags, eta):
    """Plain mirror of K8's per-lane rounds: the lanes of ``quad_lanes``;
    FTRL lanes play round by round; every loop pass runs one Newton pass
    (``trs_pass``) for each FTL lane still playing, and a lane whose solve
    is done plays its round and begins the next solve at once."""
    T, d, B = z_tm.shape
    dt = z_tm.dtype
    lanes = trs.quad_lanes(flags)
    seq = lanes[lanes >= 0].long()
    ftrl = flags[seq] == trs.ALG_FTRL
    n = seq.numel()
    rows, cols = trs.tri_index(d)
    zero = torch.zeros(n, dtype=dt)
    A = [zero.clone() for _ in rows]
    bv = [zero.clone() for _ in range(d)]
    th = [zero.clone() for _ in range(d)]
    x = [zero.clone() for _ in range(d)]
    c, cum = zero.clone(), zero.clone()
    t = torch.zeros(n, dtype=torch.int64)
    iters = trs.TRS_PARAMS[dt][1]

    def row(at):
        idx = at.clamp(max=T - 1)
        return ([z_tm[idx, i, seq] for i in range(d)], y_tm[idx, seq])

    def play(mask, xs):
        """Lanes in ``mask`` play action ``xs`` in their round t."""
        nonlocal c, cum
        zr, yt = row(t)
        r = trs._dot(zr, xs) - yt
        new_cum = cum + 0.5 * r * r
        upd = [th[i] + r * zr[i] for i in range(d)]
        newA = [A[k] + zr[i] * zr[j] for k, (i, j) in
                enumerate(zip(rows, cols))]
        newb = [bv[i] + yt * zr[i] for i in range(d)]
        for lst, new in ((th, upd), (A, newA), (bv, newb), (x, xs)):
            lst[:] = [torch.where(mask, u, v) for u, v in zip(new, lst)]
        c = torch.where(mask, c + yt * yt, c)
        cum = torch.where(mask, new_cum, cum)

    scale_eta = eta[seq]
    for r_ in range(T):                          # FTRL lanes, as before
        step = -torch.div(scale_eta, trs.correctly_rounded_sqrt(
            torch.full_like(scale_eta, r_ + 1.0)))
        play(ftrl, trs._to_ball([step * th_i for th_i in th]))
        t = torch.where(ftrl, t + 1, t)
    solving = ~ftrl & (T > 0)
    eps, lam, lo, hi = trs._trs_setup(A, bv)
    k = torch.zeros(n, dtype=torch.int64)
    prev, x1 = (lam, lo, hi), [zero.clone() for _ in range(d)]
    while bool(solving.any()):
        xs, L = trs._ridge_x(A, bv, lam + eps, d)
        new = trs._newton_step(L, xs, lam, lo, hi, d)
        same = [trs._same_bits(u, v) for u, v in zip(new, (lam, lo, hi))]
        back = [trs._same_bits(u, v) for u, v in zip(new, prev)]
        capped = k == iters
        settled = ~capped & same[0] & same[1] & same[2]
        cycle = ~capped & ~settled & (k > 0) & back[0] & back[1] & back[2]
        done = solving & (capped | settled | cycle)
        odd = cycle & ((iters - k + 1) % 2 == 0)
        play(done, trs._to_ball([torch.where(odd, u, v)
                                 for u, v in zip(x1, xs)]))
        t = torch.where(done, t + 1, t)
        solving = solving & (t < T)
        # The lanes that handed over begin their next solve; the others
        # keep this pass's x and carry for the cycle test.
        fresh = trs._trs_setup(A, bv)
        x1 = xs
        prev = tuple(torch.where(done, f, u) for f, u in
                     zip(fresh[1:], (lam, lo, hi)))
        eps = torch.where(done, fresh[0], eps)
        lam, lo, hi = (torch.where(done, f, u) for f, u in
                       zip(fresh[1:], new))
        k = torch.where(done, 0, k + 1)
    x_c, _ = trs.trs_action_settled(A, bv)
    comp = trs.quadratic_comparator_loss_tri(A, bv, c, x_c, d)
    out = [torch.empty(B, dtype=dt) for _ in range(2)]
    out[0][seq], out[1][seq] = cum, comp
    xc_out = torch.empty((d, B), dtype=dt)
    xl_out = torch.empty((d, B), dtype=dt)
    xc_out[:, seq] = torch.stack(x_c)
    xl_out[:, seq] = torch.stack(x)
    return out[0], out[1], xc_out, xl_out


@pytest.mark.parametrize("B, T", [(37, 24), (64, 40)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_schedule_equals_reference(dtype, B, T):
    rng = np.random.default_rng(B + T)
    z = rng.normal(size=(T, 5, B))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    y = np.einsum("tdb,d->tb", z, np.ones(5) / np.sqrt(5)) + 0.1 * \
        rng.normal(size=(T, B))
    z_tm = torch.as_tensor(z, dtype=dtype)
    y_tm = torch.as_tensor(y, dtype=dtype)
    flags = torch.as_tensor(rng.integers(0, 2, B), dtype=torch.int32)
    eta = torch.as_tensor(rng.uniform(0.5, 2.0, B), dtype=dtype)
    got = _lane_schedule(z_tm, y_tm, flags, eta)
    want = trs.quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    for g, w in zip(got, want):
        assert bool(trs._same_bits(g, w).all())


@pytest.mark.parametrize("pattern, width", [
    ("interleaved", 32), ("all_ftl", 32), ("all_ftrl", 32),
    ("odd_blocks", 32), ("random", 32), ("interleaved", 5),
    ("all_ftl", 1), ("random", 3)])
def test_lane_map_groups_flags(pattern, width):
    B = 77
    flags = {
        "interleaved": np.arange(B) % 2,
        "all_ftl": np.ones(B),
        "all_ftrl": np.zeros(B),
        "odd_blocks": (np.arange(B) >= 33),
        "random": np.random.default_rng(5).integers(0, 2, B),
    }[pattern]
    flags = torch.as_tensor(flags, dtype=torch.int32)
    lanes = trs.quad_lanes(flags, width)
    assert lanes.dtype == torch.int32
    assert lanes.numel() == (B + 31) // 32 * 32 + (B + width - 1) // width * 32
    live = lanes[lanes >= 0].long()
    assert torch.equal(torch.sort(live).values, torch.arange(B))
    for warp in lanes.view(-1, 32):
        f = flags[warp[warp >= 0].long()]
        assert f.numel() == 0 or bool((f == f[0]).all())
        # an FTL warp holds at most `width` sequences, an FTRL warp 32
        assert f.numel() <= (32 if f.numel() == 0 or int(f[0]) == 0
                             else width)
    # Played through the map and written back to each sequence's own
    # column, the plain version gives the unpermuted results.
    rng = np.random.default_rng(6)
    z_tm = torch.as_tensor(rng.normal(size=(6, 3, B)) * 0.5)
    y_tm = torch.as_tensor(rng.normal(size=(6, B)))
    eta = torch.full((B,), 1.1, dtype=torch.float64)
    want = trs.quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    perm = trs.quadratic_regrets_reference(z_tm[..., live], y_tm[:, live],
                                           flags[live], eta[live])
    for p, w in zip(perm, want):
        back = torch.empty_like(w)
        back[..., live] = p
        assert torch.equal(back, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_study_in_one_call_equals_per_call(dtype):
    T_grid, runs, reps = (30, 70, 100), 2, 3
    got = quadratic_study.evaluate_quadratic_stream(
        T_grid, runs=runs, replicates=reps, dtype=dtype, device="cpu")
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    flags = torch.tensor([0] * reps + [1] * reps, dtype=torch.int32)
    by_T = {k: np.empty((runs, len(T_grid), reps))
            for k in quadratic_study.LABELS}
    batches = quadratic_study.horizon_batches(T_grid, runs=runs,
                                              replicates=reps, dtype=dtype)
    for i, (z, y) in enumerate(batches):
        run, ti = divmod(i, len(T_grid))
        z2 = np.zeros((2 * reps, max(T_grid), 5), z.dtype)
        y2 = np.zeros((2 * reps, max(T_grid)), y.dtype)
        z2[:reps, :z.shape[1]] = z2[reps:, :z.shape[1]] = z
        y2[:reps, :y.shape[1]] = y2[reps:, :y.shape[1]] = y
        reg = simulate_quadratic_batch(
            torch.as_tensor(z2, dtype=tdtype),
            torch.as_tensor(y2, dtype=tdtype), flags, 1.0).regret
        reg = reg.double().numpy()
        by_T["FTRL"][run, ti] = reg[:reps]
        by_T["FTL (exact LS)"][run, ti] = reg[reps:]
    want = quadratic_study.quadratic_stats(by_T)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2 ** 32 - 5,
                                  2 ** 63 + 12345, 2 ** 64 - 1, -5])
def test_host_round_keys_are_the_bumped_keys(seed):
    keys = philox.round_keys(seed)
    assert len(keys) == 20 and all(0 <= k < 2 ** 32 for k in keys)
    mask = np.uint64(0xFFFFFFFF)
    s = seed % 2 ** 64
    k0, k1 = np.uint64(s & 0xFFFFFFFF), np.uint64(s >> 32)
    for i in range(10):
        if i:
            k0 = (k0 + np.uint64(philox.PHILOX_W0)) & mask
            k1 = (k1 + np.uint64(philox.PHILOX_W1)) & mask
        assert (keys[i], keys[10 + i]) == (int(k0), int(k1))
    # The ten rounds with these keys are philox4x32_10 under the seed.
    ctr = [torch.tensor([3, 2 ** 32 - 1], dtype=torch.int64),
           torch.tensor([7, 12345], dtype=torch.int64),
           torch.tensor([0, 1], dtype=torch.int64),
           torch.tensor([0, 0], dtype=torch.int64)]
    c0, c1, c2, c3 = ctr
    for i in range(10):
        hi0, lo0 = philox.mulhilo32(c0, philox.PHILOX_M0)
        hi1, lo1 = philox.mulhilo32(c2, philox.PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ keys[i], lo1, hi0 ^ c3 ^ keys[10 + i], lo0
    for g, w in zip((c0, c1, c2, c3), philox.philox4x32_10(*ctr, seed)):
        assert torch.equal(g, w)


CHUNK = 1024   # csrc/synthetic_kernel.cu OCO_SCALE_CHUNK


@pytest.mark.parametrize("start", [0, 2 ** 24 - 2 * CHUNK,
                                   2 ** 32 - 3 * CHUNK - 5])
def test_scale_table_round_index(start):
    """K7's table entry k of the chunk at t0 is -(eta / sqrt(float(t0 + k +
    1))) in 32 bits; the per-round scale is -(eta / sqrt(float(t + 1))) from
    a 64-bit t.  Across chunk boundaries, past 2^24 (where float rounds the
    index) and up to the last round below 2^32, both give the same float
    index, and so the same scale bit for bit."""
    t = np.arange(start, min(start + 4 * CHUNK, 2 ** 32 - 1), dtype=np.int64)
    t0 = (t // CHUNK * CHUNK).astype(np.uint32)
    k = (t % CHUNK).astype(np.uint32)
    table_index = (t0 + k + np.uint32(1)).astype(np.float32)
    round_index = (t + 1).astype(np.float32)
    assert np.array_equal(table_index.view(np.uint32),
                          round_index.view(np.uint32))
    eta = np.float32(np.sqrt(2.0))
    table = -(eta / np.sqrt(table_index))
    per_round = -(eta / np.sqrt(round_index))
    assert np.array_equal(table.view(np.uint32), per_round.view(np.uint32))
