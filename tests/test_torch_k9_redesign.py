"""The premise of K9's Hopper design, shown on the CPU.

K9 (``csrc/trs_kernel.cu``) keeps one trust-region solve in flight on each
lane of a persistent grid.  Each loop pass first hands over on the lanes
whose solve ended, once ``K9_MIN_IDLE`` of them are idle (the answer
scaled into the ball and stored, the next problem claimed and begun), then
runs one Newton pass (``oco::trs_pass``) on every lane that holds a
solve.  Problems are claimed warp by warp: the idle lanes take the next
indices of the warp's range in lane order, and a warp whose range is
shorter than its idle lanes takes a new range from a shared counter (32
problems the first time, ``K9_CHUNK`` after).  Only the schedule changed,
so:

- a plain mirror of that loop, built from ``ops/trs.py``'s own steps
  (``_trs_setup``, ``_ridge_x``, ``_newton_step``, ``_to_ball``), equals
  ``trs_solve_reference`` bit for bit, in float32 and float64, at d = 1,
  3, 5 and 7 and at batch sizes around a warp;
- every problem is claimed exactly once;
- the mirror's loop passes per warp equal ``refill_iterations``, the
  model ``chip_smoke.py`` prints beside K9's time, on the passes
  ``trs_action_settled`` counts;
- the families hold every exit of the Newton loop: the t = 0 problem (A
  = 0, b = 0), singular prefixes (t < d), interior and boundary problems,
  the cap and two-cycles of both parities.

``trs_solve_reference`` against the JAX kernel in interpret mode is
covered by ``tests/test_torch_quadratic.py``.
"""

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.data.sequences import (
    make_regression_stream,
)
from online_convex_optimization_tpu_torch.ops import trs

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]
WARPS = 2


def _problems(N, d, dtype, seed):
    """N problems drawn from the families of ``tests/test_torch_redesign.py``
    at dimension d: two regression streams' prefixes (the t = 0 problem
    first, then the singular ones), random PSD, interior and boundary
    problems, in a seeded order after the first."""
    As, bs = [], []
    for rep in range(2):
        z, y, _ = make_regression_stream(sigma=0.1, d=d, run_seed=seed + rep)(
            60, rep=rep)
        z, y = z.astype(np.float64), y.astype(np.float64)
        As.append(np.concatenate([np.zeros((1, d, d)),
                                  np.cumsum(z[:, :, None] * z[:, None], 0)]))
        bs.append(np.concatenate([np.zeros((1, d)),
                                  np.cumsum(y[:, None] * z, 0)]))
    rng = np.random.default_rng(seed)
    for family in ("psd", "interior", "boundary"):
        M = rng.normal(size=(100, d, d))
        A = M @ M.transpose(0, 2, 1) * rng.uniform(0.01, 10, (100, 1, 1))
        b = rng.normal(size=(100, d)) * rng.uniform(0.1, 20, (100, 1))
        if family == "interior":
            A = A + 5.0 * np.eye(d)
            b = 0.5 * b / np.linalg.norm(b, axis=1, keepdims=True)
        elif family == "boundary":
            b = b * 100.0
        As.append(A)
        bs.append(b)
    A, b = np.concatenate(As), np.concatenate(bs)
    order = np.concatenate([[0], 1 + rng.permutation(len(b) - 1)])
    order = np.resize(order, N)
    return (torch.as_tensor(A[order], dtype=dtype),
            torch.as_tensor(b[order], dtype=dtype))


def _refill_mirror(A, b, warps=WARPS):
    """Plain mirror of K9's loop over ``warps`` warps that step together
    and claim in warp order.  Returns ``(x (N, d), loop passes (warps,),
    problems in claim order, exits by kind)``."""
    N, d = b.shape
    dt = b.dtype
    iters = trs.TRS_PARAMS[dt][1]
    rows, cols = trs.tri_index(d)
    A_src = [A[:, r, c] for r, c in zip(rows, cols)]
    b_src = [b[:, i] for i in range(d)]
    lanes = warps * trs.WARP
    zero = torch.zeros(lanes, dtype=dt)
    At = [zero.clone() for _ in rows]
    bv = [zero.clone() for _ in range(d)]
    x = [zero.clone() for _ in range(d)]
    x1 = [zero.clone() for _ in range(d)]
    eps, lam, lo, hi = (zero.clone() for _ in range(4))
    lam1, lo1, hi1 = (zero.clone() for _ in range(3))
    k = torch.zeros(lanes, dtype=torch.int64)
    p = torch.full((lanes,), -1, dtype=torch.int64)
    done = torch.ones(lanes, dtype=torch.bool)
    cur, left, drained = [0] * warps, [0] * warps, [False] * warps
    running = [True] * warps
    counter = 0
    loops = [0] * warps
    claims = []
    exits = dict.fromkeys(("capped", "settled", "cycle, this pass's x",
                           "cycle, the pass before's x"), 0)
    out = torch.full((N, d), float("nan"), dtype=dt)
    while any(running):
        # The claim: a warp's idle lanes in lane order, its range first,
        # once K9_MIN_IDLE of them are idle; a drained warp hands over at
        # every pass and claims nothing.
        q = torch.full((lanes,), -1, dtype=torch.int64)
        hand = torch.zeros(lanes, dtype=torch.bool)
        for w in range(warps):
            span = slice(w * trs.WARP, (w + 1) * trs.WARP)
            idle = [w * trs.WARP + i for i in range(trs.WARP)
                    if bool(done[span][i])]
            if not running[w] or (len(idle) < trs.K9_MIN_IDLE
                                  and not drained[w]):
                continue
            hand[span] = True
            if drained[w]:
                continue
            need, fresh = len(idle), 0
            size = trs.WARP if cur[w] == 0 else trs.K9_CHUNK
            if left[w] < need:
                fresh, counter = counter, counter + size
            for rank, lane in enumerate(idle):
                q[lane] = (cur[w] + rank if rank < left[w]
                           else fresh + rank - left[w])
            if left[w] < need:
                cur[w], left[w] = fresh + need - left[w], size - (need
                                                                  - left[w])
            else:
                cur[w], left[w] = cur[w] + need, left[w] - need
            drained[w] = cur[w] >= N
        # The hand-over: store, then load and begin the claimed problem.
        store = done & hand & (p >= 0)
        out[p[store]] = torch.stack(trs._to_ball(x), -1)[store]
        p = torch.where(done & hand, torch.where(q < N, q, -1), p)
        take = done & hand & (p >= 0)
        claims += p[take].tolist()
        src = p.clamp(0, N - 1)
        At = [torch.where(take, a[src], u) for a, u in zip(A_src, At)]
        bv = [torch.where(take, v[src], u) for v, u in zip(b_src, bv)]
        start = trs._trs_setup(At, bv)
        eps, lam, lo, hi = (torch.where(take, s, u) for s, u in
                            zip(start, (eps, lam, lo, hi)))
        k = torch.where(take, 0, k)
        done = done & ~take
        for w in range(warps):
            if running[w]:
                if bool(done[w * trs.WARP:(w + 1) * trs.WARP].all()):
                    running[w] = False
                else:
                    loops[w] += 1
        # One Newton pass (oco::trs_pass) on every lane holding a solve.
        flight = ~done
        xs, L = trs._ridge_x(At, bv, lam + eps, d)
        new = trs._newton_step(L, xs, lam, lo, hi, d)
        same = [trs._same_bits(u, v) for u, v in zip(new, (lam, lo, hi))]
        back = [trs._same_bits(u, v) for u, v in zip(new, (lam1, lo1, hi1))]
        capped = flight & (k == iters)
        settled = flight & ~capped & same[0] & same[1] & same[2]
        cycle = (flight & ~capped & ~settled & (k > 0) & back[0] & back[1]
                 & back[2])
        end = capped | settled | cycle
        odd = cycle & ((iters - k + 1) % 2 == 0)
        for key, m in zip(exits, (capped, settled, cycle & ~odd, odd)):
            exits[key] += int(m.sum())
        x = [torch.where(flight, torch.where(odd, u, v), w)
             for u, v, w in zip(x1, xs, x)]
        go = flight & ~end
        x1 = [torch.where(go, v, u) for u, v in zip(x1, xs)]
        lam1, lo1, hi1 = (torch.where(go, v, u) for u, v in
                          zip((lam1, lo1, hi1), (lam, lo, hi)))
        lam, lo, hi = (torch.where(go, v, u) for u, v in
                       zip((lam, lo, hi), new))
        k = torch.where(go, k + 1, k)
        done = done | end
    return out, torch.tensor(loops), claims, exits


def _passes(A, b):
    d = b.shape[1]
    rows, cols = trs.tri_index(d)
    _, passes = trs.trs_action_settled([A[:, r, c] for r, c in
                                        zip(rows, cols)],
                                       [b[:, i] for i in range(d)])
    return passes


@pytest.mark.parametrize("N", [1, 31, 33, 1000])
@pytest.mark.parametrize("d", [1, 3, 5, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_refill_mirror_equals_reference(dtype, d, N):
    A, b = _problems(N, d, dtype, seed=10 * d + N)
    got, loops, claims, _ = _refill_mirror(A, b)
    want = trs.trs_solve_reference(A, b)
    assert bool(trs._same_bits(got, want).all())
    assert sorted(claims) == list(range(N))
    assert torch.equal(loops, trs.refill_iterations(_passes(A, b), WARPS))


@pytest.mark.parametrize("dtype", DTYPES)
def test_families_reach_every_exit(dtype):
    """At d = 5 the families hold the t = 0 problem and singular prefixes,
    settled and two-cycle exits of both parities and, in float32, the
    cap."""
    A, b = _problems(1000, 5, dtype, seed=0)
    assert bool((A[0] == 0).all() and (b[0] == 0).all())
    _, _, _, exits = _refill_mirror(A, b)
    assert exits["settled"] > 0
    assert exits["cycle, this pass's x"] > 0
    assert exits["cycle, the pass before's x"] > 0
    if dtype == torch.float32:
        assert exits["capped"] > 0


def test_refill_model_fills_warps():
    """On the passes of phase 9's kind (mostly short solves, a few at the
    cap) the refill schedule takes about the mean passes a problem, where
    one problem a thread takes each warp's slowest lane."""
    gen = torch.Generator().manual_seed(0)
    passes = torch.randint(2, 6, (64 * 1024,), generator=gen)
    capped = torch.rand(passes.shape, generator=gen) < 0.035
    passes = torch.where(capped, 13, passes)
    loops = trs.refill_iterations(passes, 16)
    per_problem = float(loops.sum()) * trs.WARP / passes.numel()
    lockstep = float(passes.view(-1, trs.WARP).max(1).values.double().mean())
    mean = float(passes.double().mean())
    assert mean <= per_problem < 1.1 * mean
    assert lockstep > 2.5 * per_problem
    assert int(loops.max() - loops.min()) <= 13 + trs.K9_CHUNK // trs.WARP * 4
