"""K10l's resident instance: its host-side row map and the premises of
its schedule (``csrc/admm_long_kernel.cu`` ``admm_resident_kernel``).

- ``ops/admm.py``'s row bounds of the two K10l instances against the
  constants of the CUDA source (the block's shape and its fit in shared
  memory come from the source itself, ``admm.resident_plan``, held on the
  card by ``tests/test_torch_cuda.py``).
- Plain NumPy float32 mirrors of the two K10l instances' schedules, on
  small T past a shrunken capacity (fewer warps a row, shorter rows): the
  streaming instance's (a block a row, every iteration reading the row's
  entries in thread order) and the resident instance's (R row slots of
  one replicate a block in the library's two groups of threads, the
  rows' entries on the block for the whole solve, a ring of y and z
  entries fetched cyclically stages - 1 ahead by each thread of the first
  group and read by its counterpart in the second, the rows' d x d steps
  side by side, rows that stop waiting for the block's last).  Both use
  the same per-entry arithmetic, the warp's reduce-scatter butterfly and
  the d x d step, so equal bits mean equal schedules: every thread sees
  its entries of every row in the streaming instance's order, and every
  row sums its warps in warp order.  Both are held within 5e-4 of the
  plain version.

CPU only; no JAX reference (``test_torch_admm.py`` holds the plain version
against the JAX kernel, at T = 4,160 on the rows K10l takes on the card).
"""

import os
import re

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.ops import admm
from online_convex_optimization_tpu_torch.utils import cuda_build

F = np.float32


def _source(name):
    with open(os.path.join(cuda_build.SRC_DIR, name)) as f:
        return f.read()


# ------------------------------------------------------- the host's shape

def test_resident_rows_match_the_source():
    src = _source("admm_long_kernel.cu")
    assert re.search(r"constexpr int kResidentRows = 8192;", src)
    assert admm.RESIDENT_ROWS == 8192 and admm.LONG_ROWS == 4096
    assert admm.instance_rows("resident", 8192) == (4096, 8192)
    assert admm.instance_rows("resident_one", 8192) == (16384, 16384)
    assert admm.instance_rows("long", 12288) == (38912, 38912)
    assert admm.instance_rows("resident_long", 12288) == (8192, 12288)


# ---------------------------------------------------- plain float32 mirrors

def _tri(j, k):
    return j * (j + 1) // 2 + k


def _predict(x, zt, n):
    """<x, z_t> in index order; x (..., n), zt (threads, n)."""
    q = x[..., 0] * zt[..., 0]
    for j in range(1, n):
        q = q + x[..., j] * zt[..., j]
    return q


def _shrink(sp, kappa):
    a = np.abs(sp) - kappa
    return np.copysign(np.where((a > 0) | np.isnan(a), a, F(0)), sp)


def _nan_max(a, b):
    return np.where((a > b) | np.isnan(a), a, b)


def _reduce_scatter8(v):
    """The warp butterfly of ``oco_admm.cuh`` ``reduce_scatter8``: v
    (..., 32, 8) by lane; returns (..., 32), lanes 4 j .. 4 j + 3 holding
    the sum of v[..., j]."""
    lane = np.arange(32)

    def level(own_hi, own_lo, bit):
        hi = (lane & bit) != 0
        own = np.where(hi, own_hi, own_lo)
        send = np.where(hi, own_lo, own_hi)
        return own + send[..., lane ^ bit]

    a = [level(v[..., i + 4], v[..., i], 16) for i in range(4)]
    c = [level(a[i + 2], a[i], 8) for i in range(2)]
    e = level(c[1], c[0], 4)
    e = e + e[..., lane ^ 2]
    return e + e[..., lane ^ 1]


def _publish(acc, warps):
    """acc (..., threads, n): each warp's sums of the next rhs, (...,
    warps, n), as the warp's lanes 4 j hold them."""
    n = acc.shape[-1]
    p8 = np.zeros(acc.shape[:-2] + (warps, 32, 8), F)
    p8[..., :n] = acc.reshape(acc.shape[:-2] + (warps, 32, n))
    e = _reduce_scatter8(p8)
    return e[..., 4 * np.arange(n)]


def _row_step(part, w, v, Lf, n, alpha, beta):
    """``row_step`` for rows side by side: part (rows, warps, n), w, v
    (rows, n), Lf (rows, ntri); returns x, w, v."""
    rhs = part[:, 0].copy()
    for i in range(1, part.shape[1]):
        rhs = rhs + part[:, i]
    a = []
    for j in range(n):
        sj = rhs[:, j] + (w[:, j] - v[:, j])
        for k in range(j):
            sj = sj - Lf[:, _tri(j, k)] * a[k]
        a.append(sj * Lf[:, _tri(j, j)])
    x = [None] * n
    for j in reversed(range(n)):
        sj = a[j]
        for k in range(j + 1, n):
            sj = sj - Lf[:, _tri(k, j)] * x[k]
        x[j] = sj * Lf[:, _tri(j, j)]
    x = np.stack(x, -1)
    xh = alpha * x + beta * w
    tv = xh + v
    n2 = tv[:, 0] * tv[:, 0]
    for j in range(1, n):
        n2 = n2 + tv[:, j] * tv[:, j]
    nrm = np.sqrt(_nan_max(n2, F(1)))
    wn = tv / nrm[:, None]
    return x, wn, (v + xh) - wn


class Geometry:
    """A shrunken K10l: ``warps`` warps of 32 lanes a row, rows longer than
    ``long_rows`` on K10l, up to ``cap`` of them on the resident
    instance, ``R`` rows a resident block (in the library's two groups of
    threads), a ring of ``stages``."""

    def __init__(self, warps=2, long_rows=192, cap=256, R=4, stages=3):
        self.warps, self.threads = warps, 32 * warps
        self.long_rows, self.cap, self.R, self.stages = (long_rows, cap, R,
                                                         stages)


def _solve_blocks(z, y, Lpk, state0, geo, blocks, kw, record=None):
    """Runs the blocks of one instance: ``blocks`` a list of (b, top,
    rows, resident); returns {(b, L): (s, u, x, w, v, res)} for the rows
    of length L.  A streaming block has one row and reads y and z
    directly; a resident block reads them from each thread's ring (shared
    by the thread's counterpart in the second group), whose entries
    ``record`` (if given) collects as (b, top, pass, thread, t)."""
    B, T, n = z.shape
    alpha, beta, kappa = F(kw["alpha"]), F(1.0 - kw["alpha"]), F(0.5)
    iters, tol, check_every = kw["iters"], F(kw["tol"]), kw["check_every"]
    thr = np.arange(geo.threads)
    out = {}
    for b, top, rows, resident in blocks:
        Ls = top - np.arange(rows)                     # row slot r: top - r
        idx = b * T + Ls - 1
        # A thread's entries of the longest row; on a resident block those
        # of its warp's lane 0 (the two groups' warps that share a ring meet
        # at a barrier an entry), an entry past the row neither copied nor
        # used.
        first = thr - thr % 32 if resident else thr
        mt = (top - first + geo.threads - 1) // geo.threads
        M = int(mt.max())
        tm = thr[:, None] + geo.threads * np.arange(M)[None, :]
        Lf = Lpk[idx]
        if state0 is None:
            s = np.zeros((rows, geo.threads, M), F)
            u = np.zeros_like(s)
            x, w, v = (np.zeros((rows, n), F) for _ in range(3))
        else:
            tc = np.minimum(tm, T - 1)
            valid = tm[None] < Ls[:, None, None]
            s = np.where(valid, state0[0][idx][:, tc], F(0))
            u = np.where(valid, state0[1][idx][:, tc], F(0))
            x, w, v = (state0[k][idx].copy() for k in (2, 3, 4))
        live = np.ones(rows, bool)
        res = np.zeros(rows, F)
        if resident:
            # Each thread's ring: the entry t, y_t and z_t of every stage,
            # the next entry m to fetch and its stage, the stage to read.
            ring_t = np.full((geo.stages, geo.threads), -1)
            ring_y = np.zeros((geo.stages, geo.threads), F)
            ring_z = np.zeros((geo.stages, geo.threads, n), F)
            assert (mt >= geo.stages).all()

            def fetch(who, m, slot):
                t = who + geo.threads * m
                ring_t[slot, who] = t
                cp = t < top
                slot = np.broadcast_to(slot, who.shape)[cp]
                ring_y[slot, who[cp]] = y[b, t[cp]]
                ring_z[slot, who[cp]] = z[b, t[cp]]

            for k in range(geo.stages - 1):
                fetch(thr, k, k)
            next_m = np.full(geo.threads, geo.stages - 1)
            next_slot = np.full(geo.threads, geo.stages - 1)
            slot = np.zeros(geo.threads, int)
        counter = {"pass": 0}

        def entries():
            """Yields (m, active threads, y_t, z_t) in each thread's order:
            a resident thread fetches its entry stages - 1 ahead (cyclic
            over its mt entries), then reads the stage of entry m."""
            for m in range(M):
                act = m < mt
                if resident:
                    a = np.flatnonzero(act)
                    fetch(a, next_m[a], next_slot[a])
                    next_m[a] = np.where(next_m[a] + 1 == mt[a], 0,
                                         next_m[a] + 1)
                    next_slot[a] = (next_slot[a] + 1) % geo.stages
                    t = ring_t[slot, thr]
                    assert (t[act] == tm[act, m]).all()
                    if record is not None:
                        record.extend((b, top, counter["pass"], int(i),
                                       int(t[i])) for i in a if t[i] < top)
                    yt, zt = ring_y[slot, thr], ring_z[slot, thr]
                    slot[a] = (slot[a] + 1) % geo.stages
                else:
                    t = np.minimum(tm[:, m], T - 1)
                    yt, zt = y[b, t], z[b, t]
                yield m, act, yt, zt
            counter["pass"] += 1

        def a_pass(fn):
            for m, act, yt, zt in entries():
                for r in range(rows):
                    ok = act & (tm[:, m] < Ls[r])
                    fn(r, m, ok, yt, zt)

        def fresh_acc():
            acc = np.zeros((rows, geo.threads, n), F)

            def add(r, m, ok, yt, zt):
                ysu = (yt + s[r, :, m]) - u[r, :, m]
                acc[r] = np.where(ok[:, None], acc[r] + ysu[:, None] * zt,
                                  acc[r])
            a_pass(add)
            return _publish(acc, geo.warps)

        def residuals(stop):
            pri = np.zeros((rows, geo.threads), F)

            def mx(r, m, ok, yt, zt):
                if live[r]:
                    e = np.abs((_predict(x[r], zt, n) - yt) - s[r, :, m])
                    pri[r] = np.where(ok, _nan_max(pri[r], e), pri[r])
            a_pass(mx)
            wp = pri.reshape(rows, geo.warps, 32)
            wmax = wp[..., 0]
            for lane in range(1, 32):
                wmax = _nan_max(wmax, wp[..., lane])
            for r in range(rows):
                if live[r]:
                    rr = wmax[r, 0]
                    for k in range(1, geo.warps):
                        rr = _nan_max(rr, wmax[r, k])
                    for j in range(n):
                        rr = _nan_max(rr, np.abs(x[r, j] - w[r, j]))
                    res[r] = rr
                    if stop and not rr > tol:
                        live[r] = False
            return live.any()

        part = fresh_acc()
        checked = tol > 0
        n_blocks = -(-iters // check_every) if checked else int(iters > 0)
        per_block = check_every if checked else iters
        fresh = False
        for _ in range(n_blocks):
            for _ in range(per_block):
                on = live.copy()
                xn, wn, vn = _row_step(part, w, v, Lf, n, alpha, beta)
                x, w, v = (np.where(on[:, None], a1, a0)
                           for a1, a0 in ((xn, x), (wn, w), (vn, v)))
                acc = np.zeros((rows, geo.threads, n), F)

                def it(r, m, ok, yt, zt):
                    if not on[r]:
                        return
                    sr, ur = s[r, :, m], u[r, :, m]
                    rr = _predict(x[r], zt, n) - yt
                    rh = alpha * rr + beta * sr
                    sp = rh + ur
                    sn = _shrink(sp, kappa)
                    un = (ur + rh) - sn
                    s[r, :, m] = np.where(ok, sn, sr)
                    u[r, :, m] = np.where(ok, un, ur)
                    ysu = (yt + sn) - un
                    acc[r] = np.where(ok[:, None],
                                      acc[r] + ysu[:, None] * zt, acc[r])
                a_pass(it)
                part = np.where(on[:, None, None], _publish(acc, geo.warps),
                                part)
            if checked:
                fresh = True
                if not residuals(True):
                    break
        if not fresh:
            residuals(False)
        for r in range(rows):
            L = int(Ls[r])
            sr = np.zeros(T, F)
            ur = np.zeros(T, F)
            ok = tm < L
            sr[tm[ok]] = s[r][ok]
            ur[tm[ok]] = u[r][ok]
            out[(b, L)] = (sr, ur, x[r], w[r], v[r], res[r])
    return out


def _long_blocks(B, T, geo, resident):
    """The K10l blocks of a launch: with ``resident``, the streaming
    instance on rows past ``cap``, then R-row blocks on the rows of
    long_rows + 1 .. cap entries, longest first; else a block a row."""
    cap = min(T, geo.cap) if resident else geo.long_rows
    blocks = [(g % B, T - g // B, 1, False)
              for g in range((T - cap) * B) if T > cap]
    if resident:
        groups = -(-(cap - geo.long_rows) // geo.R)
        for g in range(groups * B):
            top = cap - (g // B) * geo.R
            blocks.append((g % B, top, min(geo.R, top - geo.long_rows),
                           True))
    return blocks


def _inputs(B, T, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d))
    z = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1.0)
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(B, d)))
                + 0.3 * rng.normal(size=(B, T)))
    return z.astype(F), y.astype(F)


@pytest.mark.parametrize("d,tol,iters,B", [
    (5, 0.0, 16, 1), (3, 0.0, 16, 1), (5, 0.25, 24, 1), (8, 0.2, 24, 1),
    (5, 0.0, 12, 2)])
def test_resident_schedule_equals_streaming_schedule(d, tol, iters, B):
    """On rows past a shrunken long-row boundary and past a shrunken
    capacity, the resident instance's schedule (with the streaming one on
    the rows past its capacity; B replicates interleaved) gives every row
    the bits the streaming instance alone gives it; both within 5e-4 of
    the plain version; at tol > 0 some rows stop and others do not."""
    geo = Geometry()
    T = 300
    z, y = _inputs(B, T, d, seed=60 + d)
    Lpk = admm.admm_prologue(torch.from_numpy(z)).numpy()
    kw = dict(iters=iters, tol=tol, check_every=4, alpha=1.7)
    record = []
    new = _solve_blocks(z, y, Lpk, None, geo,
                        _long_blocks(B, T, geo, True), kw, record)
    old = _solve_blocks(z, y, Lpk, None, geo,
                        _long_blocks(B, T, geo, False), kw)
    assert sorted(new) == sorted(old) == sorted(
        (b, L) for b in range(B) for L in range(geo.long_rows + 1, T + 1))
    for key in old:
        for a, c in zip(new[key], old[key]):
            assert np.array_equal(np.asarray(a), np.asarray(c),
                                  equal_nan=True), key
    # Each thread read its entries of each pass in increasing order.
    seen = {}
    for b, top, p, i, t in record:
        seen.setdefault((b, top, p, i), []).append(t)
    for (b, top, p, i), ts in seen.items():
        assert ts == list(range(i, top, geo.threads))
    res_p, st_p = admm.admm_all_prefixes_l2_reference(
        torch.from_numpy(z), torch.from_numpy(y), torch.from_numpy(Lpk),
        iters=iters, tol=tol, check_every=4, rho=1.0, alpha=1.7)
    st_p = [a.numpy() for a in st_p] + [res_p.numpy()]
    worst = 0.0
    stops = set()
    for (b, L), got in new.items():
        row = b * T + L - 1
        for a, want in zip(got, st_p):
            worst = max(worst, float(np.abs(np.asarray(a, np.float64)
                                            - want[row]).max()))
        if L <= geo.cap:
            stops.add(float(got[-1]) <= tol)
    assert worst <= 5e-4
    if tol > 0:
        assert stops == {True, False}


@pytest.mark.parametrize("d", [5, 8])
def test_resident_schedule_continues_bit_for_bit(d):
    """6 + 6 iterations from the saved state equal 12 on the resident
    schedule (the first pass sums the partial sums a fresh pass would)."""
    geo = Geometry()
    B, T = 1, 280
    z, y = _inputs(B, T, d, seed=71)
    Lpk = admm.admm_prologue(torch.from_numpy(z)).numpy()
    blocks = _long_blocks(B, T, geo, True)
    kw = dict(iters=12, tol=0.0, check_every=10, alpha=1.7)
    whole = _solve_blocks(z, y, Lpk, None, geo, blocks, kw)
    half = _solve_blocks(z, y, Lpk, None, geo, blocks, dict(kw, iters=6))
    state = [np.zeros((B * T, T), F), np.zeros((B * T, T), F)] + \
        [np.zeros((B * T, d), F) for _ in range(3)]
    for (b, L), got in half.items():
        for k in range(5):
            state[k][b * T + L - 1] = got[k]
    cont = _solve_blocks(z, y, Lpk, state, geo, blocks, dict(kw, iters=6))
    for key in whole:
        for a, c in zip(cont[key], whole[key]):
            assert np.array_equal(np.asarray(a), np.asarray(c)), key
