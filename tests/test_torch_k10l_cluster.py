"""K10l's rows past the resident shapes' 16,384 entries: the one-row block
(rows up to 38,912 entries) and the thread-block cluster that probe builds
keep for longer rows (``csrc/admm_row_kernel.cu`` ``admm_row_kernel``;
the library leaves those rows to the streaming instance, measured faster
there), their host-side row map and the premises of their schedules.

- ``ops/admm.py``'s row bounds and instance map against the constants of
  the CUDA sources, and the kernel's sizing premises on the real sizes:
  every warp has at least ``kRowQR`` entries in each block that computes
  (the register entries carry no test) and no block more than it holds.
- Plain NumPy float32 mirrors of both schedules on the shrunken geometry
  of ``tests/test_torch_k10l_layout.py`` (two warps a row), past its
  two-row shape's rows: the one-row block (a thread's entries from its own
  cyclic ring, fetched stages - 1 ahead and read in order), and the
  cluster in its two designs: (a) the first block computing every entry,
  the others holding state; (b) each block updating its share of a
  thread's entries, the thread's partial sums handed from block to block
  and folded again from the stored s and u.  Every row's bits equal the
  streaming schedule's alone (``_solve_blocks``, a block a row); each
  thread reads its entries of each pass in order, and its fold sees them
  in the order range(i, L, threads); 6 + 6 iterations equal 12; all
  within 5e-4 of the plain version.

CPU only; no JAX reference (``test_torch_admm.py`` holds the plain version
against the JAX kernel).
"""

import os
import re

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.ops import admm
from online_convex_optimization_tpu_torch.utils import cuda_build
from test_torch_k10l_layout import (Geometry, _inputs, _nan_max, _predict,
                                    _publish, _row_step, _shrink,
                                    _solve_blocks)

F = np.float32
# The mirror's shrunken shapes on Geometry()'s 64 threads a row: the
# two-row shape's rows end at 2 cap = 512 entries; a block holds QR + MS
# entries a thread (the one-row block rows of 513..640), a cluster past
# that; the ring has STAGES stages.
QR, MS, STAGES = 4, 6, 4


def _source(name):
    with open(os.path.join(cuda_build.SRC_DIR, name)) as f:
        return f.read()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _cluster_entries(cl, spread, qr, ms):
    """A thread's entries a cluster of cl blocks holds (the source's
    ``cluster_entries``): design (b) ``cl`` blocks of qr + ms, design (a)
    the first block's qr registers and every block's ms."""
    return cl * (qr + ms) if spread else qr + cl * ms


def _cluster_of(L, spread, qr, ms, threads, most=8):
    """The blocks a cluster a row of L entries takes (0 past ``most``)."""
    for cl in range(1, most + 1):
        if L <= _cluster_entries(cl, spread, qr, ms) * threads:
            return cl
    return 0


def _shares(mt, cl, spread):
    """The entries [mb, me) each block of a cluster computes of a thread
    whose warp has mt: design (b) ceil(mt / cl) a block, in rank order;
    design (a) (or one block) all of them in the first."""
    if not spread or cl == 1:
        return [(np.zeros_like(mt), mt)]
    share = -(-mt // cl)
    out = []
    for c in range(cl):
        mb = np.minimum(mt, c * share)
        out.append((mb, np.minimum(mt, mb + share)))
    return out


# ------------------------------------------------------- the host's shape

@pytest.mark.parametrize("T,want", [
    (16384, ["resident_long", "resident", 16, 8]),
    (16385, ["resident_one", "resident_long", "resident", 16, 8]),
    (32768, ["resident_one", "resident_long", "resident", 16, 8]),
    (32769, ["resident_one", "resident_long", "resident", 16, 8]),
    (36864, ["resident_one", "resident_long", "resident", 16, 8]),
    (38912, ["resident_one", "resident_long", "resident", 16, 8]),
    (38913, ["long", "resident_one", "resident_long", "resident", 16, 8])])
def test_row_map_past_16384(T, want):
    """The wrapper's map of rows to instances in launch order: the one-row
    block takes the rows of 16,385 to 38,912 entries, the streaming
    instance the longer ones, before the resident shapes."""
    assert admm.kernel_instances(T) == want
    assert admm.instance_rows("resident_one", T) == (
        16384, min(max(T, 16384), 38912))
    assert admm.instance_rows("long", T) == (38912, max(T, 38912))
    assert admm.instance_rows("resident_long", T) == (8192, min(T, 16384))
    rows = [admm.instance_rows(name, T) for name in want]
    assert rows[0][1] == T and rows[-1][0] == 0
    assert all(a[0] == b[1] for a, b in zip(rows, rows[1:]))


def test_row_bounds_match_the_source():
    """The row bounds in ``ops/admm.py`` against the CUDA sources: 64 of
    a thread's entries in registers and 88 in shared memory, 152 a block,
    so the one-row block takes rows up to 152 x 256 = 38,912 entries; the
    long-row source launches the streaming instance on the rows past that,
    then the one-row block on the rows past kResidentLongRows; the
    clusters (at most 8 blocks), their launches and design (b)'s hand-over
    buffer only in probe builds, the library's block alone."""
    hdr = _source("oco_admm.cuh")
    qr, ms = _const(hdr, "kRowQR"), _const(hdr, "kRowMS")
    assert (qr, ms) == (64, 88)
    assert re.search(r"constexpr int kRowEntries = kRowQR \+ kRowMS;", hdr)
    assert re.search(r"constexpr int kResidentOneRows = kRowEntries \* 32 "
                     r"\* OCO_ADMM_WARPS;", hdr)
    assert (qr + ms) * 256 == admm.RESIDENT_ONE_ROWS == 38912
    src = _source("admm_row_kernel.cu")
    assert _const(src, "kMaxCluster") == 8
    assert re.search(r"return spread \? cl \* kRowEntries : kRowQR \+ cl \* "
                     r"kRowMS;", src)
    # A row one past the block's reach takes two blocks in either design.
    for sp in (True, False):
        assert _cluster_of(38913, sp, qr, ms, 256) == 2
        assert _cluster_of(38912, sp, qr, ms, 256) == 1
    for name in ("int cluster_rows(const Args& a",
                 "int launch_clusters(const Args& a"):
        at = src.index(name)
        guard = src.rindex("#ifdef OCO_ADMM_ROUTES", 0, at)
        assert "#endif" not in src[guard:at]
    assert src.count("cudaLaunchKernelEx(") == 1
    assert re.search(r"kHandBytes = DESIGN == kSpread \? C \* kThreads \* 4 "
                     r": 0;", src)
    assert re.search(r"admm_row_kernel<D, kAlone><<<", src)
    long_src = _source("admm_long_kernel.cu")
    assert re.search(r"constexpr int kResidentLongRows = %d;"
                     % admm.RESIDENT_LONG_ROWS, long_src)
    assert re.search(r"if \(r == kRouteLibrary\) \{\n    err = launch_stream<D>"
                     r"\(a, oco_admm::kResidentOneRows, stream, launched\);\n"
                     r"    if \(err == cudaSuccess\)\n      err = oco_admm::"
                     r"launch_past\(a, cap, stream, launched\);\n  \}",
                     long_src)


@pytest.mark.parametrize("spread", [True, False])
def test_every_computing_block_holds_its_register_entries(spread):
    """On the real sizes (256 threads, 64 + 88 entries), for the first and
    last rows of every cluster size up to 8 and every warp: each block that
    computes has at least 64 of the thread's entries (the kernel's register
    entries carry no test) and holds them (design (b): at most 152 a
    block; design (a): the cluster's 64 + 88 cl); the shares tile the
    thread's entries in rank order."""
    qr, ms, threads = 64, 88, 256
    first = np.arange(8) * 32
    lo = admm.RESIDENT_LONG_ROWS
    for cl in range(1, 9):
        hi = _cluster_entries(cl, spread, qr, ms) * threads
        below = lo if cl == 1 else _cluster_entries(cl - 1, spread, qr,
                                                    ms) * threads
        for L in (below + 1, below + 300, hi):
            assert _cluster_of(L, spread, qr, ms, threads) == cl
            mt = (L - first + threads - 1) // threads
            assert (mt <= _cluster_entries(cl, spread, qr, ms)).all()
            shares = _shares(mt, cl, spread)
            assert (shares[0][0] == 0).all() and (shares[-1][1] == mt).all()
            for (mb, me), nxt in zip(shares, shares[1:] + [None]):
                assert (me - mb >= qr).all(), (cl, L)
                if spread:
                    assert (me - mb <= qr + ms).all()
                if nxt is not None:
                    assert (me == nxt[0]).all()


# ---------------------------------------------------- plain float32 mirrors

class _Ring:
    """Each (row, thread)'s ring of a block: its entries mb .. me - 1
    fetched in cyclic order stages - 1 ahead, one stage an entry; entries
    yields (k, active, t) for the k-th entry of a pass, t the entry the
    stage read holds.  The kernel's warp copies its 32 lanes' entries
    together (32 consecutive rows of z), so every lane of a warp must
    fetch and read the same entry m at the same time: asserted at every
    fetch."""

    def __init__(self, mb, me, stages, threads):
        self.mb, self.me, self.cnt = mb, me, me - mb
        self.stages, self.threads = stages, threads
        R, P = mb.shape
        self.t = np.full((R, stages, P), -1)
        self.next_m = mb.copy()
        self.next_slot = np.full((R, P), stages - 1)
        self.slot = np.zeros((R, P), int)
        on = self.cnt > 0
        for k in range(stages - 1):
            self._fetch(on, np.full((R, P), k))

    def _fetch(self, on, slots):
        R, P = on.shape
        for a in (on, slots, self.next_m):
            by_warp = a.reshape(R, P // 32, 32)
            assert (by_warp == by_warp[..., :1]).all()
        r, i = np.nonzero(on)
        self.t[r, slots[r, i], i] = i + self.threads * self.next_m[r, i]
        nxt = self.next_m + 1
        self.next_m = np.where(on, np.where(nxt == self.me, self.mb, nxt),
                               self.next_m)

    def entries(self):
        R, P = self.cnt.shape
        r_all, i_all = np.indices((R, P))
        for k in range(int(self.cnt.max(initial=0))):
            act = k < self.cnt
            self._fetch(act, self.next_slot)
            self.next_slot = np.where(act, (self.next_slot + 1) % self.stages,
                                      self.next_slot)
            t = self.t[r_all, self.slot, i_all]
            self.slot = np.where(act, (self.slot + 1) % self.stages,
                                 self.slot)
            yield k, act, t


def _solve_rows(z, y, Lpk, state0, geo, cl, spread, keys, kw, record=None):
    """The one-row block (cl = 1) or a cluster of cl blocks a row in design
    (b) (``spread``) or (a), on the rows ``keys`` ((b, L) each, one row a
    cluster, all side by side); returns {(b, L): (s, u, x, w, v, res)}.
    ``record`` (if given) collects ("ring", b, L, block, pass, thread,
    [t...]) for each block's pass and ("fold", b, L, n, thread, [t...]) for
    each accumulation of the rhs."""
    B, T, n = z.shape
    alpha, beta, kappa = F(kw["alpha"]), F(1.0 - kw["alpha"]), F(0.5)
    iters, tol, check_every = kw["iters"], F(kw["tol"]), kw["check_every"]
    threads = geo.threads
    thr = np.arange(threads)
    R = len(keys)
    bs = np.array([k[0] for k in keys])
    Ls = np.array([k[1] for k in keys])
    idx = bs * T + Ls - 1
    first = thr - thr % 32
    mt = (Ls[:, None] - first[None, :] + threads - 1) // threads
    assert (mt <= _cluster_entries(cl, spread, QR, MS)).all()
    solo = not spread or cl == 1
    segs = _shares(mt, cl, spread)
    for mb, me in segs:
        assert (me - mb >= QR).all()
    M = int(mt.max())
    rr, ii = np.arange(R)[:, None], thr[None, :]
    tm = ii[..., None] + threads * np.arange(M)[None, None, :]
    valid = tm < Ls[:, None, None]
    Lf = Lpk[idx]
    if state0 is None:
        s = np.zeros((R, threads, M), F)
        u = np.zeros_like(s)
        x, w, v = (np.zeros((R, n), F) for _ in range(3))
    else:
        tc = np.minimum(tm, T - 1)
        s = np.where(valid, state0[0][idx[:, None, None], tc], F(0))
        u = np.where(valid, state0[1][idx[:, None, None], tc], F(0))
        x, w, v = (state0[k][idx].copy() for k in (2, 3, 4))
    live = np.ones(R, bool)
    res = np.zeros(R, F)
    rings = [_Ring(mb, me, STAGES, threads) for mb, me in segs]
    count = {"pass": [0] * len(segs), "fold": 0}

    def run(c, fn):
        """Block c's pass: fn(m, ok, yt, zt) on its entries in order."""
        mb, _ = segs[c]
        seen = [[[] for _ in range(threads)] for _ in range(R)]
        for k, act, t in rings[c].entries():
            m = mb + k
            want = ii + threads * m
            assert (t[act] == want[act]).all()
            ok = act & (want < Ls[:, None])
            for r, i in zip(*np.nonzero(ok)):
                seen[r][i].append(int(t[r, i]))
            tc = np.minimum(want, T - 1)
            fn(np.minimum(m, M - 1), ok, y[bs[:, None], tc],
               z[bs[:, None], tc])
        if record is not None:
            for r in range(R):
                for i in range(threads):
                    record.append(("ring", bs[r], Ls[r], c,
                                   count["pass"][c], i, seen[r][i]))
        count["pass"][c] += 1

    def fold_into(acc, on, seen):
        def add(m, ok, yt, zt, s_m, u_m, ysu=None):
            ok = ok & on[:, None]
            if ysu is None:
                ysu = (yt + s_m) - u_m
            acc[:] = np.where(ok[..., None], acc + ysu[..., None] * zt, acc)
            for r, i in zip(*np.nonzero(ok)):
                seen[r][i].append(int(i + threads * m[r, i]))
        return add

    def rhs(on, first_pass):
        """One accumulation: first_pass(acc_add) runs the computing blocks'
        passes (the first folding in it), then design (b)'s hand-overs
        fold the other blocks' shares from their stored s and u; returns
        the warps' sums the last block publishes."""
        acc = np.zeros((R, threads, n), F)
        seen = [[[] for _ in range(threads)] for _ in range(R)]
        add = fold_into(acc, on, seen)
        first_pass(add)
        for c in range(1, 1 if solo else cl):
            hand = acc.copy()               # block c - 1's sums, handed on
            acc[:] = hand
            run(c, lambda m, ok, yt, zt: add(m, ok, yt, zt, s[rr, ii, m],
                                             u[rr, ii, m]))
        if record is not None:
            for r in range(R):
                for i in range(threads):
                    record.append(("fold", bs[r], Ls[r], count["fold"], i,
                                   seen[r][i]))
        count["fold"] += 1
        return _publish(acc, geo.warps)

    def init_pass(add):
        run(0, lambda m, ok, yt, zt: add(m, ok, yt, zt, s[rr, ii, m],
                                         u[rr, ii, m]))
        for c in range(1, 1 if solo else cl):
            run(c, lambda m, ok, yt, zt: None)

    def residuals(stop):
        pri = np.zeros((R, threads), F)

        def mx(m, ok, yt, zt):
            e = np.abs((_predict(x[:, None, :], zt, n) - yt) - s[rr, ii, m])
            pri[:] = np.where(ok & live[:, None], _nan_max(pri, e), pri)
        for c in range(1 if solo else cl):
            run(c, mx)
        wp = pri.reshape(R, geo.warps, 32)
        wmax = wp[..., 0]
        for lane in range(1, 32):
            wmax = _nan_max(wmax, wp[..., lane])
        rmax = wmax[:, 0]
        for k in range(1, geo.warps):
            rmax = _nan_max(rmax, wmax[:, k])
        for j in range(n):
            rmax = _nan_max(rmax, np.abs(x[:, j] - w[:, j]))
        res[:] = np.where(live, rmax, res)
        if stop:
            live[:] = live & (rmax > tol)
        return live.any()

    part = rhs(live.copy(), init_pass)
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

            def update(fold):
                def fn(m, ok, yt, zt):
                    ok = ok & on[:, None]
                    so, uo = s[rr, ii, m], u[rr, ii, m]
                    r_ = _predict(x[:, None, :], zt, n) - yt
                    rh = alpha * r_ + beta * so
                    sp = rh + uo
                    sn = _shrink(sp, kappa)
                    un = (uo + rh) - sn
                    s[rr, ii, m] = np.where(ok, sn, so)
                    u[rr, ii, m] = np.where(ok, un, uo)
                    if fold is not None:
                        fold(m, ok, yt, zt, sn, un, (yt + sn) - un)
                return fn

            def iterate(add):
                run(0, update(add))
                for c in range(1, 1 if solo else cl):
                    run(c, update(None))
            new = rhs(on, iterate)
            part = np.where(on[:, None, None], new, part)
        if checked:
            fresh = True
            if not residuals(True):
                break
    if not fresh:
        residuals(False)
    out = {}
    for r in range(R):
        L = int(Ls[r])
        sr, ur = np.zeros(T, F), np.zeros(T, F)
        ok = tm[0] < L
        sr[tm[0][ok]] = s[r][ok]
        ur[tm[0][ok]] = u[r][ok]
        out[(int(bs[r]), L)] = (sr, ur, x[r], w[r], v[r], res[r])
    return out


def _launches(B, T, geo, spread):
    """The mirror's launches past the two-row shape's 2 cap entries:
    clusters of the most blocks first, then the one-row blocks, each a list
    of (b, L), the longest rows first and B replicates interleaved."""
    lo = 2 * geo.cap
    out = []
    for cl in range(_cluster_of(T, spread, QR, MS, geo.threads), 0, -1):
        hi = min(T, _cluster_entries(cl, spread, QR, MS) * geo.threads)
        below = lo if cl == 1 else max(
            lo, _cluster_entries(cl - 1, spread, QR, MS) * geo.threads)
        if hi > below:
            out.append((cl, [(g % B, hi - g // B)
                             for g in range((hi - below) * B)]))
    return out


def _solve_new(z, y, Lpk, state0, geo, spread, kw, record=None):
    out = {}
    for cl, keys in _launches(z.shape[0], z.shape[1], geo, spread):
        out.update(_solve_rows(z, y, Lpk, state0, geo, cl, spread, keys, kw,
                               record))
    return out


@pytest.mark.parametrize("d,tol,iters,B,spread", [
    (5, 0.0, 8, 1, True), (5, 0.0, 8, 1, False), (5, 0.45, 8, 2, True),
    (8, 0.57, 8, 1, False), (3, 0.0, 6, 1, True)])
def test_one_row_and_cluster_equal_streaming_schedule(d, tol, iters, B,
                                                      spread):
    """Past the two-row shape's rows (2 cap = 512 entries on the shrunken
    geometry), the one-row block (rows of 513..640) and a cluster of two
    blocks a row (641..T) in design (b) or (a) give every row the bits the
    streaming instance alone (a block a row) gives it; each block's pass
    reads its entries of each thread in order from the ring, and every
    accumulation of a thread's partial sums folds its entries in the order
    range(i, L, threads), across the blocks' hand-overs; within 5e-4 of
    the plain version; at tol > 0 some rows stop and others do not."""
    geo = Geometry()
    T = 680
    z, y = _inputs(B, T, d, seed=90 + d)
    Lpk = admm.admm_prologue(torch.from_numpy(z)).numpy()
    kw = dict(iters=iters, tol=tol, check_every=4, alpha=1.7)
    launches = _launches(B, T, geo, spread)
    assert [cl for cl, _ in launches] == [2, 1]
    record = []
    new = _solve_new(z, y, Lpk, None, geo, spread, kw, record)
    keys = sorted(new)
    assert keys == sorted((b, L) for b in range(B)
                          for L in range(2 * geo.cap + 1, T + 1))
    old = _solve_blocks(z, y, Lpk, None, geo,
                        [(b, L, 1, False) for b, L in keys], kw)
    for key in keys:
        for a, c in zip(new[key], old[key]):
            assert np.array_equal(np.asarray(a), np.asarray(c),
                                  equal_nan=True), key
    folds = [r for r in record if r[0] == "fold"]
    rings = [r for r in record if r[0] == "ring"]
    assert folds and rings
    for _, b, L, _, i, ts in folds:
        assert ts == list(range(i, L, geo.threads)), (b, L, i)
    for _, b, L, c, _, i, ts in rings:
        assert ts == sorted(ts) and all(t % geo.threads == i for t in ts)
    # Design (b): the second block's passes read the tail of each thread's
    # entries; design (a): only the first block reads.
    blocks = {r[3] for r in rings if r[2] > 640}
    assert blocks == ({0, 1} if spread else {0})
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
        stops.add(float(got[-1]) <= tol)
    assert worst <= 5e-4
    if tol > 0:
        assert stops == {True, False}


@pytest.mark.parametrize("spread", [True, False])
def test_cluster_schedule_continues_bit_for_bit(spread):
    """6 + 6 iterations from the saved state equal 12 on the one-row block
    and the cluster (the first pass sums the partial sums a fresh pass
    would, across the hand-overs)."""
    geo = Geometry()
    B, T, d = 1, 700, 5
    z, y = _inputs(B, T, d, seed=97)
    Lpk = admm.admm_prologue(torch.from_numpy(z)).numpy()
    kw = dict(iters=12, tol=0.0, check_every=10, alpha=1.7)
    whole = _solve_new(z, y, Lpk, None, geo, spread, kw)
    half = _solve_new(z, y, Lpk, None, geo, spread, dict(kw, iters=6))
    state = [np.zeros((B * T, T), F), np.zeros((B * T, T), F)] + \
        [np.zeros((B * T, d), F) for _ in range(3)]
    for (b, L), got in half.items():
        for k in range(5):
            state[k][b * T + L - 1] = got[k]
    cont = _solve_new(z, y, Lpk, state, geo, spread, dict(kw, iters=6))
    assert sorted(cont) == sorted(whole)
    for key in whole:
        for a, c in zip(cont[key], whole[key]):
            assert np.array_equal(np.asarray(a), np.asarray(c)), key
