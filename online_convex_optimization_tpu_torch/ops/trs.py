"""Kernels K9 (batched trust-region solve) and K8 (the quadratic game).

Counterpart of ``online_convex_optimization_tpu/ops/pallas_trs.py``:

- ``trs_solve`` (TPU ``trs_solve_packed`` / ``_trs_kernel``, behind
  ``ball_ls_action_pallas``): ``argmin_{||x|| <= 1} 0.5 x^T A x - b^T x``
  for ``(N, d, d)`` A and ``(N, d)`` b, CUDA kernel ``csrc/trs_kernel.cu``,
  plain version ``trs_solve_reference``;
- ``quadratic_regrets`` (TPU ``quadratic_regrets_packed`` /
  ``_quad_game_kernel``): the quadratic-loss game with a per-sequence
  flag (exact ball-constrained least-squares FTL, or the projected FTRL of
  ``models/quadratic.py``) and its exact comparator, CUDA kernel
  ``csrc/quad_game_kernel.cu``, plain version
  ``quadratic_regrets_reference``.

Both kernels solve with one device function (``oco::trs_action`` in
``csrc/oco_trs.cuh``), so K8's comparator equals K9 on the same
statistics bit for bit.  The algorithm is the TPU kernels' safeguarded
More-Sorensen Newton on the multiplier, with the XLA path's ridge floor
``eps_rel * (1 + tr/d)`` and final ``x / max(||x||, 1)`` (the source note of
``oco_trs.cuh`` says why); ``trs_action_reference`` is its plain version,
operation for operation.  Iterations: 12 in float32, the TPU kernels'
count; 20 in float64, where the answer has stopped moving after 18 on the
tests' and a regression stream's prefixes and on random PSD problems
(``tests/test_torch_quadratic.py::test_f64_newton_has_converged``), and
agrees with the JAX x64 bisection to 1e-12 wherever ``A + eps I`` is well
conditioned.  On a singular prefix (t < d) the floor leaves a condition
number near 1e12: there the two solvers' answers differ by up to ~1e-5
in the null space (rounding noise amplified), with equal objectives.

The kernels' Newton loop stops where the fixed count would add nothing:
a pass whose carry comes back unchanged in every bit, or equal to the
carry of two passes back (the parity of the passes left then picks the
fixed count's last one).  ``trs_action_settled`` is the plain mirror of
that exit, and equals ``trs_action_reference``, which runs the fixed
count, bit for bit.  K8 runs the loop one pass at a time, so that each
thread plays its next round as soon as its own solve is done;
``quad_lanes`` keeps FTRL and FTL sequences in warps of their own.  K9
does the same over its problems: each lane of a persistent grid keeps one
solve in flight and takes its warp's next problem once ``K9_MIN_IDLE``
lanes are idle (``refill_iterations`` models that schedule's loop
passes).

The plain version of K8 builds the running statistics with a loop over T
in the kernel's order, then solves every (round, sequence) prefix in one
batched Newton: the JAX XLA path's all-prefix pattern, with the same
arithmetic per problem as K8's per-round solve.  (``torch.cumsum`` would
sum in another order on CUDA.)

A wrapper runs the plain version on a CPU tensor and launches a kernel on
a CUDA tensor, at any d: up to ``MAX_D`` the thin instances above (a
problem or a sequence a lane), above it the wide ones, K9w and K8w (one
warp a problem or a sequence, ``wide_instance``; d <= ``WIDE_MAX_D``),
whose Cholesky and substitutions spread over the lanes in the plain
version's order of operations, so they too equal it bit for bit
(``csrc/oco_trs.cuh`` ``oco::wide``).  A warp keeps only the factor's
triangle (augmented by b) and five vectors, in shared memory where they
fit (``wide_layout``, ``wide_shared_max_d``); A stays in device memory.
K8w plays its sequences in the order of ``quad_warps``.
The TPU packing (``pack_stats`` / ``unpack_x``, the (8, 128) tiling) is
not ported: K9 reads the public ``(N, d, d)`` layout, K8 the time-major
``(T, d, B)`` one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from online_convex_optimization_tpu_torch.ops.actions import sum_last
from online_convex_optimization_tpu_torch.ops.game import (
    ALG_FTL,
    ALG_FTRL,
    check_time_major,
    per_sequence,
)
from online_convex_optimization_tpu_torch.utils import cuda_build

# Largest d of the quadratic kernels' thin instances (csrc/oco_trs.cuh
# OCO_QUAD_MAX_D); above it K8 and K9 launch their wide instances.
MAX_D = 32

# (ridge floor eps_rel, Newton iterations) by working dtype.
TRS_PARAMS = {torch.float32: (1e-6, 12), torch.float64: (1e-12, 20)}

# Launches of each CUDA kernel in this process (counted where it launches):
# K9 and K8, and their wide instances K9w and K8w.
TRS_LAUNCHES = 0
QUAD_LAUNCHES = 0
TRS_WIDE_LAUNCHES = 0
QUAD_WIDE_LAUNCHES = 0

_FLOATS = (torch.float32, torch.float64)


# Veltkamp split factors 2^ceil(p/2) + 1 (p = 53, 24) for Dekker's
# two-product.
_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}


def _two_product(a, b):
    """``a * b = p + e`` exactly (Dekker), with no fused multiply-add."""
    f = _SPLIT[a.dtype]
    p = a * b
    ta, tb = f * a, f * b
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def correctly_rounded_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt`` rounded to nearest, as the kernels' is.

    torch's CUDA sqrt is correctly rounded; its CPU sqrt is not in every
    build (torch 2.13.0+cpu misses by one ulp on some inputs in f64 and
    f32, sqrt(2) among them).  In a singular prefix one ulp
    in a Cholesky pivot moves the f64 solution by up to ~1e-4 (the ridge
    floor leaves A + eps I with a condition number near 1e12), so on the
    CPU the faithful result ``s`` is replaced by its neighbour towards
    ``sqrt(x)`` (the side the sign of ``s^2 - x`` points to) when that has
    the smaller exact residual ``|c^2 - x|``.
    """
    s = torch.sqrt(x)
    if x.device.type != "cpu":
        return s
    p, e = _two_product(s, s)
    r = (p - x) + e
    c = torch.nextafter(s, torch.where(r > 0, 0.0, float("inf")).to(s.dtype))
    pc, ec = _two_product(c, c)
    better = (torch.abs((pc - x) + ec) < torch.abs(r)) & (x > 0)
    return torch.where(better, c, s)


def tri_index(d: int):
    """``(rows, cols)`` of the packed lower triangle, row by row: entry
    ``(i, j)``, ``j <= i``, sits at ``i (i + 1) / 2 + j``."""
    rows = [i for i in range(d) for _ in range(i + 1)]
    cols = [j for i in range(d) for j in range(i + 1)]
    return rows, cols


def _tri(i: int, j: int) -> int:
    return i * (i + 1) // 2 + j


def _dot(a, b):
    """Index-order sum of ``a[i] * b[i]`` over two lists of tensors."""
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


@functools.lru_cache(maxsize=None)
def _columns(d: int, device: torch.device):
    """Packed positions of each column j below the diagonal, (j+1, j) ..
    (d-1, j), on ``device``."""
    return [torch.tensor([_tri(i, j) for i in range(j + 1, d)],
                         dtype=torch.long, device=device) for j in range(d)]


def _chol_factor(A, lam, d):
    """Lower factor of ``A + lam I``, both packed ``(d(d+1)/2, ...)``, the
    packed index first so that each entry is contiguous (or A a list of
    its entries).

    Entry (i, j) starts at ``A_ij`` (+ ``lam`` on the diagonal), subtracts
    ``L_ik * L_jk`` for k = 0, 1, ..., j - 1 in turn, then takes the sqrt
    (i == j) or divides by ``L_jj``: the kernels' order.  Step k of the
    loop below subtracts column k's products from every entry right of it,
    a row's entries (contiguous in the packed layout) at once, which is
    that order, entry by entry."""
    L = A.clone() if isinstance(A, torch.Tensor) else torch.stack(A)
    for i in range(d):
        L[_tri(i, i)] += lam
    cols = _columns(d, L.device)
    for j in range(d):
        piv = correctly_rounded_sqrt(L[_tri(j, j)])
        L[_tri(j, j)] = piv
        if j + 1 < d:
            col = L[cols[j]] / piv                # L_ij, i > j
            L[cols[j]] = col
            for i in range(j + 1, d):
                # (i, j+1 .. i) -= L_ij * (L_{j+1,j} .. L_ij)
                L[_tri(i, j + 1):_tri(i, i) + 1] -= (
                    L[_tri(i, j)] * col[:i - j])
    return L


def _fwd_solve(L, b, d):
    """``v = L^{-1} b`` for a packed factor ``L`` and a list ``b``: v_i =
    (b_i - L_i0 v_0 - L_i1 v_1 - ...) / L_ii, subtracting in increasing k,
    column k's products from every v_i, i > k, at once."""
    cols = _columns(d, L.device)
    acc = torch.stack(b)
    for k in range(d):
        vk = acc[k] / L[_tri(k, k)]
        acc[k] = vk
        if k + 1 < d:
            acc[k + 1:] -= L[cols[k]] * vk
    return list(acc.unbind(0))


def _bwd_solve(L, v, d):
    """``x = L^{-T} v``: x_i = (v_i - L_{i+1,i} x_{i+1} - ...) / L_ii in
    increasing k, one x_i after the other."""
    x = [None] * d
    for i in reversed(range(d)):
        s = v[i]
        for k in range(i + 1, d):
            s = s - L[_tri(k, i)] * x[k]
        x[i] = s / L[_tri(i, i)]
    return x


def _trs_setup(A, b):
    """The floor and the starting carry ``(eps, lam, lo, hi)`` of a solve."""
    d = len(b)
    eps_rel = TRS_PARAMS[b[0].dtype][0]
    tr = A[0]
    for i in range(1, d):
        tr = tr + A[_tri(i, i)]
    # tensor / tensor: a Python number divisor multiplies by a reciprocal.
    eps = eps_rel * (1.0 + tr / torch.full_like(tr, d))
    lam = torch.zeros_like(tr)
    return eps, lam, torch.zeros_like(tr), correctly_rounded_sqrt(_dot(b, b))


def _ridge_x(A, b, mu, d):
    """``x = (A + mu I)^{-1} b`` (a list) and the packed factor ``L``, for
    a packed ``A`` ``(d(d+1)/2, ...)`` or a list of its entries."""
    L = _chol_factor(A, mu, d)
    return _bwd_solve(L, _fwd_solve(L, b, d), d), L


def _newton_step(L, x, lam, lo, hi, d):
    """The safeguarded Newton update of the carry ``(lam, lo, hi)`` from
    the ridge solution ``x`` at ``lam`` and its factor ``L``."""
    n2 = _dot(x, x)
    q = _fwd_solve(L, x, d)
    nq2 = _dot(q, q)
    outside = n2 > 1.0
    lo = torch.where(outside, lam, lo)
    hi = torch.where(outside, hi, lam)
    step = ((n2 / torch.clamp(nq2, min=1e-30))
            * (correctly_rounded_sqrt(n2) - 1.0))
    lam_n = lam + step
    # Newton from below converges monotonically; a step that leaves the
    # bracket strictly takes the midpoint instead.
    lam = torch.where((lam_n < lo) | (lam_n > hi), 0.5 * (lo + hi), lam_n)
    return lam, lo, hi


def _to_ball(x):
    den = torch.clamp(correctly_rounded_sqrt(_dot(x, x)), min=1.0)
    return [xi / den for xi in x]


def trs_action_reference(A, b):
    """Plain version of ``oco::trs_action``: the trust-region action of a
    batch of problems given as a list of packed lower-triangle entries
    ``A`` and a list of ``b`` components, each a tensor over the batch.
    Returns the list of ``x`` components.  It runs the fixed count of
    Newton iterations; the kernels stop early where that gives the same
    bits (``trs_action_settled``)."""
    d = len(b)
    eps, lam, lo, hi = _trs_setup(A, b)
    A = torch.stack(A)
    for _ in range(TRS_PARAMS[b[0].dtype][1]):
        x, L = _ridge_x(A, b, lam + eps, d)
        lam, lo, hi = _newton_step(L, x, lam, lo, hi, d)
    return _to_ball(_ridge_x(A, b, lam + eps, d)[0])


def _same_bits(u, v):
    itype = torch.int32 if u.dtype == torch.float32 else torch.int64
    return u.view(itype) == v.view(itype)


def trs_action_settled(A, b):
    """Plain mirror of the kernels' Newton loop (``oco::trs_action``),
    which stops where the fixed count would add nothing.

    A Newton pass reads only ``A``, ``b``, the floor and the carry
    ``(lam, lo, hi)``.  Pass k solves at ``lam_k`` and forms the next
    carry; once that carry equals the one it started from in every bit,
    every later pass repeats it, so ``lam_k`` is the fixed count's last
    multiplier and pass k's ``x`` its final ridge solve.  Once the carry
    equals the one from two passes back, the carries alternate, and the
    parity of the passes left picks the fixed count's last one: the x of
    pass k or of pass k - 1.  A lane that settles in neither way takes
    the fixed count, ``iters`` passes and the solve at the final
    multiplier.

    Each lane's answer is taken where its own exit fires, from what the
    passes so far computed, and equals ``trs_action_reference`` bit for
    bit.  Returns ``(x, passes)``: the list of ``x`` components and each
    problem's ridge solves (``iters + 1`` where no exit fired).
    """
    d = len(b)
    iters = TRS_PARAMS[b[0].dtype][1]
    eps, lam, lo, hi = _trs_setup(A, b)
    A = torch.stack(A)
    done = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    passes = torch.full(lam.shape, iters + 1, dtype=torch.int64,
                        device=lam.device)
    x_out = [torch.zeros_like(lam) for _ in range(d)]
    prev = x_prev = None
    for k in range(iters + 1):
        x, L = _ridge_x(A, b, lam + eps, d)
        x_end = x
        if k == iters:
            take = [~done] * d
        else:
            new = _newton_step(L, x, lam, lo, hi, d)
            settled = ~done & _same_bits(new[0], lam) & _same_bits(
                new[1], lo) & _same_bits(new[2], hi)
            take = [settled] * d
            if prev is not None:
                cycle = ~done & ~settled & _same_bits(new[0], prev[0]) & \
                    _same_bits(new[1], prev[1]) & _same_bits(new[2], prev[2])
                # The carry after pass j >= k - 1 is pass k - 1's when
                # iters - (k - 1) is even, else pass k's.
                back = cycle & ((iters - k + 1) % 2 == 0)
                x_end = [torch.where(back, xp, xi)
                         for xp, xi in zip(x_prev, x)]
                take = [settled | cycle] * d
            passes = torch.where(take[0], k + 1, passes)
            done = done | take[0]
        x_out = [torch.where(t, xi, xo)
                 for t, xi, xo in zip(take, x_end, x_out)]
        if k < iters:
            prev, x_prev = (lam, lo, hi), x
            lam, lo, hi = new
    return _to_ball(x_out), passes


def check_trs(A: torch.Tensor, b: torch.Tensor):
    """Validate ``(N, d, d)`` / ``(N, d)`` problems; return ``(N, d)``."""
    if A.ndim != 3 or b.ndim != 2 or A.shape != (*b.shape, b.shape[1]):
        raise ValueError(f"expected A (N, d, d) and b (N, d), got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if A.dtype not in _FLOATS or b.dtype != A.dtype:
        raise TypeError(f"A and b must share dtype float32 or float64, got "
                        f"{A.dtype} and {b.dtype}")
    if b.device != A.device:
        raise ValueError(f"A on {A.device} but b on {b.device}")
    N, d = b.shape
    if N < 1 or d < 1:
        raise ValueError(f"empty batch: b has shape {tuple(b.shape)}")
    return N, d


def wide_instance(d: int) -> bool:
    """Whether K8 and K9 run their wide instance (one warp a problem or a
    sequence) at ``d``: above ``MAX_D``."""
    return d > MAX_D


# Largest d of the wide instances: a warp's workspace is addressed with
# 32-bit offsets (csrc/oco_trs.cuh oco::wide::kMaxD).
WIDE_MAX_D = 65535

# Shared memory a block may opt in to on an H100 (232,448 bytes): what
# ``wide_shared_max_d`` assumes by default.
H100_SMEM_OPTIN = 232448


def wide_layout(d: int, dtype) -> dict:
    """The device storage of a warp of K9w and K8w at ``d``
    (``csrc/oco_trs.cuh`` ``oco::wide::tri_elems``, ``stats_elems``,
    ``work_elems``), in elements of ``dtype``, each part padded to 16
    bytes: ``tri``, the packed lower triangle of order d + 1 that holds A's
    rows and b as its last row (the workspace's factor); ``stats``, K8w's
    statistics slice (A's packed rows, then b); ``work``, the workspace
    (the triangle and five vectors of d); and ``bytes``, the workspace's
    bytes."""
    item = {torch.float32: 4, torch.float64: 8}[dtype]
    q = 16 // item

    def pad(n):
        return -(-n // q) * q

    tri = pad((d + 1) * (d + 2) // 2)
    work = tri + pad(5 * d)
    return {"tri": tri, "stats": pad(d * (d + 3) // 2), "work": work,
            "bytes": work * item}


def wide_shared_max_d(dtype, optin: int = H100_SMEM_OPTIN) -> int:
    """The largest d whose workspace fits ``optin`` bytes of shared memory
    (a block's opt-in limit): past it K9w and K8w keep the workspace in
    device scratch.  334 in float32 and 234 in float64 on an H100."""
    d = 1
    while wide_layout(d + 1, dtype)["bytes"] <= optin:
        d += 1
    return d


def wide_scratch_elems(kernel: str, d: int, dtype, warps: int,
                       shared: bool) -> int:
    """Elements of the scratch buffer a wide launch of ``warps`` warps
    allocates: K8w's statistics slice a warp, and a workspace a warp where
    it is not in shared memory (``oco::wide::plan``'s out[1])."""
    lay = wide_layout(d, dtype)
    per = (lay["stats"] if kernel == "K8w" else 0) + (0 if shared
                                                       else lay["work"])
    return warps * per


def check_wide_d(d: int):
    """Raise past the wide kernels' largest d."""
    if d > WIDE_MAX_D:
        raise ValueError(f"d = {d}: the wide kernels take d <= "
                         f"{WIDE_MAX_D} (32-bit workspace offsets)")


def wide_plan(kernel: str, d: int, dtype, n: int) -> dict:
    """The launch plan of K9w (``kernel="K9w"``, n problems) or K8w
    (``"K8w"``, n sequences) on the current card: the persistent grid's
    warps, the scratch elements a launch allocates (K8w's statistics, and
    the workspaces where they do not fit shared memory), the shared bytes a
    warp (0 on the scratch route), the registers a thread and the resident
    warps an SM."""
    check_wide_d(d)
    lib = cuda_build.load()
    fn = {"K9w": lib.oco_trs_wide_plan, "K8w": lib.oco_quad_wide_plan}[kernel]
    out = (ctypes.c_longlong * 5)()
    err = fn(int(dtype == torch.float64), d, n, out)
    if err != 0:
        raise RuntimeError(f"{kernel} plan failed: CUDA error {err}")
    return dict(zip(("warps", "scratch", "smem_bytes", "registers",
                     "warps_per_sm"), out))


def _wide_scratch(kernel: str, d: int, dtype, n: int, device):
    """The scratch buffer of a wide launch (one element where it needs
    none), after checking the card's plan against ``wide_layout``."""
    plan = wide_plan(kernel, d, dtype, n)
    shared = plan["smem_bytes"] > 0
    if (plan["scratch"] != wide_scratch_elems(kernel, d, dtype,
                                              plan["warps"], shared)
            or shared and plan["smem_bytes"] != wide_layout(d, dtype)["bytes"]):
        raise RuntimeError(f"{kernel} plan {plan} disagrees with "
                           f"wide_layout({d}, {dtype})")
    return torch.empty((max(plan["scratch"], 1),), dtype=dtype, device=device)


def trs_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K9 on ``(N, d, d)`` / ``(N, d)``
    (the lower triangle of A is read); returns ``(N, d)``."""
    d = b.shape[-1]
    rows, cols = tri_index(d)
    A_tri = A[:, rows, cols]
    x = trs_action_reference([A_tri[:, k] for k in range(len(rows))],
                             [b[:, i] for i in range(d)])
    return torch.stack(x, dim=-1)


def launch_trs_solve(A: torch.Tensor, b: torch.Tensor,
                     passes=None) -> torch.Tensor:
    """Launch kernel K9 (K9w above ``MAX_D``) on contiguous CUDA problems;
    returns ``(N, d)``.  K9w also writes each solve's ridge solves into
    ``passes``, an ``(N,)`` int32 CUDA tensor, where one is given."""
    global TRS_LAUNCHES, TRS_WIDE_LAUNCHES
    N, d = b.shape
    wide = wide_instance(d)
    if passes is not None and not wide:
        raise ValueError("pass counts are written by K9w only (d > MAX_D)")
    lib = cuda_build.load()
    f64 = A.dtype == torch.float64
    with torch.cuda.device(A.device):
        x = torch.empty((N, d), dtype=A.dtype, device=A.device)
        counter = torch.empty((1,), dtype=torch.int64, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if wide:
            scratch = _wide_scratch("K9w", d, A.dtype, N, A.device)
            fn = lib.oco_trs_solve_wide_f64 if f64 else \
                lib.oco_trs_solve_wide_f32
            err = fn(A.data_ptr(), b.data_ptr(), N, d, counter.data_ptr(),
                     scratch.data_ptr(), x.data_ptr(),
                     None if passes is None else passes.data_ptr(), stream)
        else:
            fn = lib.oco_trs_solve_f64 if f64 else lib.oco_trs_solve_f32
            err = fn(A.data_ptr(), b.data_ptr(), N, d, counter.data_ptr(),
                     x.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"trust-region kernel launch failed: CUDA "
                               f"error {err}")
        if wide:
            TRS_WIDE_LAUNCHES += 1
        else:
            TRS_LAUNCHES += 1
    return x


def trs_occupancy(d: int, dtype) -> tuple:
    """Registers a thread and resident warps an SM of K9's thin instance
    for ``d`` on the current card (``wide_plan`` for K9w's)."""
    out = (ctypes.c_int * 2)()
    err = cuda_build.load().oco_trs_occupancy(int(dtype == torch.float64), d,
                                              out)
    if err != 0:
        raise RuntimeError(f"K9 occupancy query failed: CUDA error {err}")
    return out[0], out[1]


# K9's schedule (csrc/trs_kernel.cu kThreads, kChunk, kMinIdle): threads a
# block, problems a warp claims from the global counter at once, and idle
# lanes a warp waits for before it hands over.
K9_THREADS = 128
K9_CHUNK = 64
K9_MIN_IDLE = 8


def refill_iterations(passes: torch.Tensor, warps: int) -> torch.Tensor:
    """Loop passes of each warp of K9's refill schedule, in a model where
    the ``warps`` warps step together and claim in warp order.

    ``passes[p]`` is problem p's ridge solves (``trs_action_settled``'s
    count: the ``trs_pass`` calls of its solve).  In each loop pass a warp
    with ``K9_MIN_IDLE`` idle lanes (or whose counter is drained) first
    hands over: its idle lanes take the next indices of its
    range in lane order, and a warp whose range is shorter than its idle
    lanes takes a new range from the shared counter (32 problems the first
    time, ``K9_CHUNK`` after; the warps that do so in warp order) and
    serves the rest of the old range first.  Then every lane that holds a
    solve runs one pass; a warp whose lanes hold none stops.  Returns
    ``(warps,)`` int64: the passes in which each warp ran a Newton pass
    (lanes idle in them included)."""
    n_prob = passes.numel()
    passes = passes.reshape(-1).long()
    dev = passes.device
    rem = torch.zeros((warps, WARP), dtype=torch.int64, device=dev)
    cur = torch.zeros(warps, dtype=torch.int64, device=dev)
    left = torch.zeros_like(cur)
    drained = torch.zeros(warps, dtype=torch.bool, device=dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros_like(cur)
    while True:
        idle = rem == 0
        need = idle.sum(1)
        hand = (need >= K9_MIN_IDLE) | drained
        claim = hand & ~drained
        short = claim & (left < need)
        size = torch.where(short, torch.where(cur == 0, WARP, K9_CHUNK), 0)
        fresh = counter + torch.cumsum(size, 0) - size
        counter = counter + size.sum()
        rank = torch.cumsum(idle, 1) - idle.long()
        q = torch.where(rank < left[:, None], cur[:, None] + rank,
                        fresh[:, None] + rank - left[:, None])
        take = idle & claim[:, None] & (q < n_prob)
        cur = torch.where(claim, torch.where(short, fresh + need - left,
                                             cur + need), cur)
        left = torch.where(claim, torch.where(short, size - (need - left),
                                              left - need), left)
        drained = drained | (claim & (cur >= n_prob))
        rem = torch.where(take, passes[q.clamp(0, n_prob - 1)], rem)
        active = (rem > 0).any(1)
        if not bool(active.any()):
            return iters
        iters += active
        rem = (rem - 1).clamp(min=0)


def trs_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``argmin_{||x|| <= 1} 0.5 x^T A x - b^T x`` for PSD A.

    Args:
      A: ``(N, d, d)`` float32/float64 (its lower triangle is read);
        b: ``(N, d)`` of the same dtype.

    Returns:
      ``(N, d)`` with ``||x|| <= 1``.  On a CUDA tensor this launches
      kernel K9 (K9w above ``MAX_D``) or raises; on a CPU tensor it runs
      ``trs_solve_reference``.
    """
    check_trs(A, b)
    if A.device.type == "cuda":
        return launch_trs_solve(A.contiguous(), b.contiguous())
    if A.device.type == "cpu":
        return trs_solve_reference(A, b)
    raise ValueError(f"unsupported device {A.device}")


# --------------------------------------------------- K8: the quadratic game

def quadratic_comparator_loss_tri(A, b, c, x, d):
    """``0.5 * (x^T A x - 2 b^T x + c)`` from packed statistics (lists of
    tensors), in K8's order: ``xa_i = sum_j a_ij x_j``, then the two
    index-order sums."""
    quad = torch.zeros_like(c)
    dotb = torch.zeros_like(c)
    for i in range(d):
        xa = torch.zeros_like(c)
        for j in range(d):
            xa = xa + A[_tri(i, j) if j <= i else _tri(j, i)] * x[j]
        quad = quad + x[i] * xa
        dotb = dotb + b[i] * x[i]
    return 0.5 * ((quad - 2.0 * dotb) + c)


def quadratic_regrets_reference(z_tm, y_tm, alg_flag, eta):
    """Plain PyTorch version of kernel K8.

    Args:
      z_tm: ``(T, d, B)``; y_tm: ``(T, B)``; alg_flag ``(B,)`` int (0 =
        FTRL, 1 = FTL); eta ``(B,)``.

    Returns:
      ``(cum (B,), comp (B,), x_c (d, B), x_last (d, B))``: the played
      losses, the exact comparator's loss and action, the last action.
    """
    T, d, B = z_tm.shape
    rows, cols = tri_index(d)
    # Running statistics in K8's order; A_pre[t] holds them before round t.
    A_run = z_tm.new_zeros((B, len(rows)))
    b_run = z_tm.new_zeros((B, d))
    c = z_tm.new_zeros((B,))
    A_pre = z_tm.new_empty((T, B, len(rows)))
    b_pre = z_tm.new_empty((T, B, d))
    # FTRL track, sequential and O(d) per round.
    theta = z_tm.new_zeros((B, d))
    cum_r = z_tm.new_zeros((B,))
    x_r = z_tm.new_zeros((B, d))
    rounds = torch.arange(1, T + 1, dtype=z_tm.dtype, device=z_tm.device)
    scales = -torch.div(eta[None, :], correctly_rounded_sqrt(rounds)[:, None])
    for t in range(T):
        z_t, y_t = z_tm[t].t(), y_tm[t]
        A_pre[t], b_pre[t] = A_run, b_run
        x_r = scales[t][:, None] * theta
        x_r = x_r / torch.clamp(correctly_rounded_sqrt(sum_last(x_r * x_r)),
                                min=1.0)[:, None]
        r = sum_last(z_t * x_r) - y_t
        cum_r = cum_r + 0.5 * r * r
        theta = theta + r[:, None] * z_t
        A_run = A_run + z_t[:, rows] * z_t[:, cols]
        b_run = b_run + y_t[:, None] * z_t
        c = c + y_t * y_t
    # Exact-FTL track: every prefix in one batched solve.
    x_f = torch.stack(trs_action_reference(
        [A_pre[..., k] for k in range(len(rows))],
        [b_pre[..., i] for i in range(d)]), dim=-1)           # (T, B, d)
    r = sum_last(z_tm.transpose(1, 2) * x_f) - y_tm              # (T, B)
    loss = 0.5 * r * r
    cum_f = z_tm.new_zeros((B,))
    for t in range(T):                     # K8's order of summation
        cum_f = cum_f + loss[t]
    A_fin = [A_run[:, k] for k in range(len(rows))]
    b_fin = [b_run[:, i] for i in range(d)]
    x_c = trs_action_reference(A_fin, b_fin)
    comp = quadratic_comparator_loss_tri(A_fin, b_fin, c, x_c, d)
    is_ftrl = alg_flag == ALG_FTRL
    cum = torch.where(is_ftrl, cum_r, cum_f)
    x_f_last = x_f[-1] if T > 0 else torch.zeros_like(x_r)
    x_last = torch.where(is_ftrl[:, None], x_r, x_f_last)
    return cum, comp, torch.stack(x_c), x_last.t().contiguous()


# Threads of a warp: K8's lane map keeps FTRL and FTL sequences in warps of
# their own.
WARP = 32
# K8's FTL warps aimed at per SM: each FTL warp holds few enough sequences
# to give every SM this many (at most 32 a warp, at least 1).  One thread's
# Newton chain is latency-bound and a warp takes as long as its slowest
# lane, so a warp of fewer lanes finishes sooner, while the SM's other
# warps hide its latency; past about 8 warps an SM the issue slots run
# out.  On an H100 this gives 4 sequences a warp at the bench shape and 1
# on the quadratic study (PERF.md gives K8's time at each width).
FTL_WARPS_PER_SM = 8


def ftl_width(B: int, device) -> int:
    """Sequences an FTL warp of K8 holds for a batch of B on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(WARP, -(-B // (FTL_WARPS_PER_SM * sms))))


def quad_lanes(flags: torch.Tensor, width: int = WARP) -> torch.Tensor:
    """K8's lane map: thread i plays sequence ``lanes[i]`` (none where it
    is -1), int32.  The FTRL sequences (flag 0) come first, in order, 32 a
    warp; then the FTL ones, in order, ``width`` to a warp, so that no warp
    mixes the two: an FTRL round is a few operations, an FTL round a Newton
    solve.  The length, ``ceil(B / 32) * 32 + ceil(B / width) * 32``,
    depends on B alone, so nothing is read back from the device."""
    B = flags.shape[0]
    ftl = (flags != ALG_FTRL).to(torch.int64)
    order = torch.argsort(ftl, stable=True)
    n_ftrl = B - ftl.sum()
    start = (n_ftrl + WARP - 1) // WARP * WARP      # first FTL warp
    rank = torch.arange(B, device=flags.device)
    j = rank - n_ftrl                               # FTL rank
    slot = torch.where(rank < n_ftrl, rank,
                       start + j // width * WARP + j % width)
    lanes = torch.full(((B + WARP - 1) // WARP * WARP
                        + (B + width - 1) // width * WARP,), -1,
                       dtype=torch.int32, device=flags.device)
    lanes[slot] = order.to(torch.int32)
    return lanes


def quad_warps(flags: torch.Tensor) -> torch.Tensor:
    """K8w's warp map: the sequence each of its warps' claims plays, in
    claim order, int32 ``(B,)``: the FTL sequences (a solve a round) first,
    then the FTRL ones, each in order.  One sequence a warp, whatever its
    flag, so the two share a launch."""
    return torch.argsort((flags == ALG_FTRL).to(torch.int64),
                         stable=True).to(torch.int32)


def launch_quadratic_regrets_wide(z_tm, y_tm, flags, eta, passes=None):
    """Launch kernel K8w (d > ``MAX_D``) on contiguous time-major CUDA
    inputs; returns what ``launch_quadratic_regrets`` does.  ``passes``, a
    ``(T + 1, B)`` int32 CUDA tensor where given, receives each solve's
    ridge solves (row t an FTL round's, 0 for FTRL; row T the
    comparator's)."""
    global QUAD_WIDE_LAUNCHES
    T, d, B = z_tm.shape
    lib = cuda_build.load()
    fn = lib.oco_quad_game_wide_f64 if z_tm.dtype == torch.float64 else \
        lib.oco_quad_game_wide_f32
    with torch.cuda.device(z_tm.device):
        order = quad_warps(flags)
        scratch = _wide_scratch("K8w", d, z_tm.dtype, B, z_tm.device)
        counter = torch.empty((1,), dtype=torch.int64, device=z_tm.device)
        cum = torch.empty((B,), dtype=z_tm.dtype, device=z_tm.device)
        comp = torch.empty_like(cum)
        x_c = torch.empty((d, B), dtype=z_tm.dtype, device=z_tm.device)
        x_last = torch.empty_like(x_c)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), flags.data_ptr(),
                 eta.data_ptr(), order.data_ptr(), T, B, d,
                 counter.data_ptr(), scratch.data_ptr(), cum.data_ptr(),
                 comp.data_ptr(), x_c.data_ptr(), x_last.data_ptr(),
                 None if passes is None else passes.data_ptr(),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"quadratic game kernel launch failed: CUDA "
                               f"error {err}")
        QUAD_WIDE_LAUNCHES += 1
    return cum, comp, x_c, x_last


def launch_quadratic_regrets(z_tm, y_tm, flags, eta, width=None):
    """Launch kernel K8 on contiguous time-major CUDA inputs with
    per-sequence ``flags`` (int32) and ``eta``, ``width`` FTL sequences a
    warp (default ``ftl_width``; the outputs do not depend on it); returns
    ``(cum (B,), comp (B,), x_c (d, B), x_last (d, B))``.  Above ``MAX_D``
    it launches K8w, one sequence a warp (``width`` does not apply)."""
    global QUAD_LAUNCHES
    T, d, B = z_tm.shape
    if wide_instance(d):
        if width is not None:
            raise ValueError(f"width applies to K8's thin instances (d <= "
                             f"{MAX_D}); K8w plays a sequence a warp")
        return launch_quadratic_regrets_wide(z_tm, y_tm, flags, eta)
    lib = cuda_build.load()
    fn = lib.oco_quad_game_f64 if z_tm.dtype == torch.float64 else \
        lib.oco_quad_game_f32
    with torch.cuda.device(z_tm.device):
        lanes = quad_lanes(flags, width or ftl_width(B, z_tm.device))
        cum = torch.empty((B,), dtype=z_tm.dtype, device=z_tm.device)
        comp = torch.empty_like(cum)
        x_c = torch.empty((d, B), dtype=z_tm.dtype, device=z_tm.device)
        x_last = torch.empty_like(x_c)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), flags.data_ptr(),
                 eta.data_ptr(), lanes.data_ptr(), lanes.numel(), T, B, d,
                 cum.data_ptr(), comp.data_ptr(), x_c.data_ptr(),
                 x_last.data_ptr(),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"quadratic game kernel launch failed: CUDA "
                               f"error {err}")
        QUAD_LAUNCHES += 1
    return cum, comp, x_c, x_last


def quadratic_regrets(z_tm: torch.Tensor, y_tm: torch.Tensor, alg_flag=ALG_FTL,
                      eta=1.0):
    """The quadratic-loss game, ``loss_t(x) = 0.5 (<z_t, x> - y_t)^2`` on the
    unit ball, with the exact comparator from the carried statistics.

    Args:
      z_tm: ``(T, d, B)`` float32/float64; y_tm: ``(T, B)``.  Zero rows are
        inert for the statistics and the losses.
      alg_flag: 0 = FTRL (projected gradient leader), 1 = exact FTL; a
        scalar or ``(B,)``.
      eta: FTRL step scale, scalar or ``(B,)`` (ignored for FTL).

    Returns:
      ``(cum_loss (B,), comp_loss (B,), x_c (d, B), x_last (d, B))``.  On a
      CUDA tensor this launches kernel K8 (K8w above ``MAX_D``) or raises;
      on a CPU tensor it runs ``quadratic_regrets_reference``.
    """
    T, d, B = check_time_major(z_tm, y_tm)
    flags = per_sequence(alg_flag, B, torch.int32, z_tm.device)
    eta = per_sequence(eta, B, z_tm.dtype, z_tm.device)
    if z_tm.device.type == "cuda":
        return launch_quadratic_regrets(z_tm.contiguous(), y_tm.contiguous(),
                                        flags, eta)
    if z_tm.device.type == "cpu":
        return quadratic_regrets_reference(z_tm, y_tm, flags, eta)
    raise ValueError(f"unsupported device {z_tm.device}")


__all__ = ["ALG_FTL", "ALG_FTRL", "MAX_D", "trs_solve", "trs_solve_reference",
           "trs_action_reference", "trs_action_settled", "quad_lanes",
           "quad_warps", "ftl_width", "refill_iterations", "trs_occupancy",
           "wide_instance", "wide_plan", "wide_layout", "wide_shared_max_d",
           "wide_scratch_elems", "WIDE_MAX_D",
           "quadratic_regrets",
           "quadratic_regrets_reference"]
