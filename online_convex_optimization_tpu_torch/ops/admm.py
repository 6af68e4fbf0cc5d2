"""Kernel K10: the all-prefix exact-FTL ADMM on the l2 ball.

Counterpart of ``online_convex_optimization_tpu/ops/pallas_admm.py``
(``admm_all_prefixes_l2`` / ``_admm_kernel``): for every replicate ``b`` and
prefix length ``p``, one ADMM row solves

    minimize_{||x||_2 <= 1}  0.5 * sum_{t < p} |<z_t, x> - y_t|,

with the splitting, over-relaxation, soft threshold, exact-sqrt projection,
residual check and warm continuation of the TPU kernel (the CUDA sources,
``csrc/admm_kernel.cu`` and ``csrc/admm_long_kernel.cu``, spell them
out).  ``admm_prologue`` forms, in
plain PyTorch and outside the kernel as the JAX package does it in XLA, the
Cholesky factors of ``Gram_p + I`` for every row (one cumulative sum and one
batched ``torch.linalg.cholesky_ex``), packed as a lower triangle with the
diagonal inverted, so the kernel's substitutions only multiply.  The kernel
and its plain version ``admm_all_prefixes_l2_reference`` read the same
factor and differ only in the order of the rhs reductions.

Each row stops on its own residual (checked every ``check_every``
iterations when ``tol > 0``); the TPU kernel's 256-row VMEM blocks
(``block_rows``) are tiling and are not ported, nor are its 128-lane
``vec`` packing of ``(x, w, v, res)`` and the padding of T to 128.  The
state is ``(s, u, x, w, v)``: ``s``, ``u`` ``(B*T, T)`` (zero past each
row's length) and ``x``, ``w``, ``v`` ``(B*T, d)``, row ``b*T + p`` for the
length-``(p + 1)`` prefix; ``testing/from_jax.py::admm_state_from_jax``
converts the JAX package's states into it.

Float32 only, like the TPU kernel.  A wrapper runs the plain version on a
CPU tensor and launches the kernel on a CUDA tensor, for ``d <= MAX_D``
(raising above it) and any T; there is no fallback between them.  The
kernel splits each row across warps by the row's own length, so a row's
result does not depend on T: a launch on ``z[:, :T]`` gives rows ``p < T``
of a launch on longer ``z`` bit for bit.  Rows longer than ``LONG_ROWS``
take K10l: up to ``RESIDENT_ROWS`` entries its resident instance, which
keeps s and u on the chip for the whole launch, and past that its
streaming instance, whose s and u stream through device memory each
iteration; both map a row's entries to threads alike, so a row's bits do
not depend on which one takes it.  The state, ``8 B T^2`` bytes, is the
only limit on T, and an allocation the card cannot hold raises its own
error.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from online_convex_optimization_tpu_torch.utils import cuda_build

# The CUDA kernel's envelope (csrc/admm_kernel.cu OCO_ADMM_MAX_D): d <= 8
# is the TPU kernel's contract (x in lanes 0-7, y at row 8).
MAX_D = 8
# Rows longer than this (8 warps of 32 lanes with 16 entries of s and u
# each) take the long-row instance K10l (csrc/oco_admm.cuh kLongRows,
# csrc/admm_long_kernel.cu).
LONG_ROWS = 4096
# Rows up to this length among them take K10l's resident instance, whose s
# and u stay on the chip for the whole launch; longer rows its streaming
# instance (csrc/admm_long_kernel.cu kResidentRows).
RESIDENT_ROWS = 8192

# Kernel launches of K10 in this process, as the C entry reports them (one
# a call, two past T = 2048: the 16-entries-a-lane rows, then the rest;
# three past LONG_ROWS: the long rows first; four past RESIDENT_ROWS: K10l's
# streaming instance, then its resident one), of those the launches of
# K10l's two instances, and of those the resident instance's.
LAUNCHES = 0
LONG_LAUNCHES = 0
RESIDENT_LAUNCHES = 0

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def tril_index(j: int, k: int) -> int:
    """Position of entry ``(j, k)``, ``k <= j``, in the packed factor."""
    return j * (j + 1) // 2 + k


def admm_prologue(z: torch.Tensor) -> torch.Tensor:
    """Packed Cholesky factors of ``Gram_p + I`` for every row.

    Args:
      z: ``(B, T, d)``.

    Returns:
      ``(B*T, d(d+1)/2)``: row ``b*T + p`` holds the lower factor of
      ``sum_{t <= p} z_t z_t^T + I`` row by row (``tril_index``), with the
      diagonal entries replaced by their reciprocals.
    """
    B, T, d = z.shape
    outers = z[:, :, None, :] * z[:, :, :, None]                # (B, T, d, d)
    gram = torch.cumsum(outers, dim=1)
    A = gram + torch.eye(d, dtype=z.dtype, device=z.device)
    # cholesky_ex does not synchronize to check the factorization: Gram + I
    # is positive definite, and a NaN in z surfaces as a NaN residual.
    chol, _ = torch.linalg.cholesky_ex(A)
    cols = []
    for j in range(d):
        for k in range(j + 1):
            e = chol[:, :, j, k]
            cols.append(torch.reciprocal(e) if j == k else e)
    return torch.stack(cols, dim=-1).reshape(B * T, -1).contiguous()


def check_admm_inputs(z: torch.Tensor, y: torch.Tensor,
                      state0: Optional[State]):
    """Validate ``(B, T, d)`` / ``(B, T)`` float32 inputs and a state;
    return ``(B, T, d)``."""
    if z.ndim != 3 or y.shape != z.shape[:2]:
        raise ValueError(f"expected z (B, T, d) and y (B, T), got "
                         f"{tuple(z.shape)} and {tuple(y.shape)}")
    if z.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"K10 takes float32 z and y (the TPU kernel's "
                        f"type), got {z.dtype} and {y.dtype}")
    if y.device != z.device:
        raise ValueError(f"z on {z.device} but y on {y.device}")
    B, T, d = z.shape
    if B < 1 or T < 1 or d < 1:
        raise ValueError(f"empty batch: z has shape {tuple(z.shape)}")
    if state0 is not None:
        if len(state0) != 5:
            raise ValueError("state0 must be (s, u, x, w, v)")
        shapes = [(B * T, T)] * 2 + [(B * T, d)] * 3
        for name, a, shape in zip("suxwv", state0, shapes):
            if (tuple(a.shape) != shape or a.dtype != torch.float32
                    or a.device != z.device):
                raise ValueError(
                    f"state0 {name}: expected float32 {shape} on {z.device}, "
                    f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    return B, T, d


def check_kernel_envelope(T: int, d: int) -> None:
    """Raise for a shape the CUDA kernel K10 has no instance of (any T
    has one)."""
    if d > MAX_D:
        raise ValueError(f"d = {d} exceeds K10's limit d <= {MAX_D} (the TPU "
                         f"kernel's contract); the CPU plain version takes "
                         f"any d")


def kernel_instances(T: int) -> list:
    """K10's instances a launch at T runs, in launch order (the C entry's
    map of rows to instances): ``"long"`` (K10l's streaming instance) for
    the rows longer than ``RESIDENT_ROWS``, ``"resident"`` (K10l's resident
    one) for the rows of ``LONG_ROWS + 1`` to ``RESIDENT_ROWS`` entries,
    ``16`` for the rows of 2,049 to 4,096 entries, ``8`` for the rest."""
    return [name for name in ("long", "resident", 16, 8)
            if instance_rows(name, T)[1] > instance_rows(name, T)[0]]


def instance_rows(name, T: int) -> tuple:
    """The row lengths ``(lo, hi]`` that instance ``name`` (as
    ``kernel_instances`` names them) takes in a launch at T."""
    bounds = {"long": (RESIDENT_ROWS, T), "resident": (LONG_ROWS,
                                                       RESIDENT_ROWS),
              16: (2048, LONG_ROWS), 8: (0, 2048)}
    lo, hi = bounds[name]
    return lo, max(lo, min(hi, T))


def resident_plan(d: int) -> dict:
    """K10l's resident block at feature dimension d (the d = 5 instance or
    the generic one), as its source sizes it (``Resident``): rows a block,
    groups of 256 threads and rows a group, threads, a thread's entries of
    a row, of its entries of s and u those in registers (its first row's
    first) and those in shared memory, the ring's stages (one entry of y
    and z a thread of a group each), and the bytes of shared memory
    (``smem_bytes`` dynamic, ``static_bytes`` the rows' factors, x, w, v
    and partial sums)."""
    check_kernel_envelope(LONG_ROWS + 1, d)
    out = (ctypes.c_int * 10)()
    err = cuda_build.load().oco_admm_resident_plan(d, out)
    if err != 0:
        raise RuntimeError(f"K10l plan failed: CUDA error {err}")
    return dict(zip(("rows", "groups", "group_rows", "threads", "entries",
                     "register_entries", "shared_entries", "stages",
                     "smem_bytes", "static_bytes"), out))


def _cho_solve_rows(L, rhs, d):
    """``(L L^T)^{-1} rhs`` with ``L`` a list of packed factor entries whose
    diagonal is inverted: multiply-only substitutions (the TPU kernel's
    ``_cho_solve_rows``)."""
    a = []
    for j in range(d):
        sj = rhs[j]
        for k in range(j):
            sj = sj - L[tril_index(j, k)] * a[k]
        a.append(sj * L[tril_index(j, j)])
    x = [None] * d
    for j in reversed(range(d)):
        sj = a[j]
        for k in range(j + 1, d):
            sj = sj - L[tril_index(k, j)] * x[k]
        x[j] = sj * L[tril_index(j, j)]
    return x


def admm_all_prefixes_l2_reference(z, y, Lpk, *, iters: int, tol: float,
                                   check_every: int, rho: float,
                                   alpha: float,
                                   state0: Optional[State] = None):
    """Plain PyTorch version of kernel K10, the same arithmetic per entry.

    Args:
      z: ``(B, T, d)`` float32; y: ``(B, T)``; Lpk: ``admm_prologue(z)``.
      iters, tol, check_every, rho, alpha, state0: as
        ``admm_all_prefixes_l2``.

    Returns:
      ``(res (B*T,), state)``.  All rows iterate as ``(B, T, T)`` tensors;
      a row that has stopped keeps its state (``torch.where``), so each row
      follows the kernel's per-row rule.
    """
    B, T, d = z.shape
    P = T
    kappa, beta = 0.5 / rho, 1.0 - alpha
    zj = [z[:, None, :, j] for j in range(d)]                   # (B, 1, T)
    yv = y[:, None, :]
    mask = (torch.arange(T, device=z.device)[None, :]
            <= torch.arange(P, device=z.device)[:, None]).to(z.dtype)
    L = [Lpk[:, k].reshape(B, P) for k in range(Lpk.shape[1])]
    if state0 is None:
        s = z.new_zeros((B, P, T))
        u = z.new_zeros((B, P, T))
        x = [z.new_zeros((B, P)) for _ in range(d)]
        w = [z.new_zeros((B, P)) for _ in range(d)]
        v = [z.new_zeros((B, P)) for _ in range(d)]
    else:
        s0, u0, x0, w0, v0 = state0
        s, u = s0.reshape(B, P, T), u0.reshape(B, P, T)
        x, w, v = ([a.reshape(B, P, d)[..., j] for j in range(d)]
                   for a in (x0, w0, v0))

    def q_of(xs):
        q = xs[0][..., None] * zj[0]
        for j in range(1, d):
            q = q + xs[j][..., None] * zj[j]
        return q                                                 # (B, P, T)

    def one_iter(s, u, x, w, v):
        ysu = mask * ((yv + s) - u)
        rhs = [(ysu * zj[j]).sum(dim=-1) + (w[j] - v[j]) for j in range(d)]
        x = _cho_solve_rows(L, rhs, d)
        r = mask * (q_of(x) - yv)
        r_hat = alpha * r + beta * s
        sp = r_hat + u
        s = torch.sign(sp) * torch.clamp(torch.abs(sp) - kappa,
                                         min=0.0) * mask
        u = ((u + r_hat) - s) * mask
        xh = [alpha * x[j] + beta * w[j] for j in range(d)]
        t = [xh[j] + v[j] for j in range(d)]
        n2 = t[0] * t[0]
        for j in range(1, d):
            n2 = n2 + t[j] * t[j]
        nrm = torch.sqrt(torch.clamp(n2, min=1.0))
        w = [t[j] / nrm for j in range(d)]
        v = [(v[j] + xh[j]) - w[j] for j in range(d)]
        return s, u, x, w, v

    def residual(s, x, w):
        r = mask * (q_of(x) - yv)
        pri = torch.amax(torch.abs(r - s), dim=-1)
        cons = torch.abs(x[0] - w[0])
        for j in range(1, d):
            cons = torch.maximum(cons, torch.abs(x[j] - w[j]))
        return torch.maximum(pri, cons)                          # (B, P)

    state = (s, u, x, w, v)
    if tol > 0.0:
        active = torch.ones((B, P), dtype=torch.bool, device=z.device)
        for _ in range(-(-iters // check_every)):
            start = state
            for _ in range(check_every):
                state = one_iter(*state)
            # A row that stopped keeps its state: the kernel's per-row exit.
            keep = active[..., None]
            state = (torch.where(keep, state[0], start[0]),
                     torch.where(keep, state[1], start[1]),
                     *([torch.where(active, a, b) for a, b in zip(new, old)]
                       for new, old in zip(state[2:], start[2:])))
            # <=-negation: a NaN residual stops its row, as in the kernel.
            active = active & (residual(state[0], state[2], state[3]) > tol)
            if not bool(active.any()):
                break
    else:
        for _ in range(iters):
            state = one_iter(*state)
    s, u, x, w, v = state
    res = residual(s, x, w).reshape(B * P)
    out = (s.reshape(B * P, T), u.reshape(B * P, T),
           *(torch.stack(a, dim=-1).reshape(B * P, d) for a in (x, w, v)))
    return res, out


def launch_admm(z, y, Lpk, *, iters: int, tol: float, check_every: int,
                rho: float, alpha: float, state0: Optional[State] = None):
    """Launch kernel K10 on contiguous float32 CUDA inputs; returns ``(res
    (B*T,), state)``."""
    global LAUNCHES, LONG_LAUNCHES, RESIDENT_LAUNCHES
    B, T, d = z.shape
    check_kernel_envelope(T, d)
    lib = cuda_build.load()
    with torch.cuda.device(z.device):
        s = torch.empty((B * T, T), dtype=torch.float32, device=z.device)
        u = torch.empty_like(s)
        x = torch.empty((B * T, d), dtype=torch.float32, device=z.device)
        w = torch.empty_like(x)
        v = torch.empty_like(x)
        res = torch.empty((B * T,), dtype=torch.float32, device=z.device)
        st0 = ([a.contiguous() for a in state0] if state0 is not None
               else None)
        ptrs0 = [a.data_ptr() for a in st0] if st0 is not None else [None] * 5
        launched = (ctypes.c_int * 3)()
        err = lib.oco_admm_all_prefixes_f32(
            z.data_ptr(), y.data_ptr(), Lpk.data_ptr(), *ptrs0, B, T, d,
            iters, check_every, tol, 0.5 / rho, alpha, 1.0 - alpha,
            s.data_ptr(), u.data_ptr(), x.data_ptr(), w.data_ptr(),
            v.data_ptr(), res.data_ptr(),
            torch.cuda.current_stream(z.device).cuda_stream, launched)
        LAUNCHES += launched[0]
        LONG_LAUNCHES += launched[1]
        RESIDENT_LAUNCHES += launched[2]
        if err != 0:
            raise RuntimeError(f"ADMM kernel launch failed: CUDA error {err}")
    return res, (s, u, x, w, v)


def kernel_occupancy(T: int, d: int) -> dict:
    """Registers a thread and resident warps an SM of K10's four
    instances for a launch at ``(T, d)`` on the current card: ``{8: (regs,
    warps), 16: (regs, warps), "long": (regs, warps), "resident": (regs,
    warps)}``, keyed as ``kernel_instances`` names them (0 warps where T
    has no such row)."""
    check_kernel_envelope(T, d)
    out = (ctypes.c_int * 8)()
    err = cuda_build.load().oco_admm_occupancy_f32(d, T, out)
    if err != 0:
        raise RuntimeError(f"K10 occupancy query failed: CUDA error {err}")
    return {8: (out[0], out[1]), 16: (out[2], out[3]),
            "long": (out[4], out[5]), "resident": (out[6], out[7])}


def admm_all_prefixes_l2(z: torch.Tensor, y: torch.Tensor, *,
                         iters: int = 2000, tol: float = 2e-4,
                         check_every: int = 100, rho: float = 1.0,
                         alpha: float = 1.7, state0: Optional[State] = None):
    """All-prefix exact-FTL ADMM on the l2 ball for a batch of replicates.

    Args:
      z: ``(B, T, d)`` float32; y: ``(B, T)`` float32.
      iters: iteration cap; with ``tol > 0`` a row runs whole blocks of
        ``check_every`` iterations, at most ``ceil(iters / check_every)``,
        and stops after the first block whose end residual is not above
        ``tol``; with ``tol == 0`` exactly ``iters`` iterations.
      state0: the state of an earlier call on the same data (continuation:
        the iteration is Markov in the state, so 100 then 150 iterations
        equal 250 bit for bit).

    Returns:
      ``(X, res, state)``: X ``(B, T, d)`` the feasible prefix minimizers
      (``X[b, p]`` solves the length-``(p+1)`` prefix), res ``(B, T)`` the
      residuals, state ``(s, u, x, w, v)``.  On a CUDA tensor this launches
      kernel K10 (or raises); on a CPU tensor it runs
      ``admm_all_prefixes_l2_reference``.
    """
    B, T, d = check_admm_inputs(z, y, state0)
    if check_every < 1 or iters < 0:
        raise ValueError(f"need iters >= 0 and check_every >= 1, got "
                         f"{iters} and {check_every}")
    Lpk = admm_prologue(z)
    kw = dict(iters=int(iters), tol=float(tol), check_every=int(check_every),
              rho=float(rho), alpha=float(alpha), state0=state0)
    if z.device.type == "cuda":
        res, state = launch_admm(z.contiguous(), y.contiguous(), Lpk, **kw)
    elif z.device.type == "cpu":
        res, state = admm_all_prefixes_l2_reference(z, y, Lpk, **kw)
    else:
        raise ValueError(f"unsupported device {z.device}")
    return state[3].reshape(B, T, d), res.reshape(B, T), state


def feasible_actions(X) -> np.ndarray:
    """K10's float32 actions (a tensor or an array) as f64 NumPy, scaled
    into the unit l2 ball.

    The projection rounds in f32, so an action on the sphere can lie a few
    ulps outside it, where the objective is up to ~1e-5 (at T = 1000)
    below the constrained optimum.  The host polish keeps its input unless
    a candidate beats it, so such an input shuts the exact optimum out;
    scaled into the ball in f64 it no longer can.  (The JAX package hands
    the polish its f32 iterate as it is.)"""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    X = np.asarray(X, np.float64)
    return X / np.maximum(np.linalg.norm(X, axis=-1, keepdims=True), 1.0)


__all__ = ["LONG_ROWS", "MAX_D", "RESIDENT_ROWS", "admm_all_prefixes_l2",
           "admm_all_prefixes_l2_reference", "admm_prologue",
           "feasible_actions", "instance_rows", "kernel_instances",
           "kernel_occupancy", "resident_plan"]
