"""Kernels K1 (regret game), K5 (eta sweep) and K4 (carried stream).

Counterpart of ``online_convex_optimization_tpu/ops/pallas_game.py``:

- ``regrets_fused`` (TPU kernel ``_regret_kernel``, plus its VMEM-state
  twin ``_regret_kernel_dloop``): CUDA kernel ``csrc/regret_kernel.cu``,
  plain version ``regrets_fused_reference``;
- ``eta_sweep`` (TPU ``eta_sweep_packed`` / ``_sweep_kernel``): the FTRL
  regret of every (sequence, eta) pair, CUDA kernel ``csrc/sweep_kernel.cu``,
  plain version ``eta_sweep_reference``;
- ``play_stream`` and ``play_stream_many`` (TPU ``play_packed_stream`` /
  ``_stream_kernel`` and ``play_packed_stream_many``): advance a carried game
  over one time chunk, CUDA kernel ``csrc/stream_kernel.cu``, plain version
  ``play_stream_reference``; ``zero_stream_carry``, ``stream_result`` and
  ``validate_stream_chunk`` (the ``pack_time_major(validate=True)`` check)
  around them.

Each plain version is a loop over T vectorized over the batch, in its
kernel's order of operations.  A wrapper runs the plain version on a CPU
tensor and launches the kernel on a CUDA tensor; there is no fallback
between them.  All three kernels play the same round (``oco::game_round``),
so a sweep column, or a sequence fed in chunks, equals K1 bit for bit.

What bounds the kernels on an H100: about 8*(d+1) bytes of f64 input per
round against a serial chain of about 3d+10 flops per round (action with
its sqrt and divide, dot product, update).  The first design keeps that
chain in the reference's rounding order, one thread per sequence (K5: per
(sequence, setting)) with state in registers, and feeds it coalesced
time-major ``(T, d, B)`` loads so that many chains are in flight at once.

The TPU packers and tile budget (``_choose_tiles``, ``sublanes_for``, the
(S, 128) layouts) are not ported: they budget VMEM and the vreg tile.  A
stream chunk is the port's time-major ``(CT, d, B)`` with B exact: it needs
no lane padding.

Comparator modes.  The final FTL action ``x_c`` is scored by the hinge
identity ``0.5 * (len - <x_c, w>)``, ``w = sum y_t z_t``, which is exact
only when every row within the sequence's length has ``||z_t|| <= 1`` and
``y_t = +-1`` (the data builders' contract).  ``in_contract`` checks that on
the tensors' device before the launch, the counterpart of
``pack_sequences(validate=True)``; data outside it is scored by replaying
``0.5 * sum |<z_t, x_c> - y_t|`` over the sequence's own rows.  This is a
choice of formula, made before the launch, not a fallback.  A stream cannot
be replayed: its carried ``cnt = sum y_t^2`` and ``w`` give the identity,
and ``validate_stream_chunk`` checks a chunk against the contract.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    sum_last,
)
from online_convex_optimization_tpu_torch.ops.hinge import (
    hinge_subgradient,
    normalized_hinge,
)
from online_convex_optimization_tpu_torch.utils import cuda_build

ALG_FTRL = 0
ALG_FTL = 1

# Launches of each CUDA kernel in this process (counted where it launches):
# K1, K5 and K4.
LAUNCHES = 0
SWEEP_LAUNCHES = 0
STREAM_LAUNCHES = 0

# Squared row norms up to 1 + CONTRACT_TOL count as inside the unit ball:
# rows clipped in f32 and upcast carry ~1e-7 of rounding (the JAX package's
# pack_sequences(validate=True) uses the same bound).
CONTRACT_TOL = 1e-5

_FLOATS = (torch.float32, torch.float64)


def check_batch(z: torch.Tensor, y: torch.Tensor):
    """Validate a ``(B, T, d)`` / ``(B, T)`` batch; return ``(B, T, d)``."""
    if z.ndim != 3 or y.shape != z.shape[:2]:
        raise ValueError(f"expected z (B, T, d) and y (B, T), got "
                         f"{tuple(z.shape)} and {tuple(y.shape)}")
    if z.dtype not in _FLOATS or y.dtype != z.dtype:
        raise TypeError(f"z and y must share dtype float32 or float64, got "
                        f"{z.dtype} and {y.dtype}")
    if y.device != z.device:
        raise ValueError(f"z on {z.device} but y on {y.device}")
    B, T, d = z.shape
    if B < 1 or d < 1:
        raise ValueError(f"empty batch: z has shape {tuple(z.shape)}")
    if d > cuda_build.MAX_D:
        raise ValueError(f"d = {d} exceeds the kernels' maximum "
                         f"{cuda_build.MAX_D}")
    return B, T, d


def per_sequence(value, B: int, dtype, device) -> torch.Tensor:
    """Broadcast a scalar or ``(B,)`` value to a contiguous ``(B,)`` tensor
    on ``device``."""
    return torch.as_tensor(value, dtype=dtype, device=device).broadcast_to(
        (B,)).contiguous()


def per_sequence_lengths(lengths, B: int, T: int, device) -> torch.Tensor:
    """``(B,)`` int32 valid horizons (``T`` when ``lengths`` is None)."""
    if lengths is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    out = per_sequence(lengths, B, torch.int32, device)
    if bool(((out < 0) | (out > T)).any()):
        raise ValueError(f"lengths must lie in [0, {T}]")
    return out


def in_contract(z: torch.Tensor, y: torch.Tensor,
                lengths: torch.Tensor) -> bool:
    """Whether every row within its sequence's length has ``||z_t|| <= 1``
    and ``y_t = +-1``: the condition under which the hinge identity scores a
    unit-ball action exactly.  Runs on the tensors' device."""
    T = z.shape[1]
    valid = torch.arange(T, device=z.device) < lengths[:, None]
    row_ok = ((torch.linalg.vector_norm(z, dim=-1) ** 2 <= 1.0 + CONTRACT_TOL)
              & (torch.abs(y) == 1.0))
    return bool((row_ok | ~valid).all())


def regrets_fused_reference(z, y, alg_flag, eta, lengths, *, replay=False):
    """Plain PyTorch version of kernel K1, the same arithmetic in the same
    order: a loop over T vectorized over B.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; alg_flag ``(B,)`` int (0 = FTRL,
        1 = FTL); eta ``(B,)``; lengths ``(B,)`` int.
      replay: score the comparator by replaying the rows instead of by
        the hinge identity.

    Returns:
      ``(cum_loss (B,), comp_loss (B,), x_last (B, d))``.
    """
    B, T, d = z.shape
    dtype = z.dtype
    theta = z.new_zeros((B, d))
    w = z.new_zeros((B, d))
    x_last = z.new_zeros((B, d))
    cum = z.new_zeros((B,))
    is_ftrl = (alg_flag == ALG_FTRL)[:, None]
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        x = torch.where(is_ftrl, ftrl_action(theta, t + 1, eta),
                        ftl_action(theta))
        q = sum_last(z_t * x)
        cum = cum + v * normalized_hinge(q, y_t)
        theta = theta + (v * hinge_subgradient(q, y_t))[:, None] * z_t
        w = w + (v * y_t)[:, None] * z_t
        x_last = torch.where(valid[:, None], x, x_last)
    x_c = ftl_action(theta)
    if replay:
        comp = z.new_zeros((B,))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v * normalized_hinge(sum_last(z[:, t] * x_c),
                                               y[:, t])
    else:
        comp = 0.5 * (lengths.to(dtype) - sum_last(x_c * w))
    return cum, comp, x_last


def launch_time_major(z_tm, y_tm, flags, eta, lengths, replay: bool):
    """Launch kernel K1 on time-major CUDA inputs: z_tm ``(T, d, B)``, y_tm
    ``(T, B)``, contiguous, with per-sequence ``flags`` (int32), ``eta`` and
    ``lengths`` (int32) as ``regrets_fused`` prepares them.  Returns
    ``(cum_loss (B,), comp_loss (B,), x_last (d, B))``."""
    global LAUNCHES
    T, d, B = z_tm.shape
    lib = cuda_build.load()
    fn = (lib.oco_regrets_fused_f64 if z_tm.dtype == torch.float64
          else lib.oco_regrets_fused_f32)
    with torch.cuda.device(z_tm.device):
        cum = torch.empty((B,), dtype=z_tm.dtype, device=z_tm.device)
        comp = torch.empty_like(cum)
        x_last = torch.empty((d, B), dtype=z_tm.dtype, device=z_tm.device)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), flags.data_ptr(),
                 eta.data_ptr(), lengths.data_ptr(), B, d, int(replay),
                 cum.data_ptr(), comp.data_ptr(), x_last.data_ptr(),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"regret kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return cum, comp, x_last


def time_major(z: torch.Tensor, y: torch.Tensor):
    """``(B, T, d)`` / ``(B, T)`` -> contiguous ``(T, d, B)`` / ``(T, B)``:
    one thread per sequence then reads neighbouring addresses."""
    return z.permute(1, 2, 0).contiguous(), y.t().contiguous()


def regrets_fused(z: torch.Tensor, y: torch.Tensor, alg_flag, eta,
                  lengths=None):
    """Regret game + final-FTL comparator for a batch of sequences.

    Args:
      z: ``(B, T, d)`` float32/float64; y: ``(B, T)`` of the same dtype.
      alg_flag: 0 = FTRL, 1 = FTL; a scalar or ``(B,)``.
      eta: FTRL step scale, a scalar or ``(B,)`` (ignored for FTL).
      lengths: valid horizon per sequence, scalar or ``(B,)``; rows at and
        beyond it are ignored.  Defaults to ``T``.

    Returns:
      ``(cum_loss (B,), comp_loss (B,), x_last (B, d))`` on ``z``'s device.
      On a CUDA tensor this launches kernel K1 (or raises); on a CPU tensor
      it runs ``regrets_fused_reference``.
    """
    B, T, d = check_batch(z, y)
    flags = per_sequence(alg_flag, B, torch.int32, z.device)
    eta = per_sequence(eta, B, z.dtype, z.device)
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        cum, comp, x_last = launch_time_major(*time_major(z, y), flags, eta,
                                              lengths, replay)
        return cum, comp, x_last.t()
    if z.device.type == "cpu":
        return regrets_fused_reference(z, y, flags, eta, lengths,
                                       replay=replay)
    raise ValueError(f"unsupported device {z.device}")


# ------------------------------------------------------------- K5: eta sweep

def settings_grid(grid, dtype, device, what: str) -> torch.Tensor:
    """A 1-D, non-empty, contiguous grid of settings on ``device``."""
    out = torch.as_tensor(grid, dtype=dtype, device=device).contiguous()
    if out.ndim != 1 or out.numel() < 1:
        raise ValueError(f"{what} must be a non-empty 1-D grid, got shape "
                         f"{tuple(out.shape)}")
    return out


def eta_sweep_reference(z, y, eta_grid, lengths, *, replay=False):
    """Plain PyTorch version of kernel K5: ``regrets_fused_reference``'s FTRL
    arithmetic in the same order, with the settings as a second batch axis.

    State is ``(B, E, d)``; each round broadcasts ``z[:, t]`` over the E
    settings, so z is never repeated E times.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; eta_grid ``(E,)``; lengths ``(B,)``
        int.
      replay: score the comparator by replaying the rows instead of by
        the hinge identity.

    Returns:
      ``(B, E)`` regrets, ``[b, e]`` that of sequence b at ``eta_grid[e]``.
    """
    B, T, d = z.shape
    E = eta_grid.shape[0]
    dtype = z.dtype
    theta = z.new_zeros((B, E, d))
    w = z.new_zeros((B, d))
    cum = z.new_zeros((B, E))
    eta = eta_grid[None, :]
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        x = ftrl_action(theta, t + 1, eta)
        q = sum_last(z_t[:, None, :] * x)
        cum = cum + v[:, None] * normalized_hinge(q, y_t[:, None])
        theta = theta + (v[:, None] * hinge_subgradient(q, y_t[:, None])
                         )[..., None] * z_t[:, None, :]
        w = w + (v * y_t)[:, None] * z_t
    x_c = ftl_action(theta)
    if replay:
        comp = z.new_zeros((B, E))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v[:, None] * normalized_hinge(
                sum_last(z[:, t][:, None, :] * x_c), y[:, t][:, None])
    else:
        comp = 0.5 * (lengths.to(dtype)[:, None] -
                      sum_last(x_c * w[:, None, :]))
    return cum - comp


def launch_eta_sweep_time_major(z_tm, y_tm, eta_grid, lengths, replay: bool):
    """Launch kernel K5 on time-major CUDA inputs (``time_major``) with an
    ``(E,)`` ``eta_grid`` and ``lengths`` (int32) as ``eta_sweep`` prepares
    them.  Returns ``(E, B)`` regrets."""
    global SWEEP_LAUNCHES
    T, d, B = z_tm.shape
    E = eta_grid.shape[0]
    lib = cuda_build.load()
    fn = (lib.oco_eta_sweep_f64 if z_tm.dtype == torch.float64
          else lib.oco_eta_sweep_f32)
    with torch.cuda.device(z_tm.device):
        regret = torch.empty((E, B), dtype=z_tm.dtype, device=z_tm.device)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), eta_grid.data_ptr(),
                 lengths.data_ptr(), B, E, d, int(replay), regret.data_ptr(),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"eta sweep kernel launch failed: CUDA error "
                               f"{err}")
        SWEEP_LAUNCHES += 1
    return regret


def eta_sweep(z: torch.Tensor, y: torch.Tensor, eta_grid, lengths=None):
    """FTRL regret of every (sequence, eta) pair.

    Args:
      z: ``(B, T, d)`` float32/float64; y: ``(B, T)`` of the same dtype.
      eta_grid: ``(E,)`` FTRL step scales.
      lengths: valid horizon per sequence, scalar or ``(B,)``; defaults
        to ``T``.

    Returns:
      ``(B, E)`` regrets on ``z``'s device.  On a CUDA tensor this launches
      kernel K5 (or raises); on a CPU tensor it runs ``eta_sweep_reference``.
    """
    B, T, d = check_batch(z, y)
    eta_grid = settings_grid(eta_grid, z.dtype, z.device, "eta_grid")
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        return launch_eta_sweep_time_major(*time_major(z, y), eta_grid,
                                           lengths, replay).t()
    if z.device.type == "cpu":
        return eta_sweep_reference(z, y, eta_grid, lengths, replay=replay)
    raise ValueError(f"unsupported device {z.device}")


# ------------------------------------------------------- K4: carried stream

class StreamCarry(NamedTuple):
    """Carry of the streamed game in the port's conventions (K1's): theta
    moves by ``0.5 * sign`` per round and losses are halved.  ``w`` and
    ``cnt`` are the identity statistics ``sum y_t z_t`` and ``sum y_t^2``."""

    theta: torch.Tensor   # (d, B)
    w: torch.Tensor       # (d, B)
    cum: torch.Tensor     # (B,)
    cnt: torch.Tensor     # (B,)


def zero_stream_carry(B: int, d: int, dtype=torch.float32,
                      device="cpu") -> StreamCarry:
    """Fresh carry for ``B`` sequences of dimension ``d`` (B is the number
    of sequences: the port's layout needs no lane padding)."""
    if dtype not in _FLOATS:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    return StreamCarry(torch.zeros((d, B), dtype=dtype, device=device),
                       torch.zeros((d, B), dtype=dtype, device=device),
                       torch.zeros((B,), dtype=dtype, device=device),
                       torch.zeros((B,), dtype=dtype, device=device))


def check_stream_chunk(z_chunk: torch.Tensor, y_chunk: torch.Tensor,
                       carry: StreamCarry):
    """Validate a time-major ``(CT, d, B)`` / ``(CT, B)`` chunk against its
    carry (shapes, dtype, device; no device sync); return ``(CT, d, B)``."""
    if z_chunk.ndim != 3 or y_chunk.shape != (z_chunk.shape[0],
                                              z_chunk.shape[2]):
        raise ValueError(f"expected z (CT, d, B) and y (CT, B), got "
                         f"{tuple(z_chunk.shape)} and {tuple(y_chunk.shape)}")
    CT, d, B = z_chunk.shape
    if z_chunk.dtype not in _FLOATS or y_chunk.dtype != z_chunk.dtype:
        raise TypeError(f"z and y must share dtype float32 or float64, got "
                        f"{z_chunk.dtype} and {y_chunk.dtype}")
    if d > cuda_build.MAX_D:
        raise ValueError(f"d = {d} exceeds the kernels' maximum "
                         f"{cuda_build.MAX_D}")
    want = {"theta": (d, B), "w": (d, B), "cum": (B,), "cnt": (B,)}
    for name, shape in want.items():
        t = getattr(carry, name)
        if (tuple(t.shape) != shape or t.dtype != z_chunk.dtype
                or t.device != z_chunk.device):
            raise ValueError(f"carry {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; the chunk needs "
                             f"{shape} {z_chunk.dtype} on {z_chunk.device}")
    if y_chunk.device != z_chunk.device:
        raise ValueError(f"z on {z_chunk.device} but y on {y_chunk.device}")
    return CT, d, B


def validate_stream_chunk(z_chunk: torch.Tensor,
                          y_chunk: torch.Tensor) -> None:
    """Raise ``ValueError`` unless a time-major chunk meets the identity
    contract: every row has ``||z_t||^2 <= 1 + CONTRACT_TOL`` and a label of
    +-1, or is an all-zero padding row (``y_t = 0``, ``z_t = 0``).  A row
    with ``y_t = 0`` and ``z_t != 0`` would be scored wrongly by the carried
    identity, so it is refused.  Runs on the chunk's device and syncs."""
    nsq = sum_last(z_chunk.transpose(1, 2) * z_chunk.transpose(1, 2))
    max_nsq = float(nsq.max()) if nsq.numel() else 0.0
    if max_nsq > 1.0 + CONTRACT_TOL:
        raise ValueError(f"rows must lie in the unit L2 ball (max ||z||^2 = "
                         f"{max_nsq:.6f}); clip rows like the data builders "
                         f"do")
    ok = (torch.abs(y_chunk) == 1.0) | ((y_chunk == 0.0) & (nsq == 0.0))
    if not bool(ok.all()):
        raise ValueError("labels must be +-1, or 0 on an all-zero padding "
                         "row")


def play_stream_reference(z_chunk, y_chunk, alg_flag, eta, t0: int,
                          carry: StreamCarry) -> StreamCarry:
    """Plain PyTorch version of kernel K4: K1's round in the same order over
    the chunk's rows, at the global 1-based round index ``t0 + k + 1``.

    Args:
      z_chunk: ``(CT, d, B)``; y_chunk: ``(CT, B)``; alg_flag ``(B,)`` int;
        eta ``(B,)``; t0: rounds already played; carry: ``StreamCarry``.

    Returns:
      The advanced ``StreamCarry`` (new tensors).
    """
    theta, w = carry.theta.t(), carry.w.t()
    cum, cnt = carry.cum, carry.cnt
    is_ftrl = (alg_flag == ALG_FTRL)[:, None]
    for k in range(z_chunk.shape[0]):
        z_t, y_t = z_chunk[k].t(), y_chunk[k]
        x = torch.where(is_ftrl, ftrl_action(theta, t0 + k + 1, eta),
                        ftl_action(theta))
        q = sum_last(z_t * x)
        cum = cum + normalized_hinge(q, y_t)
        theta = theta + hinge_subgradient(q, y_t)[:, None] * z_t
        w = w + y_t[:, None] * z_t
        cnt = cnt + y_t * y_t
    return StreamCarry(theta.t().contiguous(), w.t().contiguous(), cum, cnt)


def launch_stream_time_major(z_tm, y_tm, flags, eta, t0: int,
                             carry: StreamCarry) -> StreamCarry:
    """Launch kernel K4 on a contiguous time-major CUDA chunk with
    per-sequence ``flags`` (int32) and ``eta``; returns the advanced carry
    in new tensors."""
    global STREAM_LAUNCHES
    CT, d, B = z_tm.shape
    lib = cuda_build.load()
    fn = (lib.oco_play_stream_f64 if z_tm.dtype == torch.float64
          else lib.oco_play_stream_f32)
    with torch.cuda.device(z_tm.device):
        out = StreamCarry(*(torch.empty_like(t) for t in carry))
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), flags.data_ptr(),
                 eta.data_ptr(), int(t0), CT, B, d,
                 *(t.data_ptr() for t in carry),
                 *(t.data_ptr() for t in out),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stream kernel launch failed: CUDA error "
                               f"{err}")
        STREAM_LAUNCHES += 1
    return out


def advance_stream(z_chunk, y_chunk, flags, eta, t0: int,
                   carry: StreamCarry) -> StreamCarry:
    """``play_stream`` with per-sequence ``flags`` (int32) and ``eta``
    already on the chunk's device: no host sync on CUDA."""
    check_stream_chunk(z_chunk, y_chunk, carry)
    if t0 < 0:
        raise ValueError(f"t0 must be >= 0, got {t0}")
    carry = StreamCarry(*(t.contiguous() for t in carry))
    if z_chunk.device.type == "cuda":
        return launch_stream_time_major(z_chunk.contiguous(),
                                        y_chunk.contiguous(), flags, eta,
                                        t0, carry)
    if z_chunk.device.type == "cpu":
        return play_stream_reference(z_chunk, y_chunk, flags, eta, t0, carry)
    raise ValueError(f"unsupported device {z_chunk.device}")


def play_stream(z_chunk: torch.Tensor, y_chunk: torch.Tensor, eta, t0: int,
                carry: StreamCarry, *, alg_flag=ALG_FTRL) -> StreamCarry:
    """Advance the streamed game over one time-major chunk.

    Args:
      z_chunk: ``(CT, d, B)`` float32/float64; y_chunk: ``(CT, B)``.
      eta: FTRL step scale, scalar or ``(B,)`` (ignored for FTL).
      t0: rounds already played; row k is global round ``t0 + k + 1``.
      carry: from ``zero_stream_carry`` or a previous call.
      alg_flag: 0 = FTRL, 1 = FTL; scalar or ``(B,)``.

    Returns:
      The advanced carry.  On a CUDA chunk this launches kernel K4 (or
      raises); on a CPU chunk it runs ``play_stream_reference``.
    """
    B = z_chunk.shape[-1]
    flags = per_sequence(alg_flag, B, torch.int32, z_chunk.device)
    eta = per_sequence(eta, B, z_chunk.dtype, z_chunk.device)
    return advance_stream(z_chunk, y_chunk, flags, eta, t0, carry)


def play_stream_many(z_stack: torch.Tensor, y_stack: torch.Tensor, eta,
                     t0: int, carry: StreamCarry, *,
                     alg_flag=ALG_FTRL) -> StreamCarry:
    """Advance over N stacked chunks ``(N, CT, d, B)`` / ``(N, CT, B)``: one
    K4 launch per chunk from a Python loop, with no host sync between
    launches (the counterpart of the TPU's one-dispatch ``lax.scan``)."""
    if z_stack.ndim != 4:
        raise ValueError(f"expected z (N, CT, d, B), got "
                         f"{tuple(z_stack.shape)}")
    N, CT, _, B = z_stack.shape
    flags = per_sequence(alg_flag, B, torch.int32, z_stack.device)
    eta = per_sequence(eta, B, z_stack.dtype, z_stack.device)
    for i in range(N):
        carry = advance_stream(z_stack[i], y_stack[i], flags, eta,
                               t0 + i * CT, carry)
    return carry


def stream_result(carry: StreamCarry):
    """Regret from a streamed carry by the hinge identity, no replay:
    ``(regret, cum_loss, comp_loss)``, each ``(B,)``, with the comparator
    the final FTL action scored as ``0.5 * (cnt - <x_c, w>)``."""
    x_c = ftl_action(carry.theta.t())
    comp = 0.5 * (carry.cnt - sum_last(x_c * carry.w.t()))
    return carry.cum - comp, carry.cum, comp
