"""Kernels K1 (regret game), K5 (eta sweep), K4 (carried stream), K3,
K3e (the packed game API) and K7 (the generation-fused game).

Counterpart of ``online_convex_optimization_tpu/ops/pallas_game.py``:

- ``regrets_fused`` (TPU kernel ``_regret_kernel``, plus its VMEM-state
  twin ``_regret_kernel_dloop``): CUDA kernel ``csrc/regret_kernel.cu``
  (``launch_regrets``) on the caller's ``(B, T, d)`` layout with the
  ``(E, T)`` scale table of ``eta_table``, plain version
  ``regrets_fused_reference``; ``regret_plays``, the evaluation's entry,
  plays each sequence under P <= 8 flags in one launch from one copy of z,
  plain version ``regret_plays_reference``;
- ``eta_sweep`` (TPU ``eta_sweep_packed`` / ``_sweep_kernel``): the FTRL
  regret of every (sequence, eta) pair, CUDA kernel ``csrc/sweep_kernel.cu``
  on the caller's ``(B, T, d)`` layout with the ``(E, T)`` scale table
  ``sweep_scales`` and the blocks' sequence order ``length_order``, plain
  version ``eta_sweep_reference``;
- ``play_stream`` and ``play_stream_many`` (TPU ``play_packed_stream`` /
  ``_stream_kernel`` and ``play_packed_stream_many``): advance a carried game
  over one time chunk, CUDA kernel ``csrc/stream_kernel.cu``, plain version
  ``play_stream_reference``; ``zero_stream_carry``, ``stream_result`` and
  ``validate_stream_chunk`` (the ``pack_time_major(validate=True)`` check)
  around them;
- ``play_packed`` (TPU ``play_packed`` / ``_game_kernel`` and its VMEM-state
  twin ``_game_kernel_dloop``) and ``play_packed_eta`` (TPU
  ``play_packed_eta`` / ``_game_eta_kernel``): cum and theta of the game on
  time-major inputs, from a ``(T,)`` table of FTRL scales (``ftrl_scales``)
  or with a per-sequence eta; CUDA kernel ``csrc/game_kernel.cu``, plain
  versions ``play_packed_reference`` and ``play_packed_eta_reference``;
  ``regrets_packed`` / ``regrets_packed_eta`` add the comparator by a plain
  PyTorch replay (the JAX ``_comparator_epilogue``), and
  ``simulate_linear_packed`` (the JAX ``simulate_linear_pallas_v2``),
  ``simulate_linear_auto`` and ``kernel_envelope`` take the ``(B, T, d)``
  API;
- ``synthetic_regrets`` (TPU ``synthetic_regrets`` / ``_synthetic_kernel``):
  the FTRL/FTL game on Rademacher rows ``+-1/sqrt(d)`` and labels ``+-1``
  drawn inside the kernel from Philox4x32-10 (``ops/philox.py``), CUDA
  kernel ``csrc/synthetic_kernel.cu``; ``synthetic_stream`` materializes
  the same rows, and the plain version ``synthetic_regrets_reference`` is
  K1's plain version on them.

Each plain version is a loop over T vectorized over the batch, in its
kernel's order of operations, sharing K1's step (``hinge_round``).  A
wrapper runs the plain version on a CPU tensor, at any d, and launches the
kernel on a CUDA tensor; there is no fallback between them.  Every kernel
here takes any d on the card: past ``cuda_build.MAX_D`` = 512 each
launches its wide instance (K1w, K3w, K3ew, K4w, K5w, K7w), whose state
lies in a device buffer of ``wide_state_elems`` elements that the wrapper
allocates (a buffer that does not fit raises as ``torch.empty`` raises);
K1w, K3w, K3ew, K4w, K6aw, K6bw and K7w keep it in shared memory while
their plans (``regret_plan``, ``packed_plan``, ``stream_plan``,
``prefix_plan``, ``tail_plan``, ``synthetic_plan``) say a block's state
fits, and need no buffer there.
K1, K4 and K5 play the same round (``oco::game_round``), K3 and K3e its
action and hinge step, so a sweep column, a sequence fed in chunks or a
packed game equals K1 bit for bit.

What bounds the kernels on an H100: about 8*(d+1) bytes of f64 input per
round against a serial chain of about 3d+10 flops per round (action with
its sqrt and divide, dot product, update).  Every design keeps that chain
in the reference's rounding order, one thread per play (K5: per
(sequence, setting)) with state in registers.  K3 and K4 feed it
coalesced time-major ``(T, d, B)`` loads so that many chains are in flight
at once; K1 and K5 stage the caller's rows in shared memory for all the
warps of a block (``csrc/oco_tiles.cuh``), so no load sits in a round and
the rows cross L2 once per block; K5's round is then bound by the FP64
pipe's issue, K1's by its chain.

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

Storage.  z and y may be stored narrower than the arithmetic, as the JAX
package stores them (``pack_sequences(dtype, y_dtype=)``): ``STORAGE``
lists the pairs, bf16 z with bf16 or int8 y and float32 z with int8 y
beside float32 and float64.  The kernels read the narrow arrays and widen
each element to float32 on read, which is exact, so a narrow run equals the
float32 run on ``z.float()``, ``y.float()`` in every bit; carries, tables
and outputs are in ``compute_dtype``.  On the CPU the wrappers upcast and
run the plain versions.  ``in_contract`` forms bf16 rows' squared norms in
float32, so rows that bf16 rounding put outside the ball are scored by
replay: the exact regret of the stored values.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    ftrl_action_scaled,
    sum_last,
)
from online_convex_optimization_tpu_torch.ops.hinge import (
    hinge_subgradient,
    normalized_hinge,
)
from online_convex_optimization_tpu_torch.ops.philox import (
    round_bits,
    round_keys,
)
from online_convex_optimization_tpu_torch.utils import cuda_build
from online_convex_optimization_tpu_torch.utils.devices import resolve_device

ALG_FTRL = 0
ALG_FTL = 1

# Launches of each CUDA kernel in this process (counted where it launches):
# K1, K5, K4, K3, K3e and K7.
LAUNCHES = 0
SWEEP_LAUNCHES = 0
STREAM_LAUNCHES = 0
PACKED_LAUNCHES = 0
PACKED_ETA_LAUNCHES = 0
SYNTHETIC_LAUNCHES = 0

# Squared row norms up to 1 + CONTRACT_TOL count as inside the unit ball:
# rows clipped in f32 and upcast carry ~1e-7 of rounding (the JAX package's
# pack_sequences(validate=True) uses the same bound).
CONTRACT_TOL = 1e-5

_FLOATS = (torch.float32, torch.float64)

# The (z, y) storage pairs of kernels K1-K6 and the suffix of their C
# entries (csrc/oco_common.cuh OCO_STORAGE_PAIRS).  bf16 y with float32 z
# and float32 y with bf16 z are left out: the JAX package's bench and
# bench suite store neither.
STORAGE = {
    (torch.float64, torch.float64): "f64",
    (torch.float32, torch.float32): "f32",
    (torch.bfloat16, torch.bfloat16): "bf16",
    (torch.bfloat16, torch.int8): "bf16i8",
    (torch.float32, torch.int8): "f32i8",
}


def storage_suffix(z_dtype, y_dtype) -> str:
    """The C suffix of a (z, y) storage pair; ``TypeError`` for a pair
    outside ``STORAGE``."""
    suffix = STORAGE.get((z_dtype, y_dtype))
    if suffix is None:
        pairs = ", ".join(f"({str(a)[6:]}, {str(b)[6:]})" for a, b in STORAGE)
        raise TypeError(f"unsupported storage: z {z_dtype} with y {y_dtype}; "
                        f"the (z, y) pairs are {pairs}")
    return suffix


def compute_dtype(z) -> torch.dtype:
    """The arithmetic's dtype for a storage (a tensor or a dtype): float64
    for float64 z, float32 for float32 and bf16 z.  Carries, eta, scale and
    threshold tables and outputs are in it."""
    dtype = z.dtype if isinstance(z, torch.Tensor) else z
    return torch.float64 if dtype == torch.float64 else torch.float32


def upcast(*tensors):
    """The tensors in the compute dtype of the first (no copy where they
    are in it already): the plain versions' inputs."""
    dtype = compute_dtype(tensors[0])
    return tuple(t.to(dtype) for t in tensors)


def check_batch(z: torch.Tensor, y: torch.Tensor):
    """Validate a ``(B, T, d)`` / ``(B, T)`` batch; return ``(B, T, d)``."""
    if z.ndim != 3 or y.shape != z.shape[:2]:
        raise ValueError(f"expected z (B, T, d) and y (B, T), got "
                         f"{tuple(z.shape)} and {tuple(y.shape)}")
    storage_suffix(z.dtype, y.dtype)
    if y.device != z.device:
        raise ValueError(f"z on {z.device} but y on {y.device}")
    B, T, d = z.shape
    if B < 1 or d < 1:
        raise ValueError(f"empty batch: z has shape {tuple(z.shape)}")
    return B, T, d


# Warps (settings) a K5 block serves: csrc/sweep_kernel.cu kSweepWarps.
# K5w sums w once a block and sequence, so its buffer holds a w for each
# group of SWEEP_WARPS settings.
SWEEP_WARPS = 16

# The hinge kernels (K1-K7), each with a wide instance past
# cuda_build.MAX_D: every one takes any d >= 1 on the card.
WIDE_KERNELS = ("K1", "K2", "K3", "K3e", "K4", "K5", "K6a", "K6b", "K7")


def wide_state_elems(kernel: str, B: int, d: int, plays: int = 1,
                     dtype=torch.float32) -> int:
    """Elements (of the compute type) of the state buffer that a launch of
    ``kernel`` at ``B`` sequences and feature dimension ``d`` with z in
    ``dtype`` (its storage or compute dtype) needs: none up to
    ``cuda_build.MAX_D``; past it, vectors of d elements laid out
    (d, slots), a slot per thread's play:

    - K2w: what its two launches' plans ask for (``plays_plan``): its
      FTL launch's ``state`` elements a sequence, laid out (B, state),
      then its tail launch's for each of ``plays`` (G) thresholds of a
      sequence, laid out (G B, state); none while both fit shared memory;
    - K5w: theta of each of ``plays`` (E) settings a sequence, and a w a
      sequence for each group of ``SWEEP_WARPS`` settings,
      ``(E + ceil(E / SWEEP_WARPS)) d B`` (no x: the final FTL action is
      written over theta);
    - K1w, K3w, K3ew, K4w, K6aw, K7w: what the library's plan asks for
      (``regret_plan`` with ``plays`` plays a sequence, ``packed_plan``
      for K3w and K3ew, ``stream_plan``, ``prefix_plan``,
      ``synthetic_plan``): none while a block's state fits its shared
      memory, past that the plan's ``state`` elements a sequence, laid out
      (B, state);
    - K6bw: ``tail_plan``'s: none while a block's state fits, past that
      its ``state`` elements for each of ``plays`` (G) thresholds of a
      sequence, laid out (G B, state).
    """
    if kernel not in WIDE_KERNELS:
        raise ValueError(f"unknown kernel {kernel}; the hinge kernels are "
                         f"{WIDE_KERNELS}")
    if d <= cuda_build.MAX_D:
        return 0
    plan = {"K3": packed_plan, "K3e": packed_plan, "K4": stream_plan,
            "K6a": prefix_plan}.get(kernel)
    if plan is not None:
        return plan(d, dtype)["state"] * B
    if kernel == "K1":
        return regret_plan(d, plays, dtype)["state"] * B
    if kernel == "K6b":
        return tail_plan(d, dtype)["state"] * plays * B
    if kernel == "K2":
        return (plays_plan(d, dtype, tails=False)["state"] * B
                + plays_plan(d, dtype, tails=True)["state"] * plays * B)
    if kernel == "K7":
        return synthetic_plan(d)["state"] * B
    return (plays + (plays + SWEEP_WARPS - 1) // SWEEP_WARPS) * d * B


def wide_state(kernel: str, B: int, d: int, plays: int, dtype, device):
    """The state buffer of a launch (``wide_state_elems``) with z in
    ``dtype`` on ``device``, in ``dtype``'s compute dtype, uninitialised
    (the kernel writes it before it reads it), or None where the launch
    needs none."""
    n = wide_state_elems(kernel, B, d, plays, dtype)
    return (torch.empty((n,), dtype=compute_dtype(dtype), device=device)
            if n else None)


def data_ptr(t) -> int:
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


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
    unit-ball action exactly.  Runs on the tensors' device; the norms are
    formed in the compute dtype (bf16's own rounding, 2^-8, would swamp
    ``CONTRACT_TOL``)."""
    T = z.shape[1]
    valid = torch.arange(T, device=z.device) < lengths[:, None]
    nsq = torch.linalg.vector_norm(z, dim=-1, dtype=compute_dtype(z)) ** 2
    row_ok = (nsq <= 1.0 + CONTRACT_TOL) & (torch.abs(y) == 1)
    return bool((row_ok | ~valid).all())


def hinge_round(theta, cum, x, z_t, y_t, v=None):
    """K1's hinge step once the action ``x`` is chosen: the loss of
    ``q = <z_t, x>`` added to ``cum`` and the tie-exact update of ``theta``.
    ``v`` (1 or 0 per sequence) masks the rounds past a sequence's length.
    Returns ``(theta, cum)``."""
    q = sum_last(z_t * x)
    loss, g = normalized_hinge(q, y_t), hinge_subgradient(q, y_t)
    if v is not None:
        loss, g = v * loss, v * g
    return theta + g[..., None] * z_t, cum + loss


def regret_plays_reference(z, y, flags, eta, lengths, *, replay=False):
    """Plain PyTorch version of kernel K1, the same arithmetic in the same
    order: a loop over T vectorized over the plays and the sequences, play
    p of sequence b being the game with ``flags[p, b]``.  z is never
    repeated over the plays.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; flags ``(P, B)`` int (0 = FTRL,
        1 = FTL); eta ``(B,)``; lengths ``(B,)`` int.
      replay: score the comparator by replaying the rows instead of by
        the hinge identity.

    Returns:
      ``(cum_loss (P, B), comp_loss (P, B), x_last (P, B, d))``.
    """
    B, T, d = z.shape
    P = flags.shape[0]
    dtype = z.dtype
    theta = z.new_zeros((P, B, d))
    w = z.new_zeros((B, d))
    x_last = z.new_zeros((P, B, d))
    cum = z.new_zeros((P, B))
    is_ftrl = (flags == ALG_FTRL)[..., None]
    eta = eta[None, :]
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        x = torch.where(is_ftrl, ftrl_action(theta, t + 1, eta),
                        ftl_action(theta))
        theta, cum = hinge_round(theta, cum, x, z_t, y_t, v)
        w = w + (v * y_t)[:, None] * z_t
        x_last = torch.where(valid[:, None], x, x_last)
    x_c = ftl_action(theta)
    if replay:
        comp = z.new_zeros((P, B))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v * normalized_hinge(sum_last(z[:, t] * x_c),
                                               y[:, t])
    else:
        comp = 0.5 * (lengths.to(dtype) - sum_last(x_c * w))
    return cum, comp, x_last


def regrets_fused_reference(z, y, alg_flag, eta, lengths, *, replay=False):
    """``regret_plays_reference`` with one play a sequence: alg_flag
    ``(B,)`` int (0 = FTRL, 1 = FTL).  Returns ``(cum_loss (B,),
    comp_loss (B,), x_last (B, d))``."""
    cum, comp, x_last = regret_plays_reference(z, y, alg_flag[None], eta,
                                               lengths, replay=replay)
    return cum[0], comp[0], x_last[0]


def eta_table(eta, B: int, T: int, dtype, device):
    """The ``(E, T)`` FTRL scale table of ``eta`` (a scalar or one value a
    sequence) and each sequence's row, ``(B,)`` int32: E is the number of
    distinct values (``torch.unique`` syncs with the host where eta is a
    vector; a scalar makes one row)."""
    eta = torch.as_tensor(eta, dtype=dtype, device=device)
    if eta.ndim == 0:
        return (sweep_scales(eta.reshape(1), T),
                torch.zeros((B,), dtype=torch.int32, device=device))
    values, index = torch.unique(per_sequence(eta, B, dtype, device),
                                 return_inverse=True)
    return sweep_scales(values, T), index.to(torch.int32)


def launch_regrets(z, y, flags, scales, eidx, lengths, replay: bool):
    """Launch kernel K1 on contiguous ``(B, T, d)`` / ``(B, T)`` CUDA inputs
    in a ``STORAGE`` pair with the plays' ``flags`` ``(P, B)`` (int32, P <= 8),
    the ``(E, T)`` scale table and each sequence's row ``eidx``
    (``eta_table``), and ``lengths`` (int32).  Returns ``(cum_loss (P, B),
    comp_loss (P, B), x_last (P, B, d))`` in the compute dtype."""
    global LAUNCHES
    B, T, d = z.shape
    P = flags.shape[0]
    fn = getattr(cuda_build.load(),
                 f"oco_regrets_fused_{storage_suffix(z.dtype, y.dtype)}")
    dtype = compute_dtype(z)
    with torch.cuda.device(z.device):
        cum = torch.empty((P, B), dtype=dtype, device=z.device)
        comp = torch.empty_like(cum)
        x_last = torch.empty((P, B, d), dtype=dtype, device=z.device)
        state = wide_state("K1", B, d, P, z.dtype, z.device)
        err = fn(z.data_ptr(), y.data_ptr(), flags.data_ptr(),
                 scales.data_ptr(), eidx.data_ptr(), lengths.data_ptr(), B, T,
                 P, d, int(replay), cum.data_ptr(), comp.data_ptr(),
                 x_last.data_ptr(), data_ptr(state),
                 torch.cuda.current_stream(z.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"regret kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return cum, comp, x_last


def regret_occupancy(plays: int, d: int, dtype) -> tuple:
    """Registers a thread, resident warps an SM and bytes of a thread's
    local frame of a K1 launch (K1w past ``cuda_build.MAX_D``) with
    ``plays`` plays a sequence at feature dimension ``d`` on the current
    card."""
    return occupancy("K1", cuda_build.load().oco_regrets_occupancy,
                     int(dtype == torch.float64), plays, d)


def stream_occupancy(d: int, dtype) -> tuple:
    """``regret_occupancy`` for K4 (K4w past ``cuda_build.MAX_D``)."""
    return occupancy("K4", cuda_build.load().oco_stream_occupancy,
                     int(dtype == torch.float64), d)


def sweep_occupancy(d: int, dtype) -> tuple:
    """``regret_occupancy`` for K5 (K5w past ``cuda_build.MAX_D``)."""
    return occupancy("K5", cuda_build.load().oco_sweep_occupancy,
                     int(dtype == torch.float64), d)


def storage_code(dtype) -> int:
    """The storage of an occupancy or plan query (``oco_packed_plan``):
    0 float32, 1 float64, 2 bf16 z."""
    return {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}[dtype]


def packed_occupancy(per_seq_eta: bool, d: int, dtype) -> tuple:
    """``regret_occupancy`` for K3 (K3e with ``per_seq_eta``; K3w, K3ew
    past ``cuda_build.MAX_D``) with z in ``dtype``."""
    return occupancy("K3e" if per_seq_eta else "K3",
                     cuda_build.load().oco_packed_occupancy,
                     storage_code(dtype), int(per_seq_eta), d)


def synthetic_occupancy(alg_flag: int, d: int) -> tuple:
    """``regret_occupancy`` for K7's FTRL (``alg_flag`` 0) or FTL (1)
    instance (K7w past ``cuda_build.MAX_D``, at its plan's block),
    float32."""
    return occupancy("K7", cuda_build.load().oco_synthetic_occupancy,
                     int(alg_flag), d)


def _plan(kernel: str, fn, *args) -> dict:
    """A wide instance's plan from its C entry ``fn(*args, out)``: warps a
    block (a sequence each), bytes of dynamic shared memory a block,
    whether the sequence's state lies in shared memory (``shared``),
    elements of the state buffer a sequence (``state``, 0 where shared)
    and ``max_shared_d``, the largest d whose state fits a block's shared
    memory."""
    keys = ("warps", "smem_bytes", "shared", "state", "max_shared_d")
    out = (ctypes.c_longlong * len(keys))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{kernel} plan failed at d={args[-1]}: CUDA "
                           f"error {err}")
    plan = dict(zip(keys, out))
    plan["shared"] = bool(plan["shared"])
    return plan


def synthetic_plan(d: int, alg_flag: int = 0) -> dict:
    """K7w's block at feature dimension ``d`` > ``cuda_build.MAX_D`` on the
    current card, as the library plans it (``oco_synthetic_plan``; see
    ``_plan``): theta and w in shared memory up to ``max_shared_d``,
    float32."""
    return _plan("K7w", cuda_build.load().oco_synthetic_plan, int(alg_flag),
                 d)


def packed_plan(d: int, dtype) -> dict:
    """K3w's (and K3ew's) block at feature dimension ``d`` >
    ``cuda_build.MAX_D`` with z in ``dtype`` (``oco_packed_plan``; see
    ``_plan``): a warp a sequence, 32 bytes of z a block at each (t, j),
    theta and the block's two row stages in shared memory up to
    ``max_shared_d``; past it theta in the state buffer, ``state``
    elements a sequence."""
    return _plan("K3w", cuda_build.load().oco_packed_plan,
                 storage_code(dtype), d)


def regret_plan(d: int, plays: int, dtype) -> dict:
    """K1w's block at feature dimension ``d`` > ``cuda_build.MAX_D`` with
    ``plays`` plays a sequence and z in ``dtype`` (``oco_regret_plan``; see
    ``_plan``): a sequence a block, a warp a play, the plays' thetas, the
    sequence's w and its two row stages in shared memory up to
    ``max_shared_d``; past it the thetas and w in the state buffer."""
    return _plan("K1w", cuda_build.load().oco_regret_plan,
                 storage_code(dtype), int(plays), d)


def stream_plan(d: int, dtype) -> dict:
    """K4w's block at feature dimension ``d`` > ``cuda_build.MAX_D`` with
    z in ``dtype`` (``oco_stream_plan``; see ``_plan``): a warp a sequence,
    32 bytes of z a block at each (t, j), theta, w and the block's row
    stage in shared memory up to ``max_shared_d``; past it theta and w in
    the state buffer, ``state`` elements a sequence."""
    return _plan("K4w", cuda_build.load().oco_stream_plan,
                 storage_code(dtype), d)


def prefix_plan(d: int, dtype) -> dict:
    """K6aw's block at feature dimension ``d`` > ``cuda_build.MAX_D`` with
    z in ``dtype`` (``oco_smart_prefix_plan``; see ``_plan``): a warp a
    sequence, theta, w and the warp's row stage in shared memory up to
    ``max_shared_d``; past it theta and w in the state buffer."""
    return _plan("K6aw", cuda_build.load().oco_smart_prefix_plan,
                 storage_code(dtype), d)


def tail_plan(d: int, dtype) -> dict:
    """K6bw's block at feature dimension ``d`` > ``cuda_build.MAX_D`` with
    z in ``dtype`` (``oco_smart_tail_plan``; see ``_plan``): a warp a tail,
    ``warps`` consecutive sorted thresholds of one sequence a block, their
    thetas and the block's two row stages in shared memory up to
    ``max_shared_d``; past it theta in the state buffer, ``state``
    elements a (threshold, sequence) pair."""
    return _plan("K6bw", cuda_build.load().oco_smart_tail_plan,
                 storage_code(dtype), d)


def plays_plan(d: int, dtype, tails: bool) -> dict:
    """K2w's FTL launch's block (K6aw's plan for K2w's kernel) or, with
    ``tails``, its tail launch's (one tail a block, K6bw's kernel) at
    feature dimension ``d`` > ``cuda_build.MAX_D`` with z in ``dtype``
    (``oco_smart_plays_plan``; see ``_plan``)."""
    return _plan("K2w", cuda_build.load().oco_smart_plays_plan,
                 storage_code(dtype), int(tails), d)


def occupancy(kernel: str, fn, *args, shared: bool = False) -> tuple:
    """``(registers, warps an SM, local frame bytes)`` from a C occupancy
    entry ``fn(*args, out)``, and with ``shared`` the bytes of a block's
    shared memory (static and dynamic) after them."""
    out = (ctypes.c_int * 4)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{kernel} occupancy query failed: CUDA error "
                           f"{err}")
    return tuple(out) if shared else tuple(out[:3])


def time_major(z: torch.Tensor, y: torch.Tensor):
    """``(B, T, d)`` / ``(B, T)`` -> contiguous ``(T, d, B)`` / ``(T, B)``:
    one thread per sequence then reads neighbouring addresses."""
    return z.permute(1, 2, 0).contiguous(), y.t().contiguous()


def regret_plays(z: torch.Tensor, y: torch.Tensor, alg_flags, eta: float,
                 lengths: torch.Tensor, replay: bool):
    """Every sequence played once per flag of ``alg_flags`` (P <= 8 flags,
    0 = FTRL, 1 = FTL) with the scalar ``eta``: one K1 launch on a CUDA
    tensor, reading one copy of z, or ``regret_plays_reference`` on a CPU
    tensor.  The evaluation's entry: ``lengths`` is a valid ``(B,)`` int32
    tensor on z's device and ``replay`` the caller's ``in_contract``
    verdict, so nothing here syncs with the host.

    Returns:
      ``(cum_loss (P, B), comp_loss (P, B), x_last (P, B, d))``.
    """
    B, T, d = check_batch(z, y)
    dtype = compute_dtype(z)
    flags = torch.tensor(alg_flags, dtype=torch.int32, device=z.device)
    flags = flags[:, None].expand(-1, B).contiguous()
    if z.device.type == "cuda":
        return launch_regrets(z.contiguous(), y.contiguous(), flags,
                              *eta_table(eta, B, T, dtype, z.device),
                              lengths, replay)
    if z.device.type == "cpu":
        return regret_plays_reference(
            *upcast(z, y), flags, per_sequence(eta, B, dtype, z.device),
            lengths, replay=replay)
    raise ValueError(f"unsupported device {z.device}")


def regrets_fused(z: torch.Tensor, y: torch.Tensor, alg_flag, eta,
                  lengths=None):
    """Regret game + final-FTL comparator for a batch of sequences.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; a ``STORAGE`` pair.
      alg_flag: 0 = FTRL, 1 = FTL; a scalar or ``(B,)``.
      eta: FTRL step scale, a scalar or ``(B,)`` (ignored for FTL).
      lengths: valid horizon per sequence, scalar or ``(B,)``; rows at and
        beyond it are ignored.  Defaults to ``T``.

    Returns:
      ``(cum_loss (B,), comp_loss (B,), x_last (B, d))`` on ``z``'s device,
      in the compute dtype.  On a CUDA tensor this launches kernel K1 (or
      raises); on a CPU tensor it runs ``regrets_fused_reference``.
    """
    B, T, d = check_batch(z, y)
    dtype = compute_dtype(z)
    flags = per_sequence(alg_flag, B, torch.int32, z.device)
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        cum, comp, x_last = launch_regrets(
            z.contiguous(), y.contiguous(), flags[None],
            *eta_table(eta, B, T, dtype, z.device), lengths, replay)
        return cum[0], comp[0], x_last[0]
    if z.device.type == "cpu":
        return regrets_fused_reference(
            *upcast(z, y), flags, per_sequence(eta, B, dtype, z.device),
            lengths, replay=replay)
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


def sweep_scales(eta: torch.Tensor, T: int) -> torch.Tensor:
    """``(E, T)`` per-setting FTRL scales ``-(eta_e / sqrt(max(1, t)))``,
    t = 1..T, in ``eta``'s dtype and on its device: ``ftrl_scales``'
    expression for each setting, the table kernels K5 and K6b read."""
    t = torch.arange(1, T + 1, dtype=eta.dtype, device=eta.device)
    return -torch.div(eta[:, None].expand(-1, T),
                      torch.sqrt(torch.clamp(t, min=1.0)))


def length_order(lengths: torch.Tensor) -> torch.Tensor:
    """The sequences by descending length (int32): the order in which the
    sweep kernels' blocks take them, so that a warp's lanes play about
    equally many rounds and the longest blocks start first."""
    return torch.argsort(lengths, descending=True, stable=True).to(
        torch.int32)


def launch_eta_sweep(z, y, scales, order, lengths, replay: bool):
    """Launch kernel K5 on contiguous ``(B, T, d)`` / ``(B, T)`` CUDA inputs
    in a ``STORAGE`` pair with the ``(E, T)`` scale table (``sweep_scales``),
    the blocks' sequence ``order`` (``length_order``) and ``lengths``
    (int32) as ``eta_sweep`` prepares them.  Returns ``(E, B)`` regrets."""
    global SWEEP_LAUNCHES
    B, T, d = z.shape
    E = scales.shape[0]
    fn = getattr(cuda_build.load(),
                 f"oco_eta_sweep_{storage_suffix(z.dtype, y.dtype)}")
    dtype = compute_dtype(z)
    with torch.cuda.device(z.device):
        regret = torch.empty((E, B), dtype=dtype, device=z.device)
        state = wide_state("K5", B, d, E, dtype, z.device)
        err = fn(z.data_ptr(), y.data_ptr(), scales.data_ptr(),
                 order.data_ptr(), lengths.data_ptr(), B, E, T, d,
                 int(replay), regret.data_ptr(), data_ptr(state),
                 torch.cuda.current_stream(z.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"eta sweep kernel launch failed: CUDA error "
                               f"{err}")
        SWEEP_LAUNCHES += 1
    return regret


def eta_sweep(z: torch.Tensor, y: torch.Tensor, eta_grid, lengths=None):
    """FTRL regret of every (sequence, eta) pair.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; a ``STORAGE`` pair.
      eta_grid: ``(E,)`` FTRL step scales.
      lengths: valid horizon per sequence, scalar or ``(B,)``; defaults
        to ``T``.

    Returns:
      ``(B, E)`` regrets on ``z``'s device.  On a CUDA tensor this launches
      kernel K5 (or raises); on a CPU tensor it runs ``eta_sweep_reference``.
    """
    B, T, d = check_batch(z, y)
    eta_grid = settings_grid(eta_grid, compute_dtype(z), z.device, "eta_grid")
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        return launch_eta_sweep(z.contiguous(), y.contiguous(),
                                sweep_scales(eta_grid, T),
                                length_order(lengths), lengths, replay).t()
    if z.device.type == "cpu":
        return eta_sweep_reference(*upcast(z, y), eta_grid, lengths,
                                   replay=replay)
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
                      device="cuda") -> StreamCarry:
    """Fresh carry for ``B`` sequences of dimension ``d`` (B is the number
    of sequences: the port's layout needs no lane padding), on the card
    unless ``device`` says otherwise."""
    if dtype not in _FLOATS:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    device = resolve_device(device)
    return StreamCarry(torch.zeros((d, B), dtype=dtype, device=device),
                       torch.zeros((d, B), dtype=dtype, device=device),
                       torch.zeros((B,), dtype=dtype, device=device),
                       torch.zeros((B,), dtype=dtype, device=device))


def check_time_major(z_tm: torch.Tensor, y_tm: torch.Tensor):
    """Validate a time-major ``(T, d, B)`` / ``(T, B)`` batch (shapes, dtype,
    device; no device sync); return ``(T, d, B)``."""
    if z_tm.ndim != 3 or y_tm.shape != (z_tm.shape[0], z_tm.shape[2]):
        raise ValueError(f"expected z (T, d, B) and y (T, B), got "
                         f"{tuple(z_tm.shape)} and {tuple(y_tm.shape)}")
    T, d, B = z_tm.shape
    storage_suffix(z_tm.dtype, y_tm.dtype)
    if y_tm.device != z_tm.device:
        raise ValueError(f"z on {z_tm.device} but y on {y_tm.device}")
    if B < 1 or d < 1:
        raise ValueError(f"empty batch: z has shape {tuple(z_tm.shape)}")
    return T, d, B


def check_stream_chunk(z_chunk: torch.Tensor, y_chunk: torch.Tensor,
                       carry: StreamCarry):
    """Validate a time-major ``(CT, d, B)`` / ``(CT, B)`` chunk against its
    carry (shapes, dtype, device; no device sync); return ``(CT, d, B)``.
    The carry is in the chunk's compute dtype."""
    CT, d, B = check_time_major(z_chunk, y_chunk)
    dtype = compute_dtype(z_chunk)
    want = {"theta": (d, B), "w": (d, B), "cum": (B,), "cnt": (B,)}
    for name, shape in want.items():
        t = getattr(carry, name)
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != z_chunk.device):
            raise ValueError(f"carry {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; the chunk needs "
                             f"{shape} {dtype} on {z_chunk.device}")
    return CT, d, B


def validate_stream_chunk(z_chunk: torch.Tensor,
                          y_chunk: torch.Tensor) -> None:
    """Raise ``ValueError`` unless a time-major chunk meets the identity
    contract: every row has ``||z_t||^2 <= 1 + CONTRACT_TOL`` and a label of
    +-1, or is an all-zero padding row (``y_t = 0``, ``z_t = 0``).  A row
    with ``y_t = 0`` and ``z_t != 0`` would be scored wrongly by the carried
    identity, so it is refused.  Runs on the chunk's device, in the compute
    dtype, and syncs."""
    z_chunk = z_chunk.to(compute_dtype(z_chunk))
    nsq = sum_last(z_chunk.transpose(1, 2) * z_chunk.transpose(1, 2))
    max_nsq = float(nsq.max()) if nsq.numel() else 0.0
    if max_nsq > 1.0 + CONTRACT_TOL:
        raise ValueError(f"rows must lie in the unit L2 ball (max ||z||^2 = "
                         f"{max_nsq:.6f}); clip rows like the data builders "
                         f"do")
    ok = (torch.abs(y_chunk) == 1) | ((y_chunk == 0) & (nsq == 0.0))
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
        theta, cum = hinge_round(theta, cum, x, z_t, y_t)
        w = w + y_t[:, None] * z_t
        cnt = cnt + y_t * y_t
    return StreamCarry(theta.t().contiguous(), w.t().contiguous(), cum, cnt)


def launch_stream_time_major(z_tm, y_tm, flags, eta, t0: int,
                             carry: StreamCarry) -> StreamCarry:
    """Launch kernel K4 on a contiguous time-major CUDA chunk in a
    ``STORAGE`` pair with per-sequence ``flags`` (int32) and ``eta``; returns the advanced
    carry in new tensors."""
    global STREAM_LAUNCHES
    CT, d, B = z_tm.shape
    fn = getattr(cuda_build.load(),
                 f"oco_play_stream_{storage_suffix(z_tm.dtype, y_tm.dtype)}")
    with torch.cuda.device(z_tm.device):
        out = StreamCarry(*(torch.empty_like(t) for t in carry))
        state = wide_state("K4", B, d, 1, z_tm.dtype, z_tm.device)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), flags.data_ptr(),
                 eta.data_ptr(), int(t0), CT, B, d,
                 *(t.data_ptr() for t in carry),
                 *(t.data_ptr() for t in out), data_ptr(state),
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
        return play_stream_reference(*upcast(z_chunk, y_chunk), flags, eta,
                                     t0, carry)
    raise ValueError(f"unsupported device {z_chunk.device}")


def play_stream(z_chunk: torch.Tensor, y_chunk: torch.Tensor, eta, t0: int,
                carry: StreamCarry, *, alg_flag=ALG_FTRL) -> StreamCarry:
    """Advance the streamed game over one time-major chunk.

    Args:
      z_chunk: ``(CT, d, B)``; y_chunk: ``(CT, B)``; a ``STORAGE`` pair.
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
    eta = per_sequence(eta, B, compute_dtype(z_chunk), z_chunk.device)
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
    eta = per_sequence(eta, B, compute_dtype(z_stack), z_stack.device)
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


# ------------------------------------------------ K3, K3e: the packed game

def ftrl_scales(T: int, eta0, *, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Per-round FTRL scales ``-(eta0 / sqrt(max(1, t)))``, t = 1..T, in the
    working dtype: the ``(T,)`` table kernel K3 reads.

    The table is a tensor/tensor division of correctly rounded values, the
    expression K1 evaluates each round (``number / tensor`` would multiply
    by a reciprocal), so K3 with it plays K1's FTRL game bit for bit.  The
    JAX ``ftrl_scales`` builds it in float32 NumPy.
    """
    eta = torch.full((1,), float(eta0), dtype=dtype,
                     device=resolve_device(device))
    return sweep_scales(eta, T)[0]


def _packed_reference(z_tm, y_tm, action):
    """K1's rounds over all T rows of a time-major batch, with the action
    ``action(theta, t)`` (0-based t); no comparator.  Zero rows are inert.
    Returns ``(cum (B,), theta (d, B))``."""
    T, d, B = z_tm.shape
    theta = z_tm.new_zeros((B, d))
    cum = z_tm.new_zeros((B,))
    for t in range(T):
        theta, cum = hinge_round(theta, cum, action(theta, t), z_tm[t].t(),
                                 y_tm[t])
    return cum, theta.t().contiguous()


def play_packed_reference(z_tm, y_tm, scales, alg_flag: int):
    """Plain PyTorch version of kernel K3: ``(cum (B,), theta (d, B))`` of
    the game on ``(T, d, B)`` / ``(T, B)`` with FTRL scales ``scales``
    ``(T,)`` (alg_flag 0) or FTL (alg_flag 1)."""
    if alg_flag == ALG_FTRL:
        return _packed_reference(
            z_tm, y_tm, lambda theta, t: ftrl_action_scaled(theta, scales[t]))
    return _packed_reference(z_tm, y_tm, lambda theta, t: ftl_action(theta))


def play_packed_eta_reference(z_tm, y_tm, eta):
    """Plain PyTorch version of kernel K3e: the FTRL game with a
    per-sequence ``eta`` ``(B,)``, K1's FTRL round."""
    return _packed_reference(
        z_tm, y_tm, lambda theta, t: ftrl_action(theta, t + 1, eta))


def _launch_packed(fn_name: str, z_tm, y_tm, extra, alg_flag):
    """Launch K3 (``alg_flag`` an int, ``extra`` the scale table) or K3e
    (``alg_flag`` None, ``extra`` the per-sequence eta) on contiguous CUDA
    inputs; returns ``(cum (B,), theta (d, B))``."""
    global PACKED_LAUNCHES, PACKED_ETA_LAUNCHES
    T, d, B = z_tm.shape
    fn = getattr(cuda_build.load(),
                 f"{fn_name}_{storage_suffix(z_tm.dtype, y_tm.dtype)}")
    dtype = compute_dtype(z_tm)
    flag = () if alg_flag is None else (int(alg_flag),)
    with torch.cuda.device(z_tm.device):
        cum = torch.empty((B,), dtype=dtype, device=z_tm.device)
        theta = torch.empty((d, B), dtype=dtype, device=z_tm.device)
        state = wide_state("K3e" if alg_flag is None else "K3", B, d, 1,
                           z_tm.dtype, z_tm.device)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), extra.data_ptr(), T, B, d,
                 *flag, cum.data_ptr(), theta.data_ptr(), data_ptr(state),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"packed game kernel launch failed: CUDA "
                               f"error {err}")
        if alg_flag is None:
            PACKED_ETA_LAUNCHES += 1
        else:
            PACKED_LAUNCHES += 1
    return cum, theta


def launch_play_packed(z_tm, y_tm, scales, alg_flag: int):
    """Launch kernel K3 on contiguous time-major CUDA inputs with a
    ``(T,)`` scale table; returns ``(cum (B,), theta (d, B))``."""
    return _launch_packed("oco_play_packed", z_tm, y_tm, scales, alg_flag)


def launch_play_packed_eta(z_tm, y_tm, eta):
    """Launch kernel K3e on contiguous time-major CUDA inputs with a
    per-sequence ``eta`` ``(B,)``; returns ``(cum (B,), theta (d, B))``."""
    return _launch_packed("oco_play_packed_eta", z_tm, y_tm, eta, None)


def play_packed(z_tm: torch.Tensor, y_tm: torch.Tensor, scales, *,
                alg_flag: int = ALG_FTRL):
    """The game on time-major inputs from a table of FTRL scales.

    Args:
      z_tm: ``(T, d, B)``; y_tm: ``(T, B)``; a ``STORAGE`` pair.  Zero rows
        are inert padding.
      scales: ``(T,)`` per-round FTRL scales (``ftrl_scales``).
      alg_flag: 0 = FTRL, 1 = FTL, for the whole batch.

    Returns:
      ``(cum_loss (B,), theta (d, B))`` on ``z_tm``'s device, no
      comparator.  On a CUDA tensor this launches kernel K3 (or raises); on
      a CPU tensor it runs ``play_packed_reference``.
    """
    T, d, B = check_time_major(z_tm, y_tm)
    if alg_flag not in (ALG_FTRL, ALG_FTL):
        raise ValueError(f"alg_flag must be 0 (FTRL) or 1 (FTL), got "
                         f"{alg_flag}")
    scales = torch.as_tensor(scales, dtype=compute_dtype(z_tm),
                             device=z_tm.device).contiguous()
    if scales.shape != (T,):
        raise ValueError(f"scales must have shape ({T},), got "
                         f"{tuple(scales.shape)}")
    if z_tm.device.type == "cuda":
        return launch_play_packed(z_tm.contiguous(), y_tm.contiguous(),
                                  scales, alg_flag)
    if z_tm.device.type == "cpu":
        return play_packed_reference(*upcast(z_tm, y_tm), scales, alg_flag)
    raise ValueError(f"unsupported device {z_tm.device}")


def play_packed_eta(z_tm: torch.Tensor, y_tm: torch.Tensor, eta):
    """FTRL on time-major inputs with a per-sequence step scale.

    Args:
      z_tm: ``(T, d, B)``; y_tm: ``(T, B)``; a ``STORAGE`` pair.
      eta: a scalar or ``(B,)``.

    Returns:
      ``(cum_loss (B,), theta (d, B))``.  On a CUDA tensor this launches
      kernel K3e (or raises); on a CPU tensor it runs
      ``play_packed_eta_reference``.
    """
    T, d, B = check_time_major(z_tm, y_tm)
    eta = per_sequence(eta, B, compute_dtype(z_tm), z_tm.device)
    if z_tm.device.type == "cuda":
        return launch_play_packed_eta(z_tm.contiguous(), y_tm.contiguous(),
                                      eta)
    if z_tm.device.type == "cpu":
        return play_packed_eta_reference(*upcast(z_tm, y_tm), eta)
    raise ValueError(f"unsupported device {z_tm.device}")


def comparator_epilogue(z_tm, y_tm, cum, theta):
    """``cum - comp``: the final FTL action ``x_c = ftl_action(theta)``
    replayed over every row, ``comp = 0.5 * sum_t |<z_t, x_c> - y_t|``.
    Plain PyTorch, as the JAX ``_comparator_epilogue`` is XLA; zero padding
    rows add nothing.  Narrow rows and labels are widened element by
    element (type promotion), never copied whole.  Returns ``(B,)``
    regrets."""
    x_c = ftl_action(theta.t()).t()                            # (d, B)
    q = z_tm[:, 0] * x_c[0]
    for j in range(1, z_tm.shape[1]):
        q = q + z_tm[:, j] * x_c[j]
    return cum - 0.5 * torch.sum(torch.abs(q - y_tm), dim=0)


def regrets_packed(z_tm, y_tm, scales, *, alg_flag: int = ALG_FTRL):
    """K3's cum and theta plus the comparator epilogue: ``(B,)`` regrets."""
    cum, theta = play_packed(z_tm, y_tm, scales, alg_flag=alg_flag)
    return comparator_epilogue(z_tm, y_tm, cum, theta)


def regrets_packed_eta(z_tm, y_tm, eta):
    """K3e's per-sequence-eta FTRL regrets, ``(B,)``."""
    cum, theta = play_packed_eta(z_tm, y_tm, eta)
    return comparator_epilogue(z_tm, y_tm, cum, theta)


def kernel_envelope(B: int, T: int, d: int, dtype=torch.float32,
                    per_lane_eta: bool = False):
    """None where ``simulate_linear_auto`` routes to the packed kernels,
    else the reason it routes to the simulator.

    This mirrors the JAX ``kernel_envelope``'s routing decision, not a
    limit of the port's kernels: K3 and K3e take any d on the card (K3w,
    K3ew past ``cuda_build.MAX_D``), but the JAX function sends d past its
    ``_D_KERNEL_MAX`` (512) to its linear scan, so the port sends it to the
    simulator's kernel (K1, K1w), and the two packages take the same route.
    z must be stored in float32, float64 or bf16 (``STORAGE``).  ``T`` and
    ``per_lane_eta`` (the JAX signature's) set no limit here.
    """
    del per_lane_eta, T
    if dtype not in {z for z, _ in STORAGE}:
        return (f"dtype {dtype}: the kernels store z as float32, float64 or "
                f"bfloat16")
    if B < 1 or d < 1:
        return f"empty batch (B={B}, d={d})"
    if d > cuda_build.MAX_D:
        return (f"d={d} past the JAX package's kernel envelope d <= "
                f"{cuda_build.MAX_D}, which routes to the linear scan")
    return None


def simulate_linear_packed(z: torch.Tensor, y: torch.Tensor, alg_flag: int,
                           eta0):
    """Batched regret through the packed kernels, the ``(B, T, d)`` API
    (counterpart of the JAX ``simulate_linear_pallas_v2``).

    ``eta0`` is a scalar (a shared step size: K3 with ``ftrl_scales``) or a
    ``(B,)`` tensor (per-sequence step sizes: K3e, FTRL only).  Computes in
    ``z``'s compute dtype on ``z``'s device; returns ``(B,)`` regrets.
    """
    B, T, d = check_batch(z, y)
    z_tm, y_tm = time_major(z, y)
    if torch.as_tensor(eta0).ndim == 1:
        if alg_flag != ALG_FTRL:
            raise ValueError("per-sequence eta is FTRL-only")
        return regrets_packed_eta(z_tm, y_tm, eta0)
    scales = ftrl_scales(T, float(eta0), dtype=compute_dtype(z),
                         device=z.device)
    return regrets_packed(z_tm, y_tm, scales, alg_flag=alg_flag)


def simulate_linear_auto(z: torch.Tensor, y: torch.Tensor, alg_flag: int,
                         eta0):
    """``simulate_linear_packed`` (K3, K3e) inside ``kernel_envelope``, the
    simulator past it: ``regrets_fused``, the kernel of
    ``models/linear.py::simulate_linear_batch`` (K1, K1w past d = 512).
    The route mirrors the JAX function's decision (it sends d past 512 to
    its scan), not a limit of K3/K3e, which take any d when called
    directly.  On a CPU tensor both run their plain versions.  Returns
    ``(B,)`` regrets."""
    B, T, d = check_batch(z, y)
    if kernel_envelope(B, T, d, z.dtype) is None:
        return simulate_linear_packed(z, y, alg_flag, eta0)
    cum, comp, _ = regrets_fused(z, y, alg_flag, eta0)
    return cum - comp


# --------------------------------------------- K7: the generation-fused game

# The TPU kernel serves 8 sublanes of ``lane_batch`` lanes: sequence b of a
# call is entry b of its (SYNTHETIC_ROWS, lane_batch) result, row-major.
SYNTHETIC_ROWS = 8


def synthetic_row_scale(d: int) -> float:
    """The rows' entry magnitude: ``1 / sqrt(d)`` as a double, rounded to
    float32, as the TPU kernel computes ``1.0 / float(np.sqrt(d))``."""
    return torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32).item()


def check_synthetic(T: int, lane_batch: int, d: int, alg_flag) -> int:
    """Validate a synthetic game's shape; return its number of sequences."""
    if not 1 <= T < 2 ** 32:
        raise ValueError(f"T must lie in [1, 2^32), got {T}")
    if lane_batch < 1 or d < 1:
        raise ValueError(f"lane_batch and d must be >= 1, got {lane_batch} "
                         f"and {d}")
    if alg_flag not in (ALG_FTRL, ALG_FTL):
        raise ValueError(f"alg_flag must be 0 (FTRL) or 1 (FTL), got "
                         f"{alg_flag}")
    return SYNTHETIC_ROWS * lane_batch


def synthetic_stream(seed: int, *, T: int, lane_batch: int, d: int = 5,
                     device="cuda"):
    """The sequences kernel K7 plays for ``seed``, materialized: ``(B, T, d)``
    float32 z with entries ``+-synthetic_row_scale(d)`` and ``(B, T)``
    labels ``+-1``, ``B = 8 * lane_batch``.  Sequence b's rows depend on
    (seed, b, t) only (``ops/philox.py``), so a call with a larger
    ``lane_batch`` extends the same population."""
    B = check_synthetic(T, lane_batch, d, ALG_FTRL)
    bits = round_bits(seed, T, B, d + 1, resolve_device(device))
    sign = (2 * bits - 1).to(torch.float32)              # (T, B, d + 1)
    z = sign[..., :d] * synthetic_row_scale(d)
    return z.permute(1, 0, 2).contiguous(), sign[..., d].t().contiguous()


def synthetic_regrets_reference(seed: int, eta0, *, T: int, lane_batch: int,
                                d: int = 5, alg_flag: int = ALG_FTRL,
                                device="cuda"):
    """Plain PyTorch version of kernel K7: ``synthetic_stream`` played by
    K1's plain version with the identity comparator (cnt = T).  Returns
    ``(8, lane_batch)`` float32 regrets."""
    z, y = synthetic_stream(seed, T=T, lane_batch=lane_batch, d=d,
                            device=device)
    B = z.shape[0]
    cum, comp, _ = regrets_fused_reference(
        z, y, per_sequence(alg_flag, B, torch.int32, z.device),
        per_sequence(float(eta0), B, torch.float32, z.device),
        per_sequence_lengths(None, B, T, z.device))
    return (cum - comp).reshape(SYNTHETIC_ROWS, lane_batch)


def launch_synthetic(seed: int, eta0, T: int, lane_batch: int, d: int,
                     alg_flag: int, device: torch.device) -> torch.Tensor:
    """Launch kernel K7 on ``device``; returns ``(8, lane_batch)`` float32
    regrets."""
    global SYNTHETIC_LAUNCHES
    lib = cuda_build.load()
    with torch.cuda.device(device):
        out = torch.empty((SYNTHETIC_ROWS, lane_batch), dtype=torch.float32,
                          device=device)
        state = wide_state("K7", out.numel(), d, 1, torch.float32, device)
        keys = (ctypes.c_uint32 * 20)(*round_keys(int(seed)))
        err = lib.oco_synthetic_regrets_f32(
            keys, float(eta0), T, out.numel(), d, alg_flag,
            synthetic_row_scale(d), out.data_ptr(), data_ptr(state),
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"synthetic kernel launch failed: CUDA error "
                               f"{err}")
        SYNTHETIC_LAUNCHES += 1
    return out


def synthetic_regrets(seed: int, eta0, *, T: int, lane_batch: int,
                      d: int = 5, alg_flag: int = ALG_FTRL, device="cuda"):
    """Regrets of the FTRL (``alg_flag`` 0) or FTL (1) game on
    ``8 * lane_batch`` Rademacher sequences generated from ``seed``, with
    nothing read from memory.

    Args:
      seed: the generator's key (an integer, taken modulo 2^64).
      eta0: the FTRL step scale (rounded to float32; ignored for FTL).
      T: rounds, 1 <= T < 2^32: nothing in a launch scales with T.
      lane_batch, d: ``8 * lane_batch`` sequences of dimension ``d``.
      device: ``cuda`` (the default) launches kernel K7 (K7w past d =
        512); ``cpu`` runs ``synthetic_regrets_reference``.

    Returns:
      ``(8, lane_batch)`` float32 regrets (the JAX function's shape).
    """
    check_synthetic(T, lane_batch, d, alg_flag)
    device = resolve_device(device)
    if device.type == "cuda":
        return launch_synthetic(seed, eta0, T, lane_batch, d, alg_flag,
                                device)
    if device.type == "cpu":
        return synthetic_regrets_reference(seed, eta0, T=T,
                                           lane_batch=lane_batch, d=d,
                                           alg_flag=alg_flag, device=device)
    raise ValueError(f"unsupported device {device}")
