"""Kernels K2 (single-switch SMART) and K6 (SMART threshold sweep).

Counterpart of ``online_convex_optimization_tpu/ops/pallas_smart.py``:

- ``smart_regrets`` (TPU ``smart_regrets_packed``, kernel ``_smart_kernel``,
  round step ``_smart_round``): the whole algorithm in one pass, CUDA kernel
  ``csrc/smart_kernel.cu``, plain version ``smart_regrets_reference``;
- ``smart_sweep`` (TPU ``smart_sweep_packed``, kernel
  ``_smart_sweep_kernel``): the regret and switch round of every (sequence,
  threshold) pair with a scalar eta, CUDA kernel
  ``csrc/smart_sweep_kernel.cu``, plain version ``smart_sweep_reference``.

Each plain version is a loop over T vectorized over the batch, in its
kernel's order of operations.  A wrapper runs the plain version on a CPU
tensor, at any d, and launches the kernel on a CUDA tensor, for d up to
512 (raising above it); there is no fallback between them.  K2 and K6
share one round step (``oco::smart_round`` in ``csrc/oco_common.cuh``), so
a sweep column equals K2 bit for bit.

Semantics are those of ``models/smart.py`` (the scan the JAX package holds
against the golden oracle): an always-on FTL track; before the switch, the
FTL lead ``F - L_t`` over the prefix comparator loss ``L_t`` of the
post-update FTL action, with ``L_t`` from the hinge identity
``0.5 * (cnt - <s_t, w_t>)``; the switch at the first round where the lead
reaches the threshold, taking effect the round AFTER; then a fresh FTRL
track with the global round index.  ``switch_t`` is that round, ``T`` when
it never fires.  The final comparator is scored by the identity on contract
data and by replaying the rows otherwise (``game.in_contract``).

What bounds the kernel on an H100: about 8*(d+1) bytes of f64 input per
round, read once, against a serial chain of about 3d+10 flops per track per
round; the first design keeps the reference's rounding order, one thread
per sequence with state in registers, and coalesced time-major
``(T, d, B)`` loads.
"""

from __future__ import annotations

import torch

from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    sum_last,
)
from online_convex_optimization_tpu_torch.ops.game import (
    check_batch,
    check_kernel_d,
    in_contract,
    per_sequence,
    per_sequence_lengths,
    settings_grid,
    time_major,
)
from online_convex_optimization_tpu_torch.ops.hinge import (
    hinge_subgradient,
    normalized_hinge,
)
from online_convex_optimization_tpu_torch.utils import cuda_build

# Launches of each CUDA kernel in this process (counted where it launches):
# K2 and K6.
LAUNCHES = 0
SWEEP_LAUNCHES = 0


def smart_regrets_reference(z, y, threshold, eta, lengths, *, replay=False):
    """Plain PyTorch version of kernel K2, the same arithmetic in the same
    order: a loop over T vectorized over B.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; threshold, eta ``(B,)``; lengths
        ``(B,)`` int.
      replay: score the final comparator by replaying the rows instead of
        by the hinge identity.

    Returns:
      ``(cum_loss (B,), comp_loss (B,), x_last (B, d), switch_t (B,) int64)``.
    """
    B, T, d = z.shape
    dtype = z.dtype
    theta = z.new_zeros((B, d))        # FTL track
    theta_r = z.new_zeros((B, d))      # FTRL track, fresh at the switch
    w = z.new_zeros((B, d))
    x_r = z.new_zeros((B, d))
    F = z.new_zeros((B,))
    total = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    switched = torch.zeros((B,), dtype=torch.bool, device=z.device)
    tau = torch.full((B,), T, dtype=torch.int64, device=z.device)
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        # FTL track: pre-update action, then the update.
        q = sum_last(z_t * ftl_action(theta))
        loss_f = normalized_hinge(q, y_t)
        theta = theta + (v * hinge_subgradient(q, y_t))[:, None] * z_t
        F = F + v * loss_f
        w = w + (v * y_t)[:, None] * z_t
        cnt = cnt + v
        # FTRL track, on once switched in an earlier round.
        active = switched & valid
        x = ftrl_action(theta_r, t + 1, eta)
        q_r = sum_last(z_t * x)
        total = total + torch.where(active, normalized_hinge(q_r, y_t),
                                    v * loss_f)
        theta_r = theta_r + (active.to(dtype) *
                             hinge_subgradient(q_r, y_t))[:, None] * z_t
        x_r = torch.where(active[:, None], x, x_r)
        # Switch test on the post-update FTL action (applies next round).
        lead = F - 0.5 * (cnt - sum_last(ftl_action(theta) * w))
        hit = valid & ~switched & (lead >= threshold)
        tau = torch.where(hit, t, tau)
        switched = switched | hit
    s_final = ftl_action(theta)
    if replay:
        comp = z.new_zeros((B,))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v * normalized_hinge(sum_last(z[:, t] * s_final),
                                               y[:, t])
    else:
        comp = 0.5 * (cnt - sum_last(s_final * w))
    x_last = torch.where(switched[:, None], x_r, s_final)
    return total, comp, x_last, tau


def launch_time_major(z_tm, y_tm, threshold, eta, lengths, replay: bool):
    """Launch kernel K2 on time-major CUDA inputs (``game.time_major``) with
    per-sequence ``threshold``, ``eta`` and ``lengths`` (int32) as
    ``smart_regrets`` prepares them.  Returns ``(cum_loss (B,),
    comp_loss (B,), x_last (d, B), switch_t (B,))``."""
    global LAUNCHES
    T, d, B = z_tm.shape
    check_kernel_d(d)
    lib = cuda_build.load()
    fn = (lib.oco_smart_regrets_f64 if z_tm.dtype == torch.float64
          else lib.oco_smart_regrets_f32)
    with torch.cuda.device(z_tm.device):
        cum = torch.empty((B,), dtype=z_tm.dtype, device=z_tm.device)
        comp = torch.empty_like(cum)
        x_last = torch.empty((d, B), dtype=z_tm.dtype, device=z_tm.device)
        tau = torch.empty((B,), dtype=torch.int64, device=z_tm.device)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), threshold.data_ptr(),
                 eta.data_ptr(), lengths.data_ptr(), B, T, d, int(replay),
                 cum.data_ptr(), comp.data_ptr(), x_last.data_ptr(),
                 tau.data_ptr(),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SMART kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return cum, comp, x_last, tau


def smart_regrets(z: torch.Tensor, y: torch.Tensor, threshold, eta,
                  lengths=None):
    """Single-switch SMART losses for a batch of sequences.

    Args:
      z: ``(B, T, d)`` float32/float64; y: ``(B, T)`` of the same dtype.
      threshold: switch threshold, a scalar or ``(B,)``.
      eta: FTRL step scale, a scalar or ``(B,)``.
      lengths: valid horizon per sequence, scalar or ``(B,)``; defaults
        to ``T``.

    Returns:
      ``(cum_loss (B,), comp_loss (B,), x_last (B, d), switch_t (B,))`` on
      ``z``'s device.  On a CUDA tensor this launches kernel K2 (or
      raises); on a CPU tensor it runs ``smart_regrets_reference``.
    """
    B, T, d = check_batch(z, y)
    threshold = per_sequence(threshold, B, z.dtype, z.device)
    eta = per_sequence(eta, B, z.dtype, z.device)
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        cum, comp, x_last, tau = launch_time_major(
            *time_major(z, y), threshold, eta, lengths, replay)
        return cum, comp, x_last.t(), tau
    if z.device.type == "cpu":
        return smart_regrets_reference(z, y, threshold, eta, lengths,
                                       replay=replay)
    raise ValueError(f"unsupported device {z.device}")


# ----------------------------------------------------- K6: threshold sweep

def smart_sweep_reference(z, y, thresholds, eta, lengths, *, replay=False):
    """Plain PyTorch version of kernel K6: ``smart_regrets_reference``'s
    arithmetic in the same order, with the thresholds as a second batch
    axis.

    The FTL track, the identity statistics and the switch test's lead do
    not depend on the threshold, so they are kept once per sequence; the
    switch state and the FTRL track are ``(B, G)`` and ``(B, G, d)``.  z is
    never repeated G times.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; thresholds ``(G,)``; eta a scalar
        tensor; lengths ``(B,)`` int.
      replay: score the final comparator by replaying the rows instead of
        by the hinge identity.

    Returns:
      ``(regret (B, G), switch_t (B, G) int64)``.
    """
    B, T, d = z.shape
    G = thresholds.shape[0]
    dtype = z.dtype
    theta = z.new_zeros((B, d))        # FTL track
    w = z.new_zeros((B, d))
    F = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    theta_r = z.new_zeros((B, G, d))   # FTRL tracks, fresh at the switch
    total = z.new_zeros((B, G))
    switched = torch.zeros((B, G), dtype=torch.bool, device=z.device)
    tau = torch.full((B, G), T, dtype=torch.int64, device=z.device)
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        # FTL track: pre-update action, then the update.
        q = sum_last(z_t * ftl_action(theta))
        loss_f = normalized_hinge(q, y_t)
        theta = theta + (v * hinge_subgradient(q, y_t))[:, None] * z_t
        F = F + v * loss_f
        w = w + (v * y_t)[:, None] * z_t
        cnt = cnt + v
        # FTRL tracks, on once switched in an earlier round.
        active = switched & valid[:, None]
        x = ftrl_action(theta_r, t + 1, eta)
        q_r = sum_last(z_t[:, None, :] * x)
        total = total + torch.where(active,
                                    normalized_hinge(q_r, y_t[:, None]),
                                    (v * loss_f)[:, None])
        theta_r = theta_r + (active.to(dtype) *
                             hinge_subgradient(q_r, y_t[:, None])
                             )[..., None] * z_t[:, None, :]
        # Switch test on the post-update FTL action (applies next round).
        lead = F - 0.5 * (cnt - sum_last(ftl_action(theta) * w))
        hit = valid[:, None] & ~switched & (lead[:, None] >= thresholds)
        tau = torch.where(hit, t, tau)
        switched = switched | hit
    s_final = ftl_action(theta)
    if replay:
        comp = z.new_zeros((B,))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v * normalized_hinge(sum_last(z[:, t] * s_final),
                                               y[:, t])
    else:
        comp = 0.5 * (cnt - sum_last(s_final * w))
    return total - comp[:, None], tau


def launch_smart_sweep_time_major(z_tm, y_tm, thresholds, eta: float,
                                  lengths, replay: bool):
    """Launch kernel K6 on time-major CUDA inputs (``game.time_major``) with
    a ``(G,)`` threshold grid, a scalar ``eta`` and ``lengths`` (int32) as
    ``smart_sweep`` prepares them.  Returns ``(regret (G, B),
    switch_t (G, B))``."""
    global SWEEP_LAUNCHES
    T, d, B = z_tm.shape
    G = thresholds.shape[0]
    check_kernel_d(d)
    lib = cuda_build.load()
    fn = (lib.oco_smart_sweep_f64 if z_tm.dtype == torch.float64
          else lib.oco_smart_sweep_f32)
    with torch.cuda.device(z_tm.device):
        regret = torch.empty((G, B), dtype=z_tm.dtype, device=z_tm.device)
        tau = torch.empty((G, B), dtype=torch.int64, device=z_tm.device)
        err = fn(z_tm.data_ptr(), y_tm.data_ptr(), thresholds.data_ptr(),
                 lengths.data_ptr(), B, G, T, d, float(eta), int(replay),
                 regret.data_ptr(), tau.data_ptr(),
                 torch.cuda.current_stream(z_tm.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SMART sweep kernel launch failed: CUDA "
                               f"error {err}")
        SWEEP_LAUNCHES += 1
    return regret, tau


def smart_sweep(z: torch.Tensor, y: torch.Tensor, thresholds, eta: float,
                lengths=None):
    """SMART regret and switch round of every (sequence, threshold) pair.

    Args:
      z: ``(B, T, d)`` float32/float64; y: ``(B, T)`` of the same dtype.
      thresholds: ``(G,)`` switch thresholds.
      eta: FTRL step scale (a number, rounded to z's dtype).
      lengths: valid horizon per sequence, scalar or ``(B,)``; defaults
        to ``T``.

    Returns:
      ``(regret (B, G), switch_t (B, G))`` on ``z``'s device.  On a CUDA
      tensor this launches kernel K6 (or raises); on a CPU tensor it runs
      ``smart_sweep_reference``.
    """
    B, T, d = check_batch(z, y)
    thresholds = settings_grid(thresholds, z.dtype, z.device, "thresholds")
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        regret, tau = launch_smart_sweep_time_major(
            *time_major(z, y), thresholds, float(eta), lengths, replay)
        return regret.t(), tau.t()
    if z.device.type == "cpu":
        return smart_sweep_reference(
            z, y, thresholds, torch.as_tensor(float(eta), dtype=z.dtype),
            lengths, replay=replay)
    raise ValueError(f"unsupported device {z.device}")
