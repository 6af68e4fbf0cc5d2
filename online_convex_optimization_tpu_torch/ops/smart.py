"""Kernels K2 (single-switch SMART) and K6 (SMART threshold sweep).

Counterpart of ``online_convex_optimization_tpu/ops/pallas_smart.py``:

- ``smart_regrets`` (TPU ``smart_regrets_packed``, kernel ``_smart_kernel``,
  round step ``_smart_round``): the whole algorithm in one pass, CUDA kernel
  ``csrc/smart_kernel.cu`` (``launch_smart``) on the caller's ``(B, T, d)``
  layout, plain version ``smart_regrets_reference``; ``smart_plays``, the
  evaluation's entry, runs G <= 4 thresholds of each sequence in one
  launch (the FTL track once, one FTL action a round, the FTRL tails in
  warps of their own), plain mirror ``smart_plays_reference``; past d =
  512 (K2w) the launch is two, K6's wide kernels in a K2 mode
  (``launch_smart_wide``: the FTL track a warp a sequence, then the tails
  a warp each);
- ``smart_sweep`` (TPU ``smart_sweep_packed``, kernel
  ``_smart_sweep_kernel``): the regret and switch round of every (sequence,
  threshold) pair with a scalar eta, two launches of
  ``csrc/smart_sweep_kernel.cu`` on the caller's ``(B, T, d)`` layout: K6a
  (``launch_smart_prefix``), the FTL prefix once per sequence with a
  pointer over the sorted thresholds, and K6b (``launch_smart_tails``),
  the FTRL tails of the pairs that switched; plain version
  ``smart_sweep_reference``, and ``smart_sweep_split_reference``
  (``smart_prefix_reference`` then ``smart_tails_reference``), the plain
  mirror of the split that the tests hold against it bit for bit.

Each plain version is a loop over T vectorized over the batch, in its
kernel's order of operations.  A wrapper runs the plain version on a CPU
tensor, at any d, and launches the kernel on a CUDA tensor; there is no
fallback between them.  K2, K6a and K6b take any d on the card (past 512
K2w and their wide instances K6aw and K6bw, whose state lies in shared
memory while their plans say it fits, else in a device buffer the wrapper
allocates, ``game.wide_state_elems``).  K6 computes what K2's FTL and tail
warps compute, in the same order, so a sweep column equals K2 bit for bit.

Semantics are those of ``models/smart.py`` (the scan the JAX package holds
against the golden oracle): an always-on FTL track; before the switch, the
FTL lead ``F - L_t`` over the prefix comparator loss ``L_t`` of the
post-update FTL action, with ``L_t`` from the hinge identity
``0.5 * (cnt - <s_t, w_t>)``; the switch at the first round where the lead
reaches the threshold, taking effect the round AFTER; then a fresh FTRL
track with the global round index.  ``switch_t`` is that round, ``T`` when
it never fires.  The final comparator is scored by the identity on contract
data and by replaying the rows otherwise (``game.in_contract``).

What bounds the kernels on an H100: about 8*(d+1) bytes of f64 input per
round, read once, against a serial chain of about 3d+10 flops per track per
round, each with a correctly rounded sqrt and divide.  Every kernel keeps
the reference's rounding order with state in registers; K2 runs the FTL
track and the FTRL tails in warps of their own over staged rows, and K6's
two launches are bound by the latency of their longest chains (the source
notes of ``csrc/smart_kernel.cu`` and ``csrc/smart_sweep_kernel.cu``).

z and y may be stored in any ``game.STORAGE`` pair (bf16 z, int8 y, ...):
the kernels widen on read and compute in ``game.compute_dtype``, the CPU
wrappers upcast and run the plain versions.
"""

from __future__ import annotations

import torch

from online_convex_optimization_tpu_torch.ops.actions import (
    ftl_action,
    ftrl_action,
    ftrl_action_scaled,
    sum_last,
)
from online_convex_optimization_tpu_torch.ops.game import (
    check_batch,
    compute_dtype,
    data_ptr,
    eta_table,
    in_contract,
    length_order,
    occupancy,
    per_sequence,
    per_sequence_lengths,
    plays_plan,
    settings_grid,
    storage_code,
    storage_suffix,
    sweep_scales,
    upcast,
    wide_state,
)
from online_convex_optimization_tpu_torch.ops.hinge import (
    hinge_subgradient,
    normalized_hinge,
)
from online_convex_optimization_tpu_torch.utils import cuda_build

# Launches of each CUDA kernel in this process (counted where it launches):
# K2, K6a (the sweep's prefix) and K6b (its tails).
LAUNCHES = 0
SWEEP_LAUNCHES = 0
SWEEP_TAIL_LAUNCHES = 0


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


def smart_plays_reference(z, y, thresholds, eta, lengths, *, replay=False):
    """Plain mirror of kernel K2's design: ``smart_regrets_reference``'s
    arithmetic with G thresholds a sequence, the FTL track once per
    sequence with one FTL action a round (the post-update action of round
    t, which the switch test scores, is round t + 1's pre-update action),
    and each switched pair's FTRL tail from the FTL losses F at its switch.
    It equals ``smart_regrets_reference`` run once per threshold row bit for
    bit (tests hold it).

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; thresholds ``(G, B)``; eta ``(B,)``;
        lengths ``(B,)`` int.
      replay: score the final comparator by replaying the rows instead of
        by the hinge identity.

    Returns:
      ``(cum_loss (G, B), comp_loss (B,), x_last (G, B, d),
      switch_t (G, B) int64)``.
    """
    B, T, d = z.shape
    G = thresholds.shape[0]
    dtype = z.dtype
    theta = z.new_zeros((B, d))        # FTL track
    w = z.new_zeros((B, d))
    x = z.new_zeros((B, d))            # the pre-update FTL action
    F = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    theta_r = z.new_zeros((G, B, d))   # FTRL tails, fresh at the switch
    total = z.new_zeros((G, B))
    x_r = z.new_zeros((G, B, d))
    tau = torch.full((G, B), T, dtype=torch.int64, device=z.device)
    eta = eta[None, :]
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        # FTL track: the carried action, the update, then the next action.
        q = sum_last(z_t * x)
        theta = theta + (v * hinge_subgradient(q, y_t))[:, None] * z_t
        F = F + v * normalized_hinge(q, y_t)
        w = w + (v * y_t)[:, None] * z_t
        cnt = cnt + v
        x = ftl_action(theta)
        # Tails: the rounds after the switch.
        active = (tau < t) & valid
        x_a = ftrl_action(theta_r, t + 1, eta)
        q_r = sum_last(z_t * x_a)
        total = torch.where(active, total + normalized_hinge(q_r, y_t), total)
        theta_r = theta_r + (active.to(dtype) * hinge_subgradient(q_r, y_t)
                             )[..., None] * z_t
        x_r = torch.where(active[..., None], x_a, x_r)
        # Switch test on the post-update action (applies next round); a
        # switched pair's tail starts from F.
        lead = F - 0.5 * (cnt - sum_last(x * w))
        hit = valid & (tau == T) & (lead >= thresholds)
        tau = torch.where(hit, t, tau)
        total = torch.where(hit, F, total)
    switched = tau < T
    if replay:
        comp = z.new_zeros((B,))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v * normalized_hinge(sum_last(z[:, t] * x), y[:, t])
    else:
        comp = 0.5 * (cnt - sum_last(x * w))
    cum = torch.where(switched, total, F)
    x_last = torch.where(switched[..., None], x_r, x)
    return cum, comp, x_last, tau


def launch_smart(z, y, thresholds, scales, eidx, lengths, replay: bool):
    """Launch kernel K2 on contiguous ``(B, T, d)`` / ``(B, T)`` CUDA inputs
    in a ``game.STORAGE`` pair with ``thresholds`` ``(G, B)`` (G <= 4), the
    ``(E, T)`` scale table and each sequence's row ``eidx``
    (``game.eta_table``), and ``lengths`` (int32); past d = 512 K2w's two
    launches (``launch_smart_wide``).  Returns ``(cum_loss (G, B),
    comp_loss (B,), x_last (G, B, d), switch_t (G, B))``."""
    global LAUNCHES
    B, T, d = z.shape
    G = thresholds.shape[0]
    dtype = compute_dtype(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        outs = (torch.empty((G, B), dtype=dtype, device=z.device),
                torch.empty((B,), dtype=dtype, device=z.device),
                torch.empty((G, B, d), dtype=dtype, device=z.device),
                torch.empty((G, B), dtype=torch.int64, device=z.device))
        if d > cuda_build.MAX_D:
            launch_smart_wide(z, y, thresholds, scales, eidx, lengths, replay,
                              outs, stream)
            return outs
        fn = getattr(cuda_build.load(),
                     f"oco_smart_regrets_{storage_suffix(z.dtype, y.dtype)}")
        err = fn(z.data_ptr(), y.data_ptr(), thresholds.data_ptr(),
                 scales.data_ptr(), eidx.data_ptr(), lengths.data_ptr(), B, T,
                 G, d, int(replay), *(o.data_ptr() for o in outs), stream)
        if err != 0:
            raise RuntimeError(f"SMART kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return outs


def launch_smart_wide(z, y, thresholds, scales, eidx, lengths, replay: bool,
                      outs, stream) -> None:
    """K2w, kernel K2 past d = 512, into ``launch_smart``'s outputs
    ``outs``: K6aw's kernel in its K2 mode (the FTL track a warp a
    sequence over each sequence's thresholds sorted on the device, comp,
    the switch rounds and the pairs without a tail), then K6bw's (each
    switched pair's FTRL tail a block), both over the sequences longest
    first; two launches, each counted.  Nothing syncs with the host."""
    global LAUNCHES
    B, T, d = z.shape
    G = thresholds.shape[0]
    lib = cuda_build.load()
    suffix = storage_suffix(z.dtype, y.dtype)
    cum, comp, x_last, tau = (o.data_ptr() for o in outs)
    ordered, perm = torch.sort(thresholds, dim=0, stable=True)
    perm = perm.to(torch.int32)
    order = length_order(lengths)
    # The buffer holds the FTL launch's part, then the tails'.
    state = wide_state("K2", B, d, G, z.dtype, z.device)
    n_ftl = plays_plan(d, z.dtype, tails=False)["state"] * B
    n_all = 0 if state is None else state.numel()
    ftl_state = state[:n_ftl] if n_ftl else None
    tail_state = state[n_ftl:] if n_all > n_ftl else None
    err = getattr(lib, f"oco_smart_plays_ftl_{suffix}")(
        z.data_ptr(), y.data_ptr(), ordered.data_ptr(), perm.data_ptr(),
        order.data_ptr(), lengths.data_ptr(), B, G, T, d, int(replay), cum,
        tau, comp, x_last, data_ptr(ftl_state), stream)
    if err != 0:
        raise RuntimeError(f"SMART FTL kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    err = getattr(lib, f"oco_smart_plays_tails_{suffix}")(
        z.data_ptr(), y.data_ptr(), scales.data_ptr(), eidx.data_ptr(),
        perm.data_ptr(), order.data_ptr(), lengths.data_ptr(), tau, B, G, T,
        d, cum, x_last, data_ptr(tail_state), stream)
    if err != 0:
        raise RuntimeError(f"SMART tail kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1


def smart_occupancy(thresholds: int, d: int, dtype) -> tuple:
    """Registers a thread, resident warps an SM and bytes of a thread's
    local frame of a K2 launch (past 512 K2w's FTL launch) with
    ``thresholds`` thresholds a sequence at feature dimension ``d`` on the
    current card."""
    return occupancy("K2", cuda_build.load().oco_smart_occupancy,
                     int(dtype == torch.float64), thresholds, d)


def plays_occupancy(tails: bool, d: int, dtype) -> tuple:
    """``(registers, warps an SM, local frame bytes, shared bytes a
    block)`` of K2w's FTL launch, or with ``tails`` its tail launch, at
    feature dimension ``d`` > 512 with z in ``dtype``, at their plans'
    blocks on the current card."""
    return occupancy("K2w", cuda_build.load().oco_smart_plays_occupancy,
                     storage_code(dtype), int(tails), d, shared=True)


def sweep_occupancy(tails: bool, d: int, dtype) -> tuple:
    """``smart_occupancy`` for K6a (K6b with ``tails``; K6aw, K6bw past
    512) with z in ``dtype``."""
    return occupancy("K6b" if tails else "K6a",
                     cuda_build.load().oco_smart_sweep_occupancy,
                     storage_code(dtype), int(tails), d)


def smart_plays(z: torch.Tensor, y: torch.Tensor, thresholds: torch.Tensor,
                eta: float, lengths: torch.Tensor, replay: bool):
    """SMART with G thresholds a sequence (``thresholds`` ``(G, B)`` on z's
    device, G <= 4) and the scalar ``eta``: one K2 launch on a CUDA tensor,
    or ``smart_plays_reference`` on a CPU tensor.  The evaluation's entry:
    ``lengths`` is a valid ``(B,)`` int32 tensor on z's device and
    ``replay`` the caller's ``in_contract`` verdict, so nothing here syncs
    with the host.

    Returns:
      ``(cum_loss (G, B), comp_loss (B,), x_last (G, B, d),
      switch_t (G, B))``.
    """
    B, T, d = check_batch(z, y)
    dtype = compute_dtype(z)
    thresholds = thresholds.to(dtype).contiguous()
    if z.device.type == "cuda":
        return launch_smart(z.contiguous(), y.contiguous(), thresholds,
                            *eta_table(eta, B, T, dtype, z.device),
                            lengths, replay)
    if z.device.type == "cpu":
        return smart_plays_reference(
            *upcast(z, y), thresholds, per_sequence(eta, B, dtype, z.device),
            lengths, replay=replay)
    raise ValueError(f"unsupported device {z.device}")


def smart_regrets(z: torch.Tensor, y: torch.Tensor, threshold, eta,
                  lengths=None):
    """Single-switch SMART losses for a batch of sequences.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; a ``game.STORAGE`` pair.
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
    dtype = compute_dtype(z)
    threshold = per_sequence(threshold, B, dtype, z.device)
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        cum, comp, x_last, tau = launch_smart(
            z.contiguous(), y.contiguous(), threshold[None],
            *eta_table(eta, B, T, dtype, z.device), lengths, replay)
        return cum[0], comp, x_last[0], tau[0]
    if z.device.type == "cpu":
        return smart_regrets_reference(
            *upcast(z, y), threshold, per_sequence(eta, B, dtype, z.device),
            lengths, replay=replay)
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


def smart_prefix_reference(z, y, thresholds, lengths, *, replay=False):
    """Plain mirror of kernel K6a, the threshold-independent prefix of the
    SMART sweep: the FTL track once per sequence, its action computed once
    a round (the post-update action of round t is round t + 1's
    pre-update action), and a pointer per sequence over the thresholds
    sorted ascending.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; thresholds ``(G,)``; lengths
        ``(B,)`` int.
      replay: score the comparator by replaying the rows instead of by the
        hinge identity.

    Returns:
      ``(partial (B, G), switch_t (B, G) int64, comp (B,))``: ``partial`` is
      the final regret of every pair without a tail (never switched, or
      switched at its last valid round) and the FTL losses F at the switch
      round (the tail's starting sum) for the others.
    """
    B, T, d = z.shape
    G = thresholds.shape[0]
    dtype = z.dtype
    ordered, perm = torch.sort(thresholds, stable=True)
    theta = z.new_zeros((B, d))
    w = z.new_zeros((B, d))
    x = z.new_zeros((B, d))            # the pre-update FTL action
    F = z.new_zeros((B,))
    cnt = z.new_zeros((B,))
    k = torch.zeros((B,), dtype=torch.int64, device=z.device)
    k_last = torch.zeros_like(k)       # thresholds passed before round len-1
    partial = z.new_zeros((B, G))
    tau = torch.full((B, G), T, dtype=torch.int64, device=z.device)
    rows = torch.arange(B, device=z.device)
    T_run = int(lengths.max())
    for t in range(T_run):
        valid = lengths > t
        v = valid.to(dtype)
        z_t, y_t = z[:, t], y[:, t]
        q = sum_last(z_t * x)
        theta = theta + (v * hinge_subgradient(q, y_t))[:, None] * z_t
        F = F + v * normalized_hinge(q, y_t)
        w = w + (v * y_t)[:, None] * z_t
        cnt = cnt + v
        x = ftl_action(theta)
        k_last = torch.where(lengths == t + 1, k, k_last)
        lead = F - 0.5 * (cnt - sum_last(x * w))
        while True:
            hit = valid & (k < G) & (lead >= ordered[k.clamp(max=G - 1)])
            if not bool(hit.any()):
                break
            cols = perm[k[hit]]
            tau[rows[hit], cols] = t
            partial[rows[hit], cols] = F[hit]
            k = k + hit.to(torch.int64)
    if replay:
        comp = z.new_zeros((B,))
        for t in range(T_run):
            v = (lengths > t).to(dtype)
            comp = comp + v * normalized_hinge(sum_last(z[:, t] * x), y[:, t])
    else:
        comp = 0.5 * (cnt - sum_last(x * w))
    sorted_pos = torch.empty_like(perm)
    sorted_pos[perm] = torch.arange(G, device=z.device)
    no_tail = sorted_pos[None, :] >= k_last[:, None]
    partial = torch.where(no_tail, (F - comp)[:, None], partial)
    return partial, tau, comp


def smart_tails_reference(z, y, scales, lengths, switch_t, partial, comp):
    """Plain mirror of kernel K6b: each switched pair's FTRL tail, rounds
    ``switch_t + 1 .. len - 1``, from a fresh theta with the scale table's
    entry of the global round (``scales`` ``(T,)``), from the starting sum
    ``partial``; the regret is the tail's total less ``comp``.  Pairs
    without a tail keep ``partial``.  Returns ``(B, G)`` regrets."""
    B, T, d = z.shape
    G = switch_t.shape[1]
    dtype = z.dtype
    tail = switch_t + 1 < lengths[:, None]
    theta = z.new_zeros((B, G, d))
    cum = partial
    T_run = int(lengths.max())
    for t in range(T_run):
        on = tail & (t > switch_t) & (lengths[:, None] > t)
        z_t, y_t = z[:, t], y[:, t]
        x = ftrl_action_scaled(theta, scales[t])
        q = sum_last(z_t[:, None, :] * x)
        cum = torch.where(on, cum + normalized_hinge(q, y_t[:, None]), cum)
        theta = theta + (on.to(dtype) * hinge_subgradient(q, y_t[:, None])
                         )[..., None] * z_t[:, None, :]
    return torch.where(tail, cum - comp[:, None], partial)


def smart_sweep_split_reference(z, y, thresholds, eta, lengths, *,
                                replay=False):
    """Plain mirror of kernel K6's split: ``smart_prefix_reference`` then
    ``smart_tails_reference`` with the scalar ``eta``'s scale table.  It
    equals ``smart_sweep_reference`` bit for bit (tests hold it); the main
    path does not use it.  Returns ``(regret (B, G), switch_t (B, G))``."""
    partial, tau, comp = smart_prefix_reference(z, y, thresholds, lengths,
                                                replay=replay)
    scales = sweep_scales(eta.reshape(1), z.shape[1])[0]
    return smart_tails_reference(z, y, scales, lengths, tau, partial,
                                 comp), tau


def launch_smart_prefix(z, y, ordered, perm, order, lengths,
                        replay: bool):
    """Launch kernel K6a on contiguous ``(B, T, d)`` / ``(B, T)`` CUDA
    inputs in a ``game.STORAGE`` pair with the thresholds sorted ascending
    (``ordered``) and their columns ``perm`` (int32), the blocks' sequence
    ``order`` (``game.length_order``) and ``lengths`` (int32).  Returns
    ``(partial (G, B), switch_t (G, B), comp (B,))`` as
    ``smart_prefix_reference`` defines them (transposed)."""
    global SWEEP_LAUNCHES
    B, T, d = z.shape
    G = ordered.shape[0]
    fn = getattr(cuda_build.load(),
                 f"oco_smart_prefix_{storage_suffix(z.dtype, y.dtype)}")
    dtype = compute_dtype(z)
    with torch.cuda.device(z.device):
        partial = torch.empty((G, B), dtype=dtype, device=z.device)
        tau = torch.empty((G, B), dtype=torch.int64, device=z.device)
        comp = torch.empty((B,), dtype=dtype, device=z.device)
        state = wide_state("K6a", B, d, 1, z.dtype, z.device)
        err = fn(z.data_ptr(), y.data_ptr(), ordered.data_ptr(),
                 perm.data_ptr(), order.data_ptr(), lengths.data_ptr(), B, G,
                 T, d, int(replay), partial.data_ptr(), tau.data_ptr(),
                 comp.data_ptr(), data_ptr(state),
                 torch.cuda.current_stream(z.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SMART sweep prefix kernel launch failed: "
                               f"CUDA error {err}")
        SWEEP_LAUNCHES += 1
    return partial, tau, comp


def launch_smart_tails(z, y, scales, perm, order, lengths, switch_t, comp,
                       regret) -> None:
    """Launch kernel K6b on K6a's outputs (``launch_smart_prefix``, with the
    same threshold columns ``perm`` (int32) in sorted order and sequence
    ``order``) and the ``(1, T)`` scale table of the scalar eta
    (``game.sweep_scales``): ``regret`` ``(G, B)`` holds K6a's ``partial``
    and is turned into the regrets in place."""
    global SWEEP_TAIL_LAUNCHES
    B, T, d = z.shape
    G = switch_t.shape[0]
    fn = getattr(cuda_build.load(),
                 f"oco_smart_tails_{storage_suffix(z.dtype, y.dtype)}")
    with torch.cuda.device(z.device):
        state = wide_state("K6b", B, d, G, z.dtype, z.device)
        err = fn(z.data_ptr(), y.data_ptr(), scales.data_ptr(),
                 perm.data_ptr(), order.data_ptr(), lengths.data_ptr(),
                 switch_t.data_ptr(), comp.data_ptr(), B, G, T, d,
                 regret.data_ptr(), data_ptr(state),
                 torch.cuda.current_stream(z.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SMART sweep tail kernel launch failed: "
                               f"CUDA error {err}")
        SWEEP_TAIL_LAUNCHES += 1


def launch_smart_sweep(z, y, thresholds, eta: float, lengths, replay: bool):
    """K6a then K6b on contiguous ``(B, T, d)`` / ``(B, T)`` CUDA inputs
    with a ``(G,)`` threshold grid, a scalar ``eta`` and ``lengths``
    (int32) as ``smart_sweep`` prepares them.  Returns
    ``(regret (G, B), switch_t (G, B))``."""
    ordered, perm = torch.sort(thresholds, stable=True)
    perm = perm.to(torch.int32)
    order = length_order(lengths)
    regret, tau, comp = launch_smart_prefix(z, y, ordered, perm, order,
                                            lengths, replay)
    scales = sweep_scales(torch.full((1,), eta, dtype=compute_dtype(z),
                                     device=z.device), z.shape[1])
    launch_smart_tails(z, y, scales, perm, order, lengths, tau, comp, regret)
    return regret, tau


def smart_sweep(z: torch.Tensor, y: torch.Tensor, thresholds, eta: float,
                lengths=None):
    """SMART regret and switch round of every (sequence, threshold) pair.

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; a ``game.STORAGE`` pair.
      thresholds: ``(G,)`` switch thresholds.
      eta: FTRL step scale (a number, rounded to the compute dtype).
      lengths: valid horizon per sequence, scalar or ``(B,)``; defaults
        to ``T``.

    Returns:
      ``(regret (B, G), switch_t (B, G))`` on ``z``'s device.  On a CUDA
      tensor this launches kernels K6a and K6b (or raises); on a CPU tensor
      it runs ``smart_sweep_reference``.
    """
    B, T, d = check_batch(z, y)
    dtype = compute_dtype(z)
    thresholds = settings_grid(thresholds, dtype, z.device, "thresholds")
    lengths = per_sequence_lengths(lengths, B, T, z.device)
    replay = not in_contract(z, y, lengths)
    if z.device.type == "cuda":
        regret, tau = launch_smart_sweep(z.contiguous(), y.contiguous(),
                                         thresholds, float(eta), lengths,
                                         replay)
        return regret.t(), tau.t()
    if z.device.type == "cpu":
        return smart_sweep_reference(
            *upcast(z, y), thresholds, torch.as_tensor(float(eta), dtype=dtype),
            lengths, replay=replay)
    raise ValueError(f"unsupported device {z.device}")
