#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py      # from the repository root; needs one card

Phases (each prints its own lines; any failure raises and the script exits
non-zero without printing a result):

  1. device  — the card's name, and its name and power limit as
               ``nvidia-smi --query-gpu=name,power.limit`` prints them.
  2. build   — compile the CUDA kernels from ``csrc/`` (timed).
  3. kernels — K1 (regret) and K2 (SMART) against their plain PyTorch
               versions on the same CUDA tensors, f64 (bound 1e-9, switch
               rounds equal) and f32 (bound 5e-4), at B=10,000 T=1000 d=5
               and B=37 T=129 d=3, ragged lengths, plus the replay mode on
               data outside the identity contract; the deterministic
               families at T in {200, 800, 1000} through the f64 kernels
               against the golden oracle (bound 1e-9).
  4. main    — the experiment driver at full scale (--t-max 1000
               --g-runs 1000, all four cases) on --device cuda; both kernels'
               launch counters must rise; then kernel times against the
               plain versions' at the main path's shapes.
  5. parity  — the same config on --device cpu (the plain versions in
               f64): every g(T) and stats entry within 1e-9 of the CUDA run.
  6. sweeps  — the eta and SMART-threshold sweeps at full width
               (models/sweep_api.py; B=32,768 T=1024 d=5, E=64 etas on
               linspace(0.05, 4, 64), G=16 thresholds with sqrt(2T),
               per-sequence lengths, generated on the card, f64 and f32):
               K5, K6 and K1 (the FTL sweep) launch counters must rise; each
               of the three path outputs against its plain version (f64
               1e-9 with switch rounds equal, f32 5e-4); a 256-sequence f64
               slice bit for bit against K1/K2 on the explicit cross
               product; the deterministic families through K5/K6 against
               the golden oracle; kernel, wrapper and plain times.
  7. stream  — StreamingKernelGame at full width (B=16,384 d=5, 128 chunks
               of 8,192 rounds: T=2^20, f32, chunks generated on the card):
               a run checkpointed and resumed halfway (utils/checkpointing)
               and fed in stacks equals the uninterrupted run bit for bit;
               K4's launch counter must rise; the main path's last chunk
               (t0 = 127 * 8,192) against the plain version on the same
               chunk and carry within 5e-4, and timed there; an f64 run
               (B=1024, T=4096 in 4 chunks) equals one K1 launch bit for
               bit and its plain version within 1e-9; f32 K4 against its
               plain version from a zero carry (B=16,384, 2 chunks of
               1,024) within 5e-4.
  8. packed  — simulate_linear_auto at the JAX pallas_v2 cell's width
               (B=131,072 T=1024 d=5, f32, generated on the card) with
               eta=sqrt(2) (K3) and eta on linspace(0.05, 4) (K3e): both
               launch counters must rise; K3 and K3e against their plain
               versions there (5e-4) and timed; in f64 at B=16,384 against
               their plain versions (1e-9), their cum against K1's bit for
               bit and the replayed regret against K1's (1e-9); K1, K2 and
               K3 at d=256 (B=8,192 T=256, f32 and f64) against their
               plain versions; kernel_envelope at d=512 and 513.
  9. quadratic — the study at its default config on --device cuda (f32;
               K8's counter must rise); its f64 statistics on cuda and cpu
               within 1e-9; K8 at the JAX bench shape (B=4,096 T=1,024
               d=5, half FTRL half FTL, regression streams generated on
               the card) against its plain version (1e-9 f64, 5e-4 f32);
               ball_ls_action (K9) on all 4,194,304 prefix statistics of
               that batch against trs_solve_reference, its counter
               rising; K8's x_c against K9 on the final statistics bit for
               bit; K8 and K9 timed.
  10. pod     — the pod-scale g(T) sweep as a user runs it:
               ``experiments/pod_demo.py --t 1000 --seqs 1048576 --device
               cuda`` (8 etas, 2^20 sequences each, lane_batch 16,384:
               8 K7 launches per eta, warm-up and timed run); K7's counter
               must rise; K7 against its plain version bit for bit (0.0) at
               lane_batch 1,024 T=1000 d=5, FTRL and FTL, and at the
               demo's launch shape (timed there); K7 against K1 on
               synthetic_stream's rows bit for bit; K7 at d=256 against its
               plain version; one launch at T=2^20 (lane_batch 128);
               then, on a one-rank NCCL process group, sharded_synthetic_g
               against the max of direct K7 calls, resumable_synthetic_g
               stopped after a slice and resumed from its checkpoint
               against one sweep (bit for bit), run_worker (T=1000,
               131,072 sequences, K1), run_stream_handoff (bitwise, the
               carry through an NCCL broadcast) and measure_scaling([1]).

The kernels' line carries, for every kernel, its launches on its path, its
error against its plain version, its kernel and plain times, its bound
(the larger of the bytes over 3.35 TB/s and the operations over the peak
for the type) and the library call's time (none computes these
recurrences: null); K7 reads nothing, so its bound is the busier of the
two pipes its work issues on: the integer ALU (the Philox xors, the bit
tests and selects) and the FMA pipe (the Philox multiplies and the float
operations of the game).  The line before the last lists the kernels as
JSON; the last line is ``{"ok": true, "device": {...}}``.  About 3.5
minutes on an H100.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.device import (
    random_game_batch,
    random_time_major_batch,
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.experiments.config import ExperimentConfig
from online_convex_optimization_tpu_torch.experiments import pod_demo
from online_convex_optimization_tpu_torch.experiments.driver import run_experiment
from online_convex_optimization_tpu_torch.experiments.quadratic_study import (
    QuadraticConfig,
    evaluate_quadratic_stream,
    run_study,
)
from online_convex_optimization_tpu_torch.models.quadratic import (
    ball_ls_action,
    simulate_quadratic_batch,
)
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)
from online_convex_optimization_tpu_torch.ops import game, smart, trs
from online_convex_optimization_tpu_torch.parallel import (
    mesh as pmesh,
    multihost,
    scaling,
    sweep,
)
from online_convex_optimization_tpu_torch.testing.golden import (
    golden_simulate_alg,
    golden_simulate_smart,
)
from online_convex_optimization_tpu_torch.utils import cuda_build
from online_convex_optimization_tpu_torch.utils.checkpointing import (
    load_pytree,
    save_pytree,
)

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = {torch.float64: 1e-9, torch.float32: 5e-4}
PARITY_TOL = 1e-9
ETA = math.sqrt(2.0)
T_GRID = tuple(range(100, 1001, 100))

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet): HBM bytes
# per second, and operations per second off the tensor cores, by working
# type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12}
# 32-bit integer operations per second on one sm_90 pipe: 132 SMs x 64
# lanes x 1.98 GHz, the clock of the data sheet's 67 TFLOP/s.  Two pipes
# take integer work and issue side by side: the ALU (logical, add, shift,
# select) and the FMA pipe, whose integer multiplies (IMAD, IMAD.HI,
# IMAD.WIDE) run on 64 of its 128 lanes an SM; the float32 peak is all 128
# doing a two-operation FMA each clock.
INT_PIPE_OPS = 132 * 64 * 1.98e9
PHILOX_ROUNDS = 10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


# ------------------------------------------------------------------ bounds
# Operation counts per unit of work, each add, multiply, divide, sqrt, abs,
# max and compare counted as one.

def hinge_round_ops(d: int, with_w: bool = True) -> int:
    """K1's round: the action (3d + 3), the hinge step (2d + 4), the theta
    update (2d) and, with the identity statistic, its update (2d)."""
    return 7 * d + 7 + (2 * d if with_w else 0)


def smart_round_ops(d: int) -> int:
    """K2's round: the FTL track's round with w, F and cnt (9d + 9), then
    the switch test (post-update action and identity, 5d + 4) or the FTRL
    track's round (7d + 7), counted as the larger."""
    return 9 * d + 9 + 7 * d + 7


def trs_ops(d: int, iters: int) -> int:
    """One trust-region solve: trace, floor and bracket (2d + 2); per Newton
    iteration the ridge, a Cholesky (d(d+1)(2d+1)/6), three triangular
    solves (d^2 each), three squared norms and the step (about 10); the
    final factor, two solves, the norm and the scaling."""
    chol = d * (d + 1) * (2 * d + 1) // 6
    per_iter = d + chol + 3 * d * d + 3 * (2 * d - 1) + 10
    return 2 * d + 2 + iters * per_iter + d + chol + 2 * d * d + 3 * d + 2


def quad_round_ops(d: int, iters: int, ftl: bool) -> int:
    """K8's round: the action (a solve for FTL; scale, projection and the
    theta update for FTRL), r and 0.5 r^2 into cum, and the statistics."""
    stats = d * (d + 1) + 2 * d + 2
    loss = 2 * d + 3
    action = trs_ops(d, iters) if ftl else 4 * d + 4 + 2 * d
    return action + loss + stats


def philox_step_ops(d: int) -> tuple:
    """K7's 32-bit integer work per sequence-step, by pipe: (ALU,
    multiplies).

    A Philox4x32-10 call per 128 of the d + 1 bits a round uses, at counter
    (t, b, k, 0) under a key schedule that depends on the seed alone: a
    step needs only the work that changes with t, and only what the used
    output words depend on.  A round maps (c0, c1, c2, c3) to (hi(M1 c2) ^
    c1 ^ k0, lo(M1 c2), hi(M0 c0) ^ c3 ^ k1, lo(M0 c0)); each 32 x 32-bit
    product (one or both halves) is one multiply, each xor of two or three
    words one LOP3.  Each used bit adds a shift and a select."""
    alu = mul = 0
    for k in range((d + 1 + 127) // 128):
        bits = min(128, d + 1 - 128 * k)
        varies = [(True, False, False, False)]   # which words change with t
        for _ in range(PHILOX_ROUNDS):
            c0, c1, c2, c3 = varies[-1]
            varies.append((c2 or c1, c2, c0 or c3, c0))
        need = set(range((bits + 31) // 32))     # output words used
        for r in reversed(range(PHILOX_ROUNDS)):
            c0, c1, c2, c3 = varies[r]
            p0, p1 = bool(need & {2, 3}), bool(need & {0, 1})
            mul += (p0 and c0) + (p1 and c2)
            alu += (0 in need and (c2 or c1)) + (2 in need and (c0 or c3))
            need = ({0} if p0 else set()) | ({2} if p1 else set()) | (
                {1} if 0 in need else set()) | ({3} if 2 in need else set())
        alu += 2 * bits
    return alu, mul


def bound(n_bytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak for the type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[dtype] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------- phase 1
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[1 device] {name}; devices={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)
    return name


# ---------------------------------------------------------------- phase 2
def phase_build():
    t0 = time.perf_counter()
    cuda_build.build(force=True)
    cuda_build.load()
    dt = time.perf_counter() - t0
    print(f"[2 build] nvcc {' '.join(cuda_build.NVCC_FLAGS)}: {dt:.2f} s")
    with open(cuda_build.LOG_PATH) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[2 build]   {line.strip()}")


# ---------------------------------------------------------------- phase 3
def make_batch(B, T, d, seed, dtype, *, contract=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, T, d), generator=g, device="cuda", dtype=torch.float64)
    if contract:
        z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                            min=1.0)
        u = torch.rand((B, T), generator=g, device="cuda", dtype=torch.float64)
        y = torch.where(u < 0.5, -1.0, 1.0).to(torch.float64)
    else:
        z = 1.5 * z
        y = torch.randn((B, T), generator=g, device="cuda", dtype=torch.float64)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
    lengths[0] = T
    return z.to(dtype), y.to(dtype), lengths


def compare_k1(label, z, y, flags, eta, lengths, *, contract=True):
    B = z.shape[0]
    fl = game.per_sequence(flags, B, torch.int32, z.device)
    et = game.per_sequence(eta, B, z.dtype, z.device)
    check(game.in_contract(z, y, lengths) == contract,
          f"K1 {label}: contract check disagrees with the data")
    got = game.regrets_fused(z, y, fl, et, lengths)
    want = game.regrets_fused_reference(z, y, fl, et, lengths,
                                        replay=not contract)
    torch.cuda.synchronize()
    err = max_err(got + (got[0] - got[1],), want + (want[0] - want[1],))
    print(f"[3 kernels] K1 {label} {z.dtype} B={B} T={z.shape[1]} "
          f"d={z.shape[2]} max_abs_err={err:.3e} (bound {TOL[z.dtype]:g})")
    check(err <= TOL[z.dtype], f"K1 {label} {z.dtype}: {err} > bound")


def compare_k2(label, z, y, thresh, eta, lengths, *, contract=True):
    B = z.shape[0]
    th = game.per_sequence(thresh, B, z.dtype, z.device)
    et = game.per_sequence(eta, B, z.dtype, z.device)
    check(game.in_contract(z, y, lengths) == contract,
          f"K2 {label}: contract check disagrees with the data")
    got = smart.smart_regrets(z, y, th, et, lengths)
    want = smart.smart_regrets_reference(z, y, th, et, lengths,
                                         replay=not contract)
    torch.cuda.synchronize()
    err = max_err(got[:3] + (got[0] - got[1],), want[:3] + (want[0] - want[1],))
    tau_diff = int((got[3] != want[3]).sum())
    print(f"[3 kernels] K2 {label} {z.dtype} B={B} T={z.shape[1]} "
          f"d={z.shape[2]} max_abs_err={err:.3e} (bound {TOL[z.dtype]:g}) "
          f"switch rounds differing: {tau_diff}")
    check(err <= TOL[z.dtype], f"K2 {label} {z.dtype}: {err} > bound")
    if z.dtype == torch.float64:
        check(tau_diff == 0, f"K2 {label}: switch rounds differ")


def phase_kernels():
    for dtype in (torch.float64, torch.float32):
        z, y, lengths = make_batch(10_000, 1000, 5, 1, dtype)
        B = z.shape[0]
        compare_k1("FTRL", z, y, 0, ETA, lengths)
        compare_k1("FTL", z, y, 1, ETA, lengths)
        mixed = torch.arange(B, device="cuda") % 2
        etas = torch.linspace(0.3, 2.5, B, device="cuda")
        compare_k1("mixed flags, per-sequence eta", z, y, mixed, etas, lengths)
        two = torch.where(mixed == 0, torch.sqrt(2.0 * lengths.double()),
                          0.8 * torch.sqrt(lengths.double()))
        compare_k2("two thresholds", z, y, two, ETA, lengths)
        del z, y
        zs, ys, ls = make_batch(37, 129, 3, 2, dtype)
        mixed = torch.arange(37, device="cuda") % 2
        compare_k1("mixed flags", zs, ys, mixed, ETA, ls)
        compare_k2("two thresholds", zs, ys,
                   torch.where(mixed == 0, 2.0, 6.5), ETA, ls)
    zr, yr, lr = make_batch(37, 129, 3, 3, torch.float64, contract=False)
    mixed = torch.arange(37, device="cuda") % 2
    compare_k1("replay (out of contract)", zr, yr, mixed, ETA, lr,
               contract=False)
    compare_k2("replay (out of contract)", zr, yr,
               torch.where(mixed == 0, 2.0, 6.5), ETA, lr, contract=False)

    # Deterministic (z = e1) families against the golden oracle: exact ties.
    seqs = [(title, T, *CASES[title](run_seed=2025)(T)[:2])
            for title in ("Label flips", "Switching leaders")
            for T in (200, 800, 1000)]
    n = len(seqs)
    z = torch.zeros((n, 1000, 5), dtype=torch.float64)
    y = torch.zeros((n, 1000), dtype=torch.float64)
    for i, (_, T, zi, yi) in enumerate(seqs):
        z[i, :T] = torch.from_numpy(zi.astype("float64"))
        y[i, :T] = torch.from_numpy(yi.astype("float64"))
    z2, y2 = torch.cat([z, z]).cuda(), torch.cat([y, y]).cuda()
    lens = torch.tensor([s[1] for s in seqs] * 2, dtype=torch.int32)
    flags = torch.tensor([0] * n + [1] * n)
    thresh = torch.tensor([math.sqrt(2.0 * s[1]) for s in seqs] + [10.0] * n,
                          dtype=torch.float64)
    cum, comp, _ = game.regrets_fused(z2, y2, flags, ETA, lens)
    lin = (cum - comp).cpu()
    cum, comp, _, tau = smart.smart_regrets(z2, y2, thresh, ETA, lens)
    sm, tau = (cum - comp).cpu(), tau.cpu()
    err, tau_bad = 0.0, 0
    for i, (title, T, zi, yi) in enumerate(seqs):
        for k, flag in ((i, 0), (i + n, 1)):
            err = max(err, abs(float(lin[k]) -
                               golden_simulate_alg(zi, yi, flag, ETA)))
        for k in (i, i + n):
            want, want_tau = golden_simulate_smart(
                zi, yi, float(thresh[k]), ETA, return_switch=True)
            err = max(err, abs(float(sm[k]) - want))
            # Never switched: the kernel reports the padded T (1000), as
            # the JAX scan does; the golden oracle reports the sequence's T.
            tau_bad += int(min(int(tau[k]), T) != want_tau)
    print(f"[3 kernels] deterministic families T in (200, 800, 1000), f64 "
          f"kernels vs golden: max_abs_err={err:.3e} (bound 1e-9), switch "
          f"rounds differing: {tau_bad}")
    check(err <= 1e-9 and tau_bad == 0, "deterministic families vs golden")


# ---------------------------------------------------------------- phase 4
def time_ms(fn, *, reps: int, inner: int = 1):
    """Median and spread (min, max) of CUDA-event milliseconds per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), min(times), max(times)


def eval_chunk_inputs():
    """One evaluation chunk as the main path builds it: 2 x 4096 sequences
    padded to T=1000, horizons 100..1000, FTRL+FTL flags, two thresholds."""
    z, y, _ = make_batch(8192, 1000, 5, 4, torch.float64)
    lengths = torch.tensor(T_GRID, dtype=torch.int32,
                           device="cuda").repeat_interleave(16).repeat(52)[:8192]
    flags = (torch.arange(8192, device="cuda") >= 4096).to(torch.int32)
    thresh = torch.where(flags == 0, torch.sqrt(2.0 * lengths.double()),
                         0.9 * torch.sqrt(2.0 * lengths.double()))
    eta = torch.full((8192,), ETA, dtype=torch.float64, device="cuda")
    return z, y, lengths, flags, thresh, eta


def time_kernels():
    out = {}
    z, y, lengths, flags, thresh, eta = eval_chunk_inputs()
    z_tm, y_tm = game.time_major(z, y)
    k1 = lambda: game.launch_time_major(z_tm, y_tm, flags, eta, lengths, False)
    k2 = lambda: smart.launch_time_major(z_tm, y_tm, thresh, eta, lengths,
                                         False)
    p1 = lambda: game.regrets_fused_reference(z, y, flags, eta, lengths)
    p2 = lambda: smart.smart_regrets_reference(z, y, thresh, eta, lengths)
    w1 = lambda: game.regrets_fused(z, y, flags, eta, lengths)
    w2 = lambda: smart.smart_regrets(z, y, thresh, eta, lengths)
    got1, want1 = w1(), p1()
    got2, want2 = w2(), p2()
    out["K1"] = {"max_abs_err": max_err(got1, want1)}
    out["K2"] = {"max_abs_err": max_err(got2[:3], want2[:3])}
    check(bool(torch.equal(got2[3], want2[3])), "K2 switch rounds at the "
          "main path's shape")
    shape = "B=8192 T=1000 d=5 f64 (one evaluation chunk)"
    rows = float(lengths.double().sum())
    out["K1"].update(bound(rows * 6 * 8 + 8192 * (16 + 8 * 7),
                           rows * hinge_round_ops(5), torch.float64))
    out["K2"].update(bound(rows * 6 * 8 + 8192 * (20 + 8 * 8),
                           rows * smart_round_ops(5), torch.float64))
    for key, kern, wrap, plain in (("K1", k1, w1, p1), ("K2", k2, w2, p2)):
        k_ms = time_ms(kern, reps=5, inner=10)
        w_ms = time_ms(wrap, reps=5)
        p_ms = time_ms(plain, reps=3)
        out[key].update(ms=k_ms[0], plain_ms=p_ms[0], library_ms=None)
        print(f"[4 main] {key} {shape}: kernel {k_ms[0]:.4f} ms "
              f"(min {k_ms[1]:.4f}, max {k_ms[2]:.4f}); wrapper with contract "
              f"check and repack {w_ms[0]:.4f} ms; plain PyTorch "
              f"{p_ms[0]:.2f} ms (min {p_ms[1]:.2f}, max {p_ms[2]:.2f}); "
              f"max_abs_err={out[key]['max_abs_err']:.3e}")
    # The g(T) batch: 1000 FTRL sequences of T = 1000.
    zg, yg, _ = make_batch(1000, 1000, 5, 5, torch.float64)
    lg = torch.full((1000,), 1000, dtype=torch.int32, device="cuda")
    fg = torch.zeros((1000,), dtype=torch.int32, device="cuda")
    eg = torch.full((1000,), ETA, dtype=torch.float64, device="cuda")
    zg_tm, yg_tm = game.time_major(zg, yg)
    k_ms = time_ms(lambda: game.launch_time_major(zg_tm, yg_tm, fg, eg, lg,
                                                  False), reps=5, inner=10)
    p_ms = time_ms(lambda: game.regrets_fused_reference(zg, yg, fg, eg, lg),
                   reps=3)
    print(f"[4 main] K1 B=1000 T=1000 d=5 f64 FTRL (one g(T) batch): kernel "
          f"{k_ms[0]:.4f} ms (min {k_ms[1]:.4f}, max {k_ms[2]:.4f}); plain "
          f"PyTorch {p_ms[0]:.2f} ms")
    return out


def phase_main(tmp):
    cfg = ExperimentConfig(t_max=1000, g_runs=1000, dpi=100, device="cuda",
                           out_dir=os.path.join(tmp, "cuda"))
    game.LAUNCHES = 0
    smart.LAUNCHES = 0
    res = run_experiment(cfg)
    launches = {"K1": game.LAUNCHES, "K2": smart.LAUNCHES}
    print(f"[4 main] driver --t-max 1000 --g-runs 1000 --device cuda: wall "
          f"{res['wall_s']:.2f} s, phases {json.dumps(res['phase_s'])}, "
          f"launches {json.dumps(launches)}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"main path did not launch both kernels: {launches}")
    stats = res["stats"]
    finite = all(math.isfinite(v) for c in stats.values() for a in c.values()
                 for v in a["mean"] + a["ci"])
    check(finite and len(stats) == 4 and len(res["g_emp"]) == len(T_GRID),
          "main path results incomplete or non-finite")
    print(f"[4 main] results.json device record: {json.dumps(res['device'])}")
    check(res["device"]["name"] == torch.cuda.get_device_name(0)
          and res["device"]["power_limit"] is not None,
          "results.json does not name the card and its power limit")
    return cfg, res, launches


# ---------------------------------------------------------------- phase 5
def results_diff(a, b):
    err = max(abs(a["g_emp"][k] - b["g_emp"][k]) for k in a["g_emp"])
    for title, algs in a["stats"].items():
        for alg, fields in algs.items():
            for f in ("mean", "ci"):
                for u, v in zip(fields[f], b["stats"][title][alg][f]):
                    err = max(err, abs(u - v))
    return err


def phase_parity(cfg, res_cuda, tmp):
    cfg_cpu = dataclasses.replace(cfg, device="cpu",
                                  out_dir=os.path.join(tmp, "cpu"))
    res_cpu = run_experiment(cfg_cpu)
    err = results_diff(res_cuda, res_cpu)
    print(f"[5 parity] --device cpu (plain PyTorch, f64) wall "
          f"{res_cpu['wall_s']:.2f} s; max |cuda - cpu| over g_emp and stats "
          f"= {err:.3e} (bound {PARITY_TOL:g})")
    check(err <= PARITY_TOL, f"CUDA and CPU results differ by {err}")
    committed = os.path.join(REPO, "results", "results.json")
    if os.path.exists(committed):
        with open(committed) as f:
            tpu = json.load(f)
        print(f"[5 parity] for information, max |cuda f64 - committed TPU "
              f"f32 results/results.json| = {results_diff(res_cuda, tpu):.3e}")


# ---------------------------------------------------------------- phase 6
SWEEP_B, SWEEP_T, D = 32_768, 1024, 5
ETA_GRID = torch.linspace(0.05, 4.0, 64, dtype=torch.float64)
# 15 thresholds on [2, 80] plus sqrt(2T); 0.5, ulp-degenerate on +-1 data,
# is not among them.
THRESH_GRID = torch.cat([torch.linspace(2.0, 80.0, 15, dtype=torch.float64),
                         torch.tensor([math.sqrt(2.0 * SWEEP_T)],
                                      dtype=torch.float64)])
SLICE = 256


def sweep_batch(dtype, seed):
    """The sweep cell's data, generated on the card: rows strictly in the
    unit ball, labels +-1, per-sequence lengths in [T/2, T]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z, y = random_game_batch(gen, SWEEP_B, SWEEP_T, D, dtype=dtype)
    lengths = torch.randint(SWEEP_T // 2, SWEEP_T + 1, (SWEEP_B,),
                            generator=gen, device="cuda", dtype=torch.int32)
    lengths[0] = SWEEP_T
    return z, y, lengths


def timed_once(fn):
    """One call of ``fn`` and its CUDA-event milliseconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def sweep_main_path(batches):
    """The sweep path as a user calls it: the FTRL eta sweep, the FTL
    sweep (one K1 launch) and the SMART threshold sweep, per dtype."""
    game.SWEEP_LAUNCHES = 0
    smart.SWEEP_LAUNCHES = 0
    game.LAUNCHES = 0
    out = {}
    for dtype, (z, y, lengths) in batches.items():
        eta_reg = ftrl_eta_sweep(z, y, ETA_GRID, length=lengths)
        ftl_reg = ftrl_eta_sweep(z, y, ETA_GRID, alg_flag=1, length=lengths)
        thr_reg = smart_threshold_sweep(z, y, THRESH_GRID, eta0=ETA,
                                        length=lengths)
        out[dtype] = (eta_reg, ftl_reg, thr_reg)
    torch.cuda.synchronize()
    launches = {"K5": game.SWEEP_LAUNCHES, "K6": smart.SWEEP_LAUNCHES,
                "K1 (FTL sweep)": game.LAUNCHES}
    print(f"[6 sweeps] ftrl_eta_sweep (E={len(ETA_GRID)}), FTL sweep and "
          f"smart_threshold_sweep (G={len(THRESH_GRID)}) at B={SWEEP_B} "
          f"T={SWEEP_T} d={D}, f64 and f32: launches {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()),
          f"sweep path did not launch K5, K6 and K1: {launches}")
    for dtype, (eta_reg, ftl_reg, thr_reg) in out.items():
        check(eta_reg.shape == ftl_reg.shape == (SWEEP_B, len(ETA_GRID))
              and thr_reg.shape == (SWEEP_B, len(THRESH_GRID))
              and all(bool(torch.isfinite(r).all())
                      for r in (eta_reg, ftl_reg, thr_reg)),
              f"sweep outputs in {dtype}: wrong shape or not finite")
        check(bool((ftl_reg == ftl_reg[:, :1]).all()),
              "FTL sweep columns differ")
    return out, launches


def sweep_vs_plain(batches, outs):
    """K5, K6 and the FTL sweep's K1 against their plain versions on the
    same CUDA tensors, at the sweep path's shapes."""
    res = {}
    for dtype, (z, y, lengths) in batches.items():
        eta_reg, ftl_reg, thr_reg = outs[dtype]
        grid = ETA_GRID.to("cuda", dtype)
        ths = THRESH_GRID.to("cuda", dtype)
        want, p5 = timed_once(lambda: game.eta_sweep_reference(z, y, grid,
                                                               lengths))
        e5 = max_err((eta_reg,), (want,))
        cum, comp, _ = game.regrets_fused_reference(
            z, y, game.per_sequence(1, SWEEP_B, torch.int32, "cuda"),
            game.per_sequence(ETA, SWEEP_B, dtype, "cuda"), lengths)
        e1 = max_err((ftl_reg,), ((cum - comp)[:, None].expand_as(ftl_reg),))
        print(f"[6 sweeps] {dtype}: FTL sweep (K1) vs plain "
              f"regrets_fused_reference max_abs_err={e1:.3e} "
              f"(bound {TOL[dtype]:g})")
        check(e1 <= TOL[dtype], f"FTL sweep vs plain in {dtype}")
        del cum, comp
        got, tau = smart.smart_sweep(z, y, ths, ETA, lengths)
        check(bool(torch.equal(got, thr_reg)),
              "smart_sweep and smart_threshold_sweep disagree")
        (want, want_tau), p6 = timed_once(lambda: smart.smart_sweep_reference(
            z, y, ths, torch.tensor(ETA, dtype=dtype, device="cuda"),
            lengths))
        e6 = max_err((got,), (want,))
        tau_diff = int((tau != want_tau).sum())
        switched = float((tau < SWEEP_T).double().mean())
        print(f"[6 sweeps] {dtype}: K5 vs plain max_abs_err={e5:.3e}, K6 vs "
              f"plain max_abs_err={e6:.3e} (bound {TOL[dtype]:g}), switch "
              f"rounds differing: {tau_diff} (share switched {switched:.3f}); "
              f"plain PyTorch {p5:.1f} ms (K5's), {p6:.1f} ms (K6's)")
        check(e5 <= TOL[dtype] and e6 <= TOL[dtype],
              f"sweep kernels vs plain in {dtype}")
        if dtype == torch.float64:
            check(tau_diff == 0, "K6 switch rounds differ from plain")
        res[dtype] = {"K5": (e5, p5), "K6": (e6, p6)}
    return res


def sweep_vs_one_shot(z, y, lengths):
    """f64: a slice of SLICE sequences x all settings through K5/K6 equals
    K1/K2 on the explicit cross product, bit for bit."""
    zs, ys, ls = z[:SLICE], y[:SLICE], lengths[:SLICE]
    E, G = len(ETA_GRID), len(THRESH_GRID)
    reg = ftrl_eta_sweep(zs, ys, ETA_GRID, length=ls)
    cum, comp, _ = game.regrets_fused(
        zs.repeat_interleave(E, 0), ys.repeat_interleave(E, 0), 0,
        ETA_GRID.to("cuda").repeat(SLICE), ls.repeat_interleave(E))
    diff5 = int((reg.reshape(-1) != cum - comp).sum())
    reg, tau = smart.smart_sweep(zs, ys, THRESH_GRID, ETA, ls)
    cum, comp, _, tau1 = smart.smart_regrets(
        zs.repeat_interleave(G, 0), ys.repeat_interleave(G, 0),
        THRESH_GRID.to("cuda").repeat(SLICE), ETA, ls.repeat_interleave(G))
    diff6 = int((reg.reshape(-1) != cum - comp).sum())
    tau_diff = int((tau.reshape(-1) != tau1).sum())
    print(f"[6 sweeps] f64 slice of {SLICE} sequences x all settings vs "
          f"K1/K2 on the explicit cross product: {diff5} (K5) and {diff6} "
          f"(K6) regrets differ in any bit, {tau_diff} switch rounds differ")
    check(diff5 == diff6 == tau_diff == 0,
          "sweep columns are not bit for bit the one-shot kernels")


def sweep_golden():
    """The deterministic families at T in {200, 800, 1000}, padded to 1000,
    through K6 at every sqrt(2T) and K5 at eta in {1, sqrt 2}, f64, against
    the golden oracle."""
    seqs = [(T, *CASES[title](run_seed=2025)(T)[:2])
            for title in ("Label flips", "Switching leaders")
            for T in (200, 800, 1000)]
    z = torch.zeros((len(seqs), 1000, 5), dtype=torch.float64)
    y = torch.zeros((len(seqs), 1000), dtype=torch.float64)
    for i, (T, zi, yi) in enumerate(seqs):
        z[i, :T] = torch.from_numpy(zi.astype("float64"))
        y[i, :T] = torch.from_numpy(yi.astype("float64"))
    z, y = z.cuda(), y.cuda()
    lens = torch.tensor([s[0] for s in seqs], dtype=torch.int32)
    ths = [math.sqrt(2.0 * T) for T in (200, 800, 1000)]
    etas = [1.0, ETA]
    reg6, tau6 = (t.cpu() for t in smart.smart_sweep(z, y, ths, ETA, lens))
    reg5 = game.eta_sweep(z, y, etas, lens).cpu()
    err, tau_bad = 0.0, 0
    for i, (T, zi, yi) in enumerate(seqs):
        for g, thr in enumerate(ths):
            want, want_tau = golden_simulate_smart(zi, yi, thr, ETA,
                                                   return_switch=True)
            err = max(err, abs(float(reg6[i, g]) - want))
            tau_bad += int(min(int(tau6[i, g]), T) != want_tau)
        for e, eta in enumerate(etas):
            err = max(err, abs(float(reg5[i, e]) -
                               golden_simulate_alg(zi, yi, 0, eta)))
    print(f"[6 sweeps] deterministic families T in (200, 800, 1000) through "
          f"K6 at sqrt(2T) and K5, f64, vs golden: max_abs_err={err:.3e} "
          f"(bound 1e-9), switch rounds differing: {tau_bad}")
    check(err <= 1e-9 and tau_bad == 0, "sweep kernels vs golden")


def sweep_replay():
    """Data outside the identity contract (replay mode) at generic d."""
    z, y, lengths = make_batch(37, 129, 3, 6, torch.float64, contract=False)
    got = game.eta_sweep(z, y, ETA_GRID[:8], lengths)
    want = game.eta_sweep_reference(z, y, ETA_GRID[:8].cuda(), lengths,
                                    replay=True)
    reg, tau = smart.smart_sweep(z, y, THRESH_GRID[:8], ETA, lengths)
    want6, want_tau = smart.smart_sweep_reference(
        z, y, THRESH_GRID[:8].cuda(),
        torch.tensor(ETA, dtype=torch.float64, device="cuda"), lengths,
        replay=True)
    err = max_err((got, reg), (want, want6))
    print(f"[6 sweeps] replay mode (out of contract) B=37 T=129 d=3 f64: "
          f"K5/K6 vs plain max_abs_err={err:.3e}, switch rounds equal: "
          f"{bool(torch.equal(tau, want_tau))}")
    check(err <= 1e-9 and bool(torch.equal(tau, want_tau)),
          "sweep kernels in replay mode")


def phase_sweeps():
    batches = {dtype: sweep_batch(dtype, 60) for dtype in
               (torch.float64, torch.float32)}
    outs, launches = sweep_main_path(batches)
    plain = sweep_vs_plain(batches, outs)
    sweep_vs_one_shot(*batches[torch.float64])
    sweep_golden()
    sweep_replay()
    timing = {}
    for dtype, (z, y, lengths) in batches.items():
        z_tm, y_tm = game.time_major(z, y)
        grid = ETA_GRID.to("cuda", dtype)
        ths = THRESH_GRID.to("cuda", dtype)
        cases = (
            ("K5", lambda: game.launch_eta_sweep_time_major(
                z_tm, y_tm, grid, lengths, False),
             lambda: ftrl_eta_sweep(z, y, ETA_GRID, length=lengths)),
            ("K6", lambda: smart.launch_smart_sweep_time_major(
                z_tm, y_tm, ths, ETA, lengths, False),
             lambda: smart_threshold_sweep(z, y, THRESH_GRID, eta0=ETA,
                                           length=lengths)))
        for key, kern, wrap in cases:
            k_ms = time_ms(kern, reps=5, inner=2)
            w_ms = time_ms(wrap, reps=3)
            err, p_ms = plain[dtype][key]
            steps = SWEEP_B * float(lengths.double().mean()) * (
                len(ETA_GRID) if key == "K5" else len(THRESH_GRID))
            print(f"[6 sweeps] {key} B={SWEEP_B} T={SWEEP_T} d={D} {dtype}: "
                  f"kernel {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}, max "
                  f"{k_ms[2]:.4f}; {steps / k_ms[0] * 1e3:.4g} "
                  f"sequence-setting-steps/s); wrapper {w_ms[0]:.4f} ms; "
                  f"plain PyTorch {p_ms:.1f} ms (one call)")
            if dtype == torch.float64:
                rows = float(lengths.double().sum())
                n_set = len(ETA_GRID) if key == "K5" else len(THRESH_GRID)
                ops = rows * n_set * (hinge_round_ops(D) if key == "K5"
                                      else smart_round_ops(D))
                n_bytes = (rows * (D + 1) * 8 + SWEEP_B * 4
                           + n_set * SWEEP_B * (8 if key == "K5" else 16))
                timing[key] = {"max_abs_err": err, "ms": k_ms[0],
                               "plain_ms": p_ms, "library_ms": None,
                               **bound(n_bytes, ops, dtype)}
        del z_tm, y_tm
    return launches, timing


# ---------------------------------------------------------------- phase 7
STREAM_B, STREAM_CT, STREAM_N = 16_384, 8192, 128


def stream_main_path(tmp):
    """StreamingKernelGame over T = 2^20 rounds in f32, chunks generated
    on the card: one game fed chunk by chunk without a break, one fed in
    stacks of two chunks (feed_many_packed) whose carry makes a
    checkpoint round trip halfway.  Returns the launch count, and the last
    chunk with the uninterrupted game's carry before and after it."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    whole = StreamingKernelGame(STREAM_B, D, eta0=ETA, device="cuda")
    split = StreamingKernelGame(STREAM_B, D, eta0=ETA, device="cuda")
    path = os.path.join(tmp, "stream_carry.npz")
    game.STREAM_LAUNCHES = 0
    t0 = time.perf_counter()
    for i in range(0, STREAM_N, 2):
        zs, ys = zip(*(random_time_major_batch(gen, STREAM_CT, STREAM_B, D)
                       for _ in range(2)))
        whole.feed_packed(zs[0], ys[0])
        before, last = whole.carry, (zs[1], ys[1])
        whole.feed_packed(zs[1], ys[1])
        split.feed_many_packed(torch.stack(zs), torch.stack(ys))
        del zs, ys
        if i + 2 == STREAM_N // 2:
            save_pytree(path, split.carry_state())
            split = StreamingKernelGame(STREAM_B, D, eta0=ETA, device="cuda")
            split.resume(load_pytree(path))
    a, b = whole.result(), split.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = game.STREAM_LAUNCHES
    diff = int((a.regret != b.regret).sum())
    print(f"[7 stream] StreamingKernelGame B={STREAM_B} d={D} f32, "
          f"{STREAM_N} chunks x {STREAM_CT} rounds (T={whole.t}), generated "
          f"on the card, two games: wall {wall:.2f} s, K4 launches "
          f"{launches}; checkpointed + stacked vs uninterrupted: {diff} "
          f"regrets differ in any bit; mean regret "
          f"{float(a.regret.double().mean()):.4f} (cum "
          f"{float(a.cum_loss.double().mean()):.1f}, comp "
          f"{float(a.comp_loss.double().mean()):.1f})")
    check(launches > 0, "stream path did not launch K4")
    check(whole.t == split.t == STREAM_N * STREAM_CT, "rounds played")
    check(diff == 0 and all(bool(torch.equal(u, v))
                            for u, v in zip(whole.carry, split.carry)),
          "checkpoint-resumed stream differs from the uninterrupted one")
    check(bool(torch.isfinite(a.regret).all()) and a.regret.shape
          == (STREAM_B,), "stream result not finite or of the wrong shape")
    return launches, last, before, whole.carry


def stream_last_chunk_vs_plain(last, before, after):
    """f32: the main path's last K4 launch (B = 16,384, CT = 8,192, global
    rounds from t0 = (STREAM_N - 1) * CT + 1 up to 2^20) against the plain
    version on the same chunk and carry, then kernel, wrapper and plain
    times on those inputs."""
    z, y = last
    t0 = (STREAM_N - 1) * STREAM_CT
    flags = game.per_sequence(0, STREAM_B, torch.int32, "cuda")
    eta = game.per_sequence(ETA, STREAM_B, torch.float32, "cuda")
    ref, p_ms = timed_once(lambda: game.play_stream_reference(
        z, y, flags, eta, t0, before))
    err = max_err(tuple(after) + game.stream_result(after),
                  tuple(ref) + game.stream_result(ref))
    print(f"[7 stream] f32 main path's last chunk B={STREAM_B} CT={STREAM_CT} "
          f"t0={t0}: K4 vs plain (carry and result) max_abs_err={err:.3e} "
          f"(bound 5e-4)")
    check(err <= TOL[torch.float32], "K4 f32 vs plain at the main path's shape")
    k_ms = time_ms(lambda: game.launch_stream_time_major(
        z, y, flags, eta, t0, before), reps=5, inner=4)
    w_ms = time_ms(lambda: game.play_stream(z, y, ETA, t0, before), reps=5)
    steps = STREAM_B * STREAM_CT
    print(f"[7 stream] K4 one chunk B={STREAM_B} CT={STREAM_CT} d={D} f32: "
          f"kernel {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}, max {k_ms[2]:.4f}; "
          f"{steps / k_ms[0] * 1e3:.4g} sequence-steps/s); wrapper "
          f"{w_ms[0]:.4f} ms; plain PyTorch {p_ms:.1f} ms (one call)")
    n_bytes = (steps * (D + 1) * 4 + STREAM_B * 8
               + 2 * STREAM_B * (2 * D + 2) * 4)
    return {"max_abs_err": err, "ms": k_ms[0], "plain_ms": p_ms,
            "library_ms": None,
            **bound(n_bytes, steps * (hinge_round_ops(D) + 2),
                    torch.float32)}


def stream_vs_one_shot():
    """f64: B = 1024, T = 4096 fed as 4 chunks equals one K1 launch bit for
    bit, and the plain version within 1e-9."""
    B, T, n = 1024, 4096, 4
    gen = torch.Generator(device="cuda").manual_seed(71)
    z, y = random_time_major_batch(gen, T, B, D, dtype=torch.float64)
    kg = StreamingKernelGame(B, D, eta0=ETA, dtype=torch.float64,
                             device="cuda", validate=True)
    ref = game.zero_stream_carry(B, D, torch.float64, "cuda")
    flags = game.per_sequence(0, B, torch.int32, "cuda")
    eta = game.per_sequence(ETA, B, torch.float64, "cuda")
    ct = T // n
    for i in range(n):
        kg.feed_packed(z[i * ct:(i + 1) * ct], y[i * ct:(i + 1) * ct])
        ref = game.play_stream_reference(z[i * ct:(i + 1) * ct],
                                         y[i * ct:(i + 1) * ct], flags, eta,
                                         i * ct, ref)
    got = kg.result()
    cum, comp, _ = game.regrets_fused(z.permute(2, 0, 1), y.t(), 0, ETA)
    diff = sum(int((u != v).sum()) for u, v in
               ((got.cum_loss, cum), (got.comp_loss, comp),
                (got.regret, cum - comp)))
    err = max_err(tuple(kg.carry) + game.stream_result(kg.carry),
                  tuple(ref) + game.stream_result(ref))
    print(f"[7 stream] f64 B={B} T={T} in {n} chunks: vs one K1 launch "
          f"{diff} values differ in any bit; vs plain (carry and result) "
          f"max_abs_err={err:.3e} (bound 1e-9)")
    check(diff == 0, "chunked K4 differs from one K1 launch")
    check(err <= 1e-9, "K4 f64 vs plain")


def stream_f32_vs_plain():
    """f32: K4 against its plain version at B = 16,384, 2 chunks of 1,024."""
    gen = torch.Generator(device="cuda").manual_seed(72)
    flags = game.per_sequence(0, STREAM_B, torch.int32, "cuda")
    eta = game.per_sequence(ETA, STREAM_B, torch.float32, "cuda")
    got = ref = game.zero_stream_carry(STREAM_B, D, torch.float32, "cuda")
    for i in range(2):
        z, y = random_time_major_batch(gen, 1024, STREAM_B, D)
        got = game.play_stream(z, y, ETA, i * 1024, got)
        ref = game.play_stream_reference(z, y, flags, eta, i * 1024, ref)
    err = max_err(tuple(got) + game.stream_result(got),
                  tuple(ref) + game.stream_result(ref))
    print(f"[7 stream] f32 B={STREAM_B} 2 chunks x 1024: K4 vs plain "
          f"max_abs_err={err:.3e} (bound 5e-4)")
    check(err <= TOL[torch.float32], "K4 f32 vs plain")
    return err


def phase_stream(tmp):
    launches, *last_chunk = stream_main_path(tmp)
    timing = stream_last_chunk_vs_plain(*last_chunk)
    del last_chunk
    stream_vs_one_shot()
    err = stream_f32_vs_plain()
    timing["max_abs_err"] = max(timing["max_abs_err"], err)
    return launches, timing


# ---------------------------------------------------------------- phase 8
PACKED_B, PACKED_T = 131_072, 1024
PACKED_F64_B = 16_384
BIG_D, BIG_B, BIG_T = 256, 8192, 256


def packed_main_path(z_tm, y_tm, etas):
    """The packed front end as a user calls it, at full width in f32:
    simulate_linear_auto with a scalar eta (K3) and a per-sequence one
    (K3e), on the (B, T, d) view of the card-generated batch."""
    z, y = z_tm.permute(2, 0, 1), y_tm.t()
    game.PACKED_LAUNCHES = game.PACKED_ETA_LAUNCHES = 0
    t0 = time.perf_counter()
    reg = game.simulate_linear_auto(z, y, 0, ETA)
    reg_eta = game.simulate_linear_auto(z, y, 0, etas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K3": game.PACKED_LAUNCHES, "K3e": game.PACKED_ETA_LAUNCHES}
    print(f"[8 packed] simulate_linear_auto B={PACKED_B} T={PACKED_T} d={D} "
          f"f32, eta=sqrt(2) and eta on linspace(0.05, 4): wall {wall:.3f} s, "
          f"launches {json.dumps(launches)}; mean regret "
          f"{float(reg.double().mean()):.4f} and "
          f"{float(reg_eta.double().mean()):.4f}")
    check(launches["K3"] > 0 and launches["K3e"] > 0,
          f"packed path did not launch K3 and K3e: {launches}")
    check(all(r.shape == (PACKED_B,) and bool(torch.isfinite(r).all())
              for r in (reg, reg_eta)), "packed regrets not finite")
    return launches


def packed_vs_plain(z_tm, y_tm, etas):
    """f32 at the main path's shape: K3 and K3e against their plain versions
    on the same tensors, then kernel, wrapper and plain times."""
    scales = game.ftrl_scales(PACKED_T, ETA, device="cuda")
    out = {}
    cases = (
        ("K3", lambda: game.launch_play_packed(z_tm, y_tm, scales, 0),
         lambda: game.play_packed(z_tm, y_tm, scales),
         lambda: game.play_packed_reference(z_tm, y_tm, scales, 0),
         PACKED_T * 4),
        ("K3e", lambda: game.launch_play_packed_eta(z_tm, y_tm, etas),
         lambda: game.play_packed_eta(z_tm, y_tm, etas),
         lambda: game.play_packed_eta_reference(z_tm, y_tm, etas),
         PACKED_B * 4))
    for key, kern, wrap, plain, extra_bytes in cases:
        got = wrap()
        want, p_ms = timed_once(plain)
        err = max_err(got + (game.comparator_epilogue(z_tm, y_tm, *got),),
                      want + (game.comparator_epilogue(z_tm, y_tm, *want),))
        k_ms = time_ms(kern, reps=5, inner=2)
        w_ms = time_ms(wrap, reps=3)
        steps = PACKED_B * PACKED_T
        n_bytes = steps * (D + 1) * 4 + extra_bytes + PACKED_B * (D + 1) * 4
        out[key] = {"max_abs_err": err, "ms": k_ms[0], "plain_ms": p_ms,
                    "library_ms": None,
                    **bound(n_bytes, steps * hinge_round_ops(D, False),
                            torch.float32)}
        print(f"[8 packed] {key} B={PACKED_B} T={PACKED_T} d={D} f32: vs "
              f"plain (cum, theta, replayed regret) max_abs_err={err:.3e} "
              f"(bound 5e-4); kernel {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}, "
              f"max {k_ms[2]:.4f}; {steps / k_ms[0] * 1e3:.4g} "
              f"sequence-steps/s; bound {out[key]['bound_ms']:.4f} ms by "
              f"{out[key]['bound_by']}); wrapper {w_ms[0]:.4f} ms; plain "
              f"PyTorch {p_ms:.1f} ms (one call)")
        check(err <= TOL[torch.float32], f"{key} f32 vs plain")
    return out


def packed_f64_vs_k1():
    """f64 at B = 16,384: K3 and K3e against their plain versions within
    1e-9; their cum against K1's bit for bit (ftrl_scales and FTL through
    K3, the per-sequence eta through K3e); the replayed regret against
    K1's within 1e-9."""
    gen = torch.Generator(device="cuda").manual_seed(80)
    z_tm, y_tm = random_time_major_batch(gen, PACKED_T, PACKED_F64_B, D,
                                         dtype=torch.float64)
    z, y = z_tm.permute(2, 0, 1), y_tm.t()
    etas = torch.linspace(0.05, 4.0, PACKED_F64_B, dtype=torch.float64,
                          device="cuda")
    scales = game.ftrl_scales(PACKED_T, ETA, dtype=torch.float64,
                              device="cuda")
    err, diff = 0.0, 0
    for flag in (0, 1):
        got = game.play_packed(z_tm, y_tm, scales, alg_flag=flag)
        want = game.play_packed_reference(z_tm, y_tm, scales, flag)
        cum, comp, _ = game.regrets_fused(z, y, flag, ETA)
        reg = game.regrets_packed(z_tm, y_tm, scales, alg_flag=flag)
        err = max(err, max_err(got + (reg,), want + (cum - comp,)))
        diff += int((got[0] != cum).sum())
    got = game.play_packed_eta(z_tm, y_tm, etas)
    want = game.play_packed_eta_reference(z_tm, y_tm, etas)
    cum, comp, _ = game.regrets_fused(z, y, 0, etas)
    reg = game.regrets_packed_eta(z_tm, y_tm, etas)
    err = max(err, max_err(got + (reg,), want + (cum - comp,)))
    diff += int((got[0] != cum).sum())
    torch.cuda.synchronize()
    print(f"[8 packed] f64 B={PACKED_F64_B} T={PACKED_T}: K3 (FTRL, FTL) and "
          f"K3e vs plain and replayed regret vs K1's max_abs_err={err:.3e} "
          f"(bound 1e-9); cum vs K1's: {diff} values differ in any bit")
    check(err <= TOL[torch.float64], "K3/K3e f64 vs plain or K1's regret")
    check(diff == 0, "K3/K3e cum differs from K1's")


def packed_large_d():
    """K1, K2 and K3 at d = 256 (the large-d instances), B = 8,192,
    T = 256, f32 and f64, against their plain versions, timed; and the
    envelope at d = 512 and 513."""
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(81)
        z, y = random_game_batch(gen, BIG_B, BIG_T, BIG_D, dtype=dtype)
        lengths = torch.full((BIG_B,), BIG_T, dtype=torch.int32,
                             device="cuda")
        flags = (torch.arange(BIG_B, device="cuda") % 2).to(torch.int32)
        eta = game.per_sequence(ETA, BIG_B, dtype, "cuda")
        thr = game.per_sequence(math.sqrt(2.0 * BIG_T), BIG_B, dtype, "cuda")
        z_tm, y_tm = game.time_major(z, y)
        scales = game.ftrl_scales(BIG_T, ETA, dtype=dtype, device="cuda")
        cases = (
            ("K1", lambda: game.launch_time_major(z_tm, y_tm, flags, eta,
                                                  lengths, False),
             lambda: game.regrets_fused_reference(z, y, flags, eta, lengths)),
            ("K2", lambda: smart.launch_time_major(z_tm, y_tm, thr, eta,
                                                   lengths, False)[:3],
             lambda: smart.smart_regrets_reference(z, y, thr, eta,
                                                   lengths)[:3]),
            ("K3", lambda: game.launch_play_packed(z_tm, y_tm, scales, 0),
             lambda: game.play_packed_reference(z_tm, y_tm, scales, 0)))
        steps = BIG_B * BIG_T
        z_bound = bound(steps * (BIG_D + 1) * z.element_size(),
                        steps * hinge_round_ops(BIG_D), dtype)
        for key, kern, plain in cases:
            got = kern()
            want, p_ms = timed_once(plain)
            got = tuple(g.t() if g.ndim == 2 and key != "K3" else g
                        for g in got)
            err = max_err(got, want)
            k_ms = time_ms(kern, reps=3)
            print(f"[8 packed] large d: {key} d={BIG_D} B={BIG_B} "
                  f"T={BIG_T} {dtype}: vs plain max_abs_err={err:.3e} "
                  f"(bound {TOL[dtype]:g}); kernel {k_ms[0]:.3f} ms (min "
                  f"{k_ms[1]:.3f}, max {k_ms[2]:.3f}; K1's bound "
                  f"{z_bound['bound_ms']:.3f} ms by {z_bound['bound_by']}); "
                  f"plain PyTorch {p_ms:.1f} ms")
            check(err <= TOL[dtype], f"{key} at d={BIG_D} {dtype} vs plain")
        del z, y, z_tm, y_tm
    at_max = game.kernel_envelope(BIG_B, BIG_T, 512)
    past = game.kernel_envelope(BIG_B, BIG_T, 513)
    print(f"[8 packed] kernel_envelope: d=512 -> {at_max!r}; d=513 -> "
          f"{past!r}")
    check(at_max is None and past is not None and "512" in past,
          "kernel_envelope boundaries")


def phase_packed():
    gen = torch.Generator(device="cuda").manual_seed(82)
    z_tm, y_tm = random_time_major_batch(gen, PACKED_T, PACKED_B, D)
    etas = torch.linspace(0.05, 4.0, PACKED_B, device="cuda")
    launches = packed_main_path(z_tm, y_tm, etas)
    timing = packed_vs_plain(z_tm, y_tm, etas)
    del z_tm, y_tm
    packed_f64_vs_k1()
    packed_large_d()
    return launches, timing


# ---------------------------------------------------------------- phase 9
QUAD_B, QUAD_T = 4096, 1024


def quad_study(tmp):
    """(a) the study at its default config on the card (f32): K8 must
    launch; (b) its f64 statistics on cuda and on cpu within 1e-9."""
    cfg = QuadraticConfig(out_dir=os.path.join(tmp, "quad"), dpi=100,
                          device="cuda")
    trs.QUAD_LAUNCHES = 0
    res = run_study(cfg)
    launches = trs.QUAD_LAUNCHES
    ftl = res["stats"]["FTL (exact LS)"]["mean"]
    ftrl = res["stats"]["FTRL"]["mean"]
    print(f"[9 quadratic] run_study default config (T={cfg.t_min}..."
          f"{cfg.t_max} step {cfg.t_step}, {cfg.runs} runs x "
          f"{cfg.replicates} replicates, d={cfg.d}, f32) --device cuda: "
          f"wall {res['wall_s']:.2f} s, K8 launches {launches}; regret at "
          f"T={cfg.t_max}: FTL {ftl[-1]:.4f}, FTRL {ftrl[-1]:.4f}")
    check(launches > 0, "the quadratic study did not launch K8")
    check(all(math.isfinite(v) for v in ftl + ftrl) and ftl[-1] < ftrl[-1],
          "quadratic study results not finite, or FTL not below FTRL")
    stats = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        stats[device] = evaluate_quadratic_stream(
            cfg.T_grid, runs=cfg.runs, replicates=cfg.replicates,
            dtype=np.float64, device=device)
        print(f"[9 quadratic] evaluate_quadratic_stream f64 --device "
              f"{device}: {time.perf_counter() - t0:.2f} s")
    err = max(float(np.abs(a - b).max())
              for k in stats["cuda"]
              for a, b in zip(stats["cuda"][k], stats["cpu"][k]))
    print(f"[9 quadratic] f64 study, max |cuda - cpu| over every mean and CI "
          f"= {err:.3e} (bound {PARITY_TOL:g})")
    check(err <= PARITY_TOL, "f64 quadratic study differs between devices")
    return launches


def prefix_statistics(z, y):
    """The running (A, b) before every round, (T, B, d, d) and (T, B, d),
    summed in K8's order, and the final ones."""
    B, T, d = z.shape
    A_pre = z.new_empty((T, B, d, d))
    b_pre = z.new_empty((T, B, d))
    A = z.new_zeros((B, d, d))
    b = z.new_zeros((B, d))
    for t in range(T):
        A_pre[t], b_pre[t] = A, b
        A = A + z[:, t, :, None] * z[:, t, None, :]
        b = b + y[:, t, None] * z[:, t]
    return A_pre, b_pre, A, b


def quad_kernels(dtype):
    """(c) K8 at the bench shape against its plain version; (d) K9 on all
    B * T prefix statistics through ball_ls_action against
    trs_solve_reference; (e) K8's x_c against K9 on the final statistics,
    bit for bit; (f) times."""
    gen = torch.Generator(device="cuda").manual_seed(90)
    z, y, _ = regression_stream_batch(gen, QUAD_B, QUAD_T, D, dtype=dtype)
    flags = (torch.arange(QUAD_B, device="cuda") >= QUAD_B // 2).to(
        torch.int32)
    eta = game.per_sequence(1.0, QUAD_B, dtype, "cuda")
    z_tm, y_tm = game.time_major(z, y)
    res = simulate_quadratic_batch(z, y, flags, eta)
    got = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
    want, p8 = timed_once(lambda: trs.quadratic_regrets_reference(
        z_tm, y_tm, flags, eta))
    e8 = max_err(got, want)
    check(bool(torch.equal(res.cum_loss, got[0])), "simulate_quadratic_batch "
          "and quadratic_regrets disagree")
    print(f"[9 quadratic] K8 B={QUAD_B} T={QUAD_T} d={D} {dtype}, half FTRL "
          f"half FTL: vs plain (cum, comp, x_c, x_last) max_abs_err="
          f"{e8:.3e} (bound {TOL[dtype]:g}); mean regret FTL "
          f"{float(res.regret[flags == 1].double().mean()):.4f}, FTRL "
          f"{float(res.regret[flags == 0].double().mean()):.4f}")
    check(e8 <= TOL[dtype], f"K8 {dtype} vs plain")
    A_pre, b_pre, A_fin, b_fin = prefix_statistics(z, y)
    A_all = A_pre.reshape(-1, D, D)
    b_all = b_pre.reshape(-1, D)
    trs.TRS_LAUNCHES = 0
    x9 = ball_ls_action(A_pre, b_pre)
    torch.cuda.synchronize()
    launches = trs.TRS_LAUNCHES
    want9, p9 = timed_once(lambda: trs.trs_solve_reference(A_all, b_all))
    e9 = max_err((x9.reshape(-1, D),), (want9,))
    n = A_all.shape[0]
    size = (A_all.numel() + b_all.numel()) * A_all.element_size()
    print(f"[9 quadratic] ball_ls_action (K9) on all {n} prefix statistics "
          f"({size / 1e6:.1f} MB of input) {dtype}: launches {launches}; vs "
          f"plain max_abs_err={e9:.3e} (bound {TOL[dtype]:g}); max ||x|| "
          f"{float(torch.linalg.vector_norm(x9, dim=-1).max()):.9f}")
    check(launches > 0, "ball_ls_action did not launch K9")
    check(e9 <= TOL[dtype], f"K9 {dtype} vs plain")
    xc9 = trs.trs_solve(A_fin, b_fin)
    diff = int((got[2].t() != xc9).sum())
    print(f"[9 quadratic] {dtype}: K8's x_c vs K9 on the final statistics: "
          f"{diff} values differ in any bit")
    check(diff == 0, f"K8's x_c differs from K9 in {dtype}")
    del want, want9
    out = {}
    if dtype == torch.float32:
        iters = trs.TRS_PARAMS[dtype][1]
        k8 = time_ms(lambda: trs.launch_quadratic_regrets(z_tm, y_tm, flags,
                                                          eta), reps=3)
        w8 = time_ms(lambda: simulate_quadratic_batch(z, y, flags, eta),
                     reps=3)
        k9 = time_ms(lambda: trs.launch_trs_solve(A_all, b_all), reps=3)
        steps = QUAD_B * QUAD_T
        ops8 = (steps // 2 * (quad_round_ops(D, iters, True)
                              + quad_round_ops(D, iters, False))
                + QUAD_B * (trs_ops(D, iters) + 2 * D * D + 2 * D + 4))
        out["K8"] = {"max_abs_err": e8, "ms": k8[0], "plain_ms": p8,
                     "library_ms": None,
                     **bound(steps * (D + 1) * 4 + QUAD_B * (8 + 4 * (2 + 2 * D)),
                             ops8, dtype)}
        out["K9"] = {"max_abs_err": e9, "ms": k9[0], "plain_ms": p9,
                     "library_ms": None,
                     **bound(size + n * D * 4, n * trs_ops(D, iters), dtype)}
        for key, k_ms, extra in (("K8", k8, f"; wrapper {w8[0]:.4f} ms"),
                                 ("K9", k9, "")):
            o = out[key]
            print(f"[9 quadratic] {key} {dtype}: kernel {k_ms[0]:.4f} ms "
                  f"(min {k_ms[1]:.4f}, max {k_ms[2]:.4f}; bound "
                  f"{o['bound_ms']:.4f} ms by {o['bound_by']}){extra}; plain "
                  f"PyTorch {o['plain_ms']:.1f} ms (one call)")
    return launches, out


def phase_quadratic(tmp):
    k8_launches = quad_study(tmp)
    timing = {}
    for dtype in (torch.float64, torch.float32):
        k9_launches, out = quad_kernels(dtype)
        timing.update(out)
    return {"K8": k8_launches, "K9": k9_launches}, timing


# --------------------------------------------------------------- phase 10
POD_T, POD_SEQS, POD_LANES = 1000, 1 << 20, 16_384
K7_LANES, K7_BIG_D = 1024, 256


def synthetic_bound(steps: float, d: int, n_out: int) -> dict:
    """K7's least time: it reads nothing and writes its regrets, and its
    work issues on two pipes side by side, so the larger of the bytes
    written and the busier pipe: the ALU with the integer xors, shifts and
    selects, and the FMA pipe with the integer multiplies (on 64 of its 128
    lanes) and the game's float operations (at the float32 peak)."""
    alu, mul = philox_step_ops(d)
    flops = hinge_round_ops(d)
    by_alu = steps * alu / INT_PIPE_OPS * 1e3
    by_fma = steps * max(mul / INT_PIPE_OPS, mul / (2 * INT_PIPE_OPS)
                         + flops / PEAK_OPS[torch.float32]) * 1e3
    by_bytes = n_out * 4 / HBM_BYTES_PER_S * 1e3
    ms, by = max((by_bytes, "bytes"), (by_alu, "operations"),
                 (by_fma, "operations"))
    print(f"[10 pod] K7 bound per launch of {steps:.4g} sequence-steps "
          f"({alu} ALU, {mul} multiplies, {flops} float operations a step): "
          f"ALU {by_alu:.4f} ms, FMA pipe {by_fma:.4f} ms, bytes "
          f"{by_bytes:.6f} ms")
    return {"bound_ms": ms, "bound_by": by}


def pod_main_path():
    """The pod demo as a user runs it, at its full default width."""
    game.SYNTHETIC_LAUNCHES = 0
    res = pod_demo.main(["--t", str(POD_T), "--seqs", str(POD_SEQS),
                         "--lane-batch", str(POD_LANES), "--device", "cuda"])
    launches = game.SYNTHETIC_LAUNCHES
    print(f"[10 pod] pod_demo --t {POD_T} --seqs {POD_SEQS} --device cuda: "
          f"wall {res['wall_s']:.4f} s, {res['steps_per_s']:.4g} "
          f"sequence-steps/s over {res['total_steps']} steps, K7 launches "
          f"{launches} (warm-up and timed run); g per eta "
          f"{json.dumps(res['g_max'])}; device {json.dumps(res['device'])}")
    check(launches > 0, "the pod demo did not launch K7")
    check(res["n_sequences_per_eta"] == POD_SEQS and len(res["g_max"]) == 8
          and all(math.isfinite(v) and 0 < v < POD_T
                  for v in res["g_max"].values()),
          "pod demo g values missing or out of range")
    check(res["device"]["name"] == torch.cuda.get_device_name(0)
          and res["device"]["power_limit"] is not None,
          "the pod demo record does not name the card and its power limit")
    return launches


def k7_vs_plain():
    """K7 against its plain version (0.0) at lane_batch 1,024, T = 1000,
    d = 5, FTRL and FTL, and against K1 on the materialized rows; at d =
    256 against the plain version; one launch at T = 2^20."""
    for alg in (0, 1):
        got = game.synthetic_regrets(7 << 20, ETA, T=POD_T,
                                     lane_batch=K7_LANES, alg_flag=alg)
        want = game.synthetic_regrets_reference(
            7 << 20, ETA, T=POD_T, lane_batch=K7_LANES, alg_flag=alg,
            device="cuda")
        z, y = game.synthetic_stream(7 << 20, T=POD_T, lane_batch=K7_LANES,
                                     device="cuda")
        cum, comp, _ = game.regrets_fused(z, y, alg, ETA)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        diff1 = int((got.reshape(-1) != cum - comp).sum())
        print(f"[10 pod] K7 {'FTL' if alg else 'FTRL'} lane_batch "
              f"{K7_LANES} T={POD_T} d={D} f32: vs plain max_abs_err="
              f"{err:.3e} ({int((got != want).sum())} differ in any bit; "
              f"bound 0); vs K1 on synthetic_stream's rows {diff1} differ "
              f"in any bit; mean regret {float(got.double().mean()):.4f}")
        check(torch.equal(got, want), "K7 differs from its plain version")
        check(diff1 == 0, "K7 differs from K1 on the materialized stream")
        del z, y, cum, comp
    got = game.synthetic_regrets(9, ETA, T=256, lane_batch=16, d=K7_BIG_D)
    want = game.synthetic_regrets_reference(9, ETA, T=256, lane_batch=16,
                                            d=K7_BIG_D, device="cuda")
    print(f"[10 pod] K7 d={K7_BIG_D} lane_batch 16 T=256: vs plain "
          f"{int((got != want).sum())} differ in any bit")
    check(torch.equal(got, want), "K7 at large d differs from plain")
    (out, ms) = timed_once(lambda: game.synthetic_regrets(
        11, ETA, T=1 << 20, lane_batch=128))
    mean = float(out.double().mean())
    print(f"[10 pod] K7 one launch T=2^20 lane_batch 128 (1,024 sequences): "
          f"{ms:.1f} ms, mean regret {mean:.2f} (10 sqrt(T) = "
          f"{10 * math.sqrt(1 << 20):.0f}), finite "
          f"{bool(torch.isfinite(out).all())}")
    check(bool(torch.isfinite(out).all()) and 0 < mean < 10 * math.sqrt(
        1 << 20), "K7 at T = 2^20 not finite or out of range")


def k7_timing():
    """K7 at the demo's launch shape (131,072 sequences, T = 1000, FTRL,
    eta = sqrt 2) against its plain version bit for bit, and timed."""
    kern = lambda: game.synthetic_regrets(0, ETA, T=POD_T,
                                          lane_batch=POD_LANES)
    got = kern()
    want, p_ms = timed_once(lambda: game.synthetic_regrets_reference(
        0, ETA, T=POD_T, lane_batch=POD_LANES, device="cuda"))
    err = float((got - want).abs().max())
    del want
    torch.cuda.empty_cache()
    k_ms = time_ms(kern, reps=5, inner=4)
    steps = 8 * POD_LANES * POD_T
    out = {"max_abs_err": err, "ms": k_ms[0], "plain_ms": p_ms,
           "library_ms": None, **synthetic_bound(steps, D, 8 * POD_LANES)}
    print(f"[10 pod] K7 lane_batch {POD_LANES} T={POD_T} d={D} f32: vs plain "
          f"max_abs_err={err:.3e} (bound 0); kernel {k_ms[0]:.4f} ms (min "
          f"{k_ms[1]:.4f}, max {k_ms[2]:.4f}; {steps / k_ms[0] * 1e3:.4g} "
          f"sequence-steps/s; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}); plain PyTorch {p_ms:.1f} ms (one call)")
    check(err == 0.0, "K7 differs from plain at the demo's shape")
    return out


class _Preempted(Exception):
    pass


def nccl_sweeps(tmp):
    """The sharded sweeps on a one-rank NCCL process group."""
    pmesh.initialize_distributed(f"127.0.0.1:{pmesh.free_port()}", 1, 0,
                                 device="cuda")
    try:
        mesh = pmesh.make_mesh(1, 1, device="cuda")
        etas = [0.5, 1.0, ETA, 2.0]
        kw = dict(T=POD_T, eta_grid=etas, lane_batch=K7_LANES)
        g = sweep.sharded_synthetic_g(mesh, blocks_per_device=4, **kw)
        want = torch.stack([torch.stack([game.synthetic_regrets(
            b << 20, float(np.float32(e)), T=POD_T,
            lane_batch=K7_LANES).max() for b in range(4)]).max()
            for e in etas])
        print(f"[10 pod] NCCL (1 rank): sharded_synthetic_g {g.tolist()} vs "
              f"the max of direct K7 calls: equal {torch.equal(g, want)}")
        check(torch.equal(g, want), "sharded_synthetic_g differs from K7")
        path = os.path.join(tmp, "g_sweep.npz")
        calls = [0]

        def preempted_after_one_slice(*args, **kwargs):
            calls[0] += 1
            if calls[0] > 2 * len(etas):
                raise _Preempted
            return game.synthetic_regrets(*args, **kwargs)

        try:
            sweep.resumable_synthetic_g(mesh, blocks_per_device=4,
                                        blocks_per_step=2,
                                        checkpoint_path=path,
                                        regret_fn=preempted_after_one_slice,
                                        **kw)
        except _Preempted:
            pass
        done = int(load_pytree(path)["done"])
        resumed = sweep.resumable_synthetic_g(mesh, blocks_per_device=4,
                                              blocks_per_step=2,
                                              checkpoint_path=path, **kw)
        print(f"[10 pod] NCCL: resumable_synthetic_g stopped after {done} of "
              f"4 blocks and resumed from its checkpoint: equal to one sweep "
              f"{bool((resumed == g.cpu().numpy()).all())}")
        check(done == 2 and bool((resumed == g.cpu().numpy()).all()),
              "resumed sweep differs from one sweep")
        game.LAUNCHES = 0
        t0 = time.perf_counter()
        w = multihost.run_worker(POD_T, 131_072, eta0=ETA)
        wall = time.perf_counter() - t0
        print(f"[10 pod] NCCL: run_worker T={POD_T} 131,072 sequences: "
              f"{wall:.2f} s, K1 launches {game.LAUNCHES}, g_max "
              f"{w['g_max']:.4f}, mean {w['mean_regret']:.4f} +- "
              f"{w['sem']:.2e}")
        check(game.LAUNCHES > 0 and w["total_scenarios"] == 131_072
              and math.isfinite(w["g_max"]), "run_worker on the card")
        h = multihost.run_stream_handoff(4096, 1024, eta0=ETA)
        print(f"[10 pod] NCCL: run_stream_handoff T=4096 B=1024 (carry "
              f"through an NCCL broadcast): bitwise cum {h['bitwise_cum']}, "
              f"regret {h['bitwise_regret']}")
        check(h["bitwise_cum"] and h["bitwise_regret"],
              "stream hand-off not bitwise")
        pts = scaling.measure_scaling([1], B_per_dev=16_384, T=1024)
        print(f"[10 pod] NCCL: measure_scaling([1]) B_per_dev=16,384 T=1024: "
              f"{pts[0].steps_per_s:.4g} sequence-steps/s")
        check(pts[0].steps_per_s > 0, "measure_scaling")
    finally:
        torch.distributed.destroy_process_group()


def phase_pod(tmp):
    launches = pod_main_path()
    k7_vs_plain()
    timing = k7_timing()
    nccl_sweeps(tmp)
    return launches, timing


def main() -> int:
    name = phase_device()
    phase_build()
    phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, res, launches = phase_main(tmp)
        timing = time_kernels()
        phase_parity(cfg, res, tmp)
        sweep_launches, sweep_timing = phase_sweeps()
        stream_launches, stream_timing = phase_stream(tmp)
        packed_launches, packed_timing = phase_packed()
        quad_launches, quad_timing = phase_quadratic(tmp)
        pod_launches, pod_timing = phase_pod(tmp)
    kernels = [
        {"name": "regret_kernel (K1: FTRL/FTL regret game + comparator)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/regret_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:679",
         "launches": launches["K1"], **timing["K1"]},
        {"name": "smart_kernel (K2: single-switch SMART)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/smart_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_smart.py:108",
         "launches": launches["K2"], **timing["K2"]},
        {"name": "stream_kernel (K4: carried FTRL/FTL stream chunk)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/stream_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:871",
         "launches": stream_launches, **stream_timing},
        {"name": "sweep_kernel (K5: FTRL eta sweep)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/sweep_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:556",
         "launches": sweep_launches["K5"], **sweep_timing["K5"]},
        {"name": "smart_sweep_kernel (K6: SMART threshold sweep)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/smart_sweep_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_smart.py:248",
         "launches": sweep_launches["K6"], **sweep_timing["K6"]},
        {"name": "game_kernel (K3: packed game from a table of FTRL scales)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/game_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:363",
         "launches": packed_launches["K3"], **packed_timing["K3"]},
        {"name": "game_kernel (K3e: packed FTRL game, per-sequence eta)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/game_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:467",
         "launches": packed_launches["K3e"], **packed_timing["K3e"]},
        {"name": "quad_game_kernel (K8: quadratic game, in-kernel trust "
                 "region)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/quad_game_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_trs.py:206",
         "launches": quad_launches["K8"], **quad_timing["K8"]},
        {"name": "trs_kernel (K9: batched ball-constrained least squares)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/trs_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_trs.py:62",
         "launches": quad_launches["K9"], **quad_timing["K9"]},
        {"name": "synthetic_kernel (K7: generation-fused FTRL/FTL game, "
                 "in-kernel Philox4x32-10)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/synthetic_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:1115",
         "launches": pod_launches, **pod_timing},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
