#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py      # from the repository root; needs one card

Phases (each prints its own lines; any failure raises and the script exits
non-zero without printing a result):

  1. device  — the card's name, and its name and power limit as
               ``nvidia-smi --query-gpu=name,power.limit`` prints them.
  2. build   — compile the CUDA kernels from ``csrc/`` (timed).
  3. kernels — K1 (regret) and K2 (SMART) against their plain PyTorch
               versions on the same CUDA tensors, bit for bit (max_abs_err
               0, switch rounds equal), f64 and f32: through the wrappers
               (one play or threshold a sequence) and the evaluation's
               entries (FTRL and FTL as two plays of one copy of z; two
               thresholds a sequence), at B=10,000 T=1000 d=5 and at
               B=77 T=203 for d = 5, 3, 64 and 65 (the unrolled, generic
               and large-d instances), ragged lengths, in contract and in
               replay mode; the deterministic families at T in {200, 800,
               1000} through the f64 kernels against the golden oracle
               (bound 1e-9).
  4. main    — the experiment driver at full scale (--t-max 1000
               --g-runs 1000, all four cases) on --device cuda: K1 must
               launch 5 times (one g(T) launch, one a case) and K2 4
               times; then K1 and K2 at the path's shapes (the g(T) launch
               of 10,000 sequences; the largest case, 9,600 sequences with
               two plays and two thresholds; the parent's 8,192-sequence
               chunk) against their plain versions bit for bit, timed,
               with their bounds and output digests (the digests that
               ``scripts/k1k2_compare.py`` prints for any commit).
  5. parity  — the same config on --device cpu (the plain versions in
               f64): every g(T) and stats entry within 1e-9 of the CUDA run.
  6. sweeps  — the eta and SMART-threshold sweeps at full width
               (models/sweep_api.py; B=32,768 T=1024 d=5, E=64 etas on
               linspace(0.05, 4, 64), G=16 thresholds with sqrt(2T),
               per-sequence lengths, generated on the card, f64 and f32):
               K5, K6a, K6b (K6's two launches) and K1 (the FTL sweep)
               launch counters must rise; each of the path outputs against
               its plain version (f64 1e-9 with switch rounds equal, f32
               5e-4), K6a and K6b each against its part of the split
               mirror, with the outputs' digests, the pairs switched and
               their tail rounds; K5 and K6 at d = 3, 64 and 65 (the
               generic and large-d instances) at B=77 T=203; a
               256-sequence f64 slice bit for bit against K1/K2 on the
               explicit cross product; the deterministic families through
               K5/K6 against the golden oracle; replay mode; kernel (K6a
               and K6b apart), wrapper and plain times against the bounds
               counted from the run's switch rounds.
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
               one K8 launch for every (run, horizon)); its f32 and f64
               statistics equal in every bit to a call per (run, horizon);
               its f64 statistics on cuda and cpu within 1e-9; K8 at the
               study's launch timed, with a digest of its outputs; K8 at
               the JAX bench shape (B=4,096 T=1,024 d=5, half FTRL half
               FTL, regression streams generated on the card) against its
               plain version (1e-9 f64, 5e-4 f32), with a digest of its
               outputs; ball_ls_action (K9) on all 4,194,304 prefix
               statistics of that batch against trs_solve_reference bit
               for bit (torch.equal), its counter rising; K9 on the
               prefixes in a random order equal to the permuted output;
               K8's x_c against K9 on the final statistics bit for bit;
               the Newton passes each solve needs there (the plain mirror
               of the kernels' exit, on the card), with K8's per-lane and
               warp-max totals, and K9's mean passes a solve against the
               warp max of one problem a thread and the refill model's
               loop passes; K8 and K9 timed (K9 f64 and f32), K8 also on
               one warp (its time a Newton pass); their bounds count each
               solve at its own passes; K9's --fmad=false issue floor
               from the SASS census of this build (a pass, a pass at the
               cap, the rest of the loop); K9's generic instance at d = 7
               and 32 (16 x 257 prefixes) against its plain version bit
               for bit.
  10. pod     — the pod-scale g(T) sweep as a user runs it:
               ``experiments/pod_demo.py --t 1000 --seqs 1048576 --device
               cuda`` (8 etas, 2^20 sequences each, lane_batch 16,384:
               8 K7 launches per eta, warm-up and timed run); K7's counter
               must rise; K7 against its plain version bit for bit (0.0) at
               lane_batch 1,024 T=1000 d=5, FTRL and FTL, and at the
               demo's launch shape (timed there); K7 against K1 on
               synthetic_stream's rows bit for bit; K7 at d=256 against its
               plain version; at T=2500 (past two chunks of its FTRL scale
               table) against its plain version bit for bit, FTRL and FTL;
               one launch at T=2^20 (lane_batch 128);
               then, on a one-rank NCCL process group, sharded_synthetic_g
               against the max of direct K7 calls, resumable_synthetic_g
               stopped after a slice and resumed from its checkpoint
               against one sweep (bit for bit), run_worker (T=1000,
               131,072 sequences, K1), run_stream_handoff (bitwise, the
               carry through an NCCL broadcast) and measure_scaling([1]).
  11. exact   — (a) K10 against its plain version, 300 fixed iterations
               (f32 bound 5e-4), at B=2 T=1000 d=5 and at B=1 T=1100 and
               T=4096 (rows over several warps; past 2,048 the
               16-entries-a-lane instance); 100 + 150 iterations from the
               saved state against 250 at T=1000 and 1100, and one
               replicate alone against its rows in the batch at T=1100,
               bit for bit; the route's launch on z[:, :600] against rows
               [:600] of the launch padded to T=1000, bit for bit; (b) K10
               at the kernel route's shape (B=16 T=1000 d=5) timed at 2,000
               fixed iterations (the bound's work; with the --fmad=false
               issue floor, registers and warps an SM) and at the route's
               iters=6000 tol=2e-4, every residual <= 1e-3, and after the
               host polish every 20th prefix's objective within 3e-6 above
               the plain banded ADMM's; (c) ``driver --exact
               --exact-solver kernel --precision f32 --device cuda`` cut to
               ``--runs 2 --g-runs 50``: every random-family cell through
               K10, K10's launches equal to the cells plus the escalations,
               FTRL and FTL (exact) means within the f32 scoring bound
               3T(T+d+3)2^-24 of ``--exact-solver auto`` (certified, host
               f64) on the same cut; the same at one horizon T=1100 (one
               run, one family, --g-runs 10), past PR 5's limit T <= 1024;
               (d) the default ``--exact --g-runs 200`` (auto, canonical,
               f64, 48 runs) on the card against the committed
               ``results/results_exact_canonical.json``: g_emp and stats
               within 1e-9, the audit equal.
  12. ssn     — the semismooth Newton (``models/ssn.py``, plain PyTorch,
               f64; no kernel of its own, K1 scores its cells) on the
               out-of-contract family z = 2 N(0, I), y = sign(<z, w> + 0.3
               noise): (a) on the card against the CPU at B=8 T=256 d=5:
               10 fixed Newton steps, X and mu within 1e-9 on the
               prefixes of at least d rows and every prefix objective
               within 1e-9 (1 + f); at tol 2e-4 and a cap of 400 steps at
               least 95% of the rows certified and every row within the
               pipeline's fail_tol 1e-3 on both (the JAX package's bars),
               the polished objectives of replicate 0 within 1e-9; the
               band call at the pipeline's width (B=8, T_max=1000, four
               256-row bands in one batch, iters 80): its Newton steps,
               wall, ms a step, rows certified, and the ATen operations
               and CUDA kernels of one eager step; (b) ``driver --exact
               --exact-solver ssn`` against ``--exact-solver xla`` on
               ``--runs 2 --g-runs 50 --t-max 300`` (the two random
               families): means within 3e-6, every cell through the SSN, K1
               scoring it, walls and ``exact_time_s``; (c) ``auto`` on the
               OOC family at T_max=1000 B=8: the cell through the SSN,
               statistics equal to ``solver="ssn"`` in every bit; (d) the
               linf SSN at T=40 against HiGHS LP objectives at the bars of
               ``tests/test_ssn.py::test_ssn_linf_matches_lp_objectives``.
  13. storage — K1-K6 on the JAX package's narrow storage: bf16 z with
               bf16 or int8 y, and f32 z with int8 y, generated on the
               card by the bf16 generators.  Each pair's main path (the
               counts zeroed before and read after): regret_plays and
               regrets_fused (K1), smart_plays and smart_regrets (K2),
               simulate_linear_auto (K3, K3e), StreamingKernelGame(dtype,
               y_dtype) (K4), ftrl_eta_sweep (K5), smart_threshold_sweep
               (K6a, K6b), every count rising.  Every instance (d = 5, 3,
               64, 65 at B=77 T=103, in contract and in replay mode) and
               each kernel at its phase's shape (K1, K2: phase 3's B=10,000
               T=1000 with two plays or thresholds; K3, K3e: phase 8's;
               K4: phase 7's chunk at t0 = 127 chunks with a carried
               state; K5, K6a, K6b: phase 6's) equal in every bit to the
               f32 instance on the upcast values and within 5e-4 of its
               plain version; timed against the f32 instance in turns,
               beside the pair's bytes bound; one K3 call at B=131,072
               must grow the peak memory by less than an f32 copy of z
               (the narrow arrays are read, not upcast) and launch once;
               K1 at bench.py's shape (262,144 sequences, T=1024, one FTRL
               play, bf16 z, int8 y), timed.  About 45 s.
  14. wide    — the instances past the thin kernels' sizes: (a) K10l, the
               rows longer than 4,096 entries, through
               ``admm_all_prefixes_l2`` at B=2 T=8192 d=5 (200 fixed
               iterations, random contract data), every long row on its
               resident instance: its launch count, the state against the
               plain version (5e-4), rows p < 4096 against the launch on
               z[:, :4096] and 100 + 100 iterations against 200 (bit for
               bit), its time (the launch less the launch on z[:, :4096]),
               bound, --fmad=false issue floor, registers, warps an SM and
               the stream its state would take; the route's iters=6000
               tol=2e-4, with the iterations each row took (one-block
               continued calls: the rows at or below tol must be the rows
               those calls saw converge); at B=1 T=9,216 (200 fixed
               iterations) the streaming instance on the rows past 8,192
               entries and the resident one on the others: both launch
               counts, every row against the plain version (5e-4), rows p
               < 8,192 against the launch on z[:, :8192] (bit for bit), the
               streaming instance's time (the launch less that launch); the
               ``--exact --exact-solver kernel`` driver at one horizon T =
               4,200 (one run, one random family, --g-runs 4) against the
               auto route at phase 11's f32 scoring bound; (b) K9w:
               ``ball_ls_action`` at d=64 on 65,536 prefix statistics (the
               launch count) in f32 and f64, each against the plain
               version on the same inputs (bit for bit, and f64 1e-9, f32
               5e-4), and at d = 40 on 4,096; timed at d = 64 (65,536),
               128 (16,384) and 256 (4,096: f32 with the workspace in
               shared memory, its first 64 problems against the plain
               version bit for bit, f64 in device scratch) in f32 and f64,
               with each launch's plan, the f32 answers against the f64
               kernel's on the same values (5e-4; well-conditioned prefixes
               of at least 4d rows) and the f64 answers against the
               trust-region conditions (1e-9); (c) K8w:
               ``simulate_quadratic_batch`` at B=4,096 T=1,024 d=64, half
               FTL (the launch count), f32, against the plain version on
               every sequence (512 a call), the same shape in f64 on every
               8th sequence, and at d = 40 (B=256 T=128), bit for bit; x_c
               equal to K9w's in every bit at d = 40, 64 and 128; timed at
               d = 64 (f32, f64; 5 launches) and 128 (f32, its one launch)
               with output digests; the quadratic study at ``--d 64``
               through its entry (one K8w launch).  The bounds count each
               solve at the Newton passes the kernels report (``passes``;
               the card's tests hold them to the plain mirror's).

The kernels' line carries, for every kernel, its launches on its path, its
error against its plain version, its kernel and plain times, its bound
(the larger of the bytes over 3.35 TB/s and the operations over the peak
for the type) and the library call's time (none computes these
recurrences: null); K7 reads nothing, so its bound is the busier of the
two pipes its work issues on: the integer ALU (the Philox xors, the bit
tests and selects) and the FMA pipe (the Philox multiplies and the float
operations of the game); K8's and K9's count each trust-region solve at
the Newton passes these inputs need (``trs_ops``); K10's is its float
operations at 2,000 fixed iterations (``admm_ops``); K2's counts the
rounds this run's switch rounds need (the FTL track on every valid row,
the switch test up to the last threshold's switch, each pair's tail).
K1's, K2's, K9's and K10's entries add their registers a thread and
resident warps an SM (K9's and K10's text lines also print the
--fmad=false issue floor, which is arithmetic and stays out of the
kernels line).  The narrow instances of phase 13 have an entry each
(name ``... (K1, bfloat16 z, int8 y: oco_*_bf16i8)``), with K1 at
bench.py's shape.  K10l's two instances, K9w and K8w (phase 14) have an
entry each at their path shapes (K10l resident: B=2 T=8192, 200
iterations; K10l streaming: B=1 T=9,216, 200 iterations; K9w: d=64,
65,536 problems, f32; K8w: d=64, B=4,096 T=1,024, f32), their errors
and plain times from the plain versions on the same inputs (K8w's in
calls of 512 sequences, summed).  The line before the
last lists the kernels as JSON; the last line is ``{"ok": true,
"device": {...}}``.  About 10-12 minutes on an H100.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
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
from scipy.optimize import linprog
from torch.utils._python_dispatch import TorchDispatchMode

from online_convex_optimization_tpu_torch.data.device import (
    random_game_batch,
    random_time_major_batch,
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.experiments.config import (
    ExperimentConfig,
    config_from_args,
)
from online_convex_optimization_tpu_torch.experiments import pod_demo
from online_convex_optimization_tpu_torch.experiments.driver import run_experiment
from online_convex_optimization_tpu_torch.experiments.quadratic_study import (
    QuadraticConfig,
    evaluate_quadratic_stream,
    horizon_batches,
    main as quad_study_main,
    quadratic_stats,
    run_study,
    study_batch,
)
from online_convex_optimization_tpu_torch.experiments.evaluate import (
    evaluate_stream_exact,
)
from online_convex_optimization_tpu_torch.models import ssn
from online_convex_optimization_tpu_torch.models.exact_ftl import (
    _admm_all_prefixes,
)
from online_convex_optimization_tpu_torch.models.polish import (
    objective as polish_objective,
    polish_prefix_actions,
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
from online_convex_optimization_tpu_torch.ops import admm, game, smart, trs
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
# float32 instructions per second with every multiply and add issued alone
# (--fmad=false): 132 SMs x 128 lanes x 1.98 GHz, half the data sheet's
# 67 TFLOP/s, which counts an FMA as two operations.
FP32_ISSUE_PER_S = 132 * 128 * 1.98e9
# float64 instructions per second with every multiply and add issued alone
# (--fmad=false): 132 SMs x 64 lanes x 1.98 GHz, half the data sheet's
# 34 TFLOP/s.
FP64_ISSUE_PER_S = 132 * 64 * 1.98e9
PHILOX_ROUNDS = 10
# The card's maximum SM clock (nvidia-smi clocks.max.sm), read in phase 1.
SM_CLOCK_HZ = 1.98e9


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


def trs_ops(d: int, passes: torch.Tensor, iters: int) -> int:
    """The trust-region solves of ``passes`` (one entry a solve: its ridge
    solves, ``iters + 1`` where the Newton loop ran its full count, as
    ``ops/trs.py::trs_action_settled`` counts them).  A solve's trace,
    floor and bracket (2d + 2) and its final scaling (3d + 2); a full pass
    is a ridge solve (the ridge, a Cholesky of d(d+1)(2d+1)/6 operations,
    two triangular solves of d^2), a third triangular solve, three squared
    norms and the step (about 10); the fixed count's last pass is the
    ridge solve alone, and an exit reuses its pass's solve."""
    chol = d * (d + 1) * (2 * d + 1) // 6
    ridge = d + chol + 2 * d * d
    full = ridge + d * d + 3 * (2 * d - 1) + 10
    capped = passes == iters + 1
    n_full = int(torch.where(capped, iters, passes).sum())
    return (passes.numel() * (5 * d + 4) + n_full * full
            + int(capped.sum()) * ridge)


def quad_round_ops(d: int, ftl: bool) -> int:
    """K8's round outside the solve: the FTRL action (scale, projection),
    r and 0.5 r^2 into cum, the theta update and the statistics."""
    stats = d * (d + 1) + 2 * d + 2
    loss = 2 * d + 3
    return loss + stats + (0 if ftl else 4 * d + 4 + 2 * d)


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
    clock = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(clock.strip()) * 1e6
    print(f"[1 device] {name}; devices={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}; max SM clock "
          f"{SM_CLOCK_HZ / 1e6:.0f} MHz")
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
            if ("registers" in line or "spill" in line
                    or "nvcc seconds" in line):
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
          f"d={z.shape[2]} max_abs_err={err:.3e} (bound 0: bit for bit)")
    check(err == 0.0, f"K1 {label} {z.dtype}: {err} != 0")


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
          f"d={z.shape[2]} max_abs_err={err:.3e} (bound 0: bit for bit) "
          f"switch rounds differing: {tau_diff}")
    check(err == 0.0 and tau_diff == 0, f"K2 {label} {z.dtype}: {err} != 0 "
          f"or {tau_diff} switch rounds differ")


def compare_plays(label, z, y, lengths, *, contract=True):
    """The evaluation's entries: K1 with FTRL and FTL as two plays of one
    copy of z, K2 with two thresholds a sequence, against their plain
    versions on the same tensors, bit for bit."""
    B = z.shape[0]
    replay = not game.in_contract(z, y, lengths)
    check(replay == (not contract), f"plays {label}: contract check")
    got = game.regret_plays(z, y, (0, 1), ETA, lengths, replay)
    flags = torch.tensor([[0] * B, [1] * B], dtype=torch.int32, device="cuda")
    et = game.per_sequence(ETA, B, z.dtype, z.device)
    want = game.regret_plays_reference(z, y, flags, et, lengths,
                                       replay=replay)
    err1 = max_err(got, want)
    root = torch.sqrt(2.0 * lengths.to(z.dtype))
    ths = torch.stack([root, 0.4 * root])
    got = smart.smart_plays(z, y, ths, ETA, lengths, replay)
    want = smart.smart_plays_reference(z, y, ths, et, lengths, replay=replay)
    torch.cuda.synchronize()
    err2 = max_err(got[:3], want[:3])
    tau_diff = int((got[3] != want[3]).sum())
    switched = int((got[3] < z.shape[1]).sum())
    print(f"[3 kernels] plays {label} {z.dtype} B={B} T={z.shape[1]} "
          f"d={z.shape[2]}: K1 (FTRL, FTL) max_abs_err={err1:.3e}, K2 two "
          f"thresholds max_abs_err={err2:.3e} (bound 0: bit for bit), "
          f"switch rounds differing: {tau_diff} ({switched} of {2 * B} "
          f"pairs switched)")
    check(err1 == 0.0 and err2 == 0.0 and tau_diff == 0,
          f"plays {label} {z.dtype}: not bit for bit")


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
        compare_plays("evaluation", z, y, lengths)
        del z, y
        # The unrolled (d = 5), generic (3, 64) and large-d (65) instances,
        # in contract and in replay mode.
        for d in (5, 3, 64, 65):
            for contract in (True, False):
                zs, ys, ls = make_batch(77, 203, d, 2 + d, dtype,
                                        contract=contract)
                mode = "contract" if contract else "replay (out of contract)"
                mixed = torch.arange(77, device="cuda") % 2
                compare_k1(f"mixed flags, {mode}", zs, ys, mixed, ETA, ls,
                           contract=contract)
                compare_k2(f"two thresholds, {mode}", zs, ys,
                           torch.where(mixed == 0, 2.0, 6.5), ETA, ls,
                           contract=contract)
                compare_plays(mode, zs, ys, ls, contract=contract)

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
def time_ms(fn, *, reps: int, inner: int = 1, warm: bool = False):
    """Median and spread (min, max) of CUDA-event milliseconds per call
    (after one warm-up call, unless the caller has just made one:
    ``warm``)."""
    if not warm:
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


def path_batch(B, seed):
    """f64 rows and labels of ``scripts/k1k2_compare.py`` (seed 90: the
    g(T) launch, 91: the largest case, 92: the parent's chunk), so that the
    digests here equal the ones that script prints for any commit."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return random_game_batch(gen, B, 1000, D, dtype=torch.float64)


def path_lengths(runs, reps):
    """A case's horizons as the evaluation stacks them: run, then horizon,
    then replicate."""
    return torch.tensor(T_GRID, dtype=torch.int32, device="cuda"
                        ).repeat_interleave(reps).repeat(runs)


def k1_bound(lengths, plays: int, dtype):
    """K1's least time: each valid row and label read once, the flags,
    lengths, table row index and the one-row table, the outputs written
    once; the rounds' operations, w once a sequence."""
    rows = float(lengths.double().sum())
    B, s = lengths.shape[0], 8 if dtype == torch.float64 else 4
    n_bytes = (rows * (D + 1) * s + B * 8 + plays * B * 4 + T_GRID[-1] * s
               + plays * B * (2 + D) * s)
    ops = rows * (plays * hinge_round_ops(D, with_w=False) + 2 * D)
    return bound(n_bytes, ops, dtype)


def k2_bound(lengths, tau, dtype):
    """K2's least time from the run's switch rounds tau (G, B): every valid
    row once through the FTL track (9d + 9), the switch test on the rows up
    to the last threshold's switch (2d + 3 + G), each pair's tail rounds
    (7d + 7); the inputs read once and the outputs written once."""
    G, B = tau.shape
    T = T_GRID[-1]
    s = 8 if dtype == torch.float64 else 4
    L = lengths.long()
    rows = float(L.sum())
    open_rows = float(torch.minimum(tau.max(0).values + 1, L).sum())
    tail = float(torch.clamp(L[None] - tau - 1, min=0).sum())
    n_bytes = (rows * (D + 1) * s + B * 8 + G * B * s + T * s
               + G * B * (1 + D) * s + B * s + G * B * 8)
    ops = (rows * (9 * D + 9) + open_rows * (2 * D + 3 + G)
           + tail * hinge_round_ops(D, with_w=False))
    return bound(n_bytes, ops, dtype)


def time_kernels():
    """K1 and K2 at the main path's shapes, f64: the g(T) launch (10
    horizons x 1,000 FTRL runs, horizon after horizon, padded to T =
    1,000) and the largest case's launch ("Massart noise 10%", 9,600
    sequences: K1 with FTRL and FTL as two plays, K2 with the thresholds
    sqrt(2T) and 0.9 sqrt(2T)); the parent's evaluation chunk (2 x 4,096
    sequences, one play or threshold each) for continuity.  Each against
    its plain version (bit for bit), timed, with its bound and the digests
    of its outputs in the doubled layout that ``scripts/k1k2_compare.py``
    prints for every commit."""
    out = {}
    g_len = torch.tensor(T_GRID, dtype=torch.int32, device="cuda"
                         ).repeat_interleave(1000)
    zg, yg = path_batch(g_len.shape[0], 90)
    tab = game.eta_table(ETA, g_len.shape[0], 1000, torch.float64, "cuda")
    fg = torch.zeros((1, g_len.shape[0]), dtype=torch.int32, device="cuda")
    k_ms = time_ms(lambda: game.launch_regrets(zg, yg, fg, *tab, g_len,
                                               False), reps=5, inner=10)
    got = game.launch_regrets(zg, yg, fg, *tab, g_len, False)
    want = game.regret_plays_reference(
        zg, yg, fg, game.per_sequence(ETA, g_len.shape[0], torch.float64,
                                      "cuda"), g_len)
    err = max_err(got, want)
    gb = k1_bound(g_len, 1, torch.float64)
    print(f"[4 main] K1 g(T) launch B={g_len.shape[0]} T=1000 (10 horizons "
          f"x 1,000 FTRL runs) d=5 f64: kernel {k_ms[0]:.4f} ms (min "
          f"{k_ms[1]:.4f}, max {k_ms[2]:.4f}); bound {gb['bound_ms']:.4f} ms "
          f"by {gb['bound_by']}; max_abs_err={err:.3e} (bound 0); digest "
          f"{output_digest([o[0] for o in got])}")
    check(err == 0.0, "K1 at the g(T) launch vs plain")
    del zg, yg, got, want

    lengths = path_lengths(48, 20)
    B = lengths.shape[0]
    z, y = path_batch(B, 91)
    eta = game.per_sequence(ETA, B, torch.float64, "cuda")
    tab = game.eta_table(ETA, B, 1000, torch.float64, "cuda")
    flags = torch.tensor([[0] * B, [1] * B], dtype=torch.int32, device="cuda")
    root = torch.sqrt(2.0 * lengths.double())
    ths = torch.stack([root, 0.9 * root])
    k1 = lambda: game.launch_regrets(z, y, flags, *tab, lengths, False)
    k2 = lambda: smart.launch_smart(z, y, ths, *tab, lengths, False)
    p1 = lambda: game.regret_plays_reference(z, y, flags, eta, lengths)
    p2 = lambda: smart.smart_plays_reference(z, y, ths, eta, lengths)
    w1 = lambda: game.regret_plays(z, y, (0, 1), ETA, lengths, False)
    w2 = lambda: smart.smart_plays(z, y, ths, ETA, lengths, False)
    got1, want1 = k1(), p1()
    got2, want2 = k2(), p2()
    out["K1"] = {"max_abs_err": max_err(got1, want1)}
    out["K2"] = {"max_abs_err": max_err(got2[:3], want2[:3])}
    check(out["K1"]["max_abs_err"] == 0.0 and out["K2"]["max_abs_err"] == 0.0
          and bool(torch.equal(got2[3], want2[3])),
          "K1 or K2 at the main path's shape vs plain")
    out["K1"].update(k1_bound(lengths, 2, torch.float64))
    out["K2"].update(k2_bound(lengths, got2[3], torch.float64))
    for key, (regs, warps) in (
            ("K1", game.regret_occupancy(2, D, torch.float64)),
            ("K2", smart.smart_occupancy(2, D, torch.float64))):
        out[key].update(registers=regs, warps_per_sm=warps)
    dig = {"K1": output_digest((got1[0].reshape(-1), got1[1].reshape(-1),
                         got1[2].reshape(-1, D))),
           "K2": output_digest((got2[0].reshape(-1), got2[1].repeat(2),
                         got2[2].reshape(-1, D), got2[3].reshape(-1)))}
    switched = int((got2[3] < 1000).sum())
    shape = (f"B={B} T=1000 d=5 f64 (the largest case, one launch: two "
             f"plays / two thresholds a sequence)")
    for key, kern, wrap, plain in (("K1", k1, w1, p1), ("K2", k2, w2, p2)):
        k_ms = time_ms(kern, reps=5, inner=10)
        w_ms = time_ms(wrap, reps=5)
        p_ms = time_ms(plain, reps=3)
        out[key].update(ms=k_ms[0], plain_ms=p_ms[0], library_ms=None)
        print(f"[4 main] {key} {shape}: kernel {k_ms[0]:.4f} ms "
              f"(min {k_ms[1]:.4f}, max {k_ms[2]:.4f}); wrapper (the scale "
              f"table) {w_ms[0]:.4f} ms; plain PyTorch {p_ms[0]:.2f} ms "
              f"(min {p_ms[1]:.2f}, max {p_ms[2]:.2f}); bound "
              f"{out[key]['bound_ms']:.4f} ms by {out[key]['bound_by']}; "
              f"max_abs_err={out[key]['max_abs_err']:.3e} (bound 0); "
              f"{out[key]['registers']} registers a thread, "
              f"{out[key]['warps_per_sm']} warps an SM; digest {dig[key]}"
              + (f"; {switched} of {2 * B} pairs switched" if key == "K2"
                 else ""))
    del got1, want1, got2, want2

    # The parent's evaluation chunk, one play or threshold a sequence.
    del z, y
    zc, yc = path_batch(4096, 92)
    zc, yc = torch.cat([zc, zc]), torch.cat([yc, yc])
    lc = torch.cat([lengths[:4096], lengths[:4096]])
    fc = (torch.arange(8192, device="cuda") >= 4096).to(torch.int32)[None]
    tc = torch.cat([ths[0, :4096], ths[1, :4096]])[None]
    tab = game.eta_table(ETA, 8192, 1000, torch.float64, "cuda")
    for key, kern in (
            ("K1", lambda: game.launch_regrets(zc, yc, fc, *tab, lc, False)),
            ("K2", lambda: smart.launch_smart(zc, yc, tc, *tab, lc, False))):
        k_ms = time_ms(kern, reps=5, inner=10)
        outs = kern()
        dg = output_digest((outs[0][0], outs[1][0] if key == "K1" else outs[1],
                     outs[2][0]) + ((outs[3][0],) if key == "K2" else ()))
        print(f"[4 main] {key} B=8192 T=1000 d=5 f64 (the parent's "
              f"evaluation chunk, for continuity): kernel {k_ms[0]:.4f} ms "
              f"(min {k_ms[1]:.4f}, max {k_ms[2]:.4f}); digest {dg}")
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
    check(launches == {"K1": 5, "K2": 4},
          f"main path launched K1 and K2 {launches} times, not 5 and 4 (one "
          f"g(T) launch, one a case)")
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
    smart.SWEEP_TAIL_LAUNCHES = 0
    game.LAUNCHES = 0
    out = {}
    for dtype, (z, y, lengths) in batches.items():
        eta_reg = ftrl_eta_sweep(z, y, ETA_GRID, length=lengths)
        ftl_reg = ftrl_eta_sweep(z, y, ETA_GRID, alg_flag=1, length=lengths)
        thr_reg = smart_threshold_sweep(z, y, THRESH_GRID, eta0=ETA,
                                        length=lengths)
        out[dtype] = (eta_reg, ftl_reg, thr_reg)
    torch.cuda.synchronize()
    launches = {"K5": game.SWEEP_LAUNCHES, "K6a": smart.SWEEP_LAUNCHES,
                "K6b": smart.SWEEP_TAIL_LAUNCHES,
                "K1 (FTL sweep)": game.LAUNCHES}
    print(f"[6 sweeps] ftrl_eta_sweep (E={len(ETA_GRID)}), FTL sweep and "
          f"smart_threshold_sweep (G={len(THRESH_GRID)}) at B={SWEEP_B} "
          f"T={SWEEP_T} d={D}, f64 and f32: launches {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()),
          f"sweep path did not launch K5, K6a, K6b and K1: {launches}")
    for dtype, (eta_reg, ftl_reg, thr_reg) in out.items():
        check(eta_reg.shape == ftl_reg.shape == (SWEEP_B, len(ETA_GRID))
              and thr_reg.shape == (SWEEP_B, len(THRESH_GRID))
              and all(bool(torch.isfinite(r).all())
                      for r in (eta_reg, ftl_reg, thr_reg)),
              f"sweep outputs in {dtype}: wrong shape or not finite")
        check(bool((ftl_reg == ftl_reg[:, :1]).all()),
              "FTL sweep columns differ")
    return out, launches


def smart_sweep_counts(tau, lengths):
    """What K6's inputs need, from the run's switch rounds tau (B, G): the
    rows on which K6a evaluates the lead (up to the last threshold's
    switch, or the whole sequence), the switched pairs with a tail and
    their tail rounds, and the rows the tails read (from each sequence's
    earliest tail)."""
    ln = lengths.to(torch.int64)[:, None]
    fired = tau < SWEEP_T
    lead_rows = torch.where(fired.all(dim=1), tau.max(dim=1).values + 1,
                            ln[:, 0])
    tail = tau + 1 < ln
    tail_rounds = torch.where(tail, ln - tau - 1, 0)
    first = torch.where(tail, tau + 1, ln).min(dim=1).values
    return {"lead_rows": float(lead_rows.double().sum()),
            "tail_pairs": int(tail.sum()),
            "tail_rounds": float(tail_rounds.double().sum()),
            "tail_rows": float((ln[:, 0] - first).double().sum()),
            "switched": float(fired.double().mean())}


def sweep_vs_plain(batches, outs):
    """K5, K6 (and K6a, K6b apart) and the FTL sweep's K1 against their
    plain versions on the same CUDA tensors, at the sweep path's shapes;
    the outputs' digests and what K6's inputs need."""
    res = {}
    for dtype, (z, y, lengths) in batches.items():
        eta_reg, ftl_reg, thr_reg = outs[dtype]
        grid = ETA_GRID.to("cuda", dtype)
        ths = THRESH_GRID.to("cuda", dtype)
        eta = torch.tensor(ETA, dtype=dtype, device="cuda")
        want, p5 = timed_once(lambda: game.eta_sweep_reference(z, y, grid,
                                                               lengths))
        e5 = max_err((eta_reg,), (want,))
        del want
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
            z, y, ths, eta, lengths))
        e6 = max_err((got,), (want,))
        tau_diff = int((tau != want_tau).sum())
        del want
        # K6a and K6b apart, each against its part of the split mirror.
        order = game.length_order(lengths)
        ordered, perm = torch.sort(ths, stable=True)
        perm = perm.to(torch.int32)
        part, tau_a, comp = smart.launch_smart_prefix(
            z, y, ordered, perm, order, lengths, False)
        (want_part, want_tau_a, want_comp), p6a = timed_once(
            lambda: smart.smart_prefix_reference(z, y, ths, lengths))
        e6a = max_err((part.t(), comp), (want_part, want_comp))
        tau_diff += int((tau_a.t() != want_tau_a).sum())
        scales = game.sweep_scales(eta.reshape(1), SWEEP_T)
        tails = part.clone()
        smart.launch_smart_tails(z, y, scales, order, lengths, tau_a, comp,
                                 tails)
        want_tails, p6b = timed_once(lambda: smart.smart_tails_reference(
            z, y, scales[0], lengths, want_tau_a, want_part, want_comp))
        e6b = max_err((tails.t(),), (want_tails,))
        del want_part, want_tails, part, tails
        counts = smart_sweep_counts(tau, lengths)
        digests = {"K5": output_digest((eta_reg,)),
                   "K6": output_digest((thr_reg, tau))}
        print(f"[6 sweeps] {dtype}: K5 vs plain max_abs_err={e5:.3e}, K6 vs "
              f"plain max_abs_err={e6:.3e}, K6a vs its plain part "
              f"{e6a:.3e}, K6b vs its plain part {e6b:.3e} (bound "
              f"{TOL[dtype]:g}), switch rounds differing: {tau_diff} (share "
              f"switched {counts['switched']:.3f}; {counts['tail_pairs']} "
              f"pairs with a tail, {counts['tail_rounds']:.0f} tail rounds, "
              f"{counts['lead_rows']:.0f} rows with the lead); digests "
              f"{json.dumps(digests)}; plain PyTorch {p5:.1f} ms (K5's), "
              f"{p6:.1f} ms (K6's), {p6a:.1f} + {p6b:.1f} ms (the split "
              f"mirror's parts)")
        check(max(e5, e6, e6a, e6b) <= TOL[dtype],
              f"sweep kernels vs plain in {dtype}")
        if dtype == torch.float64:
            check(tau_diff == 0, "K6 switch rounds differ from plain")
        res[dtype] = {"K5": (e5, p5), "K6a": (e6a, p6a), "K6b": (e6b, p6b),
                      "K6": (e6, p6), "counts": counts}
    return res


def sweep_instances():
    """K5 and K6 at every kernel instance but d = 5's (d = 3 and 64: the
    generic one, staged; d = 65: the large-d one, rows from global memory)
    at B=77 T=203 (no multiple of 32 or of a stage's chunk), E=11 and G=13
    (no multiple of a block's 8 warps), against their plain versions."""
    for dtype in (torch.float64, torch.float32):
        for d in (3, 64, 65):
            z, y, lengths = make_batch(77, 203, d, 70 + d, dtype)
            grid = torch.linspace(0.05, 4.0, 11, dtype=dtype, device="cuda")
            ths = torch.tensor([6.0, 1.0, 1e9, 2.5, -1e9, 2.5, 0.7, 10.0,
                                3.7, 1.8, 4.4, 0.2, 14.0], dtype=dtype,
                               device="cuda")
            got5 = game.eta_sweep(z, y, grid, lengths)
            got6, tau = smart.smart_sweep(z, y, ths, ETA, lengths)
            want5 = game.eta_sweep_reference(z, y, grid, lengths)
            want6, want_tau = smart.smart_sweep_reference(
                z, y, ths, torch.tensor(ETA, dtype=dtype, device="cuda"),
                lengths)
            err = max_err((got5, got6), (want5, want6))
            tau_diff = int((tau != want_tau).sum())
            print(f"[6 sweeps] K5/K6 B=77 T=203 d={d} {dtype} E=11 G=13 vs "
                  f"plain: max_abs_err={err:.3e} (bound {TOL[dtype]:g}), "
                  f"switch rounds differing: {tau_diff}")
            check(err <= TOL[dtype], f"K5/K6 at d={d} {dtype} vs plain")
            if dtype == torch.float64:
                check(tau_diff == 0, f"K6 switch rounds at d={d}")


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


def sweep_bounds(key, lengths, counts, dtype):
    """Bound and operation count of K5, K6a or K6b at phase 6's inputs,
    counting what they need: the rows once, K5's FTRL round per (row,
    setting) without w and w once per row, K6a's FTL round once per row
    (the action once, w, F, cnt: 9d + 9) and the lead (2d + 3) on the rows
    before the last threshold's switch, K6b's FTRL round per tail round."""
    item = 8 if dtype == torch.float64 else 4
    rows = float(lengths.double().sum())
    row_bytes = rows * (D + 1) * item
    E, G = len(ETA_GRID), len(THRESH_GRID)
    if key == "K5":
        ops = rows * (E * hinge_round_ops(D, with_w=False) + 2 * D)
        n_bytes = row_bytes + SWEEP_B * 4 + E * SWEEP_B * item
    elif key == "K6a":
        ops = rows * (9 * D + 9) + counts["lead_rows"] * (2 * D + 3)
        n_bytes = (row_bytes + SWEEP_B * 4 + G * item
                   + G * SWEEP_B * (8 + item) + SWEEP_B * item)
    else:
        ops = counts["tail_rounds"] * hinge_round_ops(D, with_w=False)
        n_bytes = (counts["tail_rows"] * (D + 1) * item + SWEEP_B * 4
                   + G * SWEEP_B * 8 + SWEEP_B * item
                   + counts["tail_pairs"] * 2 * item)
    return ops, bound(n_bytes, ops, dtype)


def phase_sweeps():
    batches = {dtype: sweep_batch(dtype, 60) for dtype in
               (torch.float64, torch.float32)}
    outs, launches = sweep_main_path(batches)
    plain = sweep_vs_plain(batches, outs)
    sweep_instances()
    sweep_vs_one_shot(*batches[torch.float64])
    sweep_golden()
    sweep_replay()
    timing = {}
    for dtype, (z, y, lengths) in batches.items():
        grid = ETA_GRID.to("cuda", dtype)
        ths = THRESH_GRID.to("cuda", dtype)
        scales5 = game.sweep_scales(grid, SWEEP_T)
        scales6 = game.sweep_scales(
            torch.full((1,), ETA, dtype=dtype, device="cuda"), SWEEP_T)
        order = game.length_order(lengths)
        ordered, perm = torch.sort(ths, stable=True)
        perm = perm.to(torch.int32)
        prefix = lambda: smart.launch_smart_prefix(z, y, ordered, perm, order,
                                                   lengths, False)
        part, tau, comp = prefix()
        # K6b turns its buffer into regrets in place: every timed launch
        # plays the same tails (their starting sums drift, not their work).
        buf = part.clone()
        tails = lambda: smart.launch_smart_tails(z, y, scales6, order,
                                                 lengths, tau, comp, buf)
        both = lambda: (prefix(), tails())
        sweep5 = lambda: ftrl_eta_sweep(z, y, ETA_GRID, length=lengths)
        sweep6 = lambda: smart_threshold_sweep(z, y, THRESH_GRID, eta0=ETA,
                                               length=lengths)
        cases = (("K5", lambda: game.launch_eta_sweep(
                      z, y, scales5, order, lengths, False), sweep5),
                 ("K6a", prefix, None), ("K6b", tails, None),
                 ("K6", both, sweep6))
        counts = plain[dtype]["counts"]
        for key, kern, wrap in cases:
            k_ms = time_ms(kern, reps=5, inner=2)
            err, p_ms = plain[dtype][key]
            line = (f"[6 sweeps] {key} B={SWEEP_B} T={SWEEP_T} d={D} "
                    f"{dtype}: kernel {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}, "
                    f"max {k_ms[2]:.4f})")
            if wrap is not None:
                steps = SWEEP_B * float(lengths.double().mean()) * (
                    len(ETA_GRID) if key == "K5" else len(THRESH_GRID))
                w_ms = time_ms(wrap, reps=3)
                line += (f"; {steps / k_ms[0] * 1e3:.4g} "
                         f"sequence-setting-steps/s; wrapper {w_ms[0]:.4f} "
                         f"ms (min {w_ms[1]:.4f}, max {w_ms[2]:.4f})")
            if key != "K6":
                ops, bnd = sweep_bounds(key, lengths, counts, dtype)
                issue = ops / (FP64_ISSUE_PER_S if dtype == torch.float64
                               else FP32_ISSUE_PER_S) * 1e3
                line += (f"; bound {bnd['bound_ms']:.4f} ms by "
                         f"{bnd['bound_by']}, {ops:.4g} operations; "
                         f"--fmad=false issue floor {issue:.4f} ms")
                if dtype == torch.float64:
                    timing[key] = {"max_abs_err": err, "ms": k_ms[0],
                                   "plain_ms": p_ms, "library_ms": None,
                                   **bnd}
            print(line + f"; plain PyTorch {p_ms:.1f} ms (one call)")
        del part, tau, comp, buf
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
        tab = game.eta_table(ETA, BIG_B, BIG_T, dtype, "cuda")

        def k1():
            out = game.launch_regrets(z, y, flags[None], *tab, lengths,
                                      False)
            return tuple(o[0] for o in out)

        def k2():
            cum, comp, x_last, _ = smart.launch_smart(z, y, thr[None], *tab,
                                                      lengths, False)
            return cum[0], comp, x_last[0]
        cases = (
            ("K1", k1,
             lambda: game.regrets_fused_reference(z, y, flags, eta, lengths)),
            ("K2", k2,
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


def output_digest(outs) -> str:
    """sha256 of the outputs' bytes, in order (first 16 hex digits)."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def per_call_study(cfg, dtype):
    """The study's statistics with one simulate_quadratic_batch call per
    (run, horizon), as the JAX package makes them."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    reps, T_max = cfg.replicates, max(cfg.T_grid)
    flags = torch.tensor([0] * reps + [1] * reps, dtype=torch.int32)
    by_T = {k: np.empty((cfg.runs, len(cfg.T_grid), reps))
            for k in ("FTRL", "FTL (exact LS)")}
    batches = horizon_batches(cfg.T_grid, runs=cfg.runs, replicates=reps,
                              dtype=dtype)
    for i, (z, y) in enumerate(batches):
        run, ti = divmod(i, len(cfg.T_grid))
        z2 = np.zeros((2 * reps, T_max, z.shape[2]), z.dtype)
        y2 = np.zeros((2 * reps, T_max), y.dtype)
        z2[:reps, :z.shape[1]] = z2[reps:, :z.shape[1]] = z
        y2[:reps, :y.shape[1]] = y2[reps:, :y.shape[1]] = y
        reg = simulate_quadratic_batch(
            torch.as_tensor(z2, dtype=tdtype, device="cuda"),
            torch.as_tensor(y2, dtype=tdtype, device="cuda"), flags,
            1.0).regret.double().cpu().numpy()
        by_T["FTRL"][run, ti] = reg[:reps]
        by_T["FTL (exact LS)"][run, ti] = reg[reps:]
    return quadratic_stats(by_T)


def quad_study(tmp):
    """(a) the study at its default config on the card (f32): one K8
    launch; (b) its f32 and f64 statistics equal to a call per (run,
    horizon); its f64 statistics on cuda and on cpu within 1e-9; (c) the
    study's launch timed, with a digest of K8's outputs there."""
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
          f"wall {res['wall_s']:.4f} s, K8 launches {launches}; regret at "
          f"T={cfg.t_max}: FTL {ftl[-1]:.4f}, FTRL {ftrl[-1]:.4f}")
    check(launches == 1, "the quadratic study did not make one K8 launch")
    check(all(math.isfinite(v) for v in ftl + ftrl) and ftl[-1] < ftrl[-1],
          "quadratic study results not finite, or FTL not below FTRL")
    stats = {}
    for dtype in (np.float32, np.float64):
        t0 = time.perf_counter()
        one = evaluate_quadratic_stream(cfg.T_grid, runs=cfg.runs,
                                        replicates=cfg.replicates,
                                        dtype=dtype, device="cuda")
        t1 = time.perf_counter()
        many = per_call_study(cfg, dtype)
        t2 = time.perf_counter()
        same = all(np.array_equal(a, b) for k in one
                   for a, b in zip(one[k], many[k]))
        print(f"[9 quadratic] evaluate_quadratic_stream {np.dtype(dtype)} "
              f"--device cuda, one call {t1 - t0:.4f} s against a call per "
              f"(run, horizon) {t2 - t1:.4f} s: statistics equal in every "
              f"bit {same}")
        check(same, f"the study's single call differs from a call per "
                    f"(run, horizon) in {np.dtype(dtype)}")
        stats["cuda"] = one
    t0 = time.perf_counter()
    stats["cpu"] = evaluate_quadratic_stream(
        cfg.T_grid, runs=cfg.runs, replicates=cfg.replicates,
        dtype=np.float64, device="cpu")
    print(f"[9 quadratic] evaluate_quadratic_stream f64 --device cpu: "
          f"{time.perf_counter() - t0:.2f} s")
    err = max(float(np.abs(a - b).max())
              for k in stats["cuda"]
              for a, b in zip(stats["cuda"][k], stats["cpu"][k]))
    print(f"[9 quadratic] f64 study, max |cuda - cpu| over every mean and CI "
          f"= {err:.3e} (bound {PARITY_TOL:g})")
    check(err <= PARITY_TOL, "f64 quadratic study differs between devices")
    z, y, flags = study_batch(cfg.T_grid, runs=cfg.runs,
                              replicates=cfg.replicates, device="cuda")
    z_tm, y_tm = game.time_major(z, y)
    eta = game.per_sequence(1.0, z.shape[0], z.dtype, "cuda")
    outs = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
    k_ms = time_ms(lambda: trs.launch_quadratic_regrets(z_tm, y_tm, flags,
                                                        eta), reps=3)
    print(f"[9 quadratic] K8 at the study's launch (B={z.shape[0]} "
          f"T={z.shape[1]} d={cfg.d} f32): kernel {k_ms[0]:.4f} ms (min "
          f"{k_ms[1]:.4f}, max {k_ms[2]:.4f}); digest of (cum, comp, x_c, "
          f"x_last) {output_digest(outs)}")
    k8_widths("study launch", z_tm, y_tm, flags, eta, outs)
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


K8_WIDTHS = (32, 16, 8, 4, 2, 1)


def k8_widths(label, z_tm, y_tm, flags, eta, want):
    """K8 with 32 down to 1 FTL sequences a warp: each launch's outputs
    equal ``want`` in every bit, and its time."""
    times = []
    for w in K8_WIDTHS:
        got = trs.launch_quadratic_regrets(z_tm, y_tm, flags, eta, w)
        check(all(torch.equal(g, h) for g, h in zip(got, want)),
              f"K8 at {w} FTL sequences a warp differs ({label})")
        times.append(time_ms(lambda: trs.launch_quadratic_regrets(
            z_tm, y_tm, flags, eta, w), reps=3)[0])
    choice = trs.ftl_width(flags.numel(), flags.device)
    print(f"[9 quadratic] K8 {label} by FTL sequences a warp (outputs equal "
          f"in every bit): " + ", ".join(
              f"{w}: {t:.4f} ms" for w, t in zip(K8_WIDTHS, times))
          + f"; the wrapper's choice {choice}")


def newton_counts(A_pre, b_pre, A_fin, b_fin, flags):
    """Ridge solves a solve needs on these inputs (the plain mirror of the
    kernels' exit, run on the card): ``(T, B)`` for every prefix and
    ``(B,)`` for the final statistics; with the per-lane and warp-max
    totals of K8's FTL lanes printed against the fixed count's."""
    T, B, d = b_pre.shape
    rows, cols = trs.tri_index(d)
    _, passes = trs.trs_action_settled(
        [A_pre[..., i, j] for i, j in zip(rows, cols)],
        [b_pre[..., i] for i in range(d)])
    _, final = trs.trs_action_settled(
        [A_fin[..., i, j] for i, j in zip(rows, cols)],
        [b_fin[..., i] for i in range(d)])
    iters = trs.TRS_PARAMS[b_pre.dtype][1]
    lanes = trs.quad_lanes(flags, trs.ftl_width(B, flags.device)).long()
    per_seq = passes.sum(0)
    lane_tot = torch.where(lanes >= 0, per_seq[lanes.clamp(min=0)], 0)
    ftl_lane = torch.where(lanes >= 0, flags[lanes.clamp(min=0)] != 0,
                           False)
    warps = ftl_lane.view(-1, trs.WARP).any(1)
    warp_max = lane_tot.view(-1, trs.WARP).max(1).values[warps].double()
    ftl = passes[:, flags != 0].double()
    lockstep = ftl.view(T, -1, trs.WARP).max(2).values.sum(0)
    tot = lane_tot[ftl_lane].double()
    print(f"[9 quadratic] Newton exit {b_pre.dtype}, FTL rounds: "
          f"{float(ftl.mean()):.4f} ridge solves a solve on average "
          f"(fixed count {iters + 1}), "
          f"{float((ftl == iters + 1).double().mean()):.4%} "
          f"at the cap; per FTL lane over T={T}: min {int(tot.min())}, mean "
          f"{float(tot.mean()):.1f}, max {int(tot.max())}; warp max: mean "
          f"{float(warp_max.mean()):.1f}, max {int(warp_max.max())} over "
          f"{warp_max.numel()} warps of {trs.ftl_width(B, flags.device)} "
          f"(fixed count {T * (iters + 1)}); round "
          f"by round in lockstep (the sum of each round's warp max over "
          f"32 lanes) {float(lockstep.mean()):.1f}")
    return passes, final


def quad_kernels(dtype):
    """(c) K8 at the bench shape against its plain version, with a digest
    of its outputs; (d) K9 on all B * T prefix statistics through
    ball_ls_action against trs_solve_reference; (e) K8's x_c against K9 on
    the final statistics, bit for bit; (f) the solves' Newton passes on
    these inputs, times and bounds."""
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
          f"{float(res.regret[flags == 0].double().mean()):.4f}; digest "
          f"{output_digest(got)}")
    check(e8 <= TOL[dtype], f"K8 {dtype} vs plain")
    A_pre, b_pre, A_fin, b_fin = prefix_statistics(z, y)
    A_all = A_pre.reshape(-1, D, D)
    b_all = b_pre.reshape(-1, D)
    trs.TRS_LAUNCHES = 0
    x9 = ball_ls_action(A_pre, b_pre)
    torch.cuda.synchronize()
    launches = trs.TRS_LAUNCHES
    want9, p9 = timed_once(lambda: trs.trs_solve_reference(A_all, b_all))
    x9 = x9.reshape(-1, D)
    e9 = max_err((x9,), (want9,))
    same9 = bool(torch.equal(x9, want9))
    n = A_all.shape[0]
    size = (A_all.numel() + b_all.numel()) * A_all.element_size()
    print(f"[9 quadratic] ball_ls_action (K9) on all {n} prefix statistics "
          f"({size / 1e6:.1f} MB of input) {dtype}: launches {launches}; vs "
          f"plain max_abs_err={e9:.3e} (bound {TOL[dtype]:g}), equal in "
          f"every bit {same9}; max ||x|| "
          f"{float(torch.linalg.vector_norm(x9, dim=-1).max()):.9f}")
    check(launches > 0, "ball_ls_action did not launch K9")
    check(e9 <= TOL[dtype] and same9, f"K9 {dtype} vs plain")
    perm = torch.randperm(n, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(93))
    shuffled = trs.trs_solve(A_all[perm], b_all[perm])
    check(bool(torch.equal(shuffled, x9[perm])),
          f"K9 {dtype} on a permuted batch is not the permuted output")
    print(f"[9 quadratic] K9 {dtype} on the {n} prefixes in a random order: "
          f"the permuted output in every bit")
    xc9 = trs.trs_solve(A_fin, b_fin)
    diff = int((got[2].t() != xc9).sum())
    print(f"[9 quadratic] {dtype}: K8's x_c vs K9 on the final statistics: "
          f"{diff} values differ in any bit")
    check(diff == 0, f"K8's x_c differs from K9 in {dtype}")
    del want, want9, x9, shuffled, perm
    k9 = time_ms(lambda: trs.launch_trs_solve(A_all, b_all), reps=5)
    passes, final = newton_counts(A_pre, b_pre, A_fin, b_fin, flags)
    del A_pre, b_pre, A_all, b_all
    torch.cuda.empty_cache()
    iters = trs.TRS_PARAMS[dtype][1]
    k8 = time_ms(lambda: trs.launch_quadratic_regrets(z_tm, y_tm, flags,
                                                      eta), reps=3)
    w8 = time_ms(lambda: simulate_quadratic_batch(z, y, flags, eta), reps=3)
    print(f"[9 quadratic] K8 {dtype}: kernel {k8[0]:.4f} ms (min "
          f"{k8[1]:.4f}, max {k8[2]:.4f}); wrapper {w8[0]:.4f} ms; plain "
          f"PyTorch {p8:.1f} ms (one call)")
    k8_widths(f"B={QUAD_B} T={QUAD_T} {dtype}", z_tm, y_tm, flags, eta, got)
    # 32 FTL sequences alone, in one warp and in a warp each: the chain's
    # time a Newton pass, with and without the hand-over's divergence.
    ftl32 = torch.ones(trs.WARP, dtype=torch.int32, device="cuda")
    one = slice(QUAD_B - trs.WARP, QUAD_B)
    z1, y1 = z_tm[..., one].contiguous(), y_tm[:, one].contiguous()
    worst = int(passes[:, one].sum(0).max())
    for w in (trs.WARP, 1):
        k1 = time_ms(lambda: trs.launch_quadratic_regrets(
            z1, y1, ftl32, eta[one], w), reps=3)
        print(f"[9 quadratic] K8 {dtype}, the last 32 FTL sequences alone, "
              f"{w} a warp: {k1[0]:.4f} ms for the slowest lane's {worst} "
              f"Newton passes: {k1[0] * 1e3 / worst:.4f} us a pass, "
              f"{k1[0] * 1e-3 / worst * SM_CLOCK_HZ:.0f} clocks at "
              f"{SM_CLOCK_HZ / 1e6:.0f} MHz, {k1[0] * 1e3 / QUAD_T:.3f} us a "
              f"round")
    regs, warps = trs.trs_occupancy(D, dtype)
    floor = k9_schedule(dtype, passes.reshape(-1), warps)
    print(f"[9 quadratic] K9 {dtype}: kernel {k9[0]:.4f} ms (min "
          f"{k9[1]:.4f}, max {k9[2]:.4f}); --fmad=false issue floor "
          f"{floor:.4f} ms; {regs} registers a thread, {warps} warps an SM; "
          f"plain PyTorch {p9:.1f} ms (one call)")
    out = {}
    if dtype == torch.float32:
        steps = QUAD_B * QUAD_T
        ftl = flags != 0
        ops8 = (int(ftl.sum()) * QUAD_T * quad_round_ops(D, True)
                + int((~ftl).sum()) * QUAD_T * quad_round_ops(D, False)
                + trs_ops(D, passes[:, ftl], iters)
                + trs_ops(D, final, iters) + QUAD_B * (2 * D * D + 2 * D + 4))
        bytes8 = steps * (D + 1) * 4 + QUAD_B * (8 + 4 * (2 + 2 * D))
        out["K8"] = {"max_abs_err": e8, "ms": k8[0], "plain_ms": p8,
                     "library_ms": None, **bound(bytes8, ops8, dtype)}
        out["K9"] = {"max_abs_err": e9, "ms": k9[0], "plain_ms": p9,
                     "library_ms": None,
                     **bound(size + n * D * 4, trs_ops(D, passes, iters),
                             dtype),
                     "registers": regs, "warps_per_sm": warps}
        print(f"[9 quadratic] K8 {dtype} bound {out['K8']['bound_ms']:.4f} "
              f"ms by {out['K8']['bound_by']} ({ops8:.4g} operations, each "
              f"solve at its own Newton passes); K9 bound "
              f"{out['K9']['bound_ms']:.4f} ms by {out['K9']['bound_by']}")
    return launches, out


@functools.lru_cache(maxsize=None)
def k9_sass():
    """``scripts/sass_census.py`` and its parse of K9's functions in this
    build's SASS (cuobjdump of the library, ~13 s, read once)."""
    spec = importlib.util.spec_from_file_location(
        "sass_census", os.path.join(REPO, "scripts", "sass_census.py"))
    census = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(census)
    text = census.read_sass(None, cuda_build.LIB_PATH)
    parts = [part for part in text.split("Function : ")[1:]
             if "trs_refill_kernel" in part.split("\n", 1)[0]]
    return census, census.functions(
        "".join("\n\tFunction : " + part for part in parts))


def k9_schedule(dtype, passes, warps_per_sm):
    """K9's schedule on these inputs: the mean passes a solve against the
    warp max of one problem a thread (the parent's K9: warps of 32
    neighbouring prefixes), the loop passes of the refill schedule's model
    (``trs.refill_iterations``) on the persistent grid, and the
    ``--fmad=false`` issue floor: the instructions of a Newton pass, of a
    pass at the cap and of the rest of the loop (``scripts/sass_census.py``
    on this build's SASS), each solve at its own passes with every lane of
    a warp busy, over 4 warp-instructions a clock on each SM.  Returns the
    floor in ms."""
    n = passes.numel()
    iters = trs.TRS_PARAMS[dtype][1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_warps = min(sms * warps_per_sm,
                     -(-n // trs.K9_THREADS) * trs.K9_THREADS // trs.WARP)
    mean = float(passes.double().mean())
    lockstep = passes.view(-1, trs.WARP).max(1).values.double().mean()
    loops = trs.refill_iterations(passes, grid_warps)
    print(f"[9 quadratic] K9 {dtype} schedule: {mean:.4f} ridge solves a "
          f"solve on average; one problem a thread, a warp of "
          f"32 neighbouring prefixes takes its slowest lane's "
          f"{float(lockstep):.4f} (mean warp max); the refill model on "
          f"{grid_warps} warps: {float(loops.sum()) * trs.WARP / n:.4f} lane "
          f"passes a problem, {int(loops.min())}..{int(loops.max())} loop "
          f"passes a warp")
    key = ("trs_refill_kernelIfLi5E" if dtype == torch.float32
           else "trs_refill_kernelIdLi5E")
    t0 = time.perf_counter()
    census, sass = k9_sass()
    read_s = time.perf_counter() - t0
    split = census.k9_split(next(v for k, v in sass.items() if key in k))
    capped = passes == iters + 1
    full = int(torch.where(capped, iters, passes).sum())
    warp_ins = (full * split["pass"] + int(capped.sum()) * split["last"]
                + n * split["handover"]) / trs.WARP
    floor = warp_ins / (sms * 4 * SM_CLOCK_HZ) * 1e3
    print(f"[9 quadratic] K9 {dtype} SASS fast path: {split['pass']} "
          f"instructions a Newton pass, {split['last']} a pass at the cap, "
          f"{split['handover']} the rest of the loop (ballot, claim, "
          f"hand-over); at these inputs' passes {warp_ins:.4g} "
          f"warp-instructions, --fmad=false issue floor {floor:.4f} ms "
          f"({sms} SMs x 4 a clock at {SM_CLOCK_HZ / 1e6:.0f} MHz; SASS "
          f"read in {read_s:.1f} s)")
    return floor


def k9_generic():
    """K9's generic instance (local-memory state) at d = 7 and 32 against
    its plain version, bit for bit, on regression streams' prefixes (N
    not a multiple of 32)."""
    for d in (7, 32):
        for dtype in (torch.float64, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(94)
            z, y, _ = regression_stream_batch(gen, 16, 257, d, dtype=dtype)
            A_pre, b_pre, _, _ = prefix_statistics(z, y)
            A, b = A_pre.reshape(-1, d, d), b_pre.reshape(-1, d)
            got = trs.trs_solve(A, b)
            same = bool(torch.equal(got, trs.trs_solve_reference(A, b)))
            print(f"[9 quadratic] K9 generic instance d={d} {dtype}, "
                  f"{A.shape[0]} prefixes: equal to its plain version in "
                  f"every bit {same}")
            check(same, f"K9 d={d} {dtype} vs plain")


def phase_quadratic(tmp):
    k8_launches = quad_study(tmp)
    timing = {}
    for dtype in (torch.float64, torch.float32):
        k9_launches, out = quad_kernels(dtype)
        timing.update(out)
    k9_generic()
    return {"K8": k8_launches, "K9": k9_launches}, timing


# --------------------------------------------------------------- phase 10
POD_T, POD_SEQS, POD_LANES = 1000, 1 << 20, 16_384
K7_LANES, K7_BIG_D, K7_ODD_T = 1024, 256, 2500


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
    for alg in (0, 1):
        got = game.synthetic_regrets(13, ETA, T=K7_ODD_T, lane_batch=20,
                                     alg_flag=alg)
        want = game.synthetic_regrets_reference(
            13, ETA, T=K7_ODD_T, lane_batch=20, alg_flag=alg, device="cuda")
        print(f"[10 pod] K7 {'FTL' if alg else 'FTRL'} T={K7_ODD_T} (the "
              f"scale table's chunks: 2 full, 1 partial) lane_batch 20 (a "
              f"block partly past B): vs plain {int((got != want).sum())} "
              f"differ in any bit")
        check(torch.equal(got, want), "K7 differs from plain past a chunk")
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


# --------------------------------------------------------------- phase 11
EXACT_B, EXACT_T = 16, 1000
EXACT_FIXED, EXACT_ITERS, EXACT_TOL = 2000, 6000, 2e-4
RANDOM_FAMILIES = ("Random i.i.d. (separable)", "Massart noise 10%")
F32_UNIT = 2.0 ** -24


def admm_ops(B: int, T: int, d: int, iters: int) -> int:
    """K10's operations for ``iters`` iterations of all B*T rows.  Per
    active (row, t) entry 4d + 13: the prediction <x, z_t> (2d - 1), r, the
    over-relaxation (3), r^ + u, the soft threshold (abs, minus kappa,
    clamp, sign, product: 5), the u update (2), the next rhs term (2) and
    its d products and sums (2d).  Per row 2d^2 + 12d + 1: the rhs (2d),
    the two substitutions (2d^2) and the projection (10d + 1).  Row p has
    p + 1 active entries."""
    per_entry = 4 * d + 13
    per_row = 2 * d * d + 12 * d + 1
    return iters * B * (per_entry * T * (T + 1) // 2 + per_row * T)


def exact_batch(B, T, d, seed):
    """Contract data on the card (rows in the unit ball, labels
    sign(<z, u> + 0.3 noise)), float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, T, d), generator=g, device="cuda", dtype=torch.float64)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1.0)
    u = torch.randn((B, d), generator=g, device="cuda", dtype=torch.float64)
    noise = torch.randn((B, T), generator=g, device="cuda",
                        dtype=torch.float64)
    y = torch.sign((z * u[:, None, :]).sum(-1) + 0.3 * noise)
    return z.float().contiguous(), y.float().contiguous()


def k10_vs_plain():
    """(a) K10 against its plain version at 300 fixed iterations: B = 2, T
    = 1000, and B = 1 at T = 1100 and 4096, where rows span up to 8 warps
    (T = 4096 takes the 16-entries-a-lane instance past 2,048); at T =
    1000 and 1100 the continuation and, at 1100, one replicate alone
    against its rows in the batch, bit for bit."""
    worst = 0.0
    for B, T in ((2, EXACT_T), (1, 1100), (1, 4096)):
        z, y = exact_batch(B, T, D, 110 + T)
        X, res, state = admm.admm_all_prefixes_l2(z, y, iters=300, tol=0.0)
        res_p, state_p = admm.admm_all_prefixes_l2_reference(
            z, y, admm.admm_prologue(z), iters=300, tol=0.0,
            check_every=100, rho=1.0, alpha=1.7)
        torch.cuda.synchronize()
        err = max_err(state + (res.reshape(-1),), state_p + (res_p,))
        worst = max(worst, err)
        del state, state_p
        print(f"[11 exact] K10 B={B} T={T} d={D} f32, 300 fixed iterations: "
              f"vs plain (s, u, x, w, v, res) max_abs_err={err:.3e} (bound "
              f"{TOL[torch.float32]:g})")
        check(err <= TOL[torch.float32], f"K10 vs plain at B={B} T={T}")
    for T in (EXACT_T, 1100):
        z, y = exact_batch(2, T, D, 120 + T)
        _, _, st = admm.admm_all_prefixes_l2(z, y, iters=100, tol=0.0)
        Xc, rc, stc = admm.admm_all_prefixes_l2(z, y, iters=150, tol=0.0,
                                                state0=st)
        Xl, rl, stl = admm.admm_all_prefixes_l2(z, y, iters=250, tol=0.0)
        same = (torch.equal(Xc, Xl) and torch.equal(rc, rl)
                and all(torch.equal(a, b) for a, b in zip(stc, stl)))
        print(f"[11 exact] K10 T={T}: 100 + 150 iterations from the saved "
              f"state equal 250 in every bit: {same}")
        check(same, f"K10 continuation at T={T} is not bit for bit")
    X, res, _ = admm.admm_all_prefixes_l2(z, y, iters=EXACT_ITERS,
                                          tol=EXACT_TOL)
    X1, res1, _ = admm.admm_all_prefixes_l2(
        z[1:].contiguous(), y[1:].contiguous(), iters=EXACT_ITERS,
        tol=EXACT_TOL)
    same = torch.equal(X[1:], X1) and torch.equal(res[1:], res1)
    print(f"[11 exact] K10 T=1100 iters={EXACT_ITERS} tol={EXACT_TOL:g}: "
          f"replicate 1 alone equals its rows in the batch in every bit: "
          f"{same}")
    check(same, "K10 replicate subset is not bit for bit")
    return worst


def k10_sliced_route():
    """(a) The kernel route's sliced launch: K10 on z[:, :T] at the route's
    iters and tol equals rows p < T of the launch on z zero-padded to
    T_max = 1000 (what the route launched before), in every bit."""
    z, y = exact_batch(EXACT_B, EXACT_T, D, 112)
    T = 600
    z[:, T:] = 0.0
    y[:, T:] = 0.0
    kw = dict(iters=EXACT_ITERS, tol=EXACT_TOL)
    X, res, st = admm.admm_all_prefixes_l2(z[:, :T].contiguous(),
                                           y[:, :T].contiguous(), **kw)
    Xp, resp, stp = admm.admm_all_prefixes_l2(z, y, **kw)
    same = torch.equal(X, Xp[:, :T]) and torch.equal(res, resp[:, :T])
    for a, ap in zip(st, stp):
        ap = ap.reshape(EXACT_B, EXACT_T, -1)[:, :T]
        if a.shape[-1] == T:
            same = same and bool((ap[..., T:] == 0).all())
            ap = ap[..., :T]
        same = same and torch.equal(a.reshape(EXACT_B, T, -1), ap)
    print(f"[11 exact] K10 B={EXACT_B} route iters/tol: launch on z[:, :{T}] "
          f"equals rows [:{T}] of the launch padded to T={EXACT_T} in every "
          f"bit: {same}")
    check(same, "K10's sliced launch differs from the padded rows")


def k10_path_shape():
    """(b) K10 at the kernel route's shape: times at fixed 2000 iterations
    and at the route's iters / tol; residuals; polished objectives at every
    20th prefix against the plain banded ADMM's."""
    z, y = exact_batch(EXACT_B, EXACT_T, D, 111)
    Lpk = admm.admm_prologue(z)
    kw = dict(tol=0.0, check_every=100, rho=1.0, alpha=1.7)
    fixed = lambda: admm.launch_admm(z, y, Lpk, iters=EXACT_FIXED, **kw)
    res_k, state_k = fixed()
    (res_p, state_p), p_ms = timed_once(
        lambda: admm.admm_all_prefixes_l2_reference(z, y, Lpk,
                                                    iters=EXACT_FIXED, **kw))
    err = max_err(state_k + (res_k,), state_p + (res_p,))
    del state_p, res_p
    k_ms = time_ms(fixed, reps=5)
    route = lambda: admm.admm_all_prefixes_l2(z, y, iters=EXACT_ITERS,
                                              tol=EXACT_TOL)
    r_ms = time_ms(route, reps=5)
    X, res, _ = route()
    worst = float(res.max())
    ops = admm_ops(EXACT_B, EXACT_T, D, EXACT_FIXED)
    n_bytes = 4 * (z.numel() + y.numel() + Lpk.numel()
                   + sum(a.numel() for a in state_k) + res_k.numel())
    regs, warps = admm.kernel_occupancy(EXACT_T, D)[8]
    out = {"max_abs_err": err, "ms": k_ms[0], "plain_ms": p_ms,
           "library_ms": None, **bound(n_bytes, ops, torch.float32),
           "registers": regs, "warps_per_sm": warps}
    # The --fmad=false issue floor is arithmetic, not a measurement: it is
    # printed here and stays out of the kernels line.
    issue_floor_ms = ops / FP32_ISSUE_PER_S * 1e3
    print(f"[11 exact] K10 B={EXACT_B} T={EXACT_T} d={D} f32, {EXACT_FIXED} "
          f"fixed iterations: kernel {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}, "
          f"max {k_ms[2]:.4f}; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}, {ops:.4g} operations; --fmad=false issue "
          f"floor {issue_floor_ms:.4f} ms); {regs} registers a "
          f"thread, {warps} warps an SM (the 8-entries-a-lane instance, "
          f"every row at T={EXACT_T}); vs plain max_abs_err={err:.3e} "
          f"(bound {TOL[torch.float32]:g}); plain PyTorch {p_ms:.1f} ms "
          f"(one call)")
    print(f"[11 exact] K10 route iters={EXACT_ITERS} tol={EXACT_TOL:g} with "
          f"the prologue: {r_ms[0]:.4f} ms (min {r_ms[1]:.4f}, max "
          f"{r_ms[2]:.4f}); worst residual {worst:.3e} (bound 1e-3)")
    check(err <= TOL[torch.float32], "K10 vs plain at the path shape")
    check(worst <= 1e-3, "K10 residuals at the route's tol")
    Xx, _, _ = _admm_all_prefixes(z, y, iters=EXACT_ITERS, tol=EXACT_TOL)
    zh, yh = z.double().cpu().numpy(), y.double().cpu().numpy()
    lengths = range(20, EXACT_T + 1, 20)
    gap = -math.inf
    # Both scaled into the ball first: an f32 iterate a few ulps outside it
    # scores below the constrained optimum (admm.feasible_actions).
    Xk, Xp = admm.feasible_actions(X), admm.feasible_actions(Xx)
    for b in range(EXACT_B):
        acts = [polish_prefix_actions(zh[b], yh[b], np.concatenate(
            [np.zeros((1, D)), a[b]]), "l2", lengths=lengths)
            for a in (Xk, Xp)]
        for p in lengths:
            fk, fx = (polish_objective(zh[b][:p], yh[b][:p], a[p])
                      for a in acts)
            gap = max(gap, fk - fx)
    print(f"[11 exact] polished objectives at every 20th prefix of the "
          f"{EXACT_B} replicates: max (K10 - plain banded ADMM) = {gap:.3e} "
          f"(bound 3e-6)")
    check(gap <= 3e-6, "K10's polished objectives above the plain ADMM's")
    return out


def ftrl_f32_bound(T: int) -> float:
    """What f32 scoring can move a mean regret by at horizon T, to first
    order in the unit roundoff u = 2^-24: a regret is the difference of two
    sums of T hinge losses, each loss at most 1.  Each sum's recursive
    rounding is at most T u times its value (<= T); each loss carries at
    most (d + 3) u of its own; FTRL's f32 leader, a running sum, is off by
    at most t u times its norm at round t, which moves its loss by as much
    (at most T^2 u / 2 over the game).  3 T (T + d + 3) u covers the three;
    a mean over replicates and runs keeps the bound."""
    return 3.0 * T * (T + D + 3) * F32_UNIT


def exact_kernel_route(tmp):
    """(c) the --exact kernel route through the driver, cut to 2 runs and
    50 g runs, against the auto route (certified, host f64) on the same
    cut."""
    cut = ["--runs", "2", "--g-runs", "50"]
    argv = ["--exact", "--exact-solver", "kernel", "--precision", "f32",
            "--device", "cuda", *cut, "--dpi", "100"]
    admm.LAUNCHES = 0
    game.LAUNCHES = 0
    res = run_experiment(config_from_args(
        argv + ["--out-dir", os.path.join(tmp, "exact_kernel")]))
    launches, k1 = admm.LAUNCHES, game.LAUNCHES
    audit = res["audit"]
    cells = sum(a["cells_kernel"] for a in audit.values())
    escalated = sum(a["replicates_escalated"] for a in audit.values())
    print(f"[11 exact] driver {' '.join(argv)} (cut from the full 48 runs "
          f"and --g-runs 200 to {' '.join(cut)}): wall {res['wall_s']:.2f} "
          f"s, phases {json.dumps(res['phase_s'])}; K10 launches {launches} "
          f"for {cells} kernel cells and {escalated} escalated replicates; "
          f"K1 launches {k1}; audit {json.dumps(audit)}; host seconds by "
          f"step {json.dumps(res['exact_time_s'])}")
    check(all(audit[t]["cells_kernel"] == audit[t]["cells"] == 20
              for t in RANDOM_FAMILIES),
          "a random-family cell did not go through K10")
    check(launches == cells if escalated == 0
          else cells < launches <= cells + escalated,
          f"K10 launches {launches} do not match {cells} cells plus the "
          f"escalations")
    check(k1 > 0, "the kernel route did not score FTRL through K1")
    auto = run_experiment(config_from_args(
        ["--exact", "--precision", "f32", "--device", "cuda", *cut,
         "--cases", *RANDOM_FAMILIES,
         "--out-dir", os.path.join(tmp, "exact_auto")]))
    worst = {}
    for title in RANDOM_FAMILIES:
        for alg in ("FTRL", "FTL (exact)"):
            got = res["stats"][title][alg]["mean"]
            want = auto["stats"][title][alg]["mean"]
            for T, u, v in zip(T_GRID, got, want):
                check(math.isfinite(u) and abs(u - v) <= ftrl_f32_bound(T),
                      f"{title} {alg} T={T}: kernel route {u} vs auto {v}")
                worst[alg] = max(worst.get(alg, 0.0), abs(u - v))
    print(f"[11 exact] kernel route vs --exact-solver auto (certified, host "
          f"f64; wall {auto['wall_s']:.2f} s) on the same cut, random "
          f"families: max |mean difference| FTRL {worst['FTRL']:.3e}, FTL "
          f"(exact) {worst['FTL (exact)']:.3e}; bound 3T(T+d+3)u from f32 "
          f"scoring, {ftrl_f32_bound(100):.3e} at T=100 to "
          f"{ftrl_f32_bound(1000):.3e} at T=1000")
    return launches


def exact_kernel_route_past_1024(tmp):
    """(c) The kernel route past the PR 5 limit T <= 1024: one horizon T =
    1100, one run, one random family, against the auto route on the same
    cut."""
    cut = ["--t-min", "1100", "--t-max", "1100", "--runs", "1", "--g-runs",
           "10", "--cases", RANDOM_FAMILIES[0], "--device", "cuda"]
    admm.LAUNCHES = 0
    res = run_experiment(config_from_args(
        ["--exact", "--exact-solver", "kernel", "--precision", "f32", *cut,
         "--out-dir", os.path.join(tmp, "exact_kernel_1100")]))
    launches = admm.LAUNCHES
    auto = run_experiment(config_from_args(
        ["--exact", "--precision", "f32", *cut,
         "--out-dir", os.path.join(tmp, "exact_auto_1100")]))
    diff = {alg: abs(res["stats"][RANDOM_FAMILIES[0]][alg]["mean"][0]
                     - auto["stats"][RANDOM_FAMILIES[0]][alg]["mean"][0])
            for alg in ("FTRL", "FTL (exact)")}
    print(f"[11 exact] driver --exact --exact-solver kernel {' '.join(cut)}: "
          f"wall {res['wall_s']:.2f} s, K10 launches {launches}, audit "
          f"{json.dumps(res['audit'])}; vs auto |mean difference| FTRL "
          f"{diff['FTRL']:.3e}, FTL (exact) {diff['FTL (exact)']:.3e} "
          f"(bound {ftrl_f32_bound(1100):.3e})")
    check(launches >= 1, "the kernel route at T=1100 did not launch K10")
    check(all(math.isfinite(v) and v <= ftrl_f32_bound(1100)
              for v in diff.values()),
          "the kernel route at T=1100 differs from the auto route")


def exact_default(tmp):
    """(d) the default --exact pipeline at full scale against the committed
    results/results_exact_canonical.json."""
    argv = ["--exact", "--g-runs", "200", "--device", "cuda", "--dpi", "100"]
    admm.LAUNCHES = 0
    res = run_experiment(config_from_args(
        argv + ["--out-dir", os.path.join(tmp, "exact_default")]))
    with open(os.path.join(REPO, "results",
                           "results_exact_canonical.json")) as f:
        committed = json.load(f)
    err = results_diff(res, committed)
    print(f"[11 exact] driver {' '.join(argv)} (auto, canonical, f64, 48 "
          f"runs): wall {res['wall_s']:.2f} s, phases "
          f"{json.dumps(res['phase_s'])}, K10 launches {admm.LAUNCHES}; max "
          f"|cuda - results/results_exact_canonical.json| over g_emp and "
          f"stats = {err:.3e} (bound {PARITY_TOL:g}); audit equal "
          f"{res['audit'] == committed['audit']}")
    check(err <= PARITY_TOL, "default --exact differs from the committed run")
    check(res["audit"] == committed["audit"],
          "default --exact audit differs from the committed run")


def phase_exact(tmp):
    err = k10_vs_plain()
    k10_sliced_route()
    timing = k10_path_shape()
    timing["max_abs_err"] = max(timing["max_abs_err"], err)
    launches = exact_kernel_route(tmp)
    exact_kernel_route_past_1024(tmp)
    exact_default(tmp)
    return launches, timing


# --------------------------------------------------------------- phase 12
SSN_B, SSN_T, SSN_TOL = 8, 256, 2e-4
SSN_BANDS = [0, 256, 512, 744]          # T_max = 1000: four 256-row bands


def ooc_instance(B, T, seed):
    """The out-of-contract family of tests/test_ssn.py: z = 2 N(0, I),
    y = sign(<z, w> + 0.3 noise), float64 NumPy."""
    rng = np.random.default_rng(seed)
    z = 2.0 * rng.normal(size=(B, T, D))
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(B, D)))
                + 0.3 * rng.normal(size=(B, T)))
    y[y == 0] = 1.0
    return z, y


def ooc_builder(run_seed=0):
    """That family as a stream builder: replicate r of a run from seed
    run_seed + 31 r."""
    def sampler(T, rep=0):
        z, y = ooc_instance(1, T, run_seed + 31 * rep)
        return z[0], y[0]
    return sampler


class DispatchCounter(TorchDispatchMode):
    """Counts the ATen operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ssn_step_costs(z, y, **kw):
    """ATen operations and CUDA kernels of one Newton step: a 2-step call
    less a 1-step call (tol = 0).  Kernels from torch.profiler's device
    events (None if it records none)."""
    def ops(k):
        with DispatchCounter() as c:
            ssn.ssn_all_prefixes(z, y, iters=k, tol=0.0, **kw)
        return c.n

    def kernels(k):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ssn.ssn_all_prefixes(z, y, iters=k, tol=0.0, **kw)
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    k1, k2 = kernels(1), kernels(2)
    return ops(2) - ops(1), (k2 - k1) if k2 > k1 else None


def ssn_solve(z, y, solve=None, **kw):
    """One ``solve`` (ssn_all_prefixes) call: its outputs, Newton steps and
    wall (s, ending in a synchronize)."""
    counts = {}
    if z.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = (solve or ssn.ssn_all_prefixes)(z, y, counts=counts, **kw)
    if z.is_cuda:
        torch.cuda.synchronize()
    return out, counts["steps"], time.perf_counter() - t0


def prefix_objectives(z, y, X):
    """f(X[b, p]) over the first p + 1 rows of replicate b, host f64."""
    T = z.shape[1]
    m = np.tril(np.ones((T, T)))
    return 0.5 * (np.abs(np.einsum("btd,bpd->bpt", z, X) - y[:, None])
                  * m).sum(-1)


def ssn_card_vs_cpu():
    """(a) The SSN on the card against itself on the CPU on the OOC
    instance (B=8, T=256, d=5): fixed 10 steps, the certificates at tol
    2e-4, and the polished prefix objectives."""
    z, y = ooc_instance(SSN_B, SSN_T, 120)
    zc, yc = torch.from_numpy(z), torch.from_numpy(y)
    zg, yg = zc.cuda(), yc.cuda()
    ssn_solve(zg, yg, iters=2, tol=0.0)                       # warm-up
    (Xg, _, (_, mug)), _, _ = ssn_solve(zg, yg, iters=10, tol=0.0)
    (Xc, _, (_, muc)), _, _ = ssn_solve(zc, yc, iters=10, tol=0.0)
    Xg, mug, Xc, muc = (a.cpu().numpy() for a in (Xg, mug, Xc, muc))
    # Prefixes shorter than d interpolate on a continuum: their iterate is
    # rounding-determined, so they are held by objective only.
    err_x = float(np.abs(Xg[:, D - 1:] - Xc[:, D - 1:]).max())
    err_mu = float(np.abs(mug[:, D - 1:] - muc[:, D - 1:]).max())
    fg, fc = prefix_objectives(z, y, Xg), prefix_objectives(z, y, Xc)
    err_f = float((np.abs(fg - fc) / (1.0 + fc)).max())
    print(f"[12 ssn] (a) B={SSN_B} T={SSN_T} d={D} OOC, 10 fixed Newton "
          f"steps: card vs cpu max |X| {err_x:.3e}, |mu| {err_mu:.3e} on "
          f"prefixes >= d; max |f| / (1 + f) {err_f:.3e} on all (bound 1e-9)")
    check(max(err_x, err_mu, err_f) <= 1e-9, "SSN card vs cpu at 10 steps")
    # Certified: the JAX package's bars, 95% of the rows at 2e-4
    # (tests/test_ssn.py) and every row within the pipeline's fail_tol 1e-3,
    # at a cap of 400 steps (some out-of-contract rows never reach 2e-4, in
    # the JAX package as here).  The CPU solves replicate 0 alone.
    (Xg, rg, _), steps_g, wall_g = ssn_solve(zg, yg, iters=400, tol=SSN_TOL)
    (Xc, rc, _), steps_c, wall_c = ssn_solve(zc[:1], yc[:1], iters=400,
                                             tol=SSN_TOL)
    for label, r, steps, wall in (("card", rg, steps_g, wall_g),
                                  ("cpu replicate 0", rc, steps_c, wall_c)):
        frac = float((r <= SSN_TOL).double().mean())
        print(f"[12 ssn] (a) tol {SSN_TOL:g}, cap 400, {label}: {steps} "
              f"Newton steps, {wall:.3f} s, rows certified at 2e-4 "
              f"{frac:.4f} (bound 0.95), max res {float(r.max()):.3e} "
              f"(bound 1e-3)")
        check(frac >= 0.95 and float(r.max()) <= 1e-3,
              f"SSN certificates on the {label}")
    acts = [polish_prefix_actions(z[0], y[0], np.concatenate(
        [np.zeros((1, D)), X[0].cpu().numpy()]), "l2") for X in (Xg, Xc)]
    worst = max(abs(fa - fb) / (1.0 + fb) for fa, fb in (
        [polish_objective(z[0][:p], y[0][:p], a[p]) for a in acts]
        for p in range(1, SSN_T + 1)))
    print(f"[12 ssn] (a) polished prefix objectives of replicate 0, card vs "
          f"cpu: max |f| / (1 + f) = {worst:.3e} (bound 1e-9)")
    check(worst <= 1e-9, "SSN polished objectives card vs cpu")


def ssn_band_call():
    """The band call at the pipeline's full width: B=8 replicates, T_max
    = 1000, four 256-row bands in one batch, iters 80 and tol 2e-4 (the
    pipeline's first attempt); Newton steps, wall, and the operations and
    kernels of one step."""
    z, y = ooc_instance(SSN_B, 1000, 121)
    zg, yg = torch.from_numpy(z).cuda(), torch.from_numpy(y).cuda()
    kw = dict(band_lo=SSN_BANDS, band_rows=256)
    ssn_solve(zg, yg, iters=2, tol=0.0, **kw)                 # warm-up
    (_, res, _), steps, wall = ssn_solve(zg, yg, iters=80, tol=SSN_TOL, **kw)
    (_, _, _), _, wall10 = ssn_solve(zg, yg, iters=10, tol=0.0, **kw)
    ssn._CUDA_GRAPHS = False
    ops, kernels = ssn_step_costs(zg, yg, **kw)
    ssn._CUDA_GRAPHS = True
    frac = float((res <= SSN_TOL).double().mean())
    print(f"[12 ssn] band call B={SSN_B} T_max=1000 d={D} (4 bands x 256 rows "
          f"in one batch), iters 80 tol {SSN_TOL:g}: {steps} Newton steps, "
          f"{wall:.3f} s ({wall / max(steps, 1) * 1e3:.2f} ms a step; 10 "
          f"fixed steps {wall10 * 100:.2f} ms a step), rows certified at "
          f"2e-4 {frac:.4f}; one eager step dispatches {ops} ATen "
          f"operations and "
          f"launches {kernels if kernels is not None else 'not measured'} "
          f"CUDA kernels")
    return {"steps": steps, "wall_s": wall, "ops_per_step": ops,
            "kernels_per_step": kernels}


class BandCalls:
    """Wraps ssn.ssn_all_prefixes to record each call's Newton steps and
    wall while the pipeline runs."""

    def __init__(self):
        self.calls = []
        self.orig = ssn.ssn_all_prefixes

    def __enter__(self):
        def wrapped(z, y, **kw):
            out, steps, wall = ssn_solve(z, y, self.orig, **kw)
            self.calls.append((steps, wall))
            return out
        ssn.ssn_all_prefixes = wrapped
        return self

    def __exit__(self, *exc):
        ssn.ssn_all_prefixes = self.orig


def ssn_driver(tmp):
    """(b) driver --exact --exact-solver ssn against --exact-solver xla on
    the cut --runs 2 --g-runs 50 --t-max 300, the two random families (the
    deterministic ones take the canonical closed forms in both routes), on
    the card; at T = 100..1000 and all four cases the xla route alone takes
    ~6 min (scripts/ssn_torch_probe.py --pipeline)."""
    cut = ["--runs", "2", "--g-runs", "50", "--t-max", "300", "--device",
           "cuda", "--dpi", "50", "--cases", *RANDOM_FAMILIES]
    game.LAUNCHES = 0
    with BandCalls() as calls:
        res = run_experiment(config_from_args(
            ["--exact", "--exact-solver", "ssn", *cut,
             "--out-dir", os.path.join(tmp, "exact_ssn")]))
    k1 = game.LAUNCHES
    xla = run_experiment(config_from_args(
        ["--exact", "--exact-solver", "xla", *cut,
         "--out-dir", os.path.join(tmp, "exact_xla")]))
    worst = 0.0
    for title, algs in res["stats"].items():
        for alg, fields in algs.items():
            for u, v in zip(fields["mean"], xla["stats"][title][alg]["mean"]):
                check(math.isfinite(u), f"ssn route {title} {alg} not finite")
                worst = max(worst, abs(u - v))
    audit = res["audit"]
    steps = [c[0] for c in calls.calls]
    walls = [c[1] for c in calls.calls]
    print(f"[12 ssn] (b) driver --exact --exact-solver ssn {' '.join(cut)}: "
          f"wall {res['wall_s']:.2f} s, phases {json.dumps(res['phase_s'])}, "
          f"K1 launches {k1}; {len(steps)} SSN calls, Newton steps "
          f"median {statistics.median(steps)} max {max(steps)}, wall a call "
          f"median {statistics.median(walls):.3f} s max {max(walls):.3f} s; "
          f"audit {json.dumps(audit)}; host seconds by step "
          f"{json.dumps(res['exact_time_s'])}")
    print(f"[12 ssn] (b) --exact-solver xla on the same cut: wall "
          f"{xla['wall_s']:.2f} s, phases {json.dumps(xla['phase_s'])}, host "
          f"seconds by step {json.dumps(xla['exact_time_s'])}; max |mean "
          f"ssn - xla| = {worst:.3e} (bound 3e-6)")
    check(worst <= 3e-6, "ssn route differs from the xla route")
    check(all(a["cells_ssn"] == a["cells"] - a["cells_certified"]
              - a["cells_canonical"] and a["cells_admm"] == 0
              for a in audit.values()), "a general cell missed the SSN")
    check(k1 > 0, "the ssn route did not score FTRL through K1")


def ssn_auto_ooc():
    """(c) solver='auto' on the OOC family at the pipeline's width (T_max
    = 1000, 8 replicates) against solver='ssn' on the same inputs."""
    kw = dict(T_grid=[1000], runs=1, replicates=SSN_B, progress=False,
              device="cuda")
    audit, seconds = {}, {}
    t0 = time.perf_counter()
    with BandCalls() as calls:
        auto = evaluate_stream_exact(ooc_builder, solver="auto",
                                     audit_out=audit, timing_out=seconds,
                                     **kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    forced = evaluate_stream_exact(ooc_builder, solver="ssn", **kw)
    wall_s = time.perf_counter() - t0
    same = all(np.array_equal(auto[k][i], forced[k][i])
               for k in forced for i in (0, 1))
    print(f"[12 ssn] (c) auto on the OOC family, T_max=1000 B={SSN_B}: wall "
          f"{wall:.2f} s (solver='ssn' {wall_s:.2f} s), SSN calls (steps, "
          f"s) {[(c[0], round(c[1], 3)) for c in calls.calls]}, host seconds "
          f"by step {json.dumps(seconds)}; audit {json.dumps(audit)}; stats "
          f"equal to solver='ssn' in every bit: {same}")
    check(audit["cells_ssn"] > 0 and audit["cells_admm"] == 0,
          "auto did not route the OOC cell to the SSN")
    check(same, "auto and ssn differ on the OOC family")


def ssn_linf_lp():
    """(d) The linf SSN (the solve of ExactFTL(method='ssn', norm='linf'))
    on the card at T=40 against HiGHS LP objectives, at the bars of
    tests/test_ssn.py::test_ssn_linf_matches_lp_objectives."""
    rng = np.random.default_rng(3)
    T = 40
    z = 2.0 * rng.normal(size=(T, D))
    y = np.sign(z @ rng.normal(size=D) + 0.5 * rng.normal(size=T))
    y[y == 0] = 1.0
    (X, res, _), steps, wall = ssn_solve(
        torch.from_numpy(z).cuda(), torch.from_numpy(y).cuda(), iters=300,
        tol=1e-6, norm="linf")
    X, res = X.cpu().numpy(), res.cpu().numpy()
    ok = True
    for t in range(1, T + 1):
        f_ssn = 0.5 * np.abs(z[:t] @ X[t - 1] - y[:t]).sum()
        A = np.block([[z[:t], -np.eye(t)], [-z[:t], -np.eye(t)]])
        f_lp = linprog(np.concatenate([np.zeros(D), 0.5 * np.ones(t)]),
                       A_ub=A, b_ub=np.concatenate([y[:t], -y[:t]]),
                       bounds=[(-1, 1)] * D + [(0, None)] * t,
                       method="highs").fun
        ok &= bool(np.abs(X[t - 1]).max() <= 1.0 + 1e-10)
        ok &= bool(res[t - 1] >= (f_ssn - f_lp) / (1.0 + f_ssn) - 1e-9)
        if res[t - 1] <= 2e-4:
            ok &= bool(f_ssn <= f_lp + 2e-4 * (1.0 + f_lp) + 1e-9)
    frac, med = float((res <= 2e-4).mean()), float(np.median(res))
    print(f"[12 ssn] (d) linf SSN T={T} on the card: {steps} Newton steps, "
          f"{wall:.2f} s; certified at 2e-4 {frac:.3f} (bound >= 0.9), "
          f"median gap {med:.2e} (bound 1e-6); gaps sound and certified "
          f"objectives within 2e-4 (1 + f) of HiGHS: {ok}")
    check(ok and frac >= 0.9 and med <= 1e-6, "linf SSN against HiGHS")


def phase_ssn(tmp):
    ssn_card_vs_cpu()
    band = ssn_band_call()
    ssn_driver(tmp)
    ssn_auto_ooc()
    ssn_linf_lp()
    return band


# --------------------------------------------------------------- phase 13
# The narrow storage pairs (z, y) of K1-K6, as the JAX package stores them.
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
         (torch.float32, torch.int8))
STORE_TOL = TOL[torch.float32]
# The kernels of the slice: (key, source, TPU kernel, what it computes).
STORAGE_KERNELS = (
    ("K1", "regret_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_game.py:679", "regret_kernel"),
    ("K2", "smart_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_smart.py:108", "smart_kernel"),
    ("K3", "game_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_game.py:363", "game_kernel"),
    ("K3e", "game_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_game.py:467", "game_kernel"),
    ("K4", "stream_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_game.py:871", "stream_kernel"),
    ("K5", "sweep_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_game.py:556", "sweep_kernel"),
    ("K6a", "smart_sweep_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_smart.py:248",
     "smart_prefix_kernel"),
    ("K6b", "smart_sweep_kernel.cu",
     "online_convex_optimization_tpu/ops/pallas_smart.py:248",
     "smart_tail_kernel"))
BENCH_B, BENCH_T = 262_144, 1024


def pair_name(pair) -> str:
    return game.STORAGE[pair]


def item(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def row_bytes(pair) -> int:
    """Bytes of one round of one sequence in a storage pair."""
    return D * item(pair[0]) + item(pair[1])


class PlainCache:
    """Plain versions on the upcast values, computed once for each distinct
    upcast input (bf16/bf16 and bf16/int8 share theirs)."""

    def __init__(self):
        self.memo = {}

    def get(self, key, fn):
        if key not in self.memo:
            out, ms = timed_once(fn)
            self.memo[key] = (out, ms)
        return self.memo[key]


def storage_check(label, pair, narrow, wide, plain):
    """``narrow`` (the pair's instance) against ``wide`` (the f32 instance
    on the upcast values) bit for bit, and against ``plain`` within
    STORE_TOL; returns the error against the plain version."""
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(narrow, wide))
    err = max_err([a for a in narrow if a.is_floating_point()],
                  [b for b in plain if b.is_floating_point()])
    ints = all(torch.equal(a, b.to(a.dtype)) for a, b in zip(narrow, plain)
               if not a.is_floating_point())
    print(f"[13 storage] {label} {pair_name(pair)}: vs f32 instance on the "
          f"upcast values {'equal in every bit' if same else 'DIFFERENT'}; "
          f"vs plain max_abs_err={err:.3e} (bound {STORE_TOL})"
          + ("" if ints else "; switch rounds DIFFER from plain"))
    check(same, f"{label} {pair_name(pair)}: differs from the f32 instance "
          f"on the upcast values")
    check(err <= STORE_TOL and ints, f"{label} {pair_name(pair)} vs plain")
    return err


def storage_batch(pair, B, T, d, seed, *, contract=True):
    """Rows and labels stored in ``pair`` with ragged lengths: the device
    generator's contract batch, or rows scaled past the ball (replay)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z, y = random_game_batch(gen, B, T, d, dtype=pair[0], y_dtype=pair[1])
    if not contract:
        z = (1.5 * z.float()).to(pair[0])
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0] = T
    return z, y, lengths


def up(*ts):
    return tuple(t.float() for t in ts)


def storage_main_path(batches, stream_chunks, packed):
    """Every storage entry point of the slice as a user calls it, one pair
    at a time, the counts set to 0 just before and read just after: K1
    (regret_plays, regrets_fused), K2 (smart_plays, smart_regrets), K3 and
    K3e (simulate_linear_auto), K4 (StreamingKernelGame(dtype, y_dtype)),
    K5 (ftrl_eta_sweep) and K6a/K6b (smart_threshold_sweep)."""
    launches = {}
    for pair in PAIRS:
        z, y, lengths = batches[pair]
        zc, yc = stream_chunks[pair]
        z_tm, y_tm = packed[pair]
        sw_z, sw_y, sw_len = batches[("sweep", pair)]
        game.LAUNCHES = smart.LAUNCHES = 0
        game.PACKED_LAUNCHES = game.PACKED_ETA_LAUNCHES = 0
        game.STREAM_LAUNCHES = game.SWEEP_LAUNCHES = 0
        smart.SWEEP_LAUNCHES = smart.SWEEP_TAIL_LAUNCHES = 0
        replay = not game.in_contract(z, y, lengths)
        outs = [game.regret_plays(z, y, (0, 1), ETA, lengths, replay)[0],
                game.regrets_fused(z, y, 0, ETA, lengths)[0],
                smart.smart_plays(z, y, torch.stack(
                    [torch.sqrt(2.0 * lengths.float()),
                     0.9 * torch.sqrt(2.0 * lengths.float())]), ETA,
                    lengths, replay)[0],
                smart.smart_regrets(z, y, 8.0, ETA, lengths)[0]]
        zb, yb = z_tm.permute(2, 0, 1), y_tm.t()
        outs.append(game.simulate_linear_auto(zb, yb, 0, ETA))
        outs.append(game.simulate_linear_auto(
            zb, yb, 0, torch.linspace(0.05, 4.0, zb.shape[0], device="cuda")))
        sg = StreamingKernelGame(STREAM_B, D, eta0=ETA, dtype=pair[0],
                                 y_dtype=pair[1], device="cuda")
        sg.feed_packed(zc, yc)
        sg.feed_many_packed(zc[None], yc[None])
        outs.append(sg.result().regret)
        outs.append(ftrl_eta_sweep(sw_z, sw_y, ETA_GRID, length=sw_len))
        outs.append(smart_threshold_sweep(sw_z, sw_y, THRESH_GRID, eta0=ETA,
                                          length=sw_len))
        torch.cuda.synchronize()
        got = {"K1": game.LAUNCHES, "K2": smart.LAUNCHES,
               "K3": game.PACKED_LAUNCHES, "K3e": game.PACKED_ETA_LAUNCHES,
               "K4": game.STREAM_LAUNCHES, "K5": game.SWEEP_LAUNCHES,
               "K6a": smart.SWEEP_LAUNCHES, "K6b": smart.SWEEP_TAIL_LAUNCHES}
        print(f"[13 storage] main path {pair_name(pair)}: launches "
              f"{json.dumps(got)}")
        check(all(v > 0 for v in got.values()),
              f"storage path {pair_name(pair)} missed a kernel: {got}")
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"storage path {pair_name(pair)}: outputs not finite")
        launches[pair] = got
    return launches


def storage_time(label, pair, kern, wide, n_bytes, ops):
    """The pair's kernel and the f32 instance on the upcast values, timed
    in turns (CUDA events, warmed, 5 repeats), beside the pair's bound."""
    k_ms = time_ms(kern, reps=5)
    f_ms = time_ms(wide, reps=5)
    b = bound(n_bytes, ops, torch.float32)
    print(f"[13 storage] {label} {pair_name(pair)}: kernel {k_ms[0]:.4f} ms "
          f"(min {k_ms[1]:.4f}, max {k_ms[2]:.4f}), f32 instance on the "
          f"upcast values {f_ms[0]:.4f} ms (min {f_ms[1]:.4f}, max "
          f"{f_ms[2]:.4f}); bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']} ({n_bytes / 1e9:.4f} GB)")
    return {"ms": k_ms[0], "ms_min": k_ms[1], "ms_max": k_ms[2],
            "f32_ms": f_ms[0], "library_ms": None, **b}


def storage_instances(pair, plain):
    """K1, K2, K5, K6 (the wrappers), K3, K3e and K4 at d = 5, 3, 64 and
    65 (the unrolled, generic and large-d instances), B = 77, T = 103, in
    contract and in replay mode (K3, K3e, K4 need none: no comparator)."""
    key = pair[0]
    for d in (5, 3, 64, 65):
        for contract in (True, False):
            z, y, ls = storage_batch(pair, 77, 103, d, 130 + d,
                                     contract=contract)
            mode = "contract" if contract else "replay"
            check(game.in_contract(z, y, ls) == contract,
                  f"{pair_name(pair)} d={d}: contract check")
            zf, yf = up(z, y)
            mixed = torch.arange(77, device="cuda") % 2
            etas = torch.linspace(0.3, 2.5, 77, device="cuda")
            thr = torch.where(mixed == 0, 2.0, 6.5).float()
            lab = f"d={d} {mode} B=77 T=103"
            storage_check(
                f"K1 {lab}", pair,
                game.regrets_fused(z, y, mixed, etas, ls),
                game.regrets_fused(zf, yf, mixed, etas, ls),
                plain.get(("K1", d, contract, key),
                          lambda: game.regrets_fused_reference(
                              zf, yf, mixed.int(), etas, ls,
                              replay=not contract))[0])
            storage_check(
                f"K2 {lab}", pair, smart.smart_regrets(z, y, thr, ETA, ls),
                smart.smart_regrets(zf, yf, thr, ETA, ls),
                plain.get(("K2", d, contract, key),
                          lambda: smart.smart_regrets_reference(
                              zf, yf, thr,
                              torch.full((77,), ETA, device="cuda"), ls,
                              replay=not contract))[0])
            grid = ETA_GRID[:11].float().to("cuda")
            storage_check(
                f"K5 {lab} E=11", pair, (game.eta_sweep(z, y, grid, ls),),
                (game.eta_sweep(zf, yf, grid, ls),),
                plain.get(("K5", d, contract, key),
                          lambda: (game.eta_sweep_reference(
                              zf, yf, grid, ls, replay=not contract),))[0])
            thg = THRESH_GRID[:13].float().to("cuda")
            storage_check(
                f"K6 {lab} G=13", pair, smart.smart_sweep(z, y, thg, ETA, ls),
                smart.smart_sweep(zf, yf, thg, ETA, ls),
                plain.get(("K6", d, contract, key),
                          lambda: smart.smart_sweep_reference(
                              zf, yf, thg, torch.tensor(ETA, device="cuda"),
                              ls, replay=not contract))[0])
            if not contract:
                continue
            z_tm, y_tm = game.time_major(z, y)
            zf_tm, yf_tm = game.time_major(zf, yf)
            sc = game.ftrl_scales(103, ETA, device="cuda")
            storage_check(f"K3 {lab}", pair,
                          game.play_packed(z_tm, y_tm, sc),
                          game.play_packed(zf_tm, yf_tm, sc),
                          plain.get(("K3", d, key),
                                    lambda: game.play_packed_reference(
                                        zf_tm, yf_tm, sc, 0))[0])
            storage_check(f"K3e {lab}", pair,
                          game.play_packed_eta(z_tm, y_tm, etas),
                          game.play_packed_eta(zf_tm, yf_tm, etas),
                          plain.get(("K3e", d, key),
                                    lambda: game.play_packed_eta_reference(
                                        zf_tm, yf_tm, etas))[0])
            c0 = game.zero_stream_carry(77, d, device="cuda")
            fl = mixed.int()
            storage_check(
                f"K4 {lab} t0=5", pair,
                game.play_stream(z_tm, y_tm, etas, 5, c0, alg_flag=fl),
                game.play_stream(zf_tm, yf_tm, etas, 5, c0, alg_flag=fl),
                plain.get(("K4", d, key),
                          lambda: game.play_stream_reference(
                              zf_tm, yf_tm, fl, etas, 5, c0))[0])


def storage_full(pair, batches, stream_chunks, packed, plain):
    """Each kernel at its phase's shape in the pair: against the f32
    instance on the upcast values (bit for bit) and its plain version
    (STORE_TOL), timed beside the pair's bound."""
    rb, f4 = row_bytes(pair), 4
    key = pair[0]                      # the upcast values' identity
    out = {}
    # K1 and K2 at phase 3's shape through the evaluation's entries.
    z, y, lengths = batches[pair]
    zf, yf = up(z, y)
    B, T = z.shape[:2]
    replay = not game.in_contract(z, y, lengths)
    flags = torch.tensor([[0], [1]], dtype=torch.int32,
                         device="cuda").expand(-1, B).contiguous()
    thr = torch.stack([torch.sqrt(2.0 * lengths.float()),
                       0.9 * torch.sqrt(2.0 * lengths.float())])
    etas = torch.full((B,), ETA, device="cuda")
    k1 = lambda zz, yy: game.regret_plays(zz, yy, (0, 1), ETA, lengths,
                                          replay)
    want, p1 = plain.get(("K1", key), lambda: game.regret_plays_reference(
        zf, yf, flags, etas, lengths, replay=replay))
    out["K1"] = {"max_abs_err": storage_check(
        f"K1 B={B} T={T} 2 plays", pair, k1(z, y), k1(zf, yf), want),
        "plain_ms": p1}
    rows = float(lengths.double().sum())
    out["K1"].update(storage_time(
        "K1", pair, lambda: k1(z, y), lambda: k1(zf, yf),
        rows * rb + B * 8 + 2 * B * 4 + T * 4 + 2 * B * (2 + D) * 4,
        rows * (2 * hinge_round_ops(D, with_w=False) + 2 * D)))
    k2 = lambda zz, yy: smart.smart_plays(zz, yy, thr, ETA, lengths, replay)
    want, p2 = plain.get(("K2", key), lambda: smart.smart_plays_reference(
        zf, yf, thr, etas, lengths, replay=replay))
    got = k2(z, y)
    out["K2"] = {"max_abs_err": storage_check(
        f"K2 B={B} T={T} 2 thresholds", pair, got, k2(zf, yf), want),
        "plain_ms": p2}
    tau, L = got[3], lengths.long()
    open_rows = float(torch.minimum(tau.max(0).values + 1, L).sum())
    tail = float(torch.clamp(L[None] - tau - 1, min=0).sum())
    out["K2"].update(storage_time(
        "K2", pair, lambda: k2(z, y), lambda: k2(zf, yf),
        rows * rb + B * 8 + 2 * B * 4 + T * 4 + 2 * B * (1 + D) * 4
        + B * 4 + 2 * B * 8,
        rows * (9 * D + 9) + open_rows * (2 * D + 5)
        + tail * hinge_round_ops(D, with_w=False)))
    # K3 and K3e at phase 8's shape.
    z_tm, y_tm = packed[pair]
    zf_tm, yf_tm = up(z_tm, y_tm)
    sc = game.ftrl_scales(PACKED_T, ETA, device="cuda")
    etas_p = torch.linspace(0.05, 4.0, PACKED_B, device="cuda")
    steps = PACKED_B * PACKED_T
    for name, kern, ref, extra in (
            ("K3", lambda a, b: game.launch_play_packed(a, b, sc, 0),
             lambda: game.play_packed_reference(zf_tm, yf_tm, sc, 0),
             PACKED_T * f4),
            ("K3e", lambda a, b: game.launch_play_packed_eta(a, b, etas_p),
             lambda: game.play_packed_eta_reference(zf_tm, yf_tm, etas_p),
             PACKED_B * f4)):
        want, pm = plain.get((name, key), ref)
        out[name] = {"max_abs_err": storage_check(
            f"{name} B={PACKED_B} T={PACKED_T}", pair, kern(z_tm, y_tm),
            kern(zf_tm, yf_tm), want), "plain_ms": pm}
        out[name].update(storage_time(
            name, pair, lambda: kern(z_tm, y_tm), lambda: kern(zf_tm, yf_tm),
            steps * rb + extra + PACKED_B * (D + 1) * f4,
            steps * hinge_round_ops(D, False)))
    # The narrow mode is not upcast: one K3 call's memory and launches.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, c0 = torch.cuda.memory_allocated(), game.PACKED_LAUNCHES
    game.play_packed(z_tm, y_tm, sc)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    print(f"[13 storage] K3 {pair_name(pair)} one play_packed call at "
          f"B={PACKED_B}: peak memory growth {growth} bytes (an f32 copy of z "
          f"{z_tm.numel() * 4}), launches {game.PACKED_LAUNCHES - c0}")
    check(growth < z_tm.numel() * 4 and game.PACKED_LAUNCHES == c0 + 1,
          f"K3 {pair_name(pair)}: the narrow storage was upcast")
    # K4: bit for bit at phase 7's chunk (t0 = 127 chunks, a carried
    # state), the plain version on a 512-round chunk from zero.
    zc, yc = stream_chunks[pair]
    zfc, yfc = up(zc, yc)
    fl = game.per_sequence(0, STREAM_B, torch.int32, "cuda")
    et = game.per_sequence(ETA, STREAM_B, torch.float32, "cuda")
    c0 = game.zero_stream_carry(STREAM_B, D, device="cuda")
    short = lambda a, b: game.advance_stream(a[:512], b[:512], fl, et, 0, c0)
    mid = short(zc, yc)
    check(all(torch.equal(u, v) for u, v in zip(mid, short(zfc, yfc))),
          f"K4 {pair_name(pair)} CT=512 from zero vs the f32 instance")
    t0 = (STREAM_N - 1) * STREAM_CT
    k4 = lambda a, b: game.launch_stream_time_major(a, b, fl, et, t0, mid)
    want, p4 = plain.get(("K4", key), lambda: game.play_stream_reference(
        zfc, yfc, fl, et, t0, mid))
    out["K4"] = {"max_abs_err": storage_check(
        f"K4 B={STREAM_B} CT={STREAM_CT} t0={t0} carried", pair, k4(zc, yc),
        k4(zfc, yfc), want), "plain_ms": p4}
    out["K4"].update(storage_time(
        "K4", pair, lambda: k4(zc, yc), lambda: k4(zfc, yfc),
        STREAM_CT * STREAM_B * rb + STREAM_B * 8
        + 2 * STREAM_B * (2 * D + 2) * f4,
        STREAM_CT * STREAM_B * hinge_round_ops(D)))
    # K5, K6a and K6b at phase 6's shape.
    sz, sy, sl = batches[("sweep", pair)]
    szf, syf = up(sz, sy)
    grid = ETA_GRID.float().to("cuda")
    thg = THRESH_GRID.float().to("cuda")
    replay = not game.in_contract(sz, sy, sl)
    want, p5 = plain.get(("K5", key), lambda: game.eta_sweep_reference(
        szf, syf, grid, sl, replay=replay))
    order = game.length_order(sl)
    scales = game.sweep_scales(grid, SWEEP_T)
    k5 = lambda a, b: game.launch_eta_sweep(a, b, scales, order, sl, replay)
    out["K5"] = {"max_abs_err": storage_check(
        f"K5 B={SWEEP_B} T={SWEEP_T} E={len(grid)}", pair,
        (game.eta_sweep(sz, sy, grid, sl),),
        (game.eta_sweep(szf, syf, grid, sl),), (want,)), "plain_ms": p5}
    want6, p6 = plain.get(("K6", key), lambda: smart.smart_sweep_reference(
        szf, syf, thg, torch.tensor(ETA, device="cuda"), sl, replay=replay))
    got6 = smart.smart_sweep(sz, sy, thg, ETA, sl)
    err6 = storage_check(f"K6 B={SWEEP_B} T={SWEEP_T} G={len(thg)}", pair,
                         got6, smart.smart_sweep(szf, syf, thg, ETA, sl),
                         want6)
    counts = smart_sweep_counts(got6[1], sl)
    srows = float(sl.double().sum())
    E, G = len(grid), len(thg)
    ordered, perm = torch.sort(thg, stable=True)
    perm = perm.to(torch.int32)
    pre = lambda a, b: smart.launch_smart_prefix(a, b, ordered, perm, order,
                                                 sl, replay)
    tsc = game.sweep_scales(torch.full((1,), ETA, device="cuda"), SWEEP_T)
    pa = pre(sz, sy)
    regret0 = pa[0].clone()

    def tails(a, b):
        r = regret0.clone()
        smart.launch_smart_tails(a, b, tsc, order, sl, pa[1], pa[2], r)
        return r

    check(torch.equal(tails(sz, sy), tails(szf, syf)),
          f"K6b {pair_name(pair)} vs the f32 instance")
    out["K5"].update(storage_time(
        "K5", pair, lambda: k5(sz, sy), lambda: k5(szf, syf),
        srows * rb + SWEEP_B * 4 + E * SWEEP_B * f4,
        srows * (E * hinge_round_ops(D, with_w=False) + 2 * D)))
    out["K6a"] = {"max_abs_err": err6, "plain_ms": p6}
    out["K6a"].update(storage_time(
        "K6a", pair, lambda: pre(sz, sy), lambda: pre(szf, syf),
        srows * rb + SWEEP_B * 4 + G * f4 + G * SWEEP_B * (8 + f4)
        + SWEEP_B * f4,
        srows * (9 * D + 9) + counts["lead_rows"] * (2 * D + 3)))
    out["K6b"] = {"max_abs_err": err6, "plain_ms": p6}
    out["K6b"].update(storage_time(
        "K6b", pair, lambda: tails(sz, sy), lambda: tails(szf, syf),
        counts["tail_rows"] * rb + SWEEP_B * 4 + G * SWEEP_B * 8
        + SWEEP_B * f4 + counts["tail_pairs"] * 2 * f4,
        counts["tail_rounds"] * hinge_round_ops(D, with_w=False)))
    return out


def storage_bench():
    """K1 at bench.py's shape: 262,144 sequences of T = 1024, one FTRL
    play, bf16 z and int8 y, against the f32 instance on the upcast values
    (bit for bit) and its plain version, timed beside its bound."""
    pair = (torch.bfloat16, torch.int8)
    gen = torch.Generator(device="cuda").manual_seed(131)
    z, y = random_game_batch(gen, BENCH_B, BENCH_T, D, dtype=pair[0],
                             y_dtype=pair[1])
    lengths = game.per_sequence_lengths(None, BENCH_B, BENCH_T, "cuda")
    check(game.in_contract(z, y, lengths), "bench batch in the contract")
    k1 = lambda a, b: game.regret_plays(a, b, (0,), ETA, lengths, False)
    zf, yf = up(z, y)
    want, pm = timed_once(lambda: game.regret_plays_reference(
        zf, yf, torch.zeros((1, BENCH_B), dtype=torch.int32, device="cuda"),
        torch.full((BENCH_B,), ETA, device="cuda"), lengths))
    err = storage_check(f"K1 bench.py shape B={BENCH_B} T={BENCH_T} FTRL",
                        pair, k1(z, y), k1(zf, yf), want)
    del want
    steps = BENCH_B * BENCH_T
    res = {"max_abs_err": err, "plain_ms": pm, **storage_time(
        "K1 bench.py shape", pair, lambda: k1(z, y), lambda: k1(zf, yf),
        steps * row_bytes(pair) + BENCH_B * 12 + BENCH_T * 4
        + BENCH_B * (2 + D) * 4,
        steps * (hinge_round_ops(D, with_w=False) + 2 * D))}
    print(f"[13 storage] K1 bench.py shape {pair_name(pair)}: "
          f"{steps / res['ms'] * 1e3:.4g} sequence-steps/s")
    return res


def phase_storage():
    """Phase 13: K1-K6 on the narrow storage pairs."""
    t_start = time.perf_counter()
    batches, stream_chunks, packed = {}, {}, {}
    for pair in PAIRS:
        batches[pair] = storage_batch(pair, 10_000, 1000, D, 131)
        gen = torch.Generator(device="cuda").manual_seed(132)
        sz, sy = random_game_batch(gen, SWEEP_B, SWEEP_T, D, dtype=pair[0],
                                   y_dtype=pair[1])
        sl = torch.randint(SWEEP_T // 2, SWEEP_T + 1, (SWEEP_B,),
                           generator=gen, device="cuda", dtype=torch.int32)
        sl[0] = SWEEP_T
        batches[("sweep", pair)] = (sz, sy, sl)
        gen = torch.Generator(device="cuda").manual_seed(133)
        stream_chunks[pair] = random_time_major_batch(
            gen, STREAM_CT, STREAM_B, D, dtype=pair[0], y_dtype=pair[1])
        gen = torch.Generator(device="cuda").manual_seed(134)
        packed[pair] = random_time_major_batch(
            gen, PACKED_T, PACKED_B, D, dtype=pair[0], y_dtype=pair[1])
    walls = {"data": time.perf_counter() - t_start}
    t = time.perf_counter()
    launches = storage_main_path(batches, stream_chunks, packed)
    walls["main path"] = time.perf_counter() - t
    plain = PlainCache()
    timing = {}
    walls["instances"] = walls["full"] = 0.0
    for pair in PAIRS:
        t = time.perf_counter()
        storage_instances(pair, plain)
        walls["instances"] += time.perf_counter() - t
        t = time.perf_counter()
        timing[pair] = storage_full(pair, batches, stream_chunks, packed,
                                    plain)
        walls["full"] += time.perf_counter() - t
    del batches, stream_chunks, packed, plain
    torch.cuda.empty_cache()
    t = time.perf_counter()
    bench = storage_bench()
    walls["bench"] = time.perf_counter() - t
    print(f"[13 storage] phase wall {time.perf_counter() - t_start:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in walls.items())})")
    return launches, timing, bench


# --------------------------------------------------------------- phase 14
# K10l: rows past the register instances' 4,096 entries.
LONG_B, LONG_T, LONG_ITERS = 2, 8192, 200
# K10l's streaming instance: the rows past the resident instance's 8,192.
STREAM_T = 9216
# K9w and K8w: d past the thin instances' 32.
K9W_PATH = ((64, 64, 1024, 0), (128, 16, 1024, 512))   # d, B, T, first row
K9W_D256 = (256, 4, 1024, 1024)
# K9w's plain check at d = 256 in f32, with the workspace in shared memory:
# the first problems of the timed launch (the plain version's time is its
# d^2 operations a solve, about half a minute, whatever their number).
K9W_D256_PLAIN = 64
K8W_B, K8W_T = QUAD_B, QUAD_T
# The plain versions at d = 40 (d = 64 is held at the path's shapes).
PLAIN_D = 40
PLAIN_K9_N = (4, 1024)                  # B x T prefixes: N = 4,096
PLAIN_K8 = (256, 128)                   # B, T
# K8w's plain version at the path's shape: sequences a call (its
# statistics of every prefix, 8.7 MB a sequence in f32), and the f64
# run's sample (every 8th sequence: the f64 plain version of all 4,096
# would take about twice the f32 one's time).
K8W_CHUNK = 512
K8W_SAMPLE = 8


def long_row_ops(B: int, T: int, d: int, iters: int, lo: int = 0,
                 hi: int = 0) -> int:
    """K10l's operations (``admm_ops``'s counts) over the rows of lo + 1 ..
    hi entries (by default ``admm.LONG_ROWS`` .. T)."""
    lo, hi = lo or admm.LONG_ROWS, hi or T
    entries = (hi * (hi + 1) - lo * (lo + 1)) // 2
    return iters * B * ((4 * d + 13) * entries
                        + (2 * d * d + 12 * d + 1) * (hi - lo))


def long_row_bytes(z, y, Lpk, lo: int, hi: int) -> int:
    """Bytes K10l's rows of lo + 1 .. hi entries must move: z and y read
    once, each row's factor read and its state (s, u up to T, x, w, v,
    res) written once."""
    B, T, d = z.shape
    rows = B * (hi - lo)
    return 4 * (z.numel() + y.numel() + rows * (Lpk.shape[1] + 3 * d + 1)
                + 2 * rows * T)


def k10_long():
    """K10l at B = 2, T = 8,192, d = 5 (200 fixed iterations) through
    ``admm_all_prefixes_l2``: its launches, the state against the plain
    version (5e-4), rows p < 4,096 against a launch on z[:, :4096] and
    100 + 100 iterations against 200 (bit for bit); its time (the launch
    less the launch on z[:, :4096], whose rows it repeats), bound,
    registers and warps an SM; one run at the route's tol = 2e-4 with the
    blocks of 100 iterations each row took."""
    z, y = exact_batch(LONG_B, LONG_T, D, 140)
    lo = admm.LONG_ROWS
    admm.LONG_LAUNCHES = admm.RESIDENT_LAUNCHES = 0
    X, res, st = admm.admm_all_prefixes_l2(z, y, iters=LONG_ITERS, tol=0.0)
    torch.cuda.synchronize()
    launches = admm.RESIDENT_LAUNCHES
    print(f"[14 wide] admm_all_prefixes_l2 B={LONG_B} T={LONG_T} d={D} f32, "
          f"{LONG_ITERS} fixed iterations: K10l launches "
          f"{admm.LONG_LAUNCHES}, of its resident instance {launches} (K10 "
          f"instances {admm.kernel_instances(LONG_T)}); state "
          f"{2 * st[0].numel() * 4 / 1e9:.2f} GB")
    check(launches == 1 and admm.LONG_LAUNCHES == 1,
          "admm_all_prefixes_l2 at T = 8192 did not launch K10l's resident "
          "instance once")
    Lpk = admm.admm_prologue(z)
    (res_p, st_p), p_ms = timed_once(
        lambda: admm.admm_all_prefixes_l2_reference(
            z, y, Lpk, iters=LONG_ITERS, tol=0.0, check_every=100, rho=1.0,
            alpha=1.7))
    err = max_err(st + (res.reshape(-1),), st_p + (res_p,))
    rows = torch.arange(LONG_B * LONG_T, device="cuda") % LONG_T >= lo
    err_long = max(float((a[rows].double() - b[rows].double()).abs().max())
                   for a, b in zip(st + (res.reshape(-1),), st_p + (res_p,)))
    del st_p, res_p
    torch.cuda.empty_cache()
    print(f"[14 wide] K10l vs plain (s, u, x, w, v, res): max_abs_err="
          f"{err:.3e} over every row, {err_long:.3e} over the long rows "
          f"(bound {TOL[torch.float32]:g}); plain PyTorch {p_ms:.1f} ms "
          f"(one call)")
    check(err <= TOL[torch.float32], "K10l vs plain")
    z4, y4 = z[:, :lo].contiguous(), y[:, :lo].contiguous()
    X4, r4, st4 = admm.admm_all_prefixes_l2(z4, y4, iters=LONG_ITERS,
                                            tol=0.0)
    same = torch.equal(X[:, :lo], X4) and torch.equal(res[:, :lo], r4)
    for a, a4 in zip(st, st4):
        a = a.reshape(LONG_B, LONG_T, -1)[:, :lo]
        if a.shape[-1] == LONG_T:      # s, u: zero past each row's length
            same = same and bool((a[..., lo:] == 0).all())
            a = a[..., :lo]
        same = same and torch.equal(a.reshape(a4.shape), a4)
    print(f"[14 wide] rows p < {lo} of the T={LONG_T} launch equal the "
          f"launch on z[:, :{lo}] in every bit: {same}")
    check(same, "K10's rows p < 4096 differ between T = 8192 and 4096")
    del st4
    _, _, st1 = admm.admm_all_prefixes_l2(z, y, iters=LONG_ITERS // 2,
                                          tol=0.0)
    Xc, rc, stc = admm.admm_all_prefixes_l2(z, y, iters=LONG_ITERS // 2,
                                            tol=0.0, state0=st1)
    same = (torch.equal(Xc, X) and torch.equal(rc, res)
            and all(torch.equal(a, b) for a, b in zip(stc, st)))
    print(f"[14 wide] K10 T={LONG_T}: {LONG_ITERS // 2} + {LONG_ITERS // 2} "
          f"iterations from the saved state equal {LONG_ITERS} in every "
          f"bit: {same}")
    check(same, "K10l continuation is not bit for bit")
    del st1, stc, Xc
    torch.cuda.empty_cache()
    kw = dict(iters=LONG_ITERS, tol=0.0, check_every=100, rho=1.0,
              alpha=1.7)
    Lpk4 = admm.admm_prologue(z4)
    full, short = [], []
    for _ in range(2):            # in turns: the full launch, the short one
        full.append(time_ms(lambda: admm.launch_admm(z, y, Lpk, **kw),
                            reps=3))
        short.append(time_ms(lambda: admm.launch_admm(z4, y4, Lpk4, **kw),
                             reps=3))
    f_ms = statistics.median(t[0] for t in full)
    s_ms = statistics.median(t[0] for t in short)
    k_ms = f_ms - s_ms
    ops = long_row_ops(LONG_B, LONG_T, D, LONG_ITERS)
    entries = LONG_B * ((LONG_T * (LONG_T + 1) - lo * (lo + 1)) // 2)
    n_bytes = long_row_bytes(z, y, Lpk, lo, LONG_T)
    stream_ms = 16 * entries * LONG_ITERS / HBM_BYTES_PER_S * 1e3
    regs, warps = admm.kernel_occupancy(LONG_T, D)["resident"]
    plan = admm.resident_plan(D)
    out = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "library_ms": None, **bound(n_bytes, ops, torch.float32),
           "registers": regs, "warps_per_sm": warps}
    print(f"[14 wide] K10l resident B={LONG_B} T={LONG_T} d={D} f32, "
          f"{LONG_ITERS} fixed iterations: {k_ms:.4f} ms (the launch "
          f"{f_ms:.4f} ms [{', '.join(f'{t[1]:.4f}..{t[2]:.4f}' for t in full)}]"
          f" less the launch on z[:, :{lo}] {s_ms:.4f} ms "
          f"[{', '.join(f'{t[1]:.4f}..{t[2]:.4f}' for t in short)}]); bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']} ({ops:.4g} "
          f"operations, {n_bytes / 1e9:.3f} GB in and out once); the "
          f"state's stream, 16 B an entry an iteration over {entries} long-"
          f"row entries, {stream_ms:.4f} ms at 3.35 TB/s; --fmad=false "
          f"issue floor {ops / FP32_ISSUE_PER_S * 1e3:.4f} ms; {regs} "
          f"registers a thread, {warps} warps an SM; {plan['rows']} rows a "
          f"block of {plan['threads']} threads ({plan['group_rows']} a "
          f"thread, {plan['register_entries']} of its entries in registers,"
          f" {plan['shared_entries']} in shared memory), a ring of "
          f"{plan['stages']} entries a thread of a group, "
          f"{plan['smem_bytes']} + {plan['static_bytes']} bytes of shared "
          f"memory)")
    # The route's tol: blocks of 100 iterations each row takes, from
    # continued one-block calls (a row's state before it stops is the
    # single run's, so the first block whose residual is not above tol is
    # where the single run stops it).
    t0 = time.perf_counter()
    Xt, rt, _ = admm.admm_all_prefixes_l2(z, y, iters=EXACT_ITERS,
                                          tol=EXACT_TOL)
    torch.cuda.synchronize()
    tol_s = time.perf_counter() - t0
    blocks = torch.zeros_like(rt, dtype=torch.int64)
    state = None
    for k in range(1, EXACT_ITERS // 100 + 1):
        _, rk, state = admm.admm_all_prefixes_l2(z, y, iters=100,
                                                 tol=EXACT_TOL, state0=state)
        blocks = torch.where((blocks == 0) & (rk <= EXACT_TOL), k, blocks)
        if bool((blocks > 0).all()):
            break
    del state
    def took(*sel):
        it = blocks[sel].double() * 100
        done = it[it > 0]
        return (f"{done.numel()} of {it.numel()} converged, iterations min "
                f"{float(done.min()):.0f}, median {float(done.median()):.0f},"
                f" max {float(done.max()):.0f}" if done.numel()
                else f"none of {it.numel()} converged")
    print(f"[14 wide] K10 B={LONG_B} T={LONG_T} at the route's iters="
          f"{EXACT_ITERS} tol={EXACT_TOL:g}: {tol_s:.3f} s with the "
          f"prologue; worst residual {float(rt.max()):.3e}; rows of up to "
          f"{lo} entries: {took(slice(None), slice(0, lo))}; the long rows: "
          f"{took(slice(None), slice(lo, None))}")
    check(bool(torch.isfinite(Xt).all())
          and torch.equal(rt <= EXACT_TOL, blocks > 0),
          "K10 at T = 8192 and the route's tol: the rows at or below tol "
          "are not the rows the one-block calls saw converge")
    return launches, out


def k10_stream():
    """K10l's streaming instance: B = 1, T = 9,216, d = 5, 200 fixed
    iterations through ``admm_all_prefixes_l2`` (the rows past 8,192
    entries on it, the other long rows on the resident instance): both
    launch counts, every row against the plain version (5e-4), rows p <
    8,192 against the launch on z[:, :8192] (bit for bit); its time (the
    launch less that launch), bound, registers and warps an SM."""
    T, cap = STREAM_T, admm.RESIDENT_ROWS
    z, y = exact_batch(1, T, D, 141)
    admm.LONG_LAUNCHES = admm.RESIDENT_LAUNCHES = 0
    X, res, st = admm.admm_all_prefixes_l2(z, y, iters=LONG_ITERS, tol=0.0)
    torch.cuda.synchronize()
    launches = admm.LONG_LAUNCHES - admm.RESIDENT_LAUNCHES
    print(f"[14 wide] admm_all_prefixes_l2 B=1 T={T} d={D} f32, {LONG_ITERS} "
          f"fixed iterations: K10l launches {admm.LONG_LAUNCHES}, streaming "
          f"{launches}, resident {admm.RESIDENT_LAUNCHES} (K10 instances "
          f"{admm.kernel_instances(T)})")
    check(launches == 1 and admm.RESIDENT_LAUNCHES == 1,
          f"admm_all_prefixes_l2 at T = {T} did not launch each K10l "
          "instance once")
    Lpk = admm.admm_prologue(z)
    (res_p, st_p), p_ms = timed_once(
        lambda: admm.admm_all_prefixes_l2_reference(
            z, y, Lpk, iters=LONG_ITERS, tol=0.0, check_every=100, rho=1.0,
            alpha=1.7))
    err = max_err(st + (res.reshape(-1),), st_p + (res_p,))
    rows = torch.arange(T, device="cuda") >= cap
    err_stream = max(float((a[rows].double() - b[rows].double()).abs().max())
                     for a, b in zip(st + (res.reshape(-1),), st_p + (res_p,)))
    del st_p, res_p
    torch.cuda.empty_cache()
    print(f"[14 wide] K10l streaming and resident vs plain (s, u, x, w, v, "
          f"res): max_abs_err={err:.3e} over every row, {err_stream:.3e} "
          f"over the rows past {cap} entries (bound {TOL[torch.float32]:g});"
          f" plain PyTorch {p_ms:.1f} ms (one call)")
    check(err <= TOL[torch.float32], "K10l streaming instance vs plain")
    zc, yc = z[:, :cap].contiguous(), y[:, :cap].contiguous()
    Xc, rc, stc = admm.admm_all_prefixes_l2(zc, yc, iters=LONG_ITERS,
                                            tol=0.0)
    same = torch.equal(X[:, :cap], Xc) and torch.equal(res[:, :cap], rc)
    for a, ac in zip(st, stc):
        a = a.reshape(1, T, -1)[:, :cap]
        if a.shape[-1] == T:
            same = same and bool((a[..., cap:] == 0).all())
            a = a[..., :cap]
        same = same and torch.equal(a.reshape(ac.shape), ac)
    print(f"[14 wide] rows p < {cap} of the T={T} launch equal the launch on "
          f"z[:, :{cap}] in every bit: {same}")
    check(same, f"K10's rows p < 8192 differ between T = {T} and 8192")
    del st, stc
    torch.cuda.empty_cache()
    kw = dict(iters=LONG_ITERS, tol=0.0, check_every=100, rho=1.0,
              alpha=1.7)
    Lpkc = admm.admm_prologue(zc)
    f_ms = time_ms(lambda: admm.launch_admm(z, y, Lpk, **kw), reps=3)[0]
    s_ms = time_ms(lambda: admm.launch_admm(zc, yc, Lpkc, **kw), reps=3)[0]
    ops = long_row_ops(1, T, D, LONG_ITERS, cap, T)
    regs, warps = admm.kernel_occupancy(T, D)["long"]
    out = {"max_abs_err": err, "ms": f_ms - s_ms, "plain_ms": p_ms,
           "library_ms": None,
           **bound(long_row_bytes(z, y, Lpk, cap, T), ops, torch.float32),
           "registers": regs, "warps_per_sm": warps}
    print(f"[14 wide] K10l streaming B=1 T={T} d={D} f32, {LONG_ITERS} fixed "
          f"iterations, rows of {cap + 1}..{T} entries: {out['ms']:.4f} ms "
          f"(the launch {f_ms:.4f} ms less the launch on z[:, :{cap}] "
          f"{s_ms:.4f} ms); bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}; --fmad=false issue floor "
          f"{ops / FP32_ISSUE_PER_S * 1e3:.4f} ms; {regs} registers a "
          f"thread, {warps} warps an SM")
    return launches, out


def exact_kernel_route_past_4096(tmp):
    """The --exact kernel route at one horizon T = 4,200 (one run, one
    random family, --g-runs 4): its long rows through K10l, against the
    auto route on the same cut at phase 11's f32 scoring bound."""
    cut = ["--t-min", "4200", "--t-max", "4200", "--runs", "1", "--g-runs",
           "4", "--cases", RANDOM_FAMILIES[0], "--device", "cuda"]
    admm.LONG_LAUNCHES = 0
    res = run_experiment(config_from_args(
        ["--exact", "--exact-solver", "kernel", "--precision", "f32", *cut,
         "--out-dir", os.path.join(tmp, "exact_kernel_4200")]))
    launches = admm.LONG_LAUNCHES
    auto = run_experiment(config_from_args(
        ["--exact", "--precision", "f32", *cut,
         "--out-dir", os.path.join(tmp, "exact_auto_4200")]))
    diff = {alg: abs(res["stats"][RANDOM_FAMILIES[0]][alg]["mean"][0]
                     - auto["stats"][RANDOM_FAMILIES[0]][alg]["mean"][0])
            for alg in ("FTRL", "FTL (exact)")}
    print(f"[14 wide] driver --exact --exact-solver kernel {' '.join(cut)}: "
          f"wall {res['wall_s']:.2f} s (auto {auto['wall_s']:.2f} s), K10l "
          f"launches {launches}, audit {json.dumps(res['audit'])}; vs auto "
          f"|mean difference| FTRL {diff['FTRL']:.3e}, FTL (exact) "
          f"{diff['FTL (exact)']:.3e} (bound {ftrl_f32_bound(4200):.3e})")
    check(launches >= 1, "the kernel route at T=4200 did not launch K10l")
    check(all(math.isfinite(v) and v <= ftrl_f32_bound(4200)
              for v in diff.values()),
          "the kernel route at T=4200 differs from the auto route")


def wide_prefixes(d, B, T, first, dtype, seed):
    """Prefix statistics ``(A (N, d, d), b (N, d))`` of B regression
    streams of T + first rows, the prefixes of first + 1 .. first + T rows
    (N = B T), summed in float64 and stored in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z, y, _ = regression_stream_batch(gen, B, T + first, d,
                                      dtype=torch.float64)
    A = torch.cumsum(z[:, :, :, None] * z[:, :, None, :], 1)[:, first:]
    b = torch.cumsum(y[:, :, None] * z, 1)[:, first:]
    return (A.reshape(-1, d, d).to(dtype).contiguous(),
            b.reshape(-1, d).to(dtype).contiguous())


def kkt_residual(A, b, x):
    """The relative residuals of the trust-region conditions at x: the
    multiplier lam = <x, b - A x> / ||x||^2 on the sphere (0 inside), then
    max(||(A + lam I) x - b|| / (||A||_F + |lam| + ||b||), max(0, ||x|| -
    1), lam |1 - ||x|||, max(0, -lam)); float64."""
    Ax = torch.bmm(A, x[..., None])[..., 0]
    nrm = torch.linalg.vector_norm(x, dim=1)
    inside = nrm < 1.0 - 1e-9
    lam = torch.where(inside, 0.0, (x * (b - Ax)).sum(1)
                      / torch.clamp(nrm * nrm, min=1e-300))
    scale = torch.clamp(torch.linalg.matrix_norm(A) + lam.abs()
                        + torch.linalg.vector_norm(b, dim=1), min=1e-300)
    stat = torch.linalg.vector_norm(Ax + lam[:, None] * x - b, dim=1) / scale
    return torch.stack([stat, torch.clamp(nrm - 1.0, min=0.0),
                        lam.abs() * (1.0 - nrm).abs() / scale,
                        torch.clamp(-lam, min=0.0) / scale]).amax(0)


def k9w_bounds(d, A, b, passes, dtype):
    iters = trs.TRS_PARAMS[dtype][1]
    size = (A.numel() + 2 * b.numel()) * A.element_size()
    return bound(size, trs_ops(d, passes.long(), iters), dtype)


def k9_wide():
    """K9w: ball_ls_action (the main path) at d = 64 on 65,536 prefix
    statistics, in f32 and f64, each held against the plain version on
    the same inputs (bit for bit; f64 1e-9, f32 5e-4), as at d = 40 on
    4,096; at d = 128 (N = 16,384) and 256 (N = 4,096; f32 in shared
    memory, its first 64 problems against the plain version bit for bit,
    f64 on the scratch route) f32 against the f64 kernel on the same
    values (5e-4) and the f64 answers held to the trust-region conditions
    (1e-9); timed with each launch's plan (shared memory or scratch, bytes
    and warps an SM), each solve's passes counted by the kernel for the
    bound."""
    for dtype in (torch.float64, torch.float32):
        A, b = wide_prefixes(PLAIN_D, *PLAIN_K9_N, 0, dtype, 150 + PLAIN_D)
        got = trs.trs_solve(A, b)
        want, p_ms = timed_once(lambda: trs.trs_solve_reference(A, b))
        err = max_err((got,), (want,))
        print(f"[14 wide] K9w d={PLAIN_D} {dtype} on {A.shape[0]} prefixes "
              f"(singular ones included): vs plain max_abs_err={err:.3e} "
              f"(bound {TOL[dtype]:g}), equal in every bit "
              f"{bool(torch.equal(got, want))}; plain PyTorch {p_ms:.1f} ms "
              f"(one call)")
        check(err <= TOL[dtype], f"K9w d={PLAIN_D} {dtype} vs plain")
        check(bool(torch.equal(got, want)), f"K9w d={PLAIN_D} {dtype} is not "
                                            f"its plain version bit for bit")
    timing, path, launches = {}, {}, 0
    for d, B, T, first in K9W_PATH + (K9W_D256,):
        A64, b64 = wide_prefixes(d, B, T, first, torch.float64, 160 + d)
        A32, b32 = A64.float(), b64.float()
        if first > 0:
            # f32 against f64 on the same values, where the prefixes are
            # well conditioned (t >= 4d).  A singular prefix's Gram
            # rounded to f32 is not PSD at f64's floor, so the path's
            # prefixes keep their f64 values.
            A64, b64 = A32.double(), b32.double()
        n = A32.shape[0]
        res = {}
        for dtype, (A, b) in ((torch.float32, (A32, b32)),
                              (torch.float64, (A64, b64))):
            on_path = d == K9W_PATH[0][0]
            if on_path:
                if dtype == torch.float32:
                    trs.TRS_WIDE_LAUNCHES = 0
                x_path = ball_ls_action(A, b)           # the main path
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    launches = trs.TRS_WIDE_LAUNCHES
                    check(launches == 1, "ball_ls_action at d = 64 did not "
                                         "launch K9w once")
                want, p_ms = timed_once(
                    lambda: trs.trs_solve_reference(A, b))
                err = max_err((x_path,), (want,))
                print(f"[14 wide] K9w d={d} {dtype} N={n} through "
                      f"ball_ls_action: vs plain on the same inputs "
                      f"max_abs_err={err:.3e} (bound {TOL[dtype]:g}), equal "
                      f"in every bit {bool(torch.equal(x_path, want))}; "
                      f"plain PyTorch {p_ms:.1f} ms (one call)")
                check(err <= TOL[dtype], f"K9w d={d} {dtype} N={n} vs plain")
                check(bool(torch.equal(x_path, want)), f"K9w d={d} {dtype} "
                      f"N={n} is not its plain version bit for bit")
                path[dtype] = (err, p_ms)
                del want
            passes = torch.zeros(n, dtype=torch.int32, device="cuda")
            x = trs.launch_trs_solve(A, b, passes)      # the warm-up
            if on_path:
                check(torch.equal(x, x_path), f"K9w d={d} {dtype}: the "
                      f"launch differs from ball_ls_action's")
            plan = trs.wide_plan("K9w", d, dtype, n)
            route = ("shared memory" if plan["smem_bytes"] > 0 else
                     "scratch")
            if d == K9W_D256[0] and dtype == torch.float32:
                # The cut batch against the plain version.
                cut = slice(0, K9W_D256_PLAIN)
                want, p_ms = timed_once(lambda: trs.trs_solve_reference(
                    A[cut], b[cut]))
                err = max_err((x[cut],), (want,))
                same = bool(torch.equal(x[cut], want))
                print(f"[14 wide] K9w d={d} {dtype} ({route}): the first "
                      f"{K9W_D256_PLAIN} problems of the launch vs plain "
                      f"max_abs_err={err:.3e} (bound {TOL[dtype]:g}), equal "
                      f"in every bit {same}; plain PyTorch {p_ms:.1f} ms")
                check(same, f"K9w d={d} {dtype} ({route}) differs from its "
                            f"plain version")
                del want
            if d == K9W_D256[0]:
                check(route == ("shared memory" if dtype == torch.float32
                                else "scratch"),
                      f"K9w d={d} {dtype} is on the {route} route")
            ms = time_ms(lambda: trs.launch_trs_solve(A, b), reps=5,
                         warm=True)
            bd = k9w_bounds(d, A, b, passes, dtype)
            res[dtype] = x
            print(f"[14 wide] K9w d={d} {dtype} N={n} (prefixes of {first + 1}"
                  f"..{first + T} rows): kernel {ms[0]:.4f} ms (min "
                  f"{ms[1]:.4f}, max {ms[2]:.4f}); bound {bd['bound_ms']:.4f} "
                  f"ms by {bd['bound_by']}; {float(passes.double().mean()):.4f}"
                  f" ridge solves a solve (max {int(passes.max())}); workspace "
                  f"{'shared memory' if plan['smem_bytes'] > 0 else 'scratch'} "
                  f"({plan['smem_bytes']} B shared a warp), {plan['warps']} "
                  f"warps, {plan['registers']} registers a thread, "
                  f"{plan['warps_per_sm']} warps an SM")
            check(bool(torch.isfinite(x).all()), f"K9w d={d} {dtype}: not "
                                                 f"finite")
            timing[(d, dtype)] = {"ms": ms[0], **bd,
                                  "registers": plan["registers"],
                                  "warps_per_sm": plan["warps_per_sm"]}
        diff = float((res[torch.float32].double()
                      - res[torch.float64]).abs().max())
        kkt = float(kkt_residual(A64, b64, res[torch.float64]).max())
        held = (f"bound {TOL[torch.float32]:g}" if first > 0 else
                "not held: singular prefixes of 1..63 rows round apart")
        print(f"[14 wide] K9w d={d}: f32 vs the f64 kernel on the same values "
              f"max_abs_err={diff:.3e} ({held}); f64 trust-region "
              f"conditions, worst relative residual {kkt:.3e} (bound 1e-9)")
        if first > 0:
            check(diff <= TOL[torch.float32], f"K9w d={d} f32 vs f64")
        check(kkt <= 1e-9, f"K9w d={d} f64 KKT")
        del A64, b64, A32, b32, res
        torch.cuda.empty_cache()
    out = {"max_abs_err": path[torch.float32][0],
           "plain_ms": path[torch.float32][1], "library_ms": None,
           **timing[(K9W_PATH[0][0], torch.float32)]}
    return launches, out


def k8w_statistics(z, y):
    """The final statistics (A, b) of a (B, T, d) batch, summed in K8's
    order (round by round)."""
    B, T, d = z.shape
    A = z.new_zeros((B, d, d))
    b = z.new_zeros((B, d))
    for t in range(T):
        A = A + z[:, t, :, None] * z[:, t, None, :]
        b = b + y[:, t, None] * z[:, t]
    return A, b


def k8w_plain(z_tm, y_tm, flags, eta, seqs):
    """``quadratic_regrets_reference`` on the sequences ``seqs``, K8W_CHUNK
    of them a call (its sequences are independent, so the calls give one
    call's outputs): ``(cum, comp, x_c, x_last)`` and the calls' summed
    CUDA-event milliseconds."""
    outs, ms = [], 0.0
    for i in range(0, seqs.numel(), K8W_CHUNK):
        s = seqs[i:i + K8W_CHUNK]
        o, t = timed_once(lambda: trs.quadratic_regrets_reference(
            z_tm[..., s], y_tm[:, s], flags[s], eta[s]))
        outs.append(o)
        ms += t
        torch.cuda.empty_cache()
    return tuple(torch.cat([o[k] for o in outs], dim=-1)
                 for k in range(4)), ms


def k8_wide(tmp):
    """K8w: simulate_quadratic_batch (the main path) at the
    quadratic_exact_ftl shape (B = 4,096, T = 1,024, half FTL) at d = 64
    in f32, held against the plain version on every sequence (5e-4), and
    the same shape in f64 on every K8W_SAMPLE-th sequence (1e-9); at d =
    40 against the plain version (B = 256, T = 128, f64 1e-9, f32 5e-4);
    x_c against K9w bit for bit on the final statistics at d = 40, 64 and
    128; timed at d = 64 in f32 and f64 (5 launches) and at d = 128 in f32
    (its one launch); the quadratic study at d = 64 through its entry."""
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(170 + PLAIN_D)
        z, y, _ = regression_stream_batch(gen, *PLAIN_K8, PLAIN_D,
                                          dtype=dtype)
        B = z.shape[0]
        flags = (torch.arange(B, device="cuda") % 2).to(torch.int32)
        eta = torch.linspace(0.5, 2.0, B, device="cuda", dtype=dtype)
        z_tm, y_tm = game.time_major(z, y)
        got = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
        want, p_ms = timed_once(lambda: trs.quadratic_regrets_reference(
            z_tm, y_tm, flags, eta))
        err = max_err(got, want)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        A, b = k8w_statistics(z, y)
        diff = int((got[2].t() != trs.trs_solve(A, b)).sum())
        print(f"[14 wide] K8w d={PLAIN_D} {dtype} B={B} T={z.shape[1]}, half "
              f"FTL: vs plain (cum, comp, x_c, x_last) max_abs_err="
              f"{err:.3e} (bound {TOL[dtype]:g}), equal in every bit "
              f"{same}; x_c vs K9w on the final statistics: {diff} "
              f"values differ in any bit; plain PyTorch {p_ms:.1f} ms "
              f"(one call)")
        check(err <= TOL[dtype], f"K8w d={PLAIN_D} {dtype} vs plain")
        check(same, f"K8w d={PLAIN_D} {dtype} is not its plain version bit "
                    f"for bit")
        check(diff == 0, f"K8w's x_c differs from K9w at d={PLAIN_D} {dtype}")
    timing, path, launches = {}, {}, 0
    for d, dtype in ((64, torch.float32), (64, torch.float64),
                     (128, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(180 + d)
        z, y, _ = regression_stream_batch(gen, K8W_B, K8W_T, d, dtype=dtype)
        flags = (torch.arange(K8W_B, device="cuda") >= K8W_B // 2).to(
            torch.int32)
        eta = game.per_sequence(1.0, K8W_B, dtype, "cuda")
        on_path = d == 64 and dtype == torch.float32
        if on_path:
            trs.QUAD_WIDE_LAUNCHES = 0
            t0 = time.perf_counter()
            run = simulate_quadratic_batch(z, y, flags, eta)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = trs.QUAD_WIDE_LAUNCHES
            check(launches == 1, "simulate_quadratic_batch at d = 64 did not "
                                 "launch K8w once")
            print(f"[14 wide] simulate_quadratic_batch B={K8W_B} T={K8W_T} "
                  f"d={d} {dtype}, half FTL: K8w launches {launches}, wall "
                  f"{wall:.3f} s; mean regret FTL "
                  f"{float(run.regret[flags == 1].double().mean()):.4f}, FTRL "
                  f"{float(run.regret[flags == 0].double().mean()):.4f}")
        z_tm, y_tm = game.time_major(z, y)
        passes = torch.zeros((K8W_T + 1, K8W_B), dtype=torch.int32,
                             device="cuda")
        # The warm-up at d = 64; at d = 128 the one timed launch.
        outs, one_ms = timed_once(lambda: trs.launch_quadratic_regrets_wide(
            z_tm, y_tm, flags, eta, passes))
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"K8w d={d} {dtype}: outputs not finite")
        if on_path:
            check(torch.equal(run.cum_loss, outs[0])
                  and torch.equal(run.comp_loss, outs[1])
                  and torch.equal(run.x_last, outs[3].t()),
                  "K8w's launch differs from simulate_quadratic_batch's")
            del run
        A, b = k8w_statistics(z, y)
        diff = int((outs[2].t() != trs.trs_solve(A, b)).sum())
        del A, b
        check(diff == 0, f"K8w's x_c differs from K9w at d={d} {dtype}")
        held = ""
        if d == 64:
            step = 1 if dtype == torch.float32 else K8W_SAMPLE
            seqs = torch.arange(0, K8W_B, step, device="cuda")
            want, p_ms = k8w_plain(z_tm, y_tm, flags, eta, seqs)
            err = max_err(tuple(o[..., seqs] for o in outs), want)
            same = all(torch.equal(o[..., seqs], w)
                       for o, w in zip(outs, want))
            del want
            held = (f"; vs plain on {seqs.numel()} of its {K8W_B} sequences "
                    f"(every {step}) max_abs_err={err:.3e} (bound "
                    f"{TOL[dtype]:g}), equal in every bit {same}, plain "
                    f"PyTorch {p_ms:.1f} ms ({K8W_CHUNK} sequences a call)")
            check(err <= TOL[dtype], f"K8w d={d} {dtype} B={K8W_B} "
                                     f"T={K8W_T} vs plain")
            check(same, f"K8w d={d} {dtype} B={K8W_B} T={K8W_T} is not its "
                        f"plain version bit for bit")
            path[dtype] = (err, p_ms)
            ms = time_ms(lambda: trs.launch_quadratic_regrets(
                z_tm, y_tm, flags, eta), reps=5, warm=True)
            spread = f"(min {ms[1]:.4f}, max {ms[2]:.4f}; 5 launches)"
        else:
            ms = (one_ms,)
            spread = "(one launch)"
        plan = trs.wide_plan("K8w", d, dtype, K8W_B)
        iters = trs.TRS_PARAMS[dtype][1]
        ftl = flags != 0
        steps = K8W_B * K8W_T
        ops = (int(ftl.sum()) * K8W_T * quad_round_ops(d, True)
               + int((~ftl).sum()) * K8W_T * quad_round_ops(d, False)
               + trs_ops(d, passes[:K8W_T][:, ftl].long(), iters)
               + trs_ops(d, passes[K8W_T].long(), iters)
               + K8W_B * (2 * d * d + 2 * d + 4))
        item = z.element_size()
        n_bytes = steps * (d + 1) * item + K8W_B * (8 + item * (2 + 2 * d))
        bd = bound(n_bytes, ops, dtype)
        solves = passes[:K8W_T][:, ftl].double()
        print(f"[14 wide] K8w d={d} {dtype} B={K8W_B} T={K8W_T}, half FTL: "
              f"kernel {ms[0]:.4f} ms {spread}; bound {bd['bound_ms']:.4f} "
              f"ms by {bd['bound_by']} ({ops:.4g} operations); "
              f"{float(solves.mean()):.4f} ridge solves an FTL round (max "
              f"{int(solves.max())}); workspace "
              f"{'shared memory' if plan['smem_bytes'] > 0 else 'scratch'} "
              f"({plan['smem_bytes']} B shared a warp), {plan['warps']} "
              f"warps, {plan['registers']} registers a thread, "
              f"{plan['warps_per_sm']} warps an SM; x_c vs K9w on the final "
              f"statistics: {diff} values differ in any bit{held}; digest "
              f"{output_digest(outs)}")
        timing[(d, dtype)] = {"ms": ms[0], **bd,
                              "registers": plan["registers"],
                              "warps_per_sm": plan["warps_per_sm"]}
        del z, y, z_tm, y_tm, outs, passes
        torch.cuda.empty_cache()
    trs.QUAD_WIDE_LAUNCHES = 0
    out_dir = os.path.join(tmp, "quad_d64")
    res = quad_study_main(["--d", "64", "--out-dir", out_dir, "--dpi", "60",
                           "--device", "cuda"])
    ftl = res["stats"]["FTL (exact LS)"]["mean"]
    ftrl = res["stats"]["FTRL"]["mean"]
    print(f"[14 wide] quadratic_study --d 64 (default horizons, runs and "
          f"replicates) --device cuda: wall {res['wall_s']:.3f} s, K8w "
          f"launches {trs.QUAD_WIDE_LAUNCHES}; regret at T={res['config']['t_max']}"
          f": FTL {ftl[-1]:.4f}, FTRL {ftrl[-1]:.4f}")
    check(trs.QUAD_WIDE_LAUNCHES == 1, "the d = 64 study did not make one "
                                       "K8w launch")
    check(all(math.isfinite(v) for v in ftl + ftrl) and ftl[-1] < ftrl[-1],
          "d = 64 study results not finite, or FTL not below FTRL")
    out = {"max_abs_err": path[torch.float32][0],
           "plain_ms": path[torch.float32][1], "library_ms": None,
           **timing[(64, torch.float32)]}
    return launches, out


def phase_wide(tmp):
    """Phase 14: K10 past T = 4,096 (K10l) and K8/K9 past d = 32 (K8w,
    K9w)."""
    walls = {}
    t = time.perf_counter()
    k10l = k10_long()
    torch.cuda.empty_cache()
    k10s = k10_stream()
    torch.cuda.empty_cache()
    exact_kernel_route_past_4096(tmp)
    walls["K10l"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    k9w = k9_wide()
    walls["K9w"] = time.perf_counter() - t
    t = time.perf_counter()
    k8w = k8_wide(tmp)
    walls["K8w"] = time.perf_counter() - t
    print(f"[14 wide] phase wall {sum(walls.values()):.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in walls.items())})")
    return ({"K10l": k10l[0], "K10ls": k10s[0], "K9w": k9w[0],
             "K8w": k8w[0]},
            {"K10l": k10l[1], "K10ls": k10s[1], "K9w": k9w[1],
             "K8w": k8w[1]})


def main() -> int:
    walls = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[label] = round(time.perf_counter() - t0, 1)
        return out

    name = timed("1 device", phase_device)
    timed("2 build", phase_build)
    timed("3 kernels", phase_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, res, launches = timed("4 main", phase_main, tmp)
        timing = timed("4 times", time_kernels)
        timed("5 parity", phase_parity, cfg, res, tmp)
        sweep_launches, sweep_timing = timed("6 sweeps", phase_sweeps)
        stream_launches, stream_timing = timed("7 stream", phase_stream, tmp)
        packed_launches, packed_timing = timed("8 packed", phase_packed)
        quad_launches, quad_timing = timed("9 quadratic", phase_quadratic,
                                           tmp)
        pod_launches, pod_timing = timed("10 pod", phase_pod, tmp)
        exact_launches, exact_timing = timed("11 exact", phase_exact, tmp)
        timed("12 ssn", phase_ssn, tmp)
    storage_launches, storage_timing, storage_k1_bench = timed(
        "13 storage", phase_storage)
    with tempfile.TemporaryDirectory() as tmp:
        wide_launches, wide_timing = timed("14 wide", phase_wide, tmp)
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
        {"name": "smart_prefix_kernel (K6a: SMART threshold sweep, the "
                 "FTL prefix once per sequence; K6's first of 2 launches "
                 "a call)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/smart_sweep_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_smart.py:248",
         "launches": sweep_launches["K6a"], **sweep_timing["K6a"]},
        {"name": "smart_tail_kernel (K6b: SMART threshold sweep, the FTRL "
                 "tails of the switched pairs; K6's second of 2 launches "
                 "a call)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/smart_sweep_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_smart.py:248",
         "launches": sweep_launches["K6b"], **sweep_timing["K6b"]},
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
        {"name": "trs_refill_kernel (K9: batched ball-constrained least "
                 "squares, lanes that refill)",
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
        {"name": "admm_kernel (K10: all-prefix exact-FTL ADMM, l2 ball)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/admm_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_admm.py:77",
         "launches": exact_launches, **exact_timing},
        {"name": "admm_resident_kernel (K10l resident: K10's rows of "
                 "4,097 to 8,192 entries, four a block, s and u on the chip)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/admm_long_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_admm.py:77",
         "launches": wide_launches["K10l"], **wide_timing["K10l"]},
        {"name": "admm_long_kernel (K10l streaming: K10's rows longer than "
                 "8,192 entries, a block a row, s and u streamed)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/admm_long_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_admm.py:77",
         "launches": wide_launches["K10ls"], **wide_timing["K10ls"]},
        {"name": "trs_wide_kernel (K9w: batched ball-constrained least "
                 "squares past d = 32, a warp a problem)",
         "route": "cuda",
         "source": "online_convex_optimization_tpu_torch/csrc/trs_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_trs.py:62",
         "launches": wide_launches["K9w"], **wide_timing["K9w"]},
        {"name": "quad_wide_kernel (K8w: quadratic game past d = 32, a warp "
                 "a sequence)",
         "route": "cuda",
         "source":
             "online_convex_optimization_tpu_torch/csrc/quad_game_kernel.cu",
         "replaces": "online_convex_optimization_tpu/ops/pallas_trs.py:206",
         "launches": wide_launches["K8w"], **wide_timing["K8w"]},
    ]
    for pair in PAIRS:
        z_name, y_name = (str(t)[6:] for t in pair)
        for key, src, line, what in STORAGE_KERNELS:
            entry = dict(storage_timing[pair][key])
            for extra in ("ms_min", "ms_max", "f32_ms"):
                entry.pop(extra)
            kernels.append({
                "name": f"{what} ({key}, {z_name} z, {y_name} y: "
                        f"oco_*_{pair_name(pair)})",
                "route": "cuda",
                "source": f"online_convex_optimization_tpu_torch/csrc/{src}",
                "replaces": line,
                "launches": storage_launches[pair][key], **entry})
    bench = dict(storage_k1_bench)
    for extra in ("ms_min", "ms_max", "f32_ms"):
        bench.pop(extra)
    kernels.append({
        "name": "regret_kernel (K1 at bench.py's shape: 262,144 sequences, "
                "T=1024, FTRL, bfloat16 z, int8 y: oco_regrets_fused_bf16i8)",
        "route": "cuda",
        "source": "online_convex_optimization_tpu_torch/csrc/regret_kernel.cu",
        "replaces": "online_convex_optimization_tpu/ops/pallas_game.py:679",
        "launches": storage_launches[(torch.bfloat16, torch.int8)]["K1"],
        **bench})
    print(f"[walls] seconds by phase {json.dumps(walls)}, total "
          f"{sum(walls.values()):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
