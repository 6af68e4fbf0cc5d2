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

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
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

import torch

from online_convex_optimization_tpu_torch.data.device import (
    random_game_batch,
    random_time_major_batch,
)
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.experiments.config import ExperimentConfig
from online_convex_optimization_tpu_torch.experiments.driver import run_experiment
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)
from online_convex_optimization_tpu_torch.ops import game, smart
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


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
    for key, kern, wrap, plain in (("K1", k1, w1, p1), ("K2", k2, w2, p2)):
        k_ms = time_ms(kern, reps=5, inner=10)
        w_ms = time_ms(wrap, reps=5)
        p_ms = time_ms(plain, reps=3)
        out[key].update(ms=k_ms[0], plain_ms=p_ms[0])
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
                timing[key] = {"max_abs_err": err, "ms": k_ms[0],
                               "plain_ms": p_ms}
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
    return {"max_abs_err": err, "ms": k_ms[0], "plain_ms": p_ms}


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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
