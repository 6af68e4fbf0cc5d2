#!/usr/bin/env python3
"""K1's and K2's output digests and times on the plain pipeline's
launches, for the checkout it is run from.

    cd <a checkout of any commit of the port>
    python3 <path to>/scripts/k1k2_compare.py [--scaling | --large-d | --trace]

It builds its inputs only from functions every version of the port has
(``random_game_batch``, f64, d = 5, eta = sqrt(2)), so that two commits,
each run from its own checkout in one chip call, can be held against each
other: equal digests mean equal outputs in every bit.

- Digests (sha256, 16 hex digits) of ``regrets_fused`` (cum, comp, x_last)
  and ``smart_regrets`` (cum, comp, x_last, switch_t) through the public
  wrappers, at three shapes: ``g``, the g(T) table (10 horizons 100..1,000
  x 1,000 FTRL runs, horizon after horizon, padded to T = 1,000); ``eval``,
  the largest case ("Massart noise 10%": 48 runs x 10 horizons x 20
  replicates = 9,600 sequences) doubled as the evaluation plays it (FTRL
  then FTL; thresholds sqrt(2T) then 0.9 sqrt(2T)); ``chunk``, the
  parent's evaluation chunk (2 x 4,096).  A checkout with the evaluation's
  one-copy entries (``regret_plays``, ``smart_plays``) also digests their
  outputs in the doubled layout, which must equal the wrappers'.
- Times (median, min, max ms over 5 CUDA-event-timed calls) of each kernel
  launch that the plain pipeline makes (``--t-max 1000 --g-runs 1000``),
  on prepared inputs as that checkout's wrappers prepare them, and their
  sum on the path: the parent's 17 K1 and 7 K2 launches (a g(T) batch a
  horizon, chunks of 4,096 doubled) or the change's 5 and 4 (one g(T)
  launch, one a case).
- ``--scaling``: K1's and K2's launch times against B (32 to 19,200
  sequences of T = 1,000): K1 with one FTRL play, one FTL play and both,
  K2 with two thresholds a sequence.
- ``--large-d``: K1 and K2 at ``chip_smoke.py`` phase 8's large-d shape
  (B = 8,192, T = 256, d = 256, f64 and f32), with digests.
- ``--trace``: the full plain pipeline on the card with the driver's
  ``profile_dir`` (the evaluation under ``torch.profiler``): the traced
  window, the device's busy share of it (union of kernel, copy and set
  intervals), K1's and K2's launches and device time there, the copies'
  time, and the host's seconds by step (``phase_s``).

Prints one JSON line.  Needs one CUDA card.
"""

import argparse
import hashlib
import json
import math
import os
import statistics
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    random_game_batch,
)
from online_convex_optimization_tpu_torch.ops import game, smart  # noqa: E402

ETA = math.sqrt(2.0)
T_GRID = tuple(range(100, 1001, 100))
T_MAX = 1000
DEV = "cuda"
NEW = hasattr(game, "regret_plays")


def digest(outs):
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return [statistics.median(ts), min(ts), max(ts)]


def case_lengths(runs, reps):
    """A case's horizons as the evaluation stacks them: run, then horizon,
    then replicate."""
    return torch.tensor(T_GRID, dtype=torch.int32, device=DEV
                        ).repeat_interleave(reps).repeat(runs)


def data(B, T, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return random_game_batch(gen, B, T, 5, dtype=torch.float64)


def thresholds(lengths):
    root = torch.sqrt(2.0 * lengths.double())
    return root, 0.9 * root


# ------------------------------------------------------------ the digests

def digests():
    out = {}
    shapes = {
        "g": (torch.tensor(T_GRID, dtype=torch.int32, device=DEV
                           ).repeat_interleave(1000), 90),
        "eval": (case_lengths(48, 20), 91),
        "chunk": (case_lengths(48, 20)[:4096], 92),
    }
    for name, (lengths, seed) in shapes.items():
        B = lengths.shape[0]
        z, y = data(B, T_MAX, seed)
        if name == "g":
            got = game.regrets_fused(z, y, 0, ETA, lengths)
            out["K1 g"] = digest(got)
            if NEW:
                plays = game.regret_plays(z, y, (0,), ETA, lengths, False)
                out["K1 g (plays)"] = digest([p[0] for p in plays])
            continue
        z2, y2, l2 = torch.cat([z, z]), torch.cat([y, y]), torch.cat(
            [lengths, lengths])
        flags = (torch.arange(2 * B, device=DEV) >= B).to(torch.int32)
        th = torch.cat(thresholds(lengths))
        out[f"K1 {name}"] = digest(game.regrets_fused(z2, y2, flags, ETA, l2))
        out[f"K2 {name}"] = digest(smart.smart_regrets(z2, y2, th, ETA, l2))
        if NEW:
            cum, comp, x_last = game.regret_plays(z, y, (0, 1), ETA, lengths,
                                                  False)
            out[f"K1 {name} (plays)"] = digest(
                (cum.reshape(-1), comp.reshape(-1), x_last.reshape(-1, 5)))
            cum, comp, x_last, tau = smart.smart_plays(
                z, y, torch.stack(thresholds(lengths)), ETA, lengths, False)
            out[f"K2 {name} (plays)"] = digest(
                (cum.reshape(-1), comp.repeat(2), x_last.reshape(-1, 5),
                 tau.reshape(-1)))
        del z, y, z2, y2
    return out


# ------------------------------------------------- the path's launches

def path_launches():
    """(name, K1 launch, K2 launch or None) on prepared inputs for each
    launch of the plain pipeline, as this checkout makes them."""
    cases = [("random", case_lengths(48, 16)), ("massart",
                                                case_lengths(48, 20)),
             ("flips", case_lengths(1, 1)), ("leaders", case_lengths(1, 1))]
    out = []
    if NEW:
        g_len = torch.tensor(T_GRID, dtype=torch.int32, device=DEV
                             ).repeat_interleave(1000)
        z, y = data(g_len.shape[0], T_MAX, 93)
        out.append(("g", prepared_k1(z, y, g_len, (0,)), None))
        for i, (name, lengths) in enumerate(cases):
            z, y = data(lengths.shape[0], T_MAX, 94 + i)
            out.append((name, prepared_k1(z, y, lengths, (0, 1)),
                        prepared_k2(z, y, lengths)))
        return out
    for T in T_GRID:
        z, y = data(1000, T, 93)
        lengths = torch.full((1000,), T, dtype=torch.int32, device=DEV)
        flags = torch.zeros(1000, dtype=torch.int32, device=DEV)
        out.append((f"g T={T}", prepared_tm_k1(z, y, lengths, flags), None))
    for i, (name, lengths) in enumerate(cases):
        z, y = data(lengths.shape[0], T_MAX, 94 + i)
        for c, s in enumerate(range(0, lengths.shape[0], 4096)):
            zc, yc, lc = z[s:s + 4096], y[s:s + 4096], lengths[s:s + 4096]
            n = lc.shape[0]
            z2, y2, l2 = torch.cat([zc, zc]), torch.cat([yc, yc]), torch.cat(
                [lc, lc])
            flags = (torch.arange(2 * n, device=DEV) >= n).to(torch.int32)
            out.append((f"{name} chunk {c}",
                        prepared_tm_k1(z2, y2, l2, flags),
                        prepared_tm_k2(z2, y2, l2, torch.cat(
                            thresholds(lc)))))
    return out


def prepared_k1(z, y, lengths, plays):
    B, T, _ = z.shape
    flags = torch.tensor(plays, dtype=torch.int32, device=DEV)[:, None
                                                              ].expand(-1, B)
    flags = flags.contiguous()
    table = game.eta_table(ETA, B, T, z.dtype, z.device)
    return lambda: game.launch_regrets(z, y, flags, *table, lengths, False)


def prepared_k2(z, y, lengths):
    B, T, _ = z.shape
    ths = torch.stack(thresholds(lengths)).contiguous()
    table = game.eta_table(ETA, B, T, z.dtype, z.device)
    return lambda: smart.launch_smart(z, y, ths, *table, lengths, False)


def prepared_tm_k1(z, y, lengths, flags):
    z_tm, y_tm = game.time_major(z, y)
    eta = torch.full((z.shape[0],), ETA, dtype=z.dtype, device=DEV)
    return lambda: game.launch_time_major(z_tm, y_tm, flags, eta, lengths,
                                          False)


def prepared_tm_k2(z, y, lengths, ths):
    z_tm, y_tm = game.time_major(z, y)
    eta = torch.full((z.shape[0],), ETA, dtype=z.dtype, device=DEV)
    return lambda: smart.launch_time_major(z_tm, y_tm, ths, eta, lengths,
                                           False)


def path_times():
    out, total = {}, {"K1": 0.0, "K2": 0.0}
    counts = {"K1": 0, "K2": 0}
    for name, k1, k2 in path_launches():
        for key, fn in (("K1", k1), ("K2", k2)):
            if fn is None:
                continue
            ms = time_ms(fn)
            out[f"{key} {name}"] = ms
            total[key] += ms[0]
            counts[key] += 1
    out["launches"] = counts
    out["path ms (sum of medians)"] = total
    return out


# ----------------------------------------------------------- the scaling

def scaling():
    """K1 and K2 launch times against the number of sequences B at T =
    1,000 (every sequence that long, f64): K1 with one FTRL play, one FTL
    play and both; K2 with two thresholds a sequence (sqrt(2T) and 0.9
    sqrt(2T)).  A checkout without the plays entries plays the two as a
    doubled batch."""
    out = {}
    for B in (32, 1024, 4096, 9600, 19200):
        z, y = data(B, T_MAX, 95)
        lengths = torch.full((B,), T_MAX, dtype=torch.int32, device=DEV)
        if NEW:
            runs = {"K1 FTRL": prepared_k1(z, y, lengths, (0,)),
                    "K1 FTL": prepared_k1(z, y, lengths, (1,)),
                    "K1 both": prepared_k1(z, y, lengths, (0, 1)),
                    "K2 two thresholds": prepared_k2(z, y, lengths)}
        else:
            zero = torch.zeros(B, dtype=torch.int32, device=DEV)
            z2, y2, l2 = torch.cat([z, z]), torch.cat([y, y]), torch.cat(
                [lengths, lengths])
            both = (torch.arange(2 * B, device=DEV) >= B).to(torch.int32)
            runs = {"K1 FTRL": prepared_tm_k1(z, y, lengths, zero),
                    "K1 FTL": prepared_tm_k1(z, y, lengths, zero + 1),
                    "K1 both": prepared_tm_k1(z2, y2, l2, both),
                    "K2 two thresholds": prepared_tm_k2(
                        z2, y2, l2, torch.cat(thresholds(lengths)))}
        for name, fn in runs.items():
            out[f"{name} B={B}"] = time_ms(fn)
        del z, y, runs
    return out


# ------------------------------------------------------------ large d

def large_d():
    """K1 and K2 at chip_smoke.py phase 8's large-d shape (B = 8,192,
    T = 256, d = 256, f64 and f32; flags alternating FTRL and FTL, the
    threshold sqrt(2T)), one play or threshold a sequence, with digests."""
    out = {}
    B, T, d = 8192, 256, 256
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=DEV).manual_seed(81)
        z, y = random_game_batch(gen, B, T, d, dtype=dtype)
        lengths = torch.full((B,), T, dtype=torch.int32, device=DEV)
        flags = (torch.arange(B, device=DEV) % 2).to(torch.int32)
        thr = torch.full((B,), math.sqrt(2.0 * T), dtype=dtype, device=DEV)
        if NEW:
            table = game.eta_table(ETA, B, T, dtype, DEV)
            k1 = lambda: game.launch_regrets(z, y, flags[None], *table,
                                             lengths, False)
            k2 = lambda: smart.launch_smart(z, y, thr[None], *table, lengths,
                                            False)
        else:
            k1 = prepared_tm_k1(z, y, lengths, flags)
            k2 = prepared_tm_k2(z, y, lengths, thr)
        out[f"K1 {dtype}"] = time_ms(k1, reps=3)
        out[f"K2 {dtype}"] = time_ms(k2, reps=3)
        out[f"K1 {dtype} digest"] = digest(
            game.regrets_fused(z, y, flags, ETA, lengths))
        out[f"K2 {dtype} digest"] = digest(
            smart.smart_regrets(z, y, thr, ETA, lengths))
        del z, y
    return out


# ------------------------------------------------------------ the trace

def trace_summary():
    from online_convex_optimization_tpu_torch.experiments.config import (
        ExperimentConfig)
    from online_convex_optimization_tpu_torch.experiments.driver import (
        run_experiment)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ExperimentConfig(t_max=1000, g_runs=1000, dpi=100, device=DEV,
                               out_dir=os.path.join(tmp, "out"),
                               profile_dir=os.path.join(tmp, "prof"))
        res = run_experiment(cfg)
        with open(os.path.join(tmp, "prof", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    device = [e for e in timed if e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset")]
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    busy, end = 0.0, -1.0
    for e in sorted(device, key=lambda e: float(e["ts"])):
        a, b = max(float(e["ts"]), end), float(e["ts"]) + float(e["dur"])
        if b > a:
            busy += b - a
        end = max(end, b)

    def kernel_sum(marker):
        mine = [e for e in device if e.get("cat") == "kernel"
                and marker in e["name"]]
        return {"launches": len(mine),
                "device_ms": sum(float(e["dur"]) for e in mine) / 1e3}

    window_ms = (hi - lo) / 1e3
    return {"window_ms": window_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / window_ms,
            "K1": kernel_sum("regret_kernel"),
            "K2": kernel_sum("smart_kernel"),
            "copies_ms": sum(float(e["dur"]) for e in device
                             if e.get("cat") == "gpu_memcpy") / 1e3,
            "wall_s": res["wall_s"], "phase_s": res["phase_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", action="store_true",
                    help="trace the full plain pipeline instead")
    ap.add_argument("--scaling", action="store_true",
                    help="time K1 and K2 against B at T = 1,000 instead")
    ap.add_argument("--large-d", action="store_true",
                    help="time K1 and K2 at d = 256 instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1k2_compare: no CUDA device")
    res = {"tree": os.getcwd(), "card": torch.cuda.get_device_name(0)}
    if args.trace:
        res["trace"] = trace_summary()
    elif args.scaling:
        res["scaling"] = scaling()
    elif args.large_d:
        res["large_d"] = large_d()
    else:
        res["digests"] = digests()
        torch.cuda.empty_cache()
        res["times"] = path_times()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
