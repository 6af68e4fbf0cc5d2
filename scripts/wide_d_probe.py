#!/usr/bin/env python3
"""The nine wide instances (K1w-K7w) at the path shapes of large d: times,
bounds, digests and each launch's registers, warps an SM, local frame,
shared memory and state buffer.

    cd <a checkout of the port>
    python3 <path to>/scripts/wide_d_probe.py [--d 1024]
        [--cases k1f64 k1f32 k2 k4 k4ftrl k4ftl k3 k3bf16 k5f64 k5f32 k6
                 k6f32 k7ftrl k7ftl adds]
        [--reps 3] [--tail-groups 1 2 8]

Its inputs come from ``data/device.py``'s generators and fixed seeds (the
sweep, packed and synthetic cases from ``chip_smoke.py`` phase 16's own
generators and seeds), and it calls only the launchers
(``launch_regrets``, ``launch_smart``, ``launch_stream_time_major``,
``launch_play_packed``, ``launch_play_packed_eta``, ``launch_eta_sweep``,
``launch_smart_prefix``, ``launch_smart_tails``, ``launch_synthetic``), so
equal digests mean equal outputs in every bit, and the same command run
from two checkouts compares them.  At d <= 512 it times the large-d
instance (D == -1, state in each thread's local frame); past 512 the wide
instances: ``--d 512 513`` sets the two side by side.

Cases (each at every ``--d``; ``k1f64`` alone past d = 1,024):

- ``k1f64``: K1 as ``regret_plays`` launches it, FTRL and FTL as two plays
  of one copy of z, B = 1,024, T = 1,000, f64, eta = sqrt(2);
- ``k1f32``: the same at B = 2,048, T = 1,024, f32;
- ``k2``: K2 on ``k1f64``'s data with the main path's two thresholds a
  sequence, sqrt(2T) and sqrt(2T) / 8 (the run prints the share of pairs
  that switched); past 512 K2w's two launches together, with its plans,
  its tail launch's registers, warps an SM, local frame and shared bytes,
  and its design floor (``chip_smoke.py``'s ``k2w_plan_fields``) where the
  checkout has them;
- ``k4``: K4 over 4 chunks of 1,024 rounds generated on the card
  (``random_time_major_batch``), B = 2,048, f32, FTRL and FTL on
  alternate sequences, eta = sqrt(2): the 4 launches timed together;
  ``k4ftrl`` and ``k4ftl`` the same with every sequence FTRL or FTL;
- ``k3``: K3 FTRL and FTL and K3e (eta from 0.05 to 4.0 a sequence) on
  phase 16's packed data, B = 2,048, T = 1,024, f32; ``k3bf16`` the same
  on its bf16/int8 data;
- ``k5f64``, ``k5f32``: K5 on phase 16's sweep data, B = 1,024, T = 1,024
  (lengths in [512, 1,024]), E = 64 (eta 0.05 .. 4.0);
- ``k6``, ``k6f32``: K6a and K6b on the f64 (f32) sweep data, G = 16
  (sqrt(2T)/16 .. sqrt(2T)), eta = sqrt(2); with ``--tail-groups``, K6bw
  also at each of those group sizes P (tails a block): the K6 source built
  alone with -DOCO_TAIL_GROUP=P under build/wide_d_probe/ (nvcc, the
  library's flags, all at once), its entry called as the wrapper calls the
  library's, its digest equal to the library's;
- ``k7ftrl``, ``k7ftl``: K7 at phase 16's seed, T = 1,000, lane_batch
  2,048 (16,384 sequences);
- ``adds`` (once, not per d): the latency of a dependent float32 and
  float64 add, a chain of 2^22 adds on one thread (``scripts/add_chain.cu``,
  built here with the library's nvcc flags) timed with the SM's cycle
  counter and with CUDA events: the clocks an add that
  ``chip_smoke.py``'s ``ADD_CLOCKS`` holds.

Each time is the median (min, max) of ``--reps`` CUDA-event timed calls
after a warm-up call.  Bounds: ``chip_smoke.py``'s (inputs read once,
outputs written once, its operation counts over the H100 SXM's peaks).
K1, K3, K3e, K4, K5, K6a, K6b and K7 also print their design's own
floor: K5w's theta stream (two reads and one write of d elements a
pair-round, at 3.35 TB/s); K7w's one-lane sums (2 d dependent adds a
sequence-round, one warp instruction each, at ``chip_smoke.py``'s
WARP_ISSUE_PER_S); K3w's, K3ew's, K6aw's and K6bw's from
``chip_smoke.py``'s ``packed_wide_floor``, ``prefix_wide_floor`` and
``tail_wide_floor``; K1w's and K4w's (FTL's two chains of d dependent
adds a round, times the waves of sequences their plans fit on the card)
from its ``wide_plan_fields``, with their plans.  Run from a checkout
whose ``chip_smoke.py`` lacks these, it prints no such floor.  Prints one line a case, then
all of them as one JSON line.  Needs one CUDA card.
"""

import argparse
import ctypes
import hashlib
import inspect
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S,
    WK7_LANES,
    WK7_SEED,
    WK7_T,
    WPK_B,
    WPK_T,
    WSW_B,
    WSW_E,
    WSW_G,
    WSW_PACKED_PAIRS,
    WSW_T,
    smart_sweep_counts,
    sweep_bounds,
    synthetic_bound,
    time_ms,
    wide_k1_bound,
    wide_k2_bound,
    wide_k4_bound,
    wsw_batch,
    wsw_etas,
    wsw_packed,
    wsw_packed_bound,
    wsw_thresholds,
)
try:   # the design floors, where the checkout's chip_smoke.py has them
    from chip_smoke import (  # noqa: E402
        WARP_ISSUE_PER_S,
        packed_projecting_share,
        packed_wide_floor,
        prefix_wide_floor,
    )
except ImportError:
    WARP_ISSUE_PER_S = packed_projecting_share = None
    packed_wide_floor = prefix_wide_floor = None
try:   # K1w's and K4w's plans and floors, where the checkout has them
    from chip_smoke import wide_plan_fields  # noqa: E402
except ImportError:
    wide_plan_fields = None
try:   # K2w's two launches' plans and floor, where the checkout has them
    from chip_smoke import k2w_plan_fields  # noqa: E402
except ImportError:
    k2w_plan_fields = None
try:   # K3ew's and K6bw's floors, where the checkout has them
    from chip_smoke import eta_scales, tail_wide_floor  # noqa: E402
except ImportError:
    eta_scales = tail_wide_floor = None
from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    random_game_batch,
    random_time_major_batch,
)
from online_convex_optimization_tpu_torch.ops import game, smart  # noqa: E402
from online_convex_optimization_tpu_torch.utils import cuda_build  # noqa: E402

ETA = math.sqrt(2.0)
DEV = "cuda"
SHAPES = {"k1f64": (1024, 1000, torch.float64),
          "k1f32": (2048, 1024, torch.float32),
          "k2": (1024, 1000, torch.float64),
          "k4": (2048, 1024, torch.float32),
          "k4ftrl": (2048, 1024, torch.float32),
          "k4ftl": (2048, 1024, torch.float32),
          "k3": (WPK_B, WPK_T, torch.float32),
          "k3bf16": (WPK_B, WPK_T, torch.bfloat16),
          "k5f64": (WSW_B, WSW_T, torch.float64),
          "k5f32": (WSW_B, WSW_T, torch.float32),
          "k6": (WSW_B, WSW_T, torch.float64),
          "k6f32": (WSW_B, WSW_T, torch.float32),
          "k7ftrl": (8 * WK7_LANES, WK7_T, torch.float32),
          "k7ftl": (8 * WK7_LANES, WK7_T, torch.float32)}
K4_CHUNKS = 4
# Adds of the ``adds`` case's chain.
ADD_CHAIN = 1 << 22


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def batch(B, T, d, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return random_game_batch(gen, B, T, d, dtype=dtype)


def launch_shape(name, d, dtype, *args):
    """Registers, warps an SM, local frame and (where the checkout's C
    entry reports it, else None) a block's shared memory in bytes of a
    launch of hinge kernel ``name`` (the occupancy entry's own key) at d."""
    fn = getattr(cuda_build.load(), {
        "K1": "oco_regrets_occupancy", "K2": "oco_smart_occupancy",
        "K3": "oco_packed_occupancy", "K4": "oco_stream_occupancy",
        "K5": "oco_sweep_occupancy", "K6": "oco_smart_sweep_occupancy",
        "K7": "oco_synthetic_occupancy"}[name])
    # K7's entry takes (alg_flag, d); the others (storage, *args, d):
    # 0 f32, 1 f64, and 2 bf16 where the checkout has the warp-a-sequence
    # plans (an older one reads any nonzero storage as f64).
    storage = int(dtype == torch.float64)
    if dtype == torch.bfloat16 and hasattr(game, "packed_plan"):
        storage = 2
    call = (*args, d) if name == "K7" else (storage, *args, d)
    try:
        out = game.occupancy(name, fn, *call, shared=True)
    except TypeError:   # a checkout whose entries report three numbers
        out = (*game.occupancy(name, fn, *call), None)
    return dict(zip(("registers", "warps_per_sm", "local_bytes",
                     "shared_bytes"), out))


def state_bytes(kernel, B, d, plays, dtype) -> int:
    """The launch's state buffer in bytes (z stored in ``dtype``)."""
    size = game.compute_dtype(dtype).itemsize
    planned = {"K3": "packed_plan", "K6a": "packed_plan",
               "K1": "regret_plan", "K4": "stream_plan",
               "K3e": "packed_plan", "K6b": "tail_plan", "K2": "plays_plan"}
    if kernel in planned and hasattr(game, planned[kernel]):
        return game.wide_state_elems(kernel, B, d, plays, dtype) * size
    return game.wide_state_elems(kernel, B, d, plays) * size


def plan_fields(name, B, d, dtype, occupancy, rounds, chains=2) -> dict:
    """K1w's or K4w's plan and design floor (``chip_smoke.py``'s
    ``wide_plan_fields``), where the checkout has them."""
    if wide_plan_fields is None or d <= 512:
        return {}
    occ = (occupancy["registers"], occupancy["warps_per_sm"])
    return wide_plan_fields(name, B, d, dtype, occ, rounds, chains)


def k1(z, y, d, reps):
    B, T, _ = z.shape
    dtype = z.dtype
    flags = torch.tensor([[0], [1]], dtype=torch.int32,
                         device=DEV).expand(-1, B).contiguous()
    table = game.eta_table(ETA, B, T, dtype, DEV)
    lengths = torch.full((B,), T, dtype=torch.int32, device=DEV)
    fn = lambda: game.launch_regrets(z, y, flags, *table, lengths, False)
    outs = fn()
    ms = time_ms(fn, reps=reps)
    occupancy = launch_shape("K1", d, dtype, 2)
    return {"ms": ms, **wide_k1_bound(B, T, d, 2, dtype),
            **plan_fields("K1w", B, d, dtype, occupancy, T),
            "digest": digest(outs),
            "occupancy": occupancy,
            "state_bytes": state_bytes("K1", B, d, 2, dtype)}


def k2(z, y, d, reps):
    B, T, _ = z.shape
    dtype = z.dtype
    root = math.sqrt(2.0 * T)
    ths = torch.tensor([root, root / 8.0], dtype=dtype,
                       device=DEV)[:, None].expand(-1, B).contiguous()
    table = game.eta_table(ETA, B, T, dtype, DEV)
    lengths = torch.full((B,), T, dtype=torch.int32, device=DEV)
    fn = lambda: smart.launch_smart(z, y, ths, *table, lengths, False)
    outs = fn()
    ms = time_ms(fn, reps=reps)
    tau = outs[3]
    G = tau.shape[0]
    switched = [float((tau[g] < T).double().mean()) for g in range(G)]
    plan = ({} if k2w_plan_fields is None or d <= 512
            else k2w_plan_fields(B, d, dtype, tau, lengths))
    return {"ms": ms, **wide_k2_bound(B, T, d, tau, dtype), **plan,
            "digest": digest(outs),
            "switched": switched,
            "occupancy": launch_shape("K2", d, dtype, G),
            "state_bytes": state_bytes("K2", B, d, G, dtype)}


def k4(d, reps, name="k4"):
    """K4 over the chunks; ``k4ftrl`` and ``k4ftl`` play every sequence
    FTRL or FTL on the same data."""
    B, CT, dtype = SHAPES["k4"]
    gen = torch.Generator(device=DEV).manual_seed(7)
    zs = torch.empty((K4_CHUNKS, CT, d, B), dtype=dtype, device=DEV)
    ys = torch.empty((K4_CHUNKS, CT, B), dtype=dtype, device=DEV)
    for i in range(K4_CHUNKS):
        zs[i], ys[i] = random_time_major_batch(gen, CT, B, d, dtype=dtype)
    torch.cuda.empty_cache()
    flags = {"k4": torch.arange(B, device=DEV) % 2,
             "k4ftrl": torch.zeros(B, device=DEV),
             "k4ftl": torch.ones(B, device=DEV)}[name].to(torch.int32)
    eta = torch.full((B,), ETA, dtype=dtype, device=DEV)

    def run():
        carry = game.zero_stream_carry(B, d, dtype, DEV)
        for i in range(K4_CHUNKS):
            carry = game.launch_stream_time_major(zs[i], ys[i], flags, eta,
                                                  i * CT, carry)
        return carry

    outs = run()
    ms = time_ms(run, reps=reps)
    occupancy = launch_shape("K4", d, dtype)
    return {"ms": ms, **wide_k4_bound(B, CT, d, K4_CHUNKS, dtype),
            **plan_fields("K4w", B, d, dtype, occupancy, K4_CHUNKS * CT,
                          1 if name == "k4ftrl" else 2),
            "digest": digest(outs),
            "launches": K4_CHUNKS,
            "occupancy": occupancy,
            "state_bytes": state_bytes("K4", B, d, 1, dtype)}


def k3(d, reps, pair):
    """K3 FTRL, K3 FTL and K3e, each timed alone: one entry a launch."""
    z_tm, y_tm = wsw_packed("packed", WPK_B, WPK_T, d, pair)
    scales = game.ftrl_scales(WPK_T, ETA, device=DEV)
    per_seq = wsw_etas(WPK_B, torch.float32)
    runs = {"K3 FTRL": lambda: game.launch_play_packed(z_tm, y_tm, scales, 0),
            "K3 FTL": lambda: game.launch_play_packed(z_tm, y_tm, scales, 1),
            "K3e": lambda: game.launch_play_packed_eta(z_tm, y_tm, per_seq)}
    share = (packed_projecting_share(z_tm, y_tm, scales)
             if packed_projecting_share else None)
    eta_share = (packed_projecting_share(z_tm, y_tm,
                                         eta_scales(per_seq, WPK_T))
                 if eta_scales else None)
    res = {}
    for key, fn in runs.items():
        outs = fn()
        bd = wsw_packed_bound(WPK_B, WPK_T, d, pair, key == "K3e")
        res[key] = {"ms": time_ms(fn, reps=reps), **bd,
                    "digest": digest(outs),
                    "occupancy": launch_shape("K3", d, pair[0],
                                              int(key == "K3e")),
                    "state_bytes": state_bytes(
                        "K3e" if key == "K3e" else "K3", WPK_B, d, 1,
                        pair[0])}
        if key != "K3e" and packed_wide_floor:
            res[key].update(
                packed_wide_floor(WPK_B, WPK_T, d, bd,
                                  None if key == "K3 FTL" else share),
                projecting_share=share)
        if key == "K3e" and eta_share is not None:
            res[key].update(packed_wide_floor(WPK_B, WPK_T, d, bd, eta_share),
                            projecting_share=eta_share)
    return res


def k5(d, dtype, reps):
    z, y, ln = wsw_batch(dtype, WSW_B, WSW_T, d, dtype)
    scales = game.sweep_scales(wsw_etas(WSW_E, dtype), WSW_T)
    order = game.length_order(ln)
    fn = lambda: game.launch_eta_sweep(z, y, scales, order, ln, False)
    outs = fn()
    ms = time_ms(fn, reps=reps)
    pair_rounds = WSW_E * float(ln.double().sum())
    floor = pair_rounds * 3 * d * dtype.itemsize / HBM_BYTES_PER_S * 1e3
    return {"ms": ms,
            **sweep_bounds("K5", ln, None, dtype, d, WSW_E, WSW_G)[1],
            "design_floor_ms": floor,
            "design_floor_by": "theta: 2 reads + 1 write a pair-round",
            "digest": digest((outs,)),
            "occupancy": launch_shape("K5", d, dtype),
            "state_bytes": state_bytes("K5", WSW_B, d, WSW_E, dtype)}


def tail_libraries(groups) -> dict:
    """K6's source built alone with -DOCO_TAIL_GROUP=P for each P of
    ``groups`` (all at once) under build/wide_d_probe/, its K6b entries
    and plan declared: {P: the loaded library}."""
    src = os.path.join(cuda_build.SRC_DIR, "smart_sweep_kernel.cu")
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR),
                           "wide_d_probe")
    os.makedirs(out_dir, exist_ok=True)
    paths = {P: os.path.join(out_dir, f"libtails_p{P}.so") for P in groups}
    procs = {P: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DOCO_TAIL_GROUP={P}",
         "-shared", src, "-o", path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for P, path in paths.items()}
    libs = {}
    for P, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"wide_d_probe: nvcc -DOCO_TAIL_GROUP={P} "
                             f"failed:\n{log}")
        so = ctypes.CDLL(paths[P])
        for name in ("oco_smart_tails_f64", "oco_smart_tails_f32",
                     "oco_smart_tail_plan", "oco_smart_sweep_occupancy"):
            getattr(so, name).argtypes = cuda_build._SIGNATURES[name]
        libs[P] = so
    return libs


def launch_tails(z, y, scales, perm, order, ln, tau, comp, regret):
    """``launch_smart_tails`` in the checkout's signature (K6a's perm
    since K6bw plays its tails by sorted threshold)."""
    if "perm" in inspect.signature(smart.launch_smart_tails).parameters:
        smart.launch_smart_tails(z, y, scales, perm, order, ln, tau, comp,
                                 regret)
    else:
        smart.launch_smart_tails(z, y, scales, order, ln, tau, comp, regret)


def tails_at_group(so, z, y, scales, perm, order, ln, tau, comp, regret):
    """K6b's entry of a library built at another group size, called as the
    wrapper calls the library's: the state buffer its plan asks for."""
    B, T, d = z.shape
    G = tau.shape[0]
    plan = (ctypes.c_longlong * 5)()
    err = so.oco_smart_tail_plan(game.storage_code(z.dtype), d, plan)
    if err:
        raise RuntimeError(f"oco_smart_tail_plan: cudaError {err}")
    state = (torch.empty(plan[3] * G * B, dtype=game.compute_dtype(z),
                         device=DEV) if plan[3] else None)
    fn = getattr(so, f"oco_smart_tails_{game.storage_suffix(z.dtype, y.dtype)}")
    err = fn(z.data_ptr(), y.data_ptr(), scales.data_ptr(), perm.data_ptr(),
             order.data_ptr(), ln.data_ptr(), tau.data_ptr(), comp.data_ptr(),
             B, G, T, d, regret.data_ptr(), game.data_ptr(state),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"oco_smart_tails: cudaError {err}")
    return {"warps": plan[0], "smem_bytes": plan[1], "shared": bool(plan[2]),
            "max_shared_d": plan[4]}


def k6(d, dtype, reps, tail_libs=None):
    """K6a and K6b on the sweep data, each timed alone; K6b also at the
    group sizes of ``tail_libs`` ({P: library})."""
    z, y, ln = wsw_batch(dtype, WSW_B, WSW_T, d, dtype)
    ths = wsw_thresholds(WSW_T, WSW_G, dtype)
    ordered, perm = torch.sort(ths, stable=True)
    perm = perm.to(torch.int32)
    order = game.length_order(ln)
    scales = game.sweep_scales(torch.full((1,), ETA, dtype=dtype,
                                          device=DEV), WSW_T)
    prefix = lambda: smart.launch_smart_prefix(z, y, ordered, perm, order,
                                               ln, False)
    part, tau, comp = prefix()
    counts = smart_sweep_counts(tau.t(), ln, WSW_T)
    floor = prefix_wide_floor(ln, d, dtype) if prefix_wide_floor else {}
    res = {"K6a": {"ms": time_ms(prefix, reps=reps), **floor,
                   **sweep_bounds("K6a", ln, counts, dtype, d, WSW_E,
                                  WSW_G)[1],
                   "digest": digest((part, tau, comp)),
                   "occupancy": launch_shape("K6", d, dtype, 0),
                   "state_bytes": state_bytes("K6a", WSW_B, d, WSW_G,
                                              dtype)}}
    regret = part.clone()
    launch_tails(z, y, scales, perm, order, ln, tau, comp, regret)
    tails = lambda: launch_tails(z, y, scales, perm, order, ln, tau, comp,
                                 part.clone())
    occupancy = launch_shape("K6", d, dtype, 1)
    floor = (tail_wide_floor(tau.t(), ln, d, dtype,
                             occupancy["warps_per_sm"])
             if tail_wide_floor and d > 512 else {})
    plan = (game.tail_plan(d, dtype) if hasattr(game, "tail_plan")
            and d > 512 else {})
    res["K6b"] = {"ms": time_ms(tails, reps=reps),
                  **sweep_bounds("K6b", ln, counts, dtype, d, WSW_E,
                                 WSW_G)[1], **floor,
                  "digest": digest((regret,)),
                  "tails": counts["tail_pairs"],
                  "group": plan.get("warps"),
                  "occupancy": occupancy,
                  "state_bytes": state_bytes("K6b", WSW_B, d, WSW_G, dtype)}
    for P, so in (tail_libs or {}).items():
        out = part.clone()
        at = tails_at_group(so, z, y, scales, perm, order, ln, tau, comp, out)
        fn = lambda: tails_at_group(so, z, y, scales, perm, order, ln, tau,
                                    comp, part.clone())
        occ = game.occupancy("K6bw", so.oco_smart_sweep_occupancy,
                             game.storage_code(dtype), 1, d, shared=True)
        res[f"K6b P={P}"] = {
            **res["K6b"], "ms": time_ms(fn, reps=reps), "group": P,
            "plan": at, "digest": digest((out,)),
            "occupancy": dict(zip(("registers", "warps_per_sm",
                                   "local_bytes", "shared_bytes"), occ))}
        if tail_wide_floor:
            res[f"K6b P={P}"].update(tail_wide_floor(tau.t(), ln, d, dtype,
                                                     occ[1]))
    return res


def k7(d, alg, reps):
    B = 8 * WK7_LANES
    fn = lambda: game.launch_synthetic(WK7_SEED, ETA, WK7_T, WK7_LANES, d,
                                       alg, torch.device(DEV))
    outs = fn()
    ms = time_ms(fn, reps=reps)
    steps = B * WK7_T
    floor = ({"design_floor_ms": steps * 2 * d / WARP_ISSUE_PER_S * 1e3,
              "design_floor_by": "one-lane sums: 2 d adds a sequence-round"}
             if WARP_ISSUE_PER_S else {})
    return {"ms": ms,
            **synthetic_bound(steps, d, B, label="[wide_d_probe]"), **floor,
            "digest": digest((outs,)),
            "occupancy": launch_shape("K7", d, torch.float32, alg),
            "state_bytes": state_bytes("K7", B, d, 1, torch.float32)}


def add_latency(reps) -> dict:
    """Clocks and nanoseconds of a dependent add in float32 and float64:
    ``scripts/add_chain.cu``'s chain of ADD_CHAIN adds on one thread,
    the SM's cycles (clock64) and the CUDA-event time of its launch (the
    median of ``reps`` after a warm-up; the launch's own microseconds
    included)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "add_chain.cu")
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR),
                           "add_chain")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libadd_chain.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
                    src, "-o", lib_path], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).oco_add_chain
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    res = {}
    for dtype in (torch.float32, torch.float64):
        c = torch.tensor([1.0, 2.0 ** -30], dtype=dtype, device=DEV)
        sink = torch.empty(1, dtype=dtype, device=DEV)
        clocks = torch.zeros(1, dtype=torch.int64, device=DEV)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = fn(int(dtype == torch.float64), c.data_ptr(), ADD_CHAIN,
                     sink.data_ptr(), clocks.data_ptr(), stream)
            if err:
                raise RuntimeError(f"oco_add_chain: cudaError {err}")

        run()
        ms = time_ms(run, reps=reps)
        cycles = int(clocks.item())
        res[str(dtype)[6:]] = {
            "adds": ADD_CHAIN, "cycles": cycles,
            "clocks_per_add": cycles / ADD_CHAIN,
            "ns_per_add": ms[0] * 1e6 / ADD_CHAIN, "ms": ms,
            "sink": float(sink.item())}
    return res


def run_case(name, d, reps, tail_libs=None):
    """One case's entries, keyed by kernel (several for k3 and k6)."""
    B, T, dtype = SHAPES[name]
    if name in ("k4", "k4ftrl", "k4ftl"):
        return {name: k4(d, reps, name)}
    if name in ("k3", "k3bf16"):
        pair = WSW_PACKED_PAIRS[name == "k3bf16"]
        return {(f"{key} bf16" if name == "k3bf16" else key): res
                for key, res in k3(d, reps, pair).items()}
    if name in ("k5f64", "k5f32"):
        return {name: k5(d, dtype, reps)}
    if name in ("k6", "k6f32"):
        return {(f"{key} f32" if name == "k6f32" else key): res
                for key, res in k6(d, dtype, reps, tail_libs).items()}
    if name in ("k7ftrl", "k7ftl"):
        return {name: k7(d, int(name == "k7ftl"), reps)}
    z, y = batch(B, T, d, dtype, 11 if dtype == torch.float64 else 12)
    return {name: (k2 if name == "k2" else k1)(z, y, d, reps)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--d", type=int, nargs="+", default=[1024])
    parser.add_argument("--cases", nargs="+",
                        default=[*SHAPES, "adds"],
                        choices=[*SHAPES, "adds"])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--tail-groups", type=int, nargs="*", default=[],
                        help="K6bw group sizes to build and time besides "
                             "the library's (k6, k6f32)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wide_d_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    out = {"card": smi, "cases": {}}
    if "adds" in args.cases:
        out["add_latency"] = add_latency(args.reps)
        for key, res in out["add_latency"].items():
            print(f"dependent add {key}: {res['clocks_per_add']} clocks, "
                  f"{res['ns_per_add']} ns an add ({res['cycles']} cycles "
                  f"for {res['adds']} adds; {res['ms'][0]:.4f} ms)",
                  flush=True)
    tail_libs = (tail_libraries(args.tail_groups)
                 if args.tail_groups and {"k6", "k6f32"} & set(args.cases)
                 else None)
    for d in args.d:
        cases = [c for c in args.cases
                 if c != "adds" and (d <= 1024 or c == "k1f64")]
        for name in cases:
            B, T, dtype = SHAPES[name]
            for key, res in run_case(name, d, args.reps, tail_libs).items():
                torch.cuda.empty_cache()
                key = f"{key} d={d}"
                res["shape"] = {"B": B, "T": T, "d": d,
                                "dtype": str(dtype)[6:]}
                out["cases"][key] = res
                floor = (f"; design floor {res['design_floor_ms']:.4f} ms"
                         if "design_floor_ms" in res else "")
                print(f"{key} B={B} T={T}: {res['ms'][0]:.4f} ms (min "
                      f"{res['ms'][1]:.4f}, max {res['ms'][2]:.4f}); bound "
                      f"{res['bound_ms']:.4f} ms by {res['bound_by']}{floor}; "
                      f"occupancy {json.dumps(res['occupancy'])}; state "
                      f"buffer {res['state_bytes']} B; digest "
                      f"{res['digest']}"
                      + (f"; switched {res['switched']}" if "switched" in res
                         else "")
                      + (f"; P = {res['group']} tails a block"
                         if res.get("group") else ""), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
