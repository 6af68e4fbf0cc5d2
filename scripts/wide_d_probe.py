#!/usr/bin/env python3
"""K1, K2 and K4 at the path shapes of large d: times, bounds, digests and
each launch's registers, warps an SM and local frame.

    cd <a checkout of the port>
    python3 <path to>/scripts/wide_d_probe.py [--d 512 1024 2048]
        [--cases k1f64 k1f32 k2 k4] [--reps 3]

Its inputs come from ``data/device.py``'s generators and fixed seeds, and
it calls only the launchers (``launch_regrets``, ``launch_smart``,
``launch_stream_time_major``), so equal digests mean equal outputs in
every bit.  At d <= 512 it times the large-d instance (D == -1, state in
each thread's local frame); past 512 the wide instances (state in a
device buffer): ``--d 512 513`` sets the two side by side.

Cases (each at every ``--d``; ``k1f64`` alone past d = 1,024):

- ``k1f64``: K1 as ``regret_plays`` launches it, FTRL and FTL as two plays
  of one copy of z, B = 1,024, T = 1,000, f64, eta = sqrt(2);
- ``k1f32``: the same at B = 2,048, T = 1,024, f32;
- ``k2``: K2 on ``k1f64``'s data with two thresholds a sequence, sqrt(2T)
  and T / 4 (the run prints the share of pairs that switched);
- ``k4``: K4 over 4 chunks of 1,024 rounds generated on the card
  (``random_time_major_batch``), B = 2,048, f32, FTRL and FTL on
  alternate sequences, eta = sqrt(2): the 4 launches timed together.

Each time is the median (min, max) of ``--reps`` CUDA-event timed calls
after a warm-up call.  Bounds: ``chip_smoke.py``'s ``wide_k1_bound``,
``wide_k2_bound`` and ``wide_k4_bound`` (inputs read once, outputs written
once, its operation counts over the H100 SXM's peaks).
Prints one line a case, then all of them as one JSON line.  Needs one
CUDA card.
"""

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    time_ms,
    wide_k1_bound,
    wide_k2_bound,
    wide_k4_bound,
)
from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    random_game_batch,
    random_time_major_batch,
)
from online_convex_optimization_tpu_torch.ops import game, smart  # noqa: E402

ETA = math.sqrt(2.0)
DEV = "cuda"
SHAPES = {"k1f64": (1024, 1000, torch.float64),
          "k1f32": (2048, 1024, torch.float32),
          "k2": (1024, 1000, torch.float64),
          "k4": (2048, 1024, torch.float32)}
K4_CHUNKS = 4


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def batch(B, T, d, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return random_game_batch(gen, B, T, d, dtype=dtype)


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
    return {"ms": ms, **wide_k1_bound(B, T, d, 2, dtype),
            "digest": digest(outs),
            "occupancy": list(game.regret_occupancy(2, d, dtype))}


def k2(z, y, d, reps):
    B, T, _ = z.shape
    dtype = z.dtype
    ths = torch.tensor([math.sqrt(2.0 * T), T / 4.0], dtype=dtype,
                       device=DEV)[:, None].expand(-1, B).contiguous()
    table = game.eta_table(ETA, B, T, dtype, DEV)
    lengths = torch.full((B,), T, dtype=torch.int32, device=DEV)
    fn = lambda: smart.launch_smart(z, y, ths, *table, lengths, False)
    outs = fn()
    ms = time_ms(fn, reps=reps)
    tau = outs[3]
    G = tau.shape[0]
    switched = [float((tau[g] < T).double().mean()) for g in range(G)]
    return {"ms": ms, **wide_k2_bound(B, T, d, tau, dtype),
            "digest": digest(outs),
            "switched": switched,
            "occupancy": list(smart.smart_occupancy(G, d, dtype))}


def k4(d, reps):
    B, CT, dtype = SHAPES["k4"]
    gen = torch.Generator(device=DEV).manual_seed(7)
    zs = torch.empty((K4_CHUNKS, CT, d, B), dtype=dtype, device=DEV)
    ys = torch.empty((K4_CHUNKS, CT, B), dtype=dtype, device=DEV)
    for i in range(K4_CHUNKS):
        zs[i], ys[i] = random_time_major_batch(gen, CT, B, d, dtype=dtype)
    torch.cuda.empty_cache()
    flags = (torch.arange(B, device=DEV) % 2).to(torch.int32)
    eta = torch.full((B,), ETA, dtype=dtype, device=DEV)

    def run():
        carry = game.zero_stream_carry(B, d, dtype, DEV)
        for i in range(K4_CHUNKS):
            carry = game.launch_stream_time_major(zs[i], ys[i], flags, eta,
                                                  i * CT, carry)
        return carry

    outs = run()
    ms = time_ms(run, reps=reps)
    return {"ms": ms, **wide_k4_bound(B, CT, d, K4_CHUNKS, dtype),
            "digest": digest(outs),
            "launches": K4_CHUNKS,
            "occupancy": list(game.stream_occupancy(d, dtype))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--d", type=int, nargs="+", default=[512])
    parser.add_argument("--cases", nargs="+", default=list(SHAPES))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wide_d_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    out = {"card": smi, "cases": {}}
    for d in args.d:
        cases = [c for c in args.cases if d <= 1024 or c == "k1f64"]
        for name in cases:
            B, T, dtype = SHAPES[name]
            if name == "k4":
                res = k4(d, args.reps)
            else:
                z, y = batch(B, T, d, dtype, 11 if dtype == torch.float64
                             else 12)
                res = (k2 if name == "k2" else k1)(z, y, d, args.reps)
                del z, y
            torch.cuda.empty_cache()
            key = f"{name} d={d}"
            res["shape"] = {"B": B, "T": T, "d": d, "dtype": str(dtype)[6:]}
            out["cases"][key] = res
            print(f"{key} B={B} T={T}: {res['ms'][0]:.4f} ms (min "
                  f"{res['ms'][1]:.4f}, max {res['ms'][2]:.4f}); bound "
                  f"{res['bound_ms']:.4f} ms by {res['bound_by']}; "
                  f"occupancy {res['occupancy']}; digest {res['digest']}"
                  + (f"; switched {res['switched']}" if "switched" in res
                     else ""), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
