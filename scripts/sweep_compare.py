#!/usr/bin/env python3
"""K5's and K6's output digests and times at ``chip_smoke.py`` phase 6's
inputs, for the checkout it is run from.

    cd <a checkout of any commit of the port>
    python3 <path to>/scripts/sweep_compare.py [--d D]

It builds its inputs only from functions every version of the port has
(``random_game_batch`` at seed 60: B = 32,768, T = 1,024, d = 5 or
``--d``, lengths
uniform in [512, 1,024], f64 and f32; 64 etas on linspace(0.05, 4), 16
thresholds, eta = sqrt(2) for SMART), so that two commits, each run from
its own checkout in one chip call, can be held against each other: equal
digests mean equal outputs in every bit.  Prints one JSON line: per dtype,
the sha256 digests (16 hex digits) of ``eta_sweep``'s regrets and of
``smart_sweep``'s (regret, switch_t), the wrappers' and the kernels'
median, min and max milliseconds over 5 CUDA-event-timed calls (the
kernels on prepared inputs: time-major rows for a checkout whose kernels
read them, the scale tables, order and sorted thresholds for one whose
kernels stage the caller's layout; K6 as K6a and K6b apart and together).
A checkout whose kernels take the blocks' sequence order is also timed,
with the digests of its outputs, at the identity order beside the
wrapper's length order.
Needs one CUDA card.
"""

import argparse
import hashlib
import json
import math
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    random_game_batch,
)
from online_convex_optimization_tpu_torch.ops import game, smart  # noqa: E402

B, T = 32_768, 1024
ETA = math.sqrt(2.0)
ETA_GRID = torch.linspace(0.05, 4.0, 64, dtype=torch.float64)
THRESH_GRID = torch.cat([torch.linspace(2.0, 80.0, 15, dtype=torch.float64),
                         torch.tensor([math.sqrt(2.0 * T)],
                                      dtype=torch.float64)])


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


def batch(dtype, d):
    """Phase 6's sweep batch (chip_smoke.py sweep_batch, seed 60)."""
    gen = torch.Generator(device="cuda").manual_seed(60)
    z, y = random_game_batch(gen, B, T, d, dtype=dtype)
    lengths = torch.randint(T // 2, T + 1, (B,), generator=gen,
                            device="cuda", dtype=torch.int32)
    lengths[0] = T
    return z, y, lengths


def kernels_time_major(z, y, lengths, grid, ths):
    """The kernels of a checkout whose K5 and K6 read time-major rows."""
    z_tm, y_tm = game.time_major(z, y)
    return {
        "K5": time_ms(lambda: game.launch_eta_sweep_time_major(
            z_tm, y_tm, grid, lengths, False)),
        "K6": time_ms(lambda: smart.launch_smart_sweep_time_major(
            z_tm, y_tm, ths, ETA, lengths, False))}


def staged(z, y, lengths, grid, ths, order):
    """Prepared inputs and launches of a checkout whose K5 and K6 stage
    the caller's (B, T, d) layout, with the blocks' sequence order."""
    ordered, perm = torch.sort(ths, stable=True)
    perm = perm.to(torch.int32)
    scales5 = game.sweep_scales(grid, T)
    scales6 = game.sweep_scales(
        torch.full((1,), ETA, dtype=z.dtype, device="cuda"), T)
    part, tau, comp = smart.launch_smart_prefix(z, y, ordered, perm, order,
                                                lengths, False)
    buf = part.clone()
    return {
        "K5": lambda: game.launch_eta_sweep(z, y, scales5, order, lengths,
                                            False),
        "K6a": lambda: smart.launch_smart_prefix(
            z, y, ordered, perm, order, lengths, False),
        # In place on a scratch buffer: each launch plays the same tails.
        "K6b": lambda: smart.launch_smart_tails(
            z, y, scales6, perm, order, lengths, tau, comp, buf),
        "K6 digest": lambda: tails_digest(z, y, scales6, perm, order,
                                          lengths, part, tau, comp),
    }


def tails_digest(z, y, scales, perm, order, lengths, part, tau, comp):
    out = part.clone()
    smart.launch_smart_tails(z, y, scales, perm, order, lengths, tau, comp,
                             out)
    return digest((out.t(), tau.t()))


def kernels_staged(z, y, lengths, grid, ths):
    res = {}
    identity = torch.arange(B, dtype=torch.int32, device="cuda")
    for name, order in (("", game.length_order(lengths)),
                        (" identity order", identity)):
        k = staged(z, y, lengths, grid, ths, order)
        res.update({f"K5{name}": time_ms(k["K5"]),
                    f"K6a{name}": time_ms(k["K6a"]),
                    f"K6b{name}": time_ms(k["K6b"]),
                    f"K6{name}": time_ms(lambda: (k["K6a"](), k["K6b"]()))})
        if name:
            res[f"K5 digest{name}"] = digest((k["K5"]().t(),))
            res[f"K6 digest{name}"] = k["K6 digest"]()
        del k
    return res


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--d", type=int, default=5)
    args = parser.parse_args()
    res = {"tree": os.getcwd(), "card": torch.cuda.get_device_name(0),
           "d": args.d}
    for dtype in (torch.float64, torch.float32):
        z, y, lengths = batch(dtype, args.d)
        grid = ETA_GRID.to("cuda", dtype)
        ths = THRESH_GRID.to("cuda", dtype)
        reg5 = game.eta_sweep(z, y, ETA_GRID, lengths)
        reg6, tau = smart.smart_sweep(z, y, THRESH_GRID, ETA, lengths)
        out = {"K5 digest": digest((reg5,)), "K6 digest": digest((reg6, tau)),
               "eta_sweep ms": time_ms(
                   lambda: game.eta_sweep(z, y, ETA_GRID, lengths)),
               "smart_sweep ms": time_ms(
                   lambda: smart.smart_sweep(z, y, THRESH_GRID, ETA,
                                             lengths))}
        del reg5, reg6, tau
        if hasattr(game, "launch_eta_sweep_time_major"):
            out.update(kernels_time_major(z, y, lengths, grid, ths))
        else:
            out.update(kernels_staged(z, y, lengths, grid, ths))
        res[str(dtype)] = out
        del z, y
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
