#!/usr/bin/env python3
"""K8's output digests and times at ``chip_smoke.py`` phase 9's inputs, for
the checkout it is run from.

    cd <a checkout of any commit of the port>
    python3 <path to>/scripts/k8_compare.py

It builds its inputs only from functions every version of the port has
(``regression_stream_batch`` at seed 90 for the bench shape, B = 4,096,
T = 1,024, half FTRL half FTL, f32 and f64; the quadratic study's 400
regression streams of T <= 2,000 in one batch, f32), so that two commits,
each run from its own checkout in one chip call, can be held against each
other: equal digests mean equal outputs in every bit.  Prints one JSON
line: per input, the sha256 digest (16 hex digits) of (cum, comp, x_c,
x_last) and the kernel's median, min and max milliseconds over 5 (3 for
the study) CUDA-event-timed launches.  Needs one CUDA card.
"""

import hashlib
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.data.rng import (  # noqa: E402
    run_seed_schedule,
)
from online_convex_optimization_tpu_torch.data.sequences import (  # noqa: E402
    make_regression_stream,
    stack_replicates,
)
from online_convex_optimization_tpu_torch.ops import game, trs  # noqa: E402


def digest(outs):
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_ms(fn, reps):
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


def main() -> int:
    res = {"tree": os.getcwd()}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device="cuda").manual_seed(90)
        z, y, _ = regression_stream_batch(gen, 4096, 1024, 5, dtype=dtype)
        flags = (torch.arange(4096, device="cuda") >= 2048).to(torch.int32)
        eta = game.per_sequence(1.0, 4096, dtype, "cuda")
        z_tm, y_tm = game.time_major(z, y)
        outs = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
        res[f"bench {dtype}"] = [digest(outs), time_ms(
            lambda: trs.launch_quadratic_regrets(z_tm, y_tm, flags, eta), 5)]
    T_grid, runs, reps = list(range(200, 2001, 200)), 5, 4
    zs, ys = [], []
    for run in range(runs):
        sampler = make_regression_stream(sigma=0.1, d=5,
                                         run_seed=run_seed_schedule(0, run))
        for T in T_grid:
            z, y = stack_replicates(sampler, T, reps, dtype=np.float32)
            z2 = np.zeros((reps, 2000, 5), z.dtype)
            y2 = np.zeros((reps, 2000), y.dtype)
            z2[:, :T] = z
            y2[:, :T] = y
            zs.append(z2)
            ys.append(y2)
    z = torch.as_tensor(np.concatenate(zs), device="cuda")
    y = torch.as_tensor(np.concatenate(ys), device="cuda")
    z, y = torch.cat([z, z]), torch.cat([y, y])
    n = z.shape[0] // 2
    flags = torch.cat([torch.zeros(n, dtype=torch.int32),
                       torch.ones(n, dtype=torch.int32)]).cuda()
    eta = game.per_sequence(1.0, 2 * n, torch.float32, "cuda")
    z_tm, y_tm = game.time_major(z, y)
    outs = trs.quadratic_regrets(z_tm, y_tm, flags, eta)
    res["study f32"] = [digest(outs), time_ms(
        lambda: trs.launch_quadratic_regrets(z_tm, y_tm, flags, eta), 3)]
    try:
        from online_convex_optimization_tpu_torch.experiments.quadratic_study \
            import study_batch
    except ImportError:       # a checkout whose study makes a call per horizon
        pass
    else:
        zb, yb, fb = study_batch(T_grid, runs=runs, replicates=reps,
                                 device="cuda")
        res["study_batch equals this construction"] = bool(
            torch.equal(zb, z) and torch.equal(yb, y)
            and torch.equal(fb.cuda(), flags))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
