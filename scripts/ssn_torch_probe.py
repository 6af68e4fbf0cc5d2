#!/usr/bin/env python3
"""The PyTorch port's semismooth Newton (``models/ssn.py``) on one card:
the band call at the exact pipeline's width, eager against one CUDA graph a
Newton step, and (``--pipeline``) the exact pipeline through it against
the banded ADMM.

    python3 scripts/ssn_torch_probe.py [--pipeline]     # from the repo root

Band call: the out-of-contract family of ``chip_smoke.py`` phase 12 (z = 2
N(0, I), y = sign(<z, w> + 0.3 noise)), B = 8 replicates, T_max = 1000,
four 256-row bands in one batch, float64; eager, graph, graph, eager,
each at 20 fixed steps (tol 0) and at the pipeline's first attempt (80
steps, tol 2e-4): Newton steps, wall, ms a step, peak device memory, the
outputs' equality to the first run in every bit, the ATen operations and
CUDA kernels of one step (eager), and the share of rows certified at 2e-4.

``--pipeline``: ``driver --exact --exact-solver ssn`` and ``--exact-solver
xla`` at ``--runs 2 --g-runs 50`` (all four cases, T = 100..1000) on the
card: walls, ``phase_s``, ``exact_time_s``, the audit, the SSN calls'
Newton steps and walls, and the largest difference of the mean statistics.
Needs one CUDA card; ~1 min, ~9 min with ``--pipeline``.
"""

import argparse
import json
import math
import os
import statistics
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from online_convex_optimization_tpu_torch.experiments.config import (  # noqa: E402
    config_from_args,
)
from online_convex_optimization_tpu_torch.experiments.driver import (  # noqa: E402
    run_experiment,
)
from online_convex_optimization_tpu_torch.models import ssn  # noqa: E402


def band_calls():
    z, y = cs.ooc_instance(cs.SSN_B, 1000, 121)
    zg, yg = torch.from_numpy(z).cuda(), torch.from_numpy(y).cuda()
    kw = dict(band_lo=cs.SSN_BANDS, band_rows=256)
    first = {}
    ssn._CUDA_GRAPHS = False
    ops, kernels = cs.ssn_step_costs(zg, yg, **kw)
    print(f"one eager step: {ops} ATen operations, {kernels} CUDA kernels")
    for graphs in (False, True, True, False):
        ssn._CUDA_GRAPHS = graphs
        for iters, tol in ((20, 0.0), (80, 2e-4)):
            torch.cuda.reset_peak_memory_stats()
            (X, res, st), steps, wall = cs.ssn_solve(zg, yg, iters=iters,
                                                     tol=tol, **kw)
            out = (X, res, st[1])
            same = all(torch.equal(a, b) for a, b in
                       zip(first.setdefault((iters, tol), out), out))
            print(f"graph={graphs} iters={iters} tol={tol:g}: {steps} steps, "
                  f"{wall:.3f} s, {wall / steps * 1e3:.2f} ms a step, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"rows certified at 2e-4 "
                  f"{float((res <= 2e-4).double().mean()):.4f}; equal to the "
                  f"first run in every bit: {same}", flush=True)
    ssn._CUDA_GRAPHS = True


def pipeline():
    cut = ["--runs", "2", "--g-runs", "50", "--device", "cuda"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for solver in ("ssn", "xla"):
            with cs.BandCalls() as calls:
                out[solver] = run_experiment(config_from_args(
                    ["--exact", "--exact-solver", solver, *cut,
                     "--out-dir", os.path.join(tmp, solver)]))
            res = out[solver]
            line = (f"driver --exact --exact-solver {solver} {' '.join(cut)}: "
                    f"wall {res['wall_s']:.2f} s, phases "
                    f"{json.dumps(res['phase_s'])}, host seconds by step "
                    f"{json.dumps(res['exact_time_s'])}, audit "
                    f"{json.dumps(res['audit'])}")
            if calls.calls:
                steps = [c[0] for c in calls.calls]
                walls = [c[1] for c in calls.calls]
                line += (f"; {len(steps)} SSN calls, Newton steps median "
                         f"{statistics.median(steps)} max {max(steps)}, wall "
                         f"a call median {statistics.median(walls):.3f} s, "
                         f"sum {sum(walls):.2f} s")
            print(line, flush=True)
    worst = max(abs(u - v) for title, algs in out["ssn"]["stats"].items()
                for alg, f in algs.items()
                for u, v in zip(f["mean"], out["xla"]["stats"][title][alg][
                    "mean"]) if math.isfinite(u))
    print(f"max |mean ssn - xla| = {worst:.3e}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pipeline", action="store_true")
    args = p.parse_args(argv)
    cs.phase_device()
    band_calls()
    if args.pipeline:
        pipeline()


if __name__ == "__main__":
    main()
