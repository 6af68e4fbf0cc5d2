#!/usr/bin/env python3
"""K10l's, K9w's and K8w's output digests, pass counts and times, for the
checkout it is run from.

    cd <a checkout of any commit of the port that has K10l, K9w and K8w>
    python3 <path to>/scripts/wide_compare.py [--reps N] [--only K10l]

It builds its inputs only from functions every version of the port with
the wide instances has (``regression_stream_batch`` on a CUDA generator,
``trs.launch_trs_solve``, ``trs.launch_quadratic_regrets_wide``,
``trs.wide_plan``, ``admm.admm_prologue``, ``admm.launch_admm``), so that
two commits, each run from its own checkout in one chip call, can be held
against each other: equal digests mean equal outputs and pass counts in
every bit.

Cases (``chip_smoke.py`` phase 14's inputs):
  - ``K10l ...``: K10 on ``chip_smoke.py``'s contract data (rows in the
    unit ball, labels sign(<z, u> + 0.3 noise), seed 140 + T), the digest
    of the whole launch's (s, u, x, w, v, res) and the time of the rows
    past a cut (the launch less the launch on z[:, :cut]): B = 2, T =
    8,192, d = 5 at 200 fixed iterations, cut 4,096; the same at tol =
    2e-4 with check_every = 100; the same as 100 + 100 iterations from the
    saved state (its digest must be the first case's); B = 4, T = 4,200 at
    d = 8 (the generic instance); B = 1, T = 12,288, d = 5; B = 1, T =
    9,216 and 16,385, d = 5, cut 8,192 and 16,384 (the rows of 8,193 to
    16,384 entries take K10l's two-row resident shape where the checkout
    has one, else its streaming instance); B = 1, T = 20,480 and 36,864,
    d = 5, cut 16,384 and 32,768 (the rows past 16,384 entries take K10l's
    one-row block where the checkout has one, else its streaming
    instance);
  - ``K9w d=<d> <dtype>``: the prefix statistics of regression streams
    (seed 160 + d), summed in float64 and stored in the dtype: d = 64, N =
    65,536 (64 streams of 1,024 rows, singular prefixes included); d = 128,
    N = 16,384 (16 streams, the prefixes of 513..1,536 rows); d = 256, N =
    4,096 (4 streams, the prefixes of 1,025..2,048 rows); float32 and
    float64;
  - ``K8w d=<d> <dtype>``: B = 4,096 regression streams of T = 1,024 rows
    (seed 180 + d), the second half FTL, eta 1: d = 64 in float32 and
    float64, d = 128 in float32.

For each it prints the sha256 digest (16 hex digits) of the outputs and of
the Newton passes each solve took (the kernels' ``passes`` output), the
CUDA-event milliseconds of the launch (a warm-up, then ``--reps`` launches,
default 5: median, min and max), the launch plan (warps an SM, shared bytes
a warp, scratch elements, registers a thread) and the mean passes; then
one JSON line with all of it, the card's name and its power limit.  At d =
64 it also times a yardstick that is no port of K9w: one Newton pass's
linear algebra as library calls on the same batch (``torch.linalg.
cholesky_ex`` of A + eps I, then three ``solve_triangular``: L y = b,
L^T x = y, L q = x), and that time times the mean passes.  Needs one CUDA
card; about 3 minutes a checkout of PR 13 (K8w at d = 128 takes 21 s a
launch there).
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.ops import admm, trs  # noqa: E402

K9W = ((64, 64, 1024, 0), (128, 16, 1024, 512), (256, 4, 1024, 1024))
# K10l: (label, B, T, d, iters, tol, split, cut): split runs iters / 2 +
# iters / 2 from the saved state; the time is of the rows past cut.
K10L = (("B=2 T=8192 d=5 200 it", 2, 8192, 5, 200, 0.0, False, 4096),
        ("B=2 T=8192 d=5 200 it tol 2e-4", 2, 8192, 5, 200, 2e-4, False,
         4096),
        ("B=2 T=8192 d=5 100+100 it", 2, 8192, 5, 200, 0.0, True, 4096),
        ("B=4 T=4200 d=8 200 it", 4, 4200, 8, 200, 0.0, False, 4096),
        ("B=1 T=12288 d=5 200 it", 1, 12288, 5, 200, 0.0, False, 4096),
        ("B=1 T=9216 d=5 200 it", 1, 9216, 5, 200, 0.0, False, 8192),
        ("B=1 T=16385 d=5 200 it", 1, 16385, 5, 200, 0.0, False, 16384),
        ("B=1 T=20480 d=5 200 it", 1, 20480, 5, 200, 0.0, False, 16384),
        ("B=1 T=36864 d=5 200 it", 1, 36864, 5, 200, 0.0, False, 32768))
K8W = ((64, torch.float32), (64, torch.float64), (128, torch.float32))
K8W_B, K8W_T = 4096, 1024


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
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


def prefixes(d, B, T, first, dtype):
    """(A (B T, d, d), b (B T, d)): the prefixes of first + 1 .. first + T
    rows of B streams, summed in float64, stored in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(160 + d)
    z, y, _ = regression_stream_batch(gen, B, T + first, d,
                                      dtype=torch.float64)
    A = torch.cumsum(z[:, :, :, None] * z[:, :, None, :], 1)[:, first:]
    b = torch.cumsum(y[:, :, None] * z, 1)[:, first:]
    return (A.reshape(-1, d, d).to(dtype).contiguous(),
            b.reshape(-1, d).to(dtype).contiguous())


def library_pass(A, b):
    """One Newton pass's linear algebra as library calls on the batch: the
    Cholesky of A + eps I (eps the ridge floor at lam = 0) and three
    triangular solves."""
    d = A.shape[-1]
    eps_rel = 1e-6 if A.dtype == torch.float32 else 1e-12
    tr = torch.diagonal(A, dim1=1, dim2=2).sum(1)
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    shifted = A + (eps_rel * (1.0 + tr / d))[:, None, None] * eye
    rhs = b[..., None]

    def run():
        L = torch.linalg.cholesky_ex(shifted)[0]
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
        torch.linalg.solve_triangular(L, x, upper=False)

    return run


def plan_of(kernel, d, dtype, n):
    p = trs.wide_plan(kernel, d, dtype, n)
    return {"warps_per_sm": p["warps_per_sm"], "smem_bytes": p["smem_bytes"],
            "scratch": p["scratch"], "registers": p["registers"]}


def admm_batch(B, T, d, seed):
    """chip_smoke.py's exact_batch: contract rows, float32, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, T, d), generator=g, device="cuda", dtype=torch.float64)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1.0)
    u = torch.randn((B, d), generator=g, device="cuda", dtype=torch.float64)
    noise = torch.randn((B, T), generator=g, device="cuda",
                        dtype=torch.float64)
    y = torch.sign((z * u[:, None, :]).sum(-1) + 0.3 * noise)
    return z.float().contiguous(), y.float().contiguous()


def k10l(res, reps):
    for label, B, T, d, iters, tol, split, cut in K10L:
        z, y = admm_batch(B, T, d, 140 + T)
        Lpk = admm.admm_prologue(z)
        kw = dict(tol=tol, check_every=100, rho=1.0, alpha=1.7)
        if split:
            _, st = admm.launch_admm(z, y, Lpk, iters=iters // 2, **kw)
            r, st = admm.launch_admm(z, y, Lpk, iters=iters // 2, state0=st,
                                     **kw)
        else:
            r, st = admm.launch_admm(z, y, Lpk, iters=iters, **kw)
        dig = digest(*st, r)
        del st, r
        torch.cuda.empty_cache()
        z4, y4 = z[:, :cut].contiguous(), y[:, :cut].contiguous()
        Lpk4 = admm.admm_prologue(z4)
        full = time_ms(lambda: admm.launch_admm(z, y, Lpk, iters=iters, **kw),
                       reps)
        short = time_ms(lambda: admm.launch_admm(z4, y4, Lpk4, iters=iters,
                                                 **kw), reps)
        res[f"K10l {label}"] = {"digest": dig, "ms": full[0] - short[0],
                                "launch_ms": full, "short_ms": short}
        print(f"K10l {label}", json.dumps(res[f"K10l {label}"]), flush=True)
        del z, y, Lpk, z4, y4, Lpk4
        torch.cuda.empty_cache()


def k9w(res, reps):
    for d, B, T, first in K9W:
        for dtype in (torch.float32, torch.float64):
            A, b = prefixes(d, B, T, first, dtype)
            n = A.shape[0]
            passes = torch.zeros(n, dtype=torch.int32, device="cuda")
            x = trs.launch_trs_solve(A, b, passes)
            ms = time_ms(lambda: trs.launch_trs_solve(A, b), reps)
            label = f"K9w d={d} {str(dtype)[6:]}"
            mean = float(passes.double().mean())
            res[label] = {"digest": digest(x), "passes": digest(passes),
                          "mean_passes": mean,
                          "ms": ms, "plan": plan_of("K9w", d, dtype, n)}
            if d == 64:
                lib = time_ms(library_pass(A, b), reps)
                res[label]["library_pass_ms"] = lib
                res[label]["library_ms"] = lib[0] * mean
            print(label, json.dumps(res[label]), flush=True)
            del A, b, x, passes
            torch.cuda.empty_cache()


def k8w(res, reps):
    for d, dtype in K8W:
        gen = torch.Generator(device="cuda").manual_seed(180 + d)
        z, y, _ = regression_stream_batch(gen, K8W_B, K8W_T, d, dtype=dtype)
        flags = (torch.arange(K8W_B, device="cuda") >= K8W_B // 2).to(
            torch.int32)
        eta = torch.ones(K8W_B, dtype=dtype, device="cuda")
        z_tm = z.permute(1, 2, 0).contiguous()
        y_tm = y.t().contiguous()
        del z, y
        passes = torch.zeros((K8W_T + 1, K8W_B), dtype=torch.int32,
                             device="cuda")
        outs = trs.launch_quadratic_regrets_wide(z_tm, y_tm, flags, eta,
                                                 passes)
        ms = time_ms(lambda: trs.launch_quadratic_regrets_wide(
            z_tm, y_tm, flags, eta), reps)
        ftl = passes[:K8W_T][:, flags == 1].double()
        label = f"K8w d={d} {str(dtype)[6:]}"
        res[label] = {"digest": digest(*outs), "passes": digest(passes),
                      "mean_passes": float(ftl.mean()), "ms": ms,
                      "plan": plan_of("K8w", d, dtype, K8W_B)}
        print(label, json.dumps(res[label]), flush=True)
        del z_tm, y_tm, outs, passes
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wide_compare: no CUDA device")
    reps = 5
    if "--reps" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--reps") + 1])
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = {"tree": os.getcwd(), "card": card, "reps": reps}
    print(card, flush=True)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    for name, fn in (("K10l", k10l), ("K9w", k9w), ("K8w", k8w)):
        if only in (None, name):
            fn(res, reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
