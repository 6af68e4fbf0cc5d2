#!/usr/bin/env python3
"""Probe of the wide trust-region solve (K9w, ``csrc/trs_kernel.cu``
``trs_wide_kernel``; the solve of ``csrc/oco_trs.cuh`` ``oco::wide`` that
K8w shares) on one CUDA card.

    python3 scripts/wide_probe.py        # from the repository root

For d = 64 (float32, float64) and d = 128 (float32), on prefix statistics
of at least 4d rows, it times K9w (CUDA events, the fastest of 3 after a
warm-up) at three batch sizes: one problem for each SM (each warp alone on
its SM: the time over the slowest solve's Newton passes is one warp's
latency a pass), one problem for each warp of the persistent grid, and
four; with the Newton passes the kernel reports.  Then a census of the
loops of ``trs_wide_kernel<float, shared>`` in this build's SASS
(``scripts/sass_census.py``'s reader, cuobjdump): each loop's instructions
by kind.  Prints the card's name and power limit first.

    python3 scripts/wide_probe.py --split

instead builds ``csrc/trs_kernel.cu`` alone with ``-DOCO_WIDE_SPLIT`` (the
clock64 marks of ``csrc/oco_trs.cuh``) into ``build/wide_probe/`` and, at
one problem an SM (each warp alone on its SM), prints a Newton pass's
clocks by phase: the seed of L, the Cholesky's pivots and divides, its
trailing updates, the forward and backward substitutions, the Newton step,
and the per-problem work.

    python3 scripts/wide_probe.py --k10l-split

builds K10's two sources with ``-DOCO_ADMM_SPLIT`` (the clock64 marks of
``csrc/oco_admm.cuh``) into ``build/wide_probe/`` and runs K10 at 200
fixed iterations, d = 5: one block of K10l alone on each SM (B = 1 and as
many long rows as the SMs' blocks hold) and at full occupancy (B = 2, T =
8,192, phase 14's shape), then B = 1 at T = 12,288, where both K10l
instances run.  For each K10l instance it prints a row iteration's clocks
a warp by phase: the wait for the d x d step and its barrier, a pass's
wait on its loads, its arithmetic, the reduce-scatter with its barrier,
the rest, and the d x d steps' own chain, with the probe build's outputs
held to the library's in every bit.  ``--stream-all`` routes every long
row to the streaming instance (the design the resident instance replaced)
and skips the last case.
"""

from __future__ import annotations

import collections
import ctypes
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.ops import admm, trs  # noqa: E402
from online_convex_optimization_tpu_torch.utils import cuda_build  # noqa: E402

KINDS = {"LDS": "shared load", "STS": "shared store", "LDG": "global load",
         "STG": "global store", "FMUL": "float", "FADD": "float",
         "FFMA": "float", "DMUL": "float", "DADD": "float", "DFMA": "float",
         "MUFU": "float", "IMAD": "integer", "IADD3": "integer",
         "LEA": "integer", "SHF": "integer", "VIADD": "integer",
         "LOP3": "integer", "ISETP": "integer", "MOV": "integer"}


def prefixes(N, d, dtype):
    """N prefix statistics of one regression stream, the prefixes of 4d + 1
    .. 4d + N rows (well conditioned)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    z, y, _ = regression_stream_batch(gen, 1, N + 4 * d, d,
                                      dtype=torch.float64)
    A = torch.cumsum(z[0, :, :, None] * z[0, :, None, :], 0)[4 * d:]
    b = torch.cumsum(y[0, :, None] * z[0], 0)[4 * d:]
    return A.to(dtype).contiguous(), b.to(dtype).contiguous()


def fastest_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def timings():
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d, dtype in ((64, torch.float32), (64, torch.float64),
                     (128, torch.float32)):
        plan = trs.wide_plan("K9w", d, dtype, 1 << 30)
        for N in (sms, plan["warps"], 4 * plan["warps"]):
            A, b = prefixes(N, d, dtype)
            passes = torch.zeros(N, dtype=torch.int32, device="cuda")
            trs.launch_trs_solve(A, b, passes)
            ms = fastest_ms(lambda: trs.launch_trs_solve(A, b))
            top = int(passes.max())
            print(f"K9w d={d} {dtype} N={N} ({min(N, plan['warps'])} warps, "
                  f"{plan['warps_per_sm']} an SM): {ms:.4f} ms; Newton "
                  f"passes mean {float(passes.double().mean()):.3f}, max "
                  f"{top}; {ms * 1e3 / top:.1f} us a pass of the slowest "
                  f"warp", flush=True)


def census():
    spec = importlib.util.spec_from_file_location(
        "sass_census", os.path.join(REPO, "scripts", "sass_census.py"))
    sc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sc)
    funcs = sc.functions(sc.read_sass(None, cuda_build.LIB_PATH))
    name = next(k for k in funcs if "trs_wide_kernelIfLb1E" in k)
    ins = funcs[name]
    where = {addr: i for i, (addr, *_) in enumerate(ins)}
    print(f"SASS of trs_wide_kernel<float, shared>: {len(ins)} instructions; "
          f"loops of 10 or more, by kind:")
    for target, branch in sorted(sc.loops(ins)):
        body = ins[where[target]:where[branch] + 1]
        if len(body) < 10:
            continue
        count = collections.Counter(
            KINDS.get(op.split(".")[0], "other") for _, _, op, _ in body)
        print(f"  0x{target:x}..0x{branch:x}: {len(body)} "
              + ", ".join(f"{k} {v}" for k, v in sorted(count.items())))


PHASES = ("seed", "pivots", "trailing", "forward", "backward", "step",
          "problem")


def split_library():
    """The probe build of K9w: ``csrc/trs_kernel.cu`` with the clock64
    marks compiled in, loaded through ctypes."""
    out = os.path.join(REPO, "build", "wide_probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libwide_split.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                    "-DOCO_WIDE_SPLIT", "-shared", "-o", lib,
                    os.path.join(cuda_build.SRC_DIR, "trs_kernel.cu")],
                   check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("oco_trs_solve_wide_f32", "oco_trs_solve_wide_f64"):
        getattr(so, name).argtypes = [P, P, LL, I] + [P] * 5
    so.oco_trs_wide_plan.argtypes = [I, I, LL, P]
    so.oco_wide_split.argtypes = [P]
    return so


def split():
    so = split_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d, dtype in ((64, torch.float32), (64, torch.float64),
                     (128, torch.float32)):
        A, b = prefixes(sms, d, dtype)
        plan = (ctypes.c_longlong * 5)()
        f64 = dtype == torch.float64
        assert so.oco_trs_wide_plan(int(f64), d, sms, plan) == 0
        scratch = torch.empty(max(plan[1], 1), dtype=dtype, device="cuda")
        counter = torch.empty(1, dtype=torch.int64, device="cuda")
        x = torch.empty_like(b)
        passes = torch.zeros(sms, dtype=torch.int32, device="cuda")
        fn = so.oco_trs_solve_wide_f64 if f64 else so.oco_trs_solve_wide_f32
        clocks = (ctypes.c_ulonglong * len(PHASES))()
        for _ in range(2):         # the first launch warms; its clocks drop
            assert so.oco_wide_split(clocks) == 0
            assert fn(A.data_ptr(), b.data_ptr(), sms, d, counter.data_ptr(),
                      scratch.data_ptr(), x.data_ptr(), passes.data_ptr(),
                      torch.cuda.current_stream().cuda_stream) == 0
            torch.cuda.synchronize()
        assert so.oco_wide_split(clocks) == 0
        check = torch.equal(x, trs.launch_trs_solve(A, b))
        n_pass = int(passes.sum())
        total = sum(clocks)
        print(f"K9w d={d} {dtype} N={sms} (one warp an SM, {plan[4]} an SM "
              f"at most), probe build equal to the library's in every bit "
              f"{check}: {total / n_pass:.0f} clocks a Newton pass "
              f"({n_pass} passes), by phase: " + ", ".join(
                  f"{name} {c / n_pass:.0f} ({100 * c / total:.1f}%)"
                  for name, c in zip(PHASES, clocks)), flush=True)


K10L_PHASES = ("step", "load", "arith", "publish", "other", "chain")
# K10l's instances, in the order of the probe build's clocks.
LONG_INSTANCES = ("long", "resident")


def k10l_split_library():
    """The probe build of K10: ``csrc/admm_kernel.cu`` and
    ``csrc/admm_long_kernel.cu`` with the clock64 marks compiled in."""
    out = os.path.join(REPO, "build", "wide_probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libk10l_split.so")
    run = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                          "-DOCO_ADMM_SPLIT", "-shared", "-o", lib,
                          *(os.path.join(cuda_build.SRC_DIR, f) for f in
                            ("admm_kernel.cu", "admm_long_kernel.cu"))],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"the K10l probe build failed:\n{run.stderr}")
    so = ctypes.CDLL(lib)
    so.oco_admm_all_prefixes_f32.argtypes = \
        cuda_build._SIGNATURES["oco_admm_all_prefixes_f32"]
    so.oco_admm_split.argtypes = [ctypes.c_void_p]
    so.oco_admm_split_route.argtypes = [ctypes.c_int]
    return so


def k10l_batch(B, T, d, seed):
    """chip_smoke.py's exact_batch: rows in the unit ball, labels
    sign(<z, u> + 0.3 noise), float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, T, d), generator=g, device="cuda",
                    dtype=torch.float64)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1.0)
    u = torch.randn((B, d), generator=g, device="cuda", dtype=torch.float64)
    noise = torch.randn((B, T), generator=g, device="cuda",
                        dtype=torch.float64)
    y = torch.sign((z * u[:, None, :]).sum(-1) + 0.3 * noise)
    return z.float().contiguous(), y.float().contiguous()


def k10l_split(stream_all):
    so = k10l_split_library()
    so.oco_admm_split_route(int(stream_all))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, d = 200, 5
    # One block alone on each SM: as many long rows as SMs (a resident
    # block holds resident_plan's rows).
    alone = sms * (1 if stream_all else admm.resident_plan(d)["rows"])
    cases = [("one block an SM", 1, admm.LONG_ROWS + alone),
             ("full occupancy", 2, 8192)]
    if not stream_all:
        cases.append(("both instances", 1, 12288))
    for label, B, T in cases:
        z, y = k10l_batch(B, T, d, 140)
        Lpk = admm.admm_prologue(z)
        outs = [torch.empty((B * T, T), device="cuda") for _ in range(2)] + \
            [torch.empty((B * T, d), device="cuda") for _ in range(3)] + \
            [torch.empty(B * T, device="cuda")]
        launched = (ctypes.c_int * 3)()
        clocks = (ctypes.c_ulonglong * (2 * len(K10L_PHASES)))()
        for _ in range(2):         # the first launch warms; its clocks drop
            assert so.oco_admm_split(clocks) == 0
            assert so.oco_admm_all_prefixes_f32(
                z.data_ptr(), y.data_ptr(), Lpk.data_ptr(), *[None] * 5, B,
                T, d, iters, 100, 0.0, 0.5, 1.7, 1.0 - 1.7,
                *(a.data_ptr() for a in outs),
                torch.cuda.current_stream().cuda_stream, launched) == 0
            torch.cuda.synchronize()
        assert so.oco_admm_split(clocks) == 0
        res, st = admm.launch_admm(z, y, Lpk, iters=iters, tol=0.0,
                                   check_every=100, rho=1.0, alpha=1.7)
        same = all(torch.equal(a, b) for a, b in zip(outs, (*st, res)))
        for inst, name in enumerate(LONG_INSTANCES):
            c = clocks[inst * len(K10L_PHASES):(inst + 1) * len(K10L_PHASES)]
            lo, hi = ((admm.LONG_ROWS, T) if stream_all
                      else admm.instance_rows(name, T))
            rows = B * max(hi - lo, 0)
            if rows == 0 or sum(c) == 0:
                continue
            per_block = 1 if name == "long" else \
                admm.resident_plan(d)["rows"]
            blocks = B * -(-max(hi - lo, 0) // per_block)
            warp_iters = rows * 8 * iters
            body = sum(c[:5])
            print(f"K10l {name} ({label}, B={B} T={T} d={d}, {iters} "
                  f"iterations, rows of {lo + 1}..{hi} entries), probe "
                  f"build equal to the library's in every bit {same}: "
                  f"{body / warp_iters:.0f} clocks a warp a row iteration, "
                  f"by phase: " + ", ".join(
                      f"{p} {v / warp_iters:.0f} ({100 * v / body:.1f}%)"
                      for p, v in zip(K10L_PHASES[:5], c[:5]))
                  + f"; the d x d steps' chain {c[5] / (blocks * iters):.0f}"
                  f" clocks a block iteration ({per_block} row(s) a block,"
                  f" side by side on lanes of warp 0)", flush=True)
        del z, y, Lpk, outs, st, res
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wide_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cuda_build.load()
    if "--split" in sys.argv[1:]:
        split()
        return 0
    if "--k10l-split" in sys.argv[1:]:
        k10l_split("--stream-all" in sys.argv[1:])
        return 0
    timings()
    census()
    return 0


if __name__ == "__main__":
    sys.exit(main())
