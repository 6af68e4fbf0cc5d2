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
from online_convex_optimization_tpu_torch.ops import trs  # noqa: E402
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
    timings()
    census()
    return 0


if __name__ == "__main__":
    sys.exit(main())
