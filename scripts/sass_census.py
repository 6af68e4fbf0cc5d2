#!/usr/bin/env python3
"""Census of the SASS of the port's K5, K6, K7 and K8 (and K9) main-path
instances.

    python3 scripts/sass_census.py                  # builds the kernels, reads
                                                    # cuobjdump -sass of them
    python3 scripts/sass_census.py --sass dump.txt  # a saved cuobjdump -sass
    python3 scripts/sass_census.py --lib other.so   # another build

For each kernel instance it finds the loops (a branch back to an earlier
address) and, for the main loop, prints the instructions of one pass by
opcode and by kind, the conditional blocks inside it (a forward branch
within the loop), and the longest chain of register dependences through
one pass in instructions and in clocks at the latencies assumed below.

- K7 ``synthetic_kernel<5, FTRL>``: the round loop (the loop holding the
  Philox products); the kinds split a sequence-step's warp-instructions
  into Philox (products by the Philox multipliers and the xors that take
  the keys), the FTRL scale's table read, the game's float work, and the
  rest (bits to signs, loop and control).
- K8 ``quad_game_kernel<S, 5>``: the FTL lanes' loop (the loop holding the
  row loads and the most MUFU): one Newton pass with the hand-over branch.
  There must be no loop of passes inside it (an inner back edge to the
  pass): the warp would then wait at its exit for its slowest lane each
  round.  The chain in clocks is the dependent-chain floor of one pass.
- K9 ``trs_refill_kernel<S, 5>``: the refill loop (hand-over branch, then
  one Newton pass), with its fast path split into a pass, a pass at the
  cap and the rest (``k9_split``, which ``chip_smoke.py`` phase 9 reads
  for K9's issue floor); for a build whose K9 is one problem a thread,
  ``trs_kernel<float, 5>``'s Newton loop.
- K5 ``sweep_kernel<S, 5>``, K6a ``smart_prefix_kernel<double, 5>`` and
  K6b ``smart_tail_kernel<double, 5>``: the round loop (the innermost
  loop holding the action's sqrt and divide seeds); for a build whose
  K6 is one kernel, ``smart_sweep_kernel<double, 5>``.

Latencies assumed for the chain (dependent issue to dependent issue, in
clocks): 4 for a fixed-latency ALU or FMA-pipe instruction, 8 for a
float64 add, multiply or fused multiply-add, 16 for MUFU (float32 and the
float64 seeds), 24 for a shared-memory load; a global load, a branch and
a convergence barrier are taken off the chain.  They are an estimate, not
a measurement: ``chip_smoke.py`` phase 9 times the pass on one warp.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KERNELS = {
    "K7 synthetic_kernel<5, FTRL>": "synthetic_kernelILi5ELb1E",
    "K7 synthetic_kernel<5, FTL>": "synthetic_kernelILi5ELb0E",
    # a build whose K7 has one instance for both algorithms
    "K7 synthetic_kernel<5>": "synthetic_kernelILi5EEEv",
    "K8 quad_game_kernel<float, 5>": "quad_game_kernelIfLi5E",
    "K8 quad_game_kernel<double, 5>": "quad_game_kernelIdLi5E",
    "K9 trs_refill_kernel<float, 5>": "trs_refill_kernelIfLi5E",
    "K9 trs_refill_kernel<double, 5>": "trs_refill_kernelIdLi5E",
    # a build whose K9 is one problem a thread
    "K9 trs_kernel<float, 5>": "10trs_kernelIfLi5E",
    "K5 sweep_kernel<double, 5>": "12sweep_kernelIdLi5E",
    "K5 sweep_kernel<float, 5>": "12sweep_kernelIfLi5E",
    "K6a smart_prefix_kernel<double, 5>": "smart_prefix_kernelIdLi5E",
    "K6b smart_tail_kernel<double, 5>": "smart_tail_kernelIdLi5E",
    # a build whose K6 is one kernel
    "K6 smart_sweep_kernel<double, 5>": "18smart_sweep_kernelIdLi5E",
}
PHILOX_M = ("-0x2daee0ad", "-0x326172a9", "0xd2511f53", "0xcd9e8d57")
NO_DEST = ("ST", "BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR",
           "WARPSYNC", "NOP", "YIELD", "RED", "ATOM")


def cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for path in ([os.path.join(CUDA_HOME, "bin", "cuobjdump")] if CUDA_HOME
                 else []) + [shutil.which("cuobjdump") or ""]:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("cuobjdump not found (CUDA_HOME or PATH)")


def read_sass(path, lib) -> str:
    if path:
        with open(path) as f:
            return f.read()
    if lib is None:
        from online_convex_optimization_tpu_torch.utils import cuda_build
        lib = cuda_build.build()
    return subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def functions(text):
    """{mangled name: [(address, guard, opcode, operands)]}."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = []
        for addr, body in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;",
                                     part):
            guard = ""
            if body.startswith("@"):
                guard, body = body.split(None, 1)
            op, _, rest = body.partition(" ")
            ins.append((int(addr, 16), guard, op,
                        [o.strip() for o in rest.split(",")] if rest else []))
        out[name] = ins
    return out


def loops(ins):
    """(target, branch address) of every backward branch."""
    out = []
    for addr, _, op, args in ins:
        if op.startswith("BRA") and args:
            m = re.search(r"0x([0-9a-f]+)", args[-1])
            if m and int(m.group(1), 16) <= addr:
                out.append((int(m.group(1), 16), addr))
    return out


def kind(op, args, k7):
    base = op.split(".")[0]
    text = " ".join(args)
    if k7 and (base in ("IMAD", "VIADD", "IADD3")
               and any(m in text for m in PHILOX_M)):
        return "philox product"
    if k7 and op.startswith("IMAD.HI") or (k7 and op.startswith("IMAD.WIDE")):
        return "philox product"
    if k7 and base == "LOP3" and ("0x96" in text or "0x3c" in text):
        return "philox xor"
    if base in ("LDS", "STS"):
        return "shared memory"
    if base in ("LDG", "STG", "LDL", "STL"):
        return "global/local memory"
    if base in ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR",
                "WARPSYNC", "YIELD"):
        return "control"
    if base == "MUFU":
        return "MUFU"
    if base[0] in "FD" or base in ("HFMA2", "I2FP", "F2FP"):
        return "float"
    return "integer/move/compare"


def latency(op):
    base = op.split(".")[0]
    if base == "MUFU":
        return 16
    if base in ("DADD", "DMUL", "DFMA"):
        return 8
    if base == "LDS":
        return 24
    if base in ("LDG", "STG", "BRA", "BSSY", "BSYNC", "CALL", "STS", "BAR",
                "WARPSYNC", "EXIT", "RET"):
        return 0
    return 4


def regs(arg, wide):
    out = []
    for m in re.finditer(r"\b(R|P|UR|UP)(\d+)\b", arg):
        r = f"{m.group(1)}{m.group(2)}"
        out.append(r)
        if wide and m.group(1) in ("R", "UR"):
            out.append(f"{m.group(1)}{int(m.group(2)) + 1}")
    return out


def fast_path(body):
    """The body without its slow paths: a short block that a guarded
    forward branch skips and that calls a subroutine (the correctly rounded
    divide and sqrt fall back to one off the fast path)."""
    skip = set()
    for addr, guard, op, args in body:
        m = re.search(r"0x([0-9a-f]+)", args[-1]) if args else None
        if op.startswith("BRA") and guard and m:
            block = [i for i in body if addr < i[0] < int(m.group(1), 16)]
            if len(block) <= 8 and any(i[2].startswith("CALL")
                                       for i in block):
                skip.update(i[0] for i in block)
    return [i for i in body if i[0] not in skip]


def chain(body):
    """Longest register-dependence chain through the body's fast path in
    address order: (clocks, instructions)."""
    ready = {}
    best = (0, 0)
    for _, guard, op, args in fast_path(body):
        wide = op[0] == "D" or ".64" in op or ".WIDE" in op
        n_dest = 0 if op.startswith(NO_DEST) else (
            2 if op.split(".")[0] in ("ISETP", "FSETP", "DSETP") else 1)
        srcs = regs(guard, False) + [r for a in args[n_dest:]
                                     for r in regs(a, wide)]
        start = max((ready.get(r, (0, 0)) for r in srcs), default=(0, 0))
        end = (start[0] + latency(op), start[1] + 1)
        for a in args[:n_dest]:
            for r in regs(a, wide):
                ready[r] = end
        best = max(best, end)
    return best


def guarded_blocks(body, hi):
    """(branch, target) of every guarded forward branch inside the loop
    body ending at ``hi``."""
    out = []
    for addr, guard, op, args in body:
        m = re.search(r"0x([0-9a-f]+)", args[-1]) if args else None
        if op.startswith("BRA") and guard and m and addr < int(
                m.group(1), 16) <= hi:
            out.append((addr, int(m.group(1), 16)))
    return out


def k9_split(ins):
    """Fast-path instructions of K9's refill loop by part: ``pass`` (the
    block a lane without a solve skips: the most MUFU and no load),
    ``last`` (a pass at the Newton cap, which skips the step: the pass
    without the largest block inside it) and ``handover`` (the rest of the
    loop: the ballot, the claim, the store, the load and trs_begin)."""
    lo, hi = max(loops(ins), key=lambda b: sum(
        i[2].startswith("MUFU") for i in ins if b[0] <= i[0] <= b[1]))
    fast = fast_path([i for i in ins if lo <= i[0] <= hi])

    def part(a, b):
        return [i for i in fast if a < i[0] < b]

    blocks = guarded_blocks([i for i in ins if lo <= i[0] <= hi], hi)
    guard = max((b for b in blocks if not any(
        i[2].startswith(("LDG", "STG")) for i in part(*b))),
        key=lambda b: sum(i[2].startswith("MUFU") for i in part(*b)))
    step = max((b for b in blocks if guard[0] < b[0] and b[1] <= guard[1]),
               key=lambda b: len(part(*b)))
    n_pass = len(part(*guard))
    return {"pass": n_pass, "last": n_pass - len(part(*step)),
            "handover": len(fast) - n_pass}


def census(label, ins):
    k7 = label.startswith("K7")
    back = loops(ins)
    print(f"\n== {label}: {len(ins)} instructions, {len(back)} loops "
          f"(target..branch, instructions, MUFU, global loads):")
    info = []
    for lo, hi in back:
        body = [i for i in ins if lo <= i[0] <= hi]
        ops = [i[2] for i in body]
        info.append((lo, hi, body, sum(o.startswith("MUFU") for o in ops),
                     sum(o.startswith("LDG") for o in ops),
                     sum(o.startswith("IMAD.HI") for o in ops)))
        print(f"   {lo:#06x}..{hi:#06x}: {len(body)}, MUFU {info[-1][3]}, "
              f"LDG {info[-1][4]}")
    if not info:
        return
    if k7:
        main = max(info, key=lambda x: (x[5], -len(x[2])))
    elif label.startswith("K8"):
        main = max((x for x in info if x[4]), key=lambda x: x[3])
    elif label.startswith(("K5", "K6")):
        main = min((x for x in info if x[3]), key=lambda x: len(x[2]))
    else:
        main = max(info, key=lambda x: x[3])
    lo, hi, body = main[:3]
    inner = [(a, b) for a, b in back if lo <= a and b <= hi and (a, b) != (
        lo, hi)]
    print(f"   main loop {lo:#06x}..{hi:#06x}: {len(body)} instructions a "
          f"pass; loops inside it: {len(inner)} "
          f"{[(hex(a), hex(b)) for a, b in inner]}")
    by_kind = collections.Counter(kind(i[2], i[3], k7) for i in body)
    print("   by kind: " + ", ".join(f"{k} {v}" for k, v in
                                      by_kind.most_common()))
    by_op = collections.Counter(i[2].split(".")[0] for i in body)
    print("   by opcode: " + ", ".join(f"{k} {v}" for k, v in
                                        by_op.most_common()))
    cond = [sum(1 for i in body if a < i[0] < t)
            for a, t in guarded_blocks(body, hi)]
    print(f"   conditional blocks (instructions skipped by a forward "
          f"branch): {len(cond)}, largest {sorted(cond)[-5:]}")
    fast = fast_path(body)
    by_kind = collections.Counter(kind(i[2], i[3], k7) for i in fast)
    print(f"   fast path (no slow-path calls): {len(fast)} instructions; "
          + ", ".join(f"{k} {v}" for k, v in by_kind.most_common()))
    clocks, n = chain(body)
    print(f"   dependent chain through one pass: {n} instructions, {clocks} "
          f"clocks at the assumed latencies")
    if "refill" in label:
        split = k9_split(ins)
        print(f"   fast path by part: a Newton pass {split['pass']}, a pass "
              f"at the cap {split['last']}, the rest of the loop (ballot, "
              f"claim, hand-over) {split['handover']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sass", help="a saved cuobjdump -sass listing")
    p.add_argument("--lib", help="a built kernel library (default: build "
                                 "this checkout's)")
    a = p.parse_args(argv)
    funcs = functions(read_sass(a.sass, a.lib))
    for label, key in KERNELS.items():
        for name, ins in funcs.items():
            if key in name:
                census(label, ins)
    return 0


if __name__ == "__main__":
    sys.exit(main())
