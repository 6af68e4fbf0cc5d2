"""Build the port's CUDA kernels into one shared library and load it.

Counterpart of ``online_convex_optimization_tpu/utils/native.py`` (which
builds ``native/`` with g++): here ``nvcc`` compiles ``csrc/*.cu`` for Hopper
(``sm_90a``) into ``build/torch_kernels/liboco_torch_kernels.so`` at the
repository root, with a plain C interface loaded through ``ctypes``.  The
build happens at first use and is keyed by a hash of the sources and flags,
so a changed kernel is rebuilt and an unchanged one is not.

The flags are part of the numerics: ``--fmad=false`` keeps products unfused
(the f64 kernels reproduce the reference's rounding, ties included), and
``--use_fast_math`` is never used.  A failed build raises with nvcc's
output; nothing falls back to another path.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "liboco_torch_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")

# The largest d of the hinge-game kernels' instances that keep their state
# in registers or in each thread's local frame (csrc/oco_common.cuh
# OCO_LARGE_D, the JAX package's _D_KERNEL_MAX).  Past it every hinge
# kernel (K1-K7) launches its wide instance, whose state lies in a device
# buffer the wrapper allocates (ops/game.py::wide_state_elems), so each
# takes any d.  The quadratic kernels K8 and K9 take any d too (their wide
# instances above ops/trs.py MAX_D).
MAX_D = 512

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_KEYS = ctypes.POINTER(ctypes.c_uint32)
_F = ctypes.c_float

# Every pointer and the stream are c_void_p; see the extern "C" blocks.
_SIGNATURES = {
    "oco_synthetic_regrets_f32": [_KEYS, _F, _LL, _LL, _I, _I, _F, _P, _P,
                                  _P],
    "oco_admm_all_prefixes_f32": [_P] * 8 + [_I] * 5 + [_F] * 4 + [_P] * 8,
    "oco_admm_occupancy_f32": [_I, _I, _P],
    "oco_admm_resident_plan": [_I, _I, _P],
    "oco_admm_row_plan": [_I, _I, _P],
    "oco_regrets_occupancy": [_I, _I, _I, _P],
    "oco_smart_occupancy": [_I, _I, _I, _P],
    "oco_stream_occupancy": [_I, _I, _P],
    "oco_sweep_occupancy": [_I, _I, _P],
    "oco_smart_sweep_occupancy": [_I, _I, _I, _P],
    "oco_packed_occupancy": [_I, _I, _I, _P],
    "oco_synthetic_occupancy": [_I, _I, _P],
    "oco_synthetic_plan": [_I, _I, _P],
    "oco_packed_plan": [_I, _I, _P],
    "oco_smart_prefix_plan": [_I, _I, _P],
    "oco_smart_tail_plan": [_I, _I, _P],
    "oco_smart_plays_plan": [_I, _I, _I, _P],
    "oco_smart_plays_occupancy": [_I, _I, _I, _P],
    "oco_regret_plan": [_I, _I, _I, _P],
    "oco_stream_plan": [_I, _I, _P],
    "oco_trs_occupancy": [_I, _I, _P],
    "oco_trs_wide_plan": [_I, _I, _LL, _P],
    "oco_quad_wide_plan": [_I, _I, _LL, _P],
}
# The hinge-game entries have one instance a (z, y) storage pair
# (csrc/oco_common.cuh OCO_STORAGE_PAIRS, ops/game.py STORAGE); the
# quadratic kernels K8 and K9 take float64 and float32.
STORAGE_SUFFIXES = ("f64", "f32", "bf16", "bf16i8", "f32i8")
for _ty in STORAGE_SUFFIXES:
    _SIGNATURES.update({
        f"oco_regrets_fused_{_ty}": [_P] * 6 + [_LL, _LL, _I, _I, _I] +
                                    [_P] * 5,
        f"oco_smart_regrets_{_ty}": [_P] * 6 + [_LL, _LL, _I, _I, _I] +
                                    [_P] * 5,
        f"oco_smart_plays_ftl_{_ty}": [_P] * 6 + [_LL] * 3 + [_I] * 2 +
                                      [_P] * 6,
        f"oco_smart_plays_tails_{_ty}": [_P] * 8 + [_LL] * 3 + [_I] +
                                        [_P] * 4,
        f"oco_eta_sweep_{_ty}": [_P] * 5 + [_LL] * 3 + [_I] * 2 + [_P] * 3,
        f"oco_smart_prefix_{_ty}": [_P] * 6 + [_LL] * 3 + [_I] * 2 +
                                   [_P] * 5,
        f"oco_smart_tails_{_ty}": [_P] * 8 + [_LL] * 3 + [_I] + [_P] * 3,
        f"oco_play_stream_{_ty}": [_P, _P, _P, _P, _LL, _LL, _LL, _I] +
                                  [_P] * 10,
        f"oco_play_packed_{_ty}": [_P, _P, _P, _LL, _LL, _I, _I] +
                                  [_P] * 4,
        f"oco_play_packed_eta_{_ty}": [_P, _P, _P, _LL, _LL, _I] + [_P] * 4,
    })
for _ty in ("f64", "f32"):
    _SIGNATURES.update({
        f"oco_quad_game_{_ty}": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _I,
                                 _P, _P, _P, _P, _P],
        f"oco_trs_solve_{_ty}": [_P, _P, _LL, _I, _P, _P, _P],
        f"oco_quad_game_wide_{_ty}": [_P] * 5 + [_LL, _LL, _I] + [_P] * 8,
        f"oco_trs_solve_wide_{_ty}": [_P, _P, _LL, _I] + [_P] * 5,
    })

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def source_hash() -> str:
    """Hash of the flags and of every source file's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME
                  else []) + [shutil.which("nvcc") or ""]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


def _run_all(cmds, log):
    """Start every command at once, wait for all, log their output and
    each one's seconds; raise with the first failure's output."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]

    def wait(proc):
        out, err = proc.communicate()
        return out, err, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        results = list(pool.map(wait, procs))
    failed = None
    for cmd, proc, (out, err, secs) in zip(cmds, procs, results):
        what = (os.path.basename(cmd[cmd.index("-c") + 1]) if "-c" in cmd
                else "link")
        log.write(" ".join(cmd) + "\n" + out + err
                  + f"nvcc seconds {secs:.2f}: {what}\n")
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, err)
    if failed is not None:
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n"
                           f"{failed[1]}")


def build(force: bool = False) -> str:
    """Compile the library unless a build of the same sources exists (or
    ``force``); return its path.  Each ``.cu`` file is compiled by its own
    nvcc, all started together, then linked.  nvcc's output (ptxas register
    and spill counts) goes to ``build/torch_kernels/build.log``."""
    key = source_hash()
    stamp = LIB_PATH + ".sha256"
    if not force and os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == key:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    srcs = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(p)}.{os.getpid()}.o")
            for p in srcs]
    try:
        with open(LOG_PATH, "w") as log:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                      for src, obj in zip(srcs, objs)], log)
            _run_all([[nvcc, "-shared", "-o", tmp, *objs]], log)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(key)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
