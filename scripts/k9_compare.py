#!/usr/bin/env python3
"""K9's output digests and times, for the checkout it is run from.

    cd <a checkout of any commit of the port>
    python3 <path to>/scripts/k9_compare.py

It builds its inputs only from functions every version of the port has
(``regression_stream_batch`` on a CUDA generator, the running statistics
summed as ``chip_smoke.py`` phase 9 sums them, ``trs.launch_trs_solve``),
so that two commits, each run from its own checkout in one chip call, can
be held against each other: equal digests mean equal outputs in every bit.

Inputs (A, b) and the label each is printed under:
  - ``phase9 <dtype>``: phase 9's prefix statistics, seed 90, B = 4,096,
    T = 1,024, d = 5, every (round, sequence) prefix: N = 4,194,304 = 2^22,
    float32 and float64;
  - ``N=65536``, ``N=1048576``: the first 2^16 and 2^20 of the float32
    ones; ``N=4194299``: all but the last 5 (N not a multiple of 32);
  - ``d=<3, 7, 32> <dtype>``: the prefix statistics of regression streams
    at that d (seed 91; B = 512, T = 256 at d = 3 and 7, B = 128, T = 128
    at d = 32), float32 and float64.

Prints one JSON line: per input, the sha256 digest (16 hex digits) of x and
K9's median, min and max milliseconds over 5 CUDA-event-timed launches.
Needs one CUDA card; about a minute.
"""

import hashlib
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    regression_stream_batch,
)
from online_convex_optimization_tpu_torch.ops import trs  # noqa: E402


def digest(x):
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


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


def prefixes(seed, B, T, d, dtype):
    """Every (round, sequence) prefix's (A, b), (T * B, d, d) and (T * B,
    d), round-major, summed in K8's order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z, y, _ = regression_stream_batch(gen, B, T, d, dtype=dtype)
    A_pre = z.new_empty((T, B, d, d))
    b_pre = z.new_empty((T, B, d))
    A = z.new_zeros((B, d, d))
    b = z.new_zeros((B, d))
    for t in range(T):
        A_pre[t], b_pre[t] = A, b
        A = A + z[:, t, :, None] * z[:, t, None, :]
        b = b + y[:, t, None] * z[:, t]
    return A_pre.reshape(-1, d, d), b_pre.reshape(-1, d)


def run(res, label, A, b):
    x = trs.launch_trs_solve(A, b)
    res[label] = [digest(x), time_ms(lambda: trs.launch_trs_solve(A, b))]


def main() -> int:
    res = {"tree": os.getcwd(), "card": torch.cuda.get_device_name(0)}
    for dtype in (torch.float32, torch.float64):
        A, b = prefixes(90, 4096, 1024, 5, dtype)
        run(res, f"phase9 {dtype}", A, b)
        if dtype == torch.float32:
            for n in (1 << 16, 1 << 20, A.shape[0] - 5):
                run(res, f"N={n}", A[:n].contiguous(), b[:n].contiguous())
        del A, b
        torch.cuda.empty_cache()
    for d, B, T in ((3, 512, 256), (7, 512, 256), (32, 128, 128)):
        for dtype in (torch.float32, torch.float64):
            A, b = prefixes(91, B, T, d, dtype)
            run(res, f"d={d} {dtype}", A, b)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
