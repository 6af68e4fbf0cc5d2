#!/usr/bin/env python3
"""Device time by kernel on two paths of the PyTorch port, from
torch.profiler traces on one CUDA card.

    python3 scripts/probe_device_split.py [--out FILE]

- stream: ``StreamingKernelGame`` at B = 16,384, d = 5, f32, fed 16 chunks
  of 8,192 rounds generated on the card (``data/device.py``), as
  ``chip_smoke.py`` phase 7 does: the device time of K4 (``stream_kernel``)
  and of everything else (the generation), and the device's busy share of
  the traced wall.
- exact: the driver's ``--exact --exact-solver kernel --precision f32``
  route on its two random families (every K10 cell of phase 11c's cut,
  ``--runs 2 --g-runs 50``): K10's (``admm_kernel``) launches and device
  time against the route's wall.

Kernel times come from the kernel events of the trace that
``utils/profiling.trace`` records; the busy share is the union of their
intervals over the traced wall.
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from online_convex_optimization_tpu_torch.data.device import (  # noqa: E402
    random_time_major_batch,
)
from online_convex_optimization_tpu_torch.experiments.config import (  # noqa: E402
    config_from_args,
)
from online_convex_optimization_tpu_torch.experiments.driver import (  # noqa: E402
    run_experiment,
)
from online_convex_optimization_tpu_torch.models.streaming import (  # noqa: E402
    StreamingKernelGame,
)
from online_convex_optimization_tpu_torch.utils import profiling  # noqa: E402

STREAM_B, STREAM_CT, STREAM_CHUNKS, D = 16_384, 8192, 16, 5
RANDOM_FAMILIES = ("Random i.i.d. (separable)", "Massart noise 10%")


def traced(fn, tmp: str):
    """Run fn under ``profiling.trace``; return (wall seconds, kernel events
    as (name, start us, duration us))."""
    torch.cuda.synchronize()
    with profiling.trace(tmp):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
               if e.get("cat") == "kernel"]
    return wall, kernels


def busy_us(kernels) -> float:
    """Length of the union of the kernels' intervals."""
    total, end = 0.0, -1.0
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


def split(kernels, marker: str) -> dict:
    mine = [k for k in kernels if marker in k[0]]
    return {"launches": len(mine),
            "device_ms": sum(k[2] for k in mine) / 1e3,
            "other_device_ms": sum(k[2] for k in kernels
                                   if marker not in k[0]) / 1e3}


def stream_probe(tmp: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(70)
    game = StreamingKernelGame(STREAM_B, D, eta0=2 ** 0.5, device="cuda")

    def run():
        for _ in range(STREAM_CHUNKS):
            game.feed_packed(*random_time_major_batch(gen, STREAM_CT,
                                                      STREAM_B, D))
    run()   # warm-up: the build and the generator's first call
    wall, kernels = traced(run, tmp)
    out = split(kernels, "stream_kernel")
    device = out["device_ms"] + out["other_device_ms"]
    out.update(wall_ms=wall * 1e3, busy_share=busy_us(kernels) / 1e3
               / (wall * 1e3), k4_share=out["device_ms"] / device,
               generation_share=out["other_device_ms"] / device,
               chunks=STREAM_CHUNKS)
    return out


def exact_probe(tmp: str) -> dict:
    argv = ["--exact", "--exact-solver", "kernel", "--precision", "f32",
            "--device", "cuda", "--runs", "2", "--g-runs", "50",
            "--cases", *RANDOM_FAMILIES, "--out-dir",
            os.path.join(tmp, "exact")]
    res = {}

    def run():
        res.update(run_experiment(config_from_args(argv)))
    wall, kernels = traced(run, tmp)
    out = split(kernels, "admm_kernel")
    out.update(wall_s=wall, exact_time_s=res["exact_time_s"],
               phase_s=res["phase_s"], argv=argv)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "probe_device_split.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_device_split: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        result = {"device": smi, "stream": stream_probe(tmp),
                  "exact": exact_probe(tmp)}
    text = json.dumps(result, indent=1)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
