"""Timing and throughput measurement.

Counterpart of ``online_convex_optimization_tpu/utils/profiling.py``:
``measure`` times a callable after a warm-up, and ``trace`` records a
``torch.profiler`` trace.  On a CUDA device ``measure`` times each run with
CUDA events on the current stream and waits for them, so the time is the
device's, not that of the host's enqueue; on the CPU (the gloo worker
groups of ``parallel/scaling.py``) it reads the host clock.  A request for
the card where there is none raises (``utils/devices.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch

from online_convex_optimization_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class Timing:
    best_s: float
    mean_s: float
    runs: int
    device: str

    def steps_per_s(self, steps: int) -> float:
        return steps / self.best_s


def measure(fn: Callable[[], object], *, warmup: int = 2, runs: int = 5,
            device="cuda") -> Timing:
    """Time ``fn`` ``runs`` times after ``warmup`` untimed calls."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(runs):
        if cuda:
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return Timing(best_s=min(times), mean_s=sum(times) / len(times),
                  runs=runs, device=str(device))


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the card's kernels
    too where there is one) into ``log_dir/trace.json`` (Chrome or Perfetto
    format); yields the profiler, whose ``key_averages()`` sums time by
    kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
