"""Scaling measurement harness: steps/s at 1 device / N devices / N
processes.

Counterpart of ``online_convex_optimization_tpu/parallel/scaling.py``.
``measure_scaling`` runs the same sharded FTRL sweep on meshes of growing
rank counts, up to the world size, and reports aggregate and per-device
throughput and the efficiency against the smallest mesh; with no process
group the world is one rank, so on one card the curve is the single point
``[1]``.  ``measure_multihost`` spawns gloo CPU worker groups
(``parallel/multihost.py``) and collects each group's timed sweep.  Times
come from ``utils/profiling.measure`` (CUDA events on a card, the host
clock on the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from online_convex_optimization_tpu_torch.models.linear import (
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.parallel.mesh import (
    free_port,
    local_shard,
    make_mesh,
    world,
)
from online_convex_optimization_tpu_torch.utils.devices import resolve_device
from online_convex_optimization_tpu_torch.utils.profiling import measure


@dataclasses.dataclass(frozen=True)
class ScalePoint:
    n_devices: int
    steps_per_s: float
    steps_per_s_per_device: float
    efficiency: float  # vs the smallest measured mesh


def _sweep_program(mesh, B_per_dev: int, T: int, d: int, eta0: float,
                   reps: int):
    """One timed unit on this rank: ``reps`` FTRL batches of its shard,
    the sum of their max regrets reduced over the mesh.  Returns the
    callable and the sequence-steps it plays over the whole mesh."""
    B = B_per_dev * mesh.size
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    z_loc = torch.from_numpy(local_shard(mesh, z)).to(mesh.device)
    y_loc = torch.from_numpy(local_shard(mesh, y)).to(mesh.device)

    def run():
        acc = torch.zeros((1,), dtype=z_loc.dtype, device=mesh.device)
        for i in range(reps):
            eta = eta0 * (1.0 + 1e-6 * i)
            acc = acc + simulate_linear_batch(z_loc, y_loc, 0, eta).regret.max()
        return float(mesh.all_reduce(acc, dist.ReduceOp.MAX)[0])

    return run, B * T * reps


def measure_scaling(device_counts: Optional[Sequence[int]] = None, *,
                    B_per_dev: int = 1024, T: int = 256, d: int = 5,
                    eta0: float = float(np.sqrt(2.0)), reps: int = 4,
                    device="cuda") -> List[ScalePoint]:
    """Sharded FTRL throughput for each rank count (default: 1, 2, 4, ...
    up to the world size).  Every rank of the world calls it (each mesh
    builds its process groups on every rank); a rank outside a smaller mesh
    reports NaN for it."""
    n_avail, _ = world()
    device = resolve_device(device)
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_avail]
    points: List[ScalePoint] = []
    base_per_dev = None
    for n in device_counts:
        mesh = make_mesh(n, 1, device=device)
        if mesh.coords is not None:
            fn, steps = _sweep_program(mesh, B_per_dev, T, d, eta0, reps)
            secs = measure(fn, warmup=1, runs=3, device=device).best_s
        else:
            steps, secs = 0, float("nan")
        sps = steps / secs
        if base_per_dev is None:
            base_per_dev = sps / n
        points.append(ScalePoint(
            n_devices=n, steps_per_s=sps, steps_per_s_per_device=sps / n,
            efficiency=(sps / n) / base_per_dev))
    return points


def measure_multihost(process_counts=(1, 2), *, T: int = 256,
                      per_device_batch: int = 512, bench_reps: int = 3,
                      timeout: float = 600.0):
    """Cross-PROCESS scaling on the CPU: for each count, spawn that many
    gloo worker processes (``parallel/multihost.py --device cpu``) and
    collect the group's timed sweep throughput, the '1 process / >= 2
    processes' rows of BASELINE.md, measurable without a pod."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": repo}
    points = []
    for n_proc in process_counts:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "online_convex_optimization_tpu_torch.parallel.multihost",
             "--t", str(T), "--per-device-batch", str(per_device_batch),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_proc), "--process-id", str(i),
             "--bench-reps", str(bench_reps), "--device", "cpu"],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(n_proc)]
        outs = []
        try:
            for pr in procs:
                stdout, stderr = pr.communicate(timeout=timeout)
                if pr.returncode != 0:
                    raise RuntimeError(stderr[-2000:])
                outs.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        points.append({
            "n_processes": n_proc,
            "devices_per_process": 1,
            "n_global_devices": outs[0]["n_global_devices"],
            "steps_per_s": outs[0]["bench_steps_per_s"],
            "steps_per_s_per_device":
                outs[0]["bench_steps_per_s_per_device"],
            "agree_across_hosts": all(
                abs(o["bench_steps_per_s"] - outs[0]["bench_steps_per_s"])
                / outs[0]["bench_steps_per_s"] < 0.5 for o in outs),
        })
    return points


def main(argv=None):
    """Measure the scaling curve and print it as JSON (and write it to
    ``--out``)."""
    import argparse

    p = argparse.ArgumentParser(description="OCO scaling curve")
    p.add_argument("--out", default="")
    p.add_argument("--b-per-dev", type=int, default=1024)
    p.add_argument("--t", type=int, default=256)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--multihost", action="store_true",
                   help="also measure 1- vs 2-process gloo CPU groups")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    pts = measure_scaling(B_per_dev=args.b_per_dev, T=args.t, reps=args.reps,
                          device=device)
    record = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_devices_available": world()[0],
        "workload": {"B_per_dev": args.b_per_dev, "T": args.t,
                     "reps": args.reps, "program": "sharded FTRL sweep"},
        "points": [dataclasses.asdict(pt) for pt in pts],
    }
    if args.multihost:
        record["multihost_points"] = measure_multihost(
            T=args.t, per_device_batch=args.b_per_dev)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
