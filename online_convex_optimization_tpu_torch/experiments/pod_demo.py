"""Pod-scale empirical-g sweep demo (BASELINE config 5).

Counterpart of ``online_convex_optimization_tpu/experiments/pod_demo.py``.
The reference estimates g(T) by looping 1000 FTRL simulations per horizon
in one Python thread (algorithms.py:135-171).  This demo runs the
pod-scale version of that estimate: millions of sequences x a step-size
grid, each rank generating its own disjoint sequence population inside
kernel K7 (``ops/game.py::synthetic_regrets``: nothing is read from or
written to device memory but the regrets) and the per-eta worst case
reduced across the ranks (``parallel/sweep.py::sharded_synthetic_g``).

In a process group the mesh spans its ranks, the eta grid sharded over
``hyper`` and the sequences over ``data``; alone it runs on a (1, 1) mesh,
one card.  The record names the device (the card's name and power limit).

Run: ``python -m online_convex_optimization_tpu_torch.experiments.pod_demo
--t 1000 --seqs 1048576 --out pod_scale_demo.json`` (``--device cpu`` runs
the plain version on the CPU, for small sizes).
"""

from __future__ import annotations

import argparse
import json
import math

from online_convex_optimization_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    make_mesh,
    world,
)
from online_convex_optimization_tpu_torch.parallel.sweep import (
    sharded_synthetic_g,
)
from online_convex_optimization_tpu_torch.utils.devices import (
    device_record,
    resolve_device,
)
from online_convex_optimization_tpu_torch.utils.profiling import measure


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--t", type=int, default=1000, help="horizon T")
    p.add_argument("--seqs", type=int, default=1 << 20,
                   help="sequences per eta (rounded up to a block multiple)")
    p.add_argument("--etas", type=float, nargs="*",
                   default=[0.25, 0.5, 0.75, 1.0, math.sqrt(2.0), 2.0,
                            2.0 * math.sqrt(2.0), 4.0])
    p.add_argument("--lane-batch", type=int, default=16384)
    p.add_argument("--n-hyper", type=int, default=1,
                   help="hyper-axis size (eta-grid sharding)")
    p.add_argument("--device", default="cuda",
                   help="cuda (kernel K7; raises without a card) or cpu")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    n_dev, _ = world()
    if args.n_hyper > n_dev:
        raise ValueError(f"--n-hyper {args.n_hyper} > {n_dev} ranks")
    mesh = make_mesh(n_dev // args.n_hyper, args.n_hyper, device=device)
    n_data = mesh.shape[DATA_AXIS]
    per_block = 8 * args.lane_batch
    blocks = -(-args.seqs // (per_block * n_data))
    seqs = blocks * per_block * n_data

    def run():
        g = sharded_synthetic_g(mesh, T=args.t, eta_grid=args.etas,
                                blocks_per_device=blocks,
                                lane_batch=args.lane_batch)
        return g.cpu().numpy()

    g = run()
    timing = measure(run, warmup=0, runs=1, device=device)
    steps = len(args.etas) * seqs * args.t
    result = {
        "metric": "pod_scale_g_sweep",
        "T": args.t,
        "n_sequences_per_eta": seqs,
        "eta_grid": list(args.etas),
        "g_max": {f"{e:g}": float(v) for e, v in zip(args.etas, g)},
        "devices": mesh.size,
        "mesh": dict(mesh.shape),
        "device": device_record(device),
        "total_steps": steps,
        "wall_s": timing.best_s,
        "steps_per_s": steps / timing.best_s,
        "note": ("worst-case FTRL regret over Rademacher sequences drawn "
                 "from Philox4x32-10 where they are played (inside kernel "
                 "K7 on a card); max over the data ranks, eta grid on the "
                 "hyper axis"),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
