"""Batched evaluation with hyperparameter sweeps.

Evaluates a batch of sequences over a whole eta grid and a whole SMART
threshold grid, each in one launch: kernels K5 and K6 on a CUDA device,
their plain PyTorch versions on the CPU.  The same steps as the JAX
package's ``examples/kernel_batch_sweep.py``.

    python -m online_convex_optimization_tpu_torch.examples.kernel_batch_sweep --device cpu
    python -m online_convex_optimization_tpu_torch.examples.kernel_batch_sweep --device cuda
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.device import random_game_batch
from online_convex_optimization_tpu_torch.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--horizon", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device")
    B, T = args.batch, args.horizon
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    z, y = random_game_batch(gen, B, T)

    etas = np.linspace(0.1, 3.0, 16, dtype=np.float32)
    reg_eta = ftrl_eta_sweep(z, y, etas).cpu().numpy()          # (B, 16)
    best_eta = float(etas[np.argmin(reg_eta.mean(axis=0))])
    print(f"eta sweep: mean regret per eta -> best eta0 = {best_eta:.3f}")

    ths = np.asarray([2.0, 8.0, math.sqrt(2.0 * T), 1e9], np.float32)
    reg_th = smart_threshold_sweep(z, y, ths, eta0=2 ** 0.5).cpu().numpy()
    means = reg_th.mean(axis=0)
    print("SMART threshold sweep (mean regret):",
          {round(float(t), 1): round(float(m), 3) for t, m in zip(ths, means)})
    return {"best_eta": best_eta, "eta_regret": reg_eta,
            "threshold_regret": reg_th}


if __name__ == "__main__":
    main()
