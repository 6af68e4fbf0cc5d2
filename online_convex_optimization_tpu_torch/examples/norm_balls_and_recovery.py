"""Non-l2 balls end to end, and a preemption-safe sweep.

1. Non-l2 exact FTL: on contract data the l1 ball certifies every prefix
   a priori (|z_ij| <= ||z_i||_2 <= 1, ``models/linear_regime.py``); on
   general data the linf ball runs either the banded ADMM (the default) or
   the linf semismooth Newton (``ExactFTL(method="ssn", norm="linf")``).
2. Preemption-safe sweep (``parallel/sweep.py::resumable_synthetic_g``):
   the seed blocks run in checkpointed slices, a restarted sweep resumes
   from the last slice, and the final table is bit-equal to the
   uninterrupted sweep.  A stand-in ``regret_fn`` (an integer hash of the
   seed) takes the place of kernel K7 so that the example runs anywhere.

The same steps as the JAX package's ``examples/norm_balls_and_recovery.py``.

    python -m online_convex_optimization_tpu_torch.examples.norm_balls_and_recovery --device cpu
    python -m online_convex_optimization_tpu_torch.examples.norm_balls_and_recovery --device cuda
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.sequences import (
    make_random_iid_stream,
)
from online_convex_optimization_tpu_torch.models.exact_ftl import ExactFTL
from online_convex_optimization_tpu_torch.models.linear_regime import (
    certified_prefix_actions,
)
from online_convex_optimization_tpu_torch.parallel.mesh import make_mesh
from online_convex_optimization_tpu_torch.parallel.sweep import (
    resumable_synthetic_g,
    sharded_synthetic_g,
)


def stand_in(seed, eta, *, T, lane_batch, alg_flag, device):
    """``(8, lane_batch)`` pseudo-regrets in [0, eta) from an integer hash
    of (seed, lane, T), in 32-bit unsigned arithmetic carried in int64."""
    mask = 0xFFFFFFFF
    lane = torch.arange(8 * lane_batch, dtype=torch.int64,
                        device=device).reshape(8, lane_batch)
    u = ((seed & mask) * 40503 + lane * 69069 + T + 7 * alg_flag) & mask
    u = u ^ (u >> 15)
    u = (u * 739982445) & mask
    u = u ^ (u >> 13)
    return (u.to(torch.float64) / 2.0 ** 32).to(torch.float32) * eta


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--horizon", type=int, default=40)
    args = p.parse_args(argv)
    dev, T = args.device, args.horizon
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device")

    # 1) The l1 ball on contract data: certified a priori.
    z, y, _ = make_random_iid_stream(run_seed=7)(60)
    acts_l1 = certified_prefix_actions(np.asarray(z, np.float64),
                                       np.asarray(y, np.float64), "l1")
    print(f"l1 contract data : all 60 prefixes certified closed-form -> "
          f"{acts_l1 is not None} (zero solver iterations)")

    # The linf ball on general data: the ADMM and the semismooth Newton.
    rng = np.random.default_rng(0)
    zg = 1.5 * rng.normal(size=(T, 5))
    yg = np.sign(zg @ rng.normal(size=5))
    yg[yg == 0] = 1.0
    admm = ExactFTL(d=5, T_max=T, norm="linf", fail_tol=1e-2, device=dev)
    ssn = ExactFTL(d=5, T_max=T, norm="linf", method="ssn", fail_tol=3e-2,
                   device=dev)
    a1 = admm.prefix_actions(zg, yg)
    a2 = ssn.prefix_actions(zg, yg)
    f_admm = 0.5 * np.abs(zg @ a1[T] - yg).sum()
    f_ssn = 0.5 * np.abs(zg @ a2[T] - yg).sum()
    print(f"linf general data: ADMM f({T})={f_admm:.6f}  SSN f({T})="
          f"{f_ssn:.6f}  (two solvers, one program)")

    # 2) The resumable sweep: slices reproduce the one-shot sweep bitwise.
    mesh = make_mesh(1, 1, device=dev)
    kw = dict(T=32, eta_grid=[1.0, 2.0], blocks_per_device=6, lane_batch=64,
              regret_fn=stand_in)
    with tempfile.TemporaryDirectory() as tmp:
        g_sliced = resumable_synthetic_g(
            mesh, blocks_per_step=2,
            checkpoint_path=os.path.join(tmp, "g.npz"), **kw)
    g_once = sharded_synthetic_g(mesh, **kw).cpu().numpy()
    same = bool((g_sliced == g_once).all())
    print(f"resumable sweep  : sliced == one-shot bitwise -> {same}  "
          f"g={g_sliced}")
    return {"l1_certified": acts_l1 is not None, "f_admm": f_admm,
            "f_ssn": f_ssn, "g_sliced": g_sliced, "g_once": g_once}


if __name__ == "__main__":
    main()
