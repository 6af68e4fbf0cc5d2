"""The two exact-FTL solver regimes side by side.

1. Certified linear regime (``models/linear_regime.py``): on binary-label
   data whose predictions stay in [-1, 1] (checked per prefix by the
   optimality certificate, never assumed) the exact program is linear and
   every prefix minimizer is the closed form w_t/||w_t||: no solver
   iterations.
2. General regime: out-of-contract data (rows outside the unit ball, the
   regime the reference's own smoke test uses) goes to an iterative
   solver, the batched consensus ADMM or the semismooth Newton
   (``ExactFTL(method="ssn")``, tens of Newton steps where the ADMM needs
   thousands of iterations), then the host active-set polish.

The same steps as the JAX package's ``examples/certified_and_ssn.py``.

    python -m online_convex_optimization_tpu_torch.examples.certified_and_ssn --device cpu
    python -m online_convex_optimization_tpu_torch.examples.certified_and_ssn --device cuda
"""

from __future__ import annotations

import argparse

import numpy as np

from online_convex_optimization_tpu_torch.data.sequences import (
    make_random_iid_stream,
)
from online_convex_optimization_tpu_torch.models.exact_ftl import (
    ExactFTL,
    run_ftl_exact,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--admm-iters", type=int, default=8000)
    args = p.parse_args(argv)
    dev, T = args.device, args.horizon

    # Certified regime: contract data.
    z, y, _ = make_random_iid_stream(run_seed=3)(T)
    solver = ExactFTL(d=5, T_max=T, norm="l2", device=dev)
    res = run_ftl_exact(z, y, solver=solver, device=dev)
    print(f"contract data : regret {res.regret:.6f} via "
          f"{solver.last_info.get('solver', 'admm')} "
          f"(residual {solver.last_info['residual']:.1e})")

    # General regime: the reference smoke-test distribution.
    rng = np.random.default_rng(0)
    z2 = 2.0 * rng.normal(size=(T, 5))          # unclipped: ||z|| >> 1
    y2 = np.sign(z2 @ rng.normal(size=5))
    y2[y2 == 0] = 1.0
    admm = ExactFTL(d=5, T_max=T, norm="l2", iters=args.admm_iters,
                    device=dev)
    r_admm = run_ftl_exact(z2, y2, solver=admm, device=dev)
    ssn = ExactFTL(d=5, T_max=T, norm="l2", method="ssn", iters=300,
                   device=dev)
    r_ssn = run_ftl_exact(z2, y2, solver=ssn, device=dev)
    print(f"general (admm): regret {r_admm.regret:.6f} "
          f"(residual {admm.last_info['residual']:.1e})")
    print(f"general (ssn) : regret {r_ssn.regret:.6f} "
          f"(duality gap {ssn.last_info['residual']:.1e})")
    if not abs(r_admm.regret - r_ssn.regret) < 1e-4:
        raise RuntimeError(f"the ADMM's regret {r_admm.regret} and the "
                           f"SSN's {r_ssn.regret} differ by 1e-4 or more")
    return {"certified": res, "admm": r_admm, "ssn": r_ssn}


if __name__ == "__main__":
    main()
