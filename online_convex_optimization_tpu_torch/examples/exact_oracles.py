"""Exact leaders: hinge-loss exact FTL (all prefixes in one batched ADMM,
then the active-set polish) and the quadratic-loss ball-constrained
least-squares track.  The same steps as the JAX package's
``examples/exact_oracles.py``.

    python -m online_convex_optimization_tpu_torch.examples.exact_oracles --device cpu
    python -m online_convex_optimization_tpu_torch.examples.exact_oracles --device cuda
"""

from __future__ import annotations

import argparse

from online_convex_optimization_tpu_torch.data.sequences import (
    make_random_iid_stream,
    make_regression_stream,
)
from online_convex_optimization_tpu_torch.models.exact_ftl import (
    run_ftl_exact,
    run_ftrl,
)
from online_convex_optimization_tpu_torch.models.quadratic import (
    simulate_quadratic,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--horizon", type=int, default=80)
    p.add_argument("--quadratic-horizon", type=int, default=500)
    args = p.parse_args(argv)
    dev = args.device
    z, y, _ = make_random_iid_stream(run_seed=7)(args.horizon)
    exact = run_ftl_exact(z, y, norm="l2", device=dev)
    ftrl = run_ftrl(z, y, eta0=1.0, device=dev)
    print(f"hinge exact FTL: regret {exact.regret:.4f} "
          f"(FTRL vs same comparator: {ftrl.regret:.4f})")

    zq, yq, _ = make_regression_stream(sigma=0.1, run_seed=7)(
        args.quadratic_horizon)
    q_ftl = simulate_quadratic(zq, yq, alg="ftl", device=dev)
    q_ftrl = simulate_quadratic(zq, yq, alg="ftrl", eta0=1.0, device=dev)
    print(f"quadratic exact FTL: regret {float(q_ftl.regret):.4f} "
          f"(FTRL: {float(q_ftrl.regret):.4f})")
    return {"exact_ftl": exact, "ftrl": ftrl, "quadratic_ftl": q_ftl,
            "quadratic_ftrl": q_ftrl}


if __name__ == "__main__":
    main()
