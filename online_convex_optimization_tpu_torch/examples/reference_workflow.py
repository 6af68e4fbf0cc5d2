"""The reference's workflow on the drop-in API (algorithms.py surface).

Runs a miniature version of the reference driver's pipeline: estimate the
empirical worst-case threshold table g(T), then compare FTRL / FTL / SMART
/ SMART(empirical g) on one sequence family.  The same steps as the JAX
package's ``examples/reference_workflow.py``.

    python -m online_convex_optimization_tpu_torch.examples.reference_workflow --device cpu
    python -m online_convex_optimization_tpu_torch.examples.reference_workflow --device cuda
"""

from __future__ import annotations

import argparse

import online_convex_optimization_tpu_torch as oco
from online_convex_optimization_tpu_torch.data import CASES


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--t-grid", type=int, nargs="+", default=[100, 200, 300])
    p.add_argument("--g-runs", type=int, default=20)
    args = p.parse_args(argv)
    dev = args.device
    g_emp = oco.empirical_worst_case_thresholds(args.t_grid, runs=args.g_runs,
                                                device=dev)
    print("g(T):", {t: round(v, 3) for t, v in g_emp.items()})

    sampler = CASES["Massart noise 10%"](run_seed=2025)
    rows = {}
    for T in args.t_grid:
        z, y, _ = sampler(T, rep=0)
        rows[T] = {
            "FTRL": oco.simulate_alg(z, y, 0, 2 ** 0.5, device=dev),
            "FTL": oco.simulate_alg(z, y, 1, 2 ** 0.5, device=dev),
            "SMART": oco.simulate_SMART(z, y, device=dev),
            "EMP": oco.simulate_empirical_g_SMART(z, y, g_emp[T],
                                                  device=dev)}
        print(f"T={T}: " + "  ".join(f"{k}={v:7.3f}"
                                     for k, v in rows[T].items()))
    return {"g_emp": g_emp, "regret": rows}


if __name__ == "__main__":
    main()
