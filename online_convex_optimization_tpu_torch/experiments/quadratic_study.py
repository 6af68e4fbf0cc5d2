"""Quadratic-loss track study (BASELINE config 1): regret vs T for exact
ball-constrained least-squares FTL and FTRL on the regression stream.

Counterpart of ``online_convex_optimization_tpu/experiments/quadratic_study.py``:
zero-padded batches over a horizon grid, the reference aggregation
(replicate mean per run, mean +- 1.96*SEM across runs), a JSON artifact and
a figure.  Every (run, horizon) batch, FTRL and FTL replicates under a
per-sequence flag, rides one ``simulate_quadratic_batch`` call: one launch
of kernel K8 on ``--device cuda`` (the default), its plain PyTorch version
on ``--device cpu``.  (The JAX package makes one call per (run,
horizon); the regrets are the same.)

Run:  python -m online_convex_optimization_tpu_torch.experiments.quadratic_study
          --t-max 2000 --runs 5 --replicates 4 --out-dir results --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from online_convex_optimization_tpu_torch.data.rng import run_seed_schedule
from online_convex_optimization_tpu_torch.data.sequences import (
    make_regression_stream,
    stack_replicates,
)
from online_convex_optimization_tpu_torch.experiments.driver import (
    device_record,
)
from online_convex_optimization_tpu_torch.models.quadratic import (
    simulate_quadratic_batch,
)
from online_convex_optimization_tpu_torch.utils.devices import resolve_device
from online_convex_optimization_tpu_torch.utils.logging_utils import (
    get_logger,
    log_metrics,
)
from online_convex_optimization_tpu_torch.utils.stats import mean_ci

LABELS = ("FTRL", "FTL (exact LS)")


def horizon_batches(T_grid, *, runs: int = 5, replicates: int = 4,
                    base_seed: int = 0, sigma: float = 0.1, d: int = 5,
                    dtype=np.float32):
    """The study's regression streams: ``(z, y)`` of shapes ``(replicates,
    T, d)`` and ``(replicates, T)`` for each (run, horizon), runs outer."""
    out = []
    for run in range(runs):
        sampler = make_regression_stream(
            sigma=sigma, d=d, run_seed=run_seed_schedule(base_seed, run))
        out += [stack_replicates(sampler, int(T), replicates, dtype=dtype)
                for T in T_grid]
    return out


def quadratic_stats(by_T) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Mean and 95% CI across runs of the replicate means, per horizon, from
    ``{label: (runs, horizons, replicates)}`` regrets."""
    stats: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for k in LABELS:
        run_means = np.nanmean(by_T[k], axis=2)
        means, cis = zip(*(mean_ci(run_means[:, ti])
                           for ti in range(run_means.shape[1])))
        stats[k] = (np.asarray(means), np.asarray(cis))
    return stats


def study_batch(T_grid, *, runs: int = 5, replicates: int = 4,
                base_seed: int = 0, sigma: float = 0.1, d: int = 5,
                dtype=np.float32, device="cuda"):
    """Every (run, horizon) batch of the study as one game batch: ``z``
    ``(B, T_max, d)``, ``y`` ``(B, T_max)`` and ``flags`` ``(B,)``, with
    ``B = 2 * runs * len(T_grid) * replicates``.  All FTRL replicates come
    first, then the same sequences for FTL, each block (run, horizon,
    replicate)-major, zero-padded to ``T_max = max(T_grid)``."""
    device = resolve_device(device)
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    T_max = max(int(t) for t in T_grid)
    batches = horizon_batches(T_grid, runs=runs, replicates=replicates,
                              base_seed=base_seed, sigma=sigma, d=d,
                              dtype=dtype)
    n = len(batches) * replicates
    z_all = np.zeros((n, T_max, d), batches[0][0].dtype)
    y_all = np.zeros((n, T_max), batches[0][1].dtype)
    for i, (z, y) in enumerate(batches):
        rows = slice(i * replicates, (i + 1) * replicates)
        z_all[rows, :z.shape[1]] = z
        y_all[rows, :y.shape[1]] = y
    z_t = torch.as_tensor(z_all, dtype=tdtype, device=device)
    y_t = torch.as_tensor(y_all, dtype=tdtype, device=device)
    flags = torch.cat([torch.zeros(n, dtype=torch.int32, device=device),
                       torch.ones(n, dtype=torch.int32, device=device)])
    return torch.cat([z_t, z_t]), torch.cat([y_t, y_t]), flags


def evaluate_quadratic_stream(
    T_grid,
    *,
    runs: int = 5,
    replicates: int = 4,
    base_seed: int = 0,
    eta0: float = 1.0,
    sigma: float = 0.1,
    d: int = 5,
    dtype=np.float32,
    device="cuda",
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Regret statistics for the quadratic track on the regression stream.

    Every (run, horizon) batch rides one ``simulate_quadratic_batch`` call
    (``study_batch``; one launch of K8 on a CUDA device).  Padded rounds
    are inert (they lose 0.5*(0-0)^2 = 0 and leave the statistics
    untouched) and each sequence is played on its own, so every regret is
    the one a call per (run, horizon) would give, bit for bit.  At the
    default config that is 400 sequences of T = 2000 (32 MB of f64 z): one
    call, where K8 plays them side by side."""
    z, y, flags = study_batch(T_grid, runs=runs, replicates=replicates,
                              base_seed=base_seed, sigma=sigma, d=d,
                              dtype=dtype, device=device)
    reg = simulate_quadratic_batch(z, y, flags, eta0).regret
    reg = reg.double().cpu().numpy().reshape(2, runs, len(T_grid),
                                             replicates)
    return quadratic_stats(dict(zip(LABELS, reg)))


def plot_quadratic(T_grid, stats, *, out_path: str, dpi: int = 150) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    x = np.asarray(T_grid, float)
    for label, (mean, ci) in stats.items():
        line = ax.plot(x, mean, marker="o", label=label)[0]
        ax.fill_between(x, mean - ci, mean + ci,
                        color=line.get_color(), alpha=0.2)
    ax.plot(x, np.log(np.maximum(x, 2.0)),
            "k--", alpha=0.5, label=r"$\log T$ guide")
    ax.set_xlabel("T")
    ax.set_ylabel("regret")
    ax.set_title("Quadratic track: exact ball-LS FTL vs FTRL "
                 "(regression stream)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


@dataclasses.dataclass
class QuadraticConfig:
    t_min: int = 200
    t_max: int = 2000
    t_step: int = 200
    runs: int = 5
    replicates: int = 4
    base_seed: int = 0
    eta0: float = 1.0
    sigma: float = 0.1
    d: int = 5
    out_dir: str = "results"
    dpi: int = 150
    device: str = "cuda"

    @property
    def T_grid(self):
        return tuple(range(self.t_min, self.t_max + 1, self.t_step))


def run_study(cfg: QuadraticConfig) -> dict:
    log = get_logger()
    t0 = time.time()
    device = resolve_device(cfg.device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    stats = evaluate_quadratic_stream(
        cfg.T_grid, runs=cfg.runs, replicates=cfg.replicates,
        base_seed=cfg.base_seed, eta0=cfg.eta0, sigma=cfg.sigma, d=cfg.d,
        device=device)
    figure = os.path.join(cfg.out_dir, "quadratic_regret.png")
    if importlib.util.find_spec("matplotlib") is None:
        log.warning("matplotlib is not installed: figure not written")
        figure = None
    else:
        plot_quadratic(cfg.T_grid, stats, out_path=figure, dpi=cfg.dpi)
    results = {
        "config": dataclasses.asdict(cfg),
        "device": device_record(device),
        "wall_s": time.time() - t0,
        "figure": figure,
        "stats": {
            k: {"mean": [float(v) for v in m],
                "ci": [float(v) for v in c]}
            for k, (m, c) in stats.items()
        },
    }
    with open(os.path.join(cfg.out_dir, "results_quadratic.json"), "w") as f:
        json.dump(results, f, indent=1)
    log.info("quadratic study done in %.1fs -> %s", results["wall_s"],
             cfg.out_dir)
    log_metrics(os.path.join(cfg.out_dir, "metrics.jsonl"), {
        "event": "quadratic_study_done", "wall_s": results["wall_s"],
        "T_grid": list(cfg.T_grid)})
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    d = QuadraticConfig()
    p.add_argument("--t-min", type=int, default=d.t_min)
    p.add_argument("--t-max", type=int, default=d.t_max)
    p.add_argument("--t-step", type=int, default=d.t_step)
    p.add_argument("--runs", type=int, default=d.runs)
    p.add_argument("--replicates", type=int, default=d.replicates)
    p.add_argument("--base-seed", type=int, default=d.base_seed)
    p.add_argument("--eta0", type=float, default=d.eta0)
    p.add_argument("--sigma", type=float, default=d.sigma)
    p.add_argument("--d", type=int, default=d.d)
    p.add_argument("--out-dir", default=d.out_dir)
    p.add_argument("--dpi", type=int, default=d.dpi)
    p.add_argument("--device", choices=["cuda", "cpu"], default=d.device,
                   help="cuda (default): kernel K8; cpu: its plain PyTorch "
                        "version")
    a = p.parse_args(argv)
    cfg = QuadraticConfig(t_min=a.t_min, t_max=a.t_max, t_step=a.t_step,
                          runs=a.runs, replicates=a.replicates,
                          base_seed=a.base_seed, eta0=a.eta0, sigma=a.sigma,
                          d=a.d, out_dir=a.out_dir, dpi=a.dpi,
                          device=a.device)
    results = run_study(cfg)
    print(f"done in {results['wall_s']:.1f}s -> {cfg.out_dir}/")
    return results


if __name__ == "__main__":
    main()
