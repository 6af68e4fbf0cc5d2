"""Experiment driver: g(T) estimation -> per-case evaluation -> figures.

Counterpart of ``online_convex_optimization_tpu/experiments/driver.py`` in
its plain mode (reference driver.py:204-226):

    python -m online_convex_optimization_tpu_torch.experiments.driver \
        --t-max 1000 --g-runs 1000 --out-dir results --device cuda

Outputs in --out-dir:
  - g_emp_<key>.json          : checkpointed g(T) table (resumable)
  - results.json              : config echo, wall_s, g_emp and per-case
                                mean/CI stats as the JAX driver writes them,
                                plus ``device`` (the card's name and power
                                limit, in place of the JAX driver's relay
                                record) and ``phase_s`` (wall time of the
                                g(T), evaluation and figure phases; the
                                figures are skipped, with a warning and
                                ``null``, where matplotlib is not installed)
  - empirical_g_T.png         : g(T) vs theory curves
  - algorithm_comparison.png  : per-case regret comparison grid
  - <--profile-dir>/trace.json: with --profile-dir, a torch.profiler trace
                                of the per-case evaluation
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import time
from typing import Dict

import numpy as np

from online_convex_optimization_tpu_torch.data.sequences import (
    CASES,
    REPLICATES_BY_TITLE,
    RUNS_BY_TITLE,
)
from online_convex_optimization_tpu_torch.experiments.config import (
    ExperimentConfig,
    config_from_args,
)
from online_convex_optimization_tpu_torch.experiments.evaluate import (
    evaluate_stream_with_stats,
)
from online_convex_optimization_tpu_torch.experiments.gt import estimate_g
from online_convex_optimization_tpu_torch.experiments.plotting import (
    plot_comparisons,
    plot_empirical_g,
)
from online_convex_optimization_tpu_torch.utils.devices import (
    device_record,
    resolve_device,
)
from online_convex_optimization_tpu_torch.utils.logging_utils import (
    get_logger,
    log_metrics,
)
from online_convex_optimization_tpu_torch.utils.profiling import trace


def resolve_dtype(cfg: ExperimentConfig):
    """``f32`` -> float32; ``auto`` and ``x64`` -> float64 on every device."""
    return np.float32 if cfg.precision == "f32" else np.float64


def run_experiment(cfg: ExperimentConfig) -> Dict:
    if cfg.exact:
        raise NotImplementedError(
            "--exact: the exact-FTL track is not ported to PyTorch yet "
            "(ROADMAP.md queue 1, item 14, 'The exact track')")
    log = get_logger()
    t_start = time.time()
    device = resolve_device(cfg.device)
    dtype = resolve_dtype(cfg)
    os.makedirs(cfg.out_dir, exist_ok=True)
    log.info("experiment start: T_grid=%s g_runs=%d dtype=%s device=%s",
             cfg.T_grid, cfg.g_runs, np.dtype(dtype).name, device)
    cache = (os.path.join(cfg.out_dir, f"g_emp_{cfg.g_cache_key()}.json")
             if cfg.checkpoint else None)

    # 1) empirical g(T)
    g_emp = estimate_g(cfg.T_grid, runs=cfg.g_runs, base_seed=cfg.base_seed,
                       eta0=cfg.eta0, dtype=dtype, chunk=cfg.batch_chunk,
                       cache_path=cache, check=cfg.check, device=device)
    t_g = time.time()

    # 2) per-case evaluation (optionally under a torch.profiler trace)
    prof = (trace(cfg.profile_dir) if cfg.profile_dir
            else contextlib.nullcontext())
    titles = cfg.cases or tuple(CASES)
    stats_by_case = {}
    eff_runs, eff_reps = {}, {}
    with prof:
        for title in titles:
            runs = cfg.runs_override or RUNS_BY_TITLE.get(title, 1)
            reps = cfg.replicates_override or REPLICATES_BY_TITLE.get(title,
                                                                      1)
            eff_runs[title], eff_reps[title] = runs, reps
            stats_by_case[title] = evaluate_stream_with_stats(
                CASES[title], cfg.T_grid, g_emp, runs=runs, replicates=reps,
                base_seed=cfg.base_seed, eta0=cfg.eta0, dtype=dtype,
                batch_chunk=cfg.batch_chunk, stream_name=title,
                device=device)
    t_eval = time.time()  # the regrets reached the host: the device is done

    # 3) figures; matplotlib is an optional dependency (the "plots" extra)
    if importlib.util.find_spec("matplotlib") is None:
        log.warning("matplotlib is not installed: figures not written")
        figures_s = None
    else:
        plot_empirical_g(
            cfg.T_grid, g_emp,
            out_path=os.path.join(cfg.out_dir, "empirical_g_T.png"),
            title="Empirical worst-case g(T) for SMART (ALG_WC = FTRL)",
            dpi=cfg.dpi)
        plot_comparisons(
            cfg.T_grid, stats_by_case,
            out_path=os.path.join(cfg.out_dir, "algorithm_comparison.png"),
            runs_by_title=eff_runs, reps_by_title=eff_reps,
            suptitle="Online Linear Binary Classification", dpi=cfg.dpi)
        figures_s = time.time() - t_eval
    t_end = time.time()

    results = {
        "config": dataclasses.asdict(cfg),
        "wall_s": t_end - t_start,
        "phase_s": {"g": t_g - t_start, "evaluate": t_eval - t_g,
                    "figures": figures_s},
        "device": device_record(device),
        "g_emp": {str(k): v for k, v in g_emp.items()},
        "stats": {
            title: {k: {"mean": list(map(float, m)), "ci": list(map(float, c))}
                    for k, (m, c) in stats.items()}
            for title, stats in stats_by_case.items()
        },
    }
    with open(os.path.join(cfg.out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    log.info("experiment done in %.1fs -> %s", results["wall_s"], cfg.out_dir)
    log_metrics(os.path.join(cfg.out_dir, "metrics.jsonl"), {
        "event": "experiment_done", "wall_s": results["wall_s"],
        "phase_s": results["phase_s"], "g_runs": cfg.g_runs,
        "device": results["device"], "cases": list(results["stats"])})
    return results


def main(argv=None) -> None:
    cfg = config_from_args(argv)
    results = run_experiment(cfg)
    print(f"done in {results['wall_s']:.1f}s -> {cfg.out_dir}/")


if __name__ == "__main__":
    main()
