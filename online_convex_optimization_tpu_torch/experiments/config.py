"""Experiment configuration with CLI overrides.

Counterpart of ``online_convex_optimization_tpu/experiments/config.py``
(``ExperimentConfig``, ``build_parser``, ``config_from_args``).
Differences from the JAX package:

  - ``--device`` (``cuda`` or ``cpu``, default ``cuda``) names where the
    simulators run; ``cuda`` without a card raises, it never falls back.
  - ``precision="auto"`` means float64 on every device (the H100 computes
    f64 natively); ``f32`` keeps the JAX package's TPU behaviour, routing
    the two 1x1 deterministic families to the f64 golden oracle.
  - ``--exact`` runs the exact-FTL mode with the JAX package's flags and
    defaults (``--exact-iters``, ``--exact-solver``, ``--exact-selection``,
    ``--norm``, ``--exact-admm-precision``).  ``--exact-solver kernel`` is
    kernel K10 (l2, ``--precision f32``); ``--exact-solver ssn`` is the
    semismooth Newton (l2), which solves in float64 whatever
    ``--precision`` is; ``--exact-admm-precision high`` raises
    (``ValueError``: the TPU's bf16x3 products have no IEEE counterpart on
    the card).
  - ``--check`` is an explicit ``torch.isfinite`` guard on every g(T)
    batch, on by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # Horizon grid: arange(100, 1100, 100) in the reference (driver.py:49).
    t_min: int = 100
    t_max: int = 1000
    t_step: int = 100
    base_seed: int = 0
    g_runs: int = 1000            # driver.py:51
    eta0: float = math.sqrt(2.0)  # driver.py:102
    cases: Tuple[str, ...] = ()   # empty = all registry cases
    runs_override: Optional[int] = None
    replicates_override: Optional[int] = None
    precision: str = "auto"       # auto/x64: float64 on every device; f32
    exact: bool = False           # exact-FTL comparison mode (exact driver)
    exact_iters: int = 2000
    # ADMM iterate products: "highest" (IEEE) only; "high" raises.
    exact_admm_precision: str = "highest"
    # Exact solve: "auto" = certified closed form, semismooth Newton for the
    # uncertified out-of-contract l2 cells, banded ADMM for the uncertified
    # in-contract ones; "linear" = require the certificate; "xla" = force
    # the banded ADMM; "kernel" = force K10 (l2, f32); "ssn" = force the
    # semismooth Newton (l2, f64).
    exact_solver: str = "auto"
    # Degenerate-optima selection: "canonical" (min-l2-norm point of the
    # optimal face, models/canonical.py) or "committed" (the solver's).
    exact_selection: str = "canonical"
    norm: str = "l2"              # exact oracle ball (exact_ftl.py:72)
    out_dir: str = "results"
    dpi: int = 600                # matches the reference (driver.py:158)
    checkpoint: bool = True
    # Max sequences a device batch: the largest case (9,600) and the g(T)
    # table (10,000) each fit one launch.
    batch_chunk: int = 16384
    check: bool = True            # isfinite guard on the g(T) regrets
    device: str = "cuda"
    profile_dir: str = ""         # write a torch.profiler trace of the eval

    @property
    def T_grid(self) -> Tuple[int, ...]:
        return tuple(range(self.t_min, self.t_max + 1, self.t_step))

    def g_cache_key(self) -> str:
        fields = {
            "t": list(self.T_grid), "seed": self.base_seed,
            "runs": self.g_runs, "eta0": self.eta0,
            "precision": self.precision, "device": self.device,
        }
        if self.exact:  # plain-pipeline keys predate (and ignore) these
            fields.update(exact=True, norm=self.norm,
                          iters=self.exact_iters,
                          admm_prec=self.exact_admm_precision,
                          solver=self.exact_solver)
        payload = json.dumps(fields, sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()[:12]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oco-torch",
        description="Online convex optimization experiments on PyTorch/CUDA")
    d = ExperimentConfig()
    p.add_argument("--t-min", type=int, default=d.t_min)
    p.add_argument("--t-max", type=int, default=d.t_max)
    p.add_argument("--t-step", type=int, default=d.t_step)
    p.add_argument("--base-seed", type=int, default=d.base_seed)
    p.add_argument("--g-runs", type=int, default=d.g_runs)
    p.add_argument("--eta0", type=float, default=d.eta0)
    p.add_argument("--cases", nargs="*", default=None,
                   help="subset of case titles (default: all)")
    p.add_argument("--runs", type=int, default=None,
                   help="override per-case run count")
    p.add_argument("--replicates", type=int, default=None,
                   help="override per-case replicate count")
    p.add_argument("--precision", choices=["auto", "x64", "f32"],
                   default=d.precision,
                   help="auto and x64: float64 on every device")
    p.add_argument("--exact", action="store_true",
                   help="exact-FTL comparison mode (exact_ftl_driver.py)")
    p.add_argument("--exact-iters", type=int, default=d.exact_iters)
    p.add_argument("--exact-admm-precision", choices=["highest", "high"],
                   default=d.exact_admm_precision,
                   help="ADMM iterate products: highest = IEEE; high (the "
                        "TPU's bf16x3) raises on this port")
    p.add_argument("--exact-solver",
                   choices=["auto", "linear", "xla", "kernel", "ssn"],
                   default=d.exact_solver,
                   help="exact solve: auto = certified closed form where "
                        "the optimality certificate holds, else semismooth "
                        "Newton for out-of-contract l2 cells and the banded "
                        "ADMM for the rest; linear = require the "
                        "certificate; xla = force the banded ADMM; kernel = "
                        "force kernel K10 (l2, --precision f32); ssn = force "
                        "the semismooth Newton (l2, float64)")
    p.add_argument("--exact-selection", choices=["committed", "canonical"],
                   default=d.exact_selection,
                   help="degenerate-optima selection: canonical = min-l2-"
                        "norm point of the optimal face; committed = the "
                        "solver's selection")
    p.add_argument("--norm", choices=["l2", "linf", "l1"], default=d.norm)
    p.add_argument("--out-dir", default=d.out_dir)
    p.add_argument("--dpi", type=int, default=d.dpi)
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--batch-chunk", type=int, default=d.batch_chunk)
    p.add_argument("--check", action="store_true", default=d.check,
                   dest="check",
                   help="raise on a non-finite g(T) regret (default: on)")
    p.add_argument("--no-check", action="store_false", dest="check",
                   help="disable the isfinite guard")
    p.add_argument("--device", choices=["cuda", "cpu"], default=d.device,
                   help="cuda: the CUDA kernels; cpu: their plain PyTorch "
                        "versions")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace of the evaluation")
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> ExperimentConfig:
    args = build_parser().parse_args(argv)
    return ExperimentConfig(
        t_min=args.t_min, t_max=args.t_max, t_step=args.t_step,
        base_seed=args.base_seed, g_runs=args.g_runs, eta0=args.eta0,
        cases=tuple(args.cases) if args.cases else (),
        runs_override=args.runs, replicates_override=args.replicates,
        precision=args.precision, exact=args.exact,
        exact_iters=args.exact_iters,
        exact_admm_precision=args.exact_admm_precision,
        exact_solver=args.exact_solver,
        exact_selection=args.exact_selection, norm=args.norm,
        out_dir=args.out_dir, dpi=args.dpi,
        checkpoint=not args.no_checkpoint, batch_chunk=args.batch_chunk,
        check=args.check, device=args.device, profile_dir=args.profile_dir)
