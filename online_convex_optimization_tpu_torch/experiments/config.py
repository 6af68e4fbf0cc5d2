"""Experiment configuration with CLI overrides.

Counterpart of ``online_convex_optimization_tpu/experiments/config.py``
(``ExperimentConfig``, ``build_parser``, ``config_from_args``) for the plain
pipeline.  Differences from the JAX package:

  - ``--device`` (``cuda`` or ``cpu``, default ``cuda``) names where the
    simulators run; ``cuda`` without a card raises, it never falls back.
  - ``precision="auto"`` means float64 on every device (the H100 computes
    f64 natively); ``f32`` keeps the JAX package's TPU behaviour, routing
    the two 1x1 deterministic families to the f64 golden oracle.
  - ``--exact`` is parsed and raises ``NotImplementedError``: the exact-FTL
    track is not ported yet (ROADMAP.md queue 1, item 14, "The exact
    track").
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
    exact: bool = False           # exact-FTL mode: not ported, raises
    out_dir: str = "results"
    dpi: int = 600                # matches the reference (driver.py:158)
    checkpoint: bool = True
    batch_chunk: int = 4096       # max sequences per device batch
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
                   help="exact-FTL comparison mode (not ported yet: raises)")
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
        out_dir=args.out_dir, dpi=args.dpi,
        checkpoint=not args.no_checkpoint, batch_chunk=args.batch_chunk,
        check=args.check, device=args.device, profile_dir=args.profile_dir)
