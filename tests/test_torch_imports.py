"""The port never imports JAX, and a CPU call launches no kernel.

Runs in a fresh interpreter, since the test process itself has JAX loaded.
"""

import os
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "online_convex_optimization_tpu_torch"

_CHILD = """
import sys
import numpy as np
import online_convex_optimization_tpu_torch as oco
from online_convex_optimization_tpu_torch.experiments import driver
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.data import CASES

z, y, _ = CASES["Random i.i.d. (separable)"](run_seed=2025)(60, rep=0)
r = oco.simulate_alg(z, y, 0, 2 ** 0.5, device="cpu")
s = oco.simulate_SMART(z, y, device="cpu")
assert np.isfinite(r) and np.isfinite(s)

# The sweep and streaming slice, through its examples, on the CPU.
import online_convex_optimization_tpu_torch.testing.from_jax
import online_convex_optimization_tpu_torch.utils.checkpointing
from online_convex_optimization_tpu_torch.examples import (
    kernel_batch_sweep, streaming_long_horizon)
out = kernel_batch_sweep.main(["--device", "cpu", "--batch", "16",
                               "--horizon", "32"])
assert out["eta_regret"].shape == (16, 16)
assert out["threshold_regret"].shape == (16, 4)
res = streaming_long_horizon.main(["--device", "cpu", "--batch", "8",
                                   "--chunk", "8", "--chunks", "4"])
assert res.regret.shape == (8,) and bool(np.isfinite(res.regret).all())

# The quadratic track and the packed game API, on the CPU.
import torch
from online_convex_optimization_tpu_torch.experiments import quadratic_study
from online_convex_optimization_tpu_torch.ops import trs
study = quadratic_study.main(["--t-min", "20", "--t-max", "40", "--t-step",
                              "20", "--runs", "2", "--replicates", "2",
                              "--out-dir", sys.argv[1], "--device", "cpu"])
assert np.isfinite(study["stats"]["FTL (exact LS)"]["mean"]).all()
zb = torch.from_numpy(np.stack([z] * 3))
yb = torch.from_numpy(np.stack([y] * 3))
assert game.simulate_linear_auto(zb, yb, 0, 1.0).shape == (3,)
assert game.kernel_envelope(3, 60, 5) is None

# The sharded sweeps, the worker and the pod-scale demo (K7's plain
# version), on the CPU.
from online_convex_optimization_tpu_torch.experiments import pod_demo
from online_convex_optimization_tpu_torch.parallel import (
    mesh, multihost, scaling, sweep)
from online_convex_optimization_tpu_torch.utils import debug, profiling
pod = pod_demo.main(["--t", "8", "--seqs", "16", "--lane-batch", "2",
                     "--device", "cpu"])
assert len(pod["g_max"]) == 8 and pod["n_sequences_per_eta"] == 16
w = multihost.run_worker(8, 4, eta0=1.0, device="cpu")
assert w["total_scenarios"] == 4

# The exact-FTL track: the --exact driver through the banded ADMM and
# K10's plain version, on the CPU.
from online_convex_optimization_tpu_torch.models import exact_ftl
from online_convex_optimization_tpu_torch.ops import admm
for solver, precision in (("auto", "x64"), ("xla", "x64"), ("kernel", "f32")):
    driver.main(["--exact", "--exact-solver", solver, "--precision",
                      precision, "--t-min", "20", "--t-max", "40",
                      "--t-step", "20", "--g-runs", "3", "--runs", "2",
                      "--replicates", "2", "--dpi", "20", "--device", "cpu",
                      "--cases", "Massart noise 10%", "Label flips",
                      "--out-dir", sys.argv[1] + "/exact_" + solver])
res = exact_ftl.run_ftl_exact(z[:30], y[:30], device="cpu")
assert np.isfinite(res.regret)

# The semismooth Newton, the fidelity audit and the four remaining
# examples, on the CPU.
from online_convex_optimization_tpu_torch.models import ssn
from online_convex_optimization_tpu_torch.experiments import fidelity
from online_convex_optimization_tpu_torch.examples import (
    certified_and_ssn, exact_oracles, norm_balls_and_recovery,
    reference_workflow)
report = fidelity.main(["--out", sys.argv[1] + "/fidelity.md"])
assert report.startswith("# Figure fidelity")
wf = reference_workflow.main(["--device", "cpu", "--t-grid", "40", "80",
                              "--g-runs", "4"])
assert set(wf["regret"]) == {40, 80}
eo = exact_oracles.main(["--device", "cpu", "--horizon", "30",
                         "--quadratic-horizon", "60"])
assert np.isfinite(eo["exact_ftl"].regret)
cs = certified_and_ssn.main(["--device", "cpu", "--horizon", "30",
                             "--admm-iters", "8000"])
assert abs(cs["admm"].regret - cs["ssn"].regret) < 1e-4
nb = norm_balls_and_recovery.main(["--device", "cpu"])
assert nb["l1_certified"] and (nb["g_sliced"] == nb["g_once"]).all()

assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("online_convex_optimization_tpu.")
               or m == "online_convex_optimization_tpu" for m in sys.modules)
assert game.LAUNCHES == 0 and smart.LAUNCHES == 0
assert game.SWEEP_LAUNCHES == game.STREAM_LAUNCHES == smart.SWEEP_LAUNCHES == 0
assert game.PACKED_LAUNCHES == game.PACKED_ETA_LAUNCHES == 0
assert trs.TRS_LAUNCHES == trs.QUAD_LAUNCHES == 0
assert game.SYNTHETIC_LAUNCHES == 0
assert admm.LAUNCHES == 0
print("OK")
"""


def test_port_runs_without_jax_and_launches_nothing_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    offenders = [str(p) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
