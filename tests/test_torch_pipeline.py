"""The port's experiment pipeline against the JAX driver, both on CPU in f64.

At ``--t-max 300 --g-runs 20 --runs 2 --replicates 2 --dpi 50`` every
``g_emp`` and ``stats`` entry agrees to 1e-9; plus the port driver's
contract: ``--exact --exact-solver ssn`` runs (l2; ``--norm linf`` raises),
``--device cuda`` without a card raises, the f32
deterministic families route to the golden oracle, the g(T) cache is
provenance-keyed and the isfinite guard names its horizon.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.experiments import driver as jax_driver
from online_convex_optimization_tpu.experiments import evaluate as jax_evaluate
from online_convex_optimization_tpu_torch.data.sequences import CASES
from online_convex_optimization_tpu_torch.experiments import driver as pt_driver
from online_convex_optimization_tpu_torch.experiments import evaluate as pt_evaluate
from online_convex_optimization_tpu_torch.experiments.config import (
    ExperimentConfig,
    config_from_args,
)
from online_convex_optimization_tpu_torch.experiments.gt import estimate_g

torch.set_num_threads(1)

TOL = 1e-9
ARGS = ["--t-max", "300", "--g-runs", "20", "--runs", "2", "--replicates",
        "2", "--dpi", "50"]


def _max_diff(a, b):
    err = max(abs(a["g_emp"][k] - b["g_emp"][k]) for k in b["g_emp"])
    assert a["g_emp"].keys() == b["g_emp"].keys()
    assert a["stats"].keys() == b["stats"].keys()
    for title, algs in b["stats"].items():
        for alg, fields in algs.items():
            for f in ("mean", "ci"):
                got = a["stats"][title][alg][f]
                assert len(got) == len(fields[f])
                err = max(err, max(abs(u - v) for u, v in zip(got, fields[f])))
    return err


def test_port_driver_matches_jax_driver(tmp_path):
    pt_dir, jax_dir = tmp_path / "torch", tmp_path / "jax"
    pt_driver.main(ARGS + ["--device", "cpu", "--out-dir", str(pt_dir)])
    jax_driver.main(ARGS + ["--out-dir", str(jax_dir)])
    with open(pt_dir / "results.json") as f:
        pt = json.load(f)
    with open(jax_dir / "results.json") as f:
        jx = json.load(f)
    assert _max_diff(pt, jx) <= TOL
    assert pt["device"] == {"type": "cpu"}
    assert set(pt["phase_s"]) == {"g", "evaluate", "figures"}
    for name in ("empirical_g_T.png", "algorithm_comparison.png"):
        assert os.path.getsize(pt_dir / name) > 0


def test_driver_refuses_exact_and_missing_card(tmp_path):
    # --exact --exact-solver ssn runs every general cell through the
    # semismooth Newton (l2 only in the pipeline, as in the JAX package).
    ssn_args = ["--exact", "--exact-solver", "ssn", "--device", "cpu",
                "--t-min", "20", "--t-max", "40", "--t-step", "20",
                "--g-runs", "3", "--runs", "1", "--replicates", "2",
                "--cases", "Massart noise 10%", "--dpi", "20"]
    res = pt_driver.run_experiment(config_from_args(
        ssn_args + ["--out-dir", str(tmp_path / "ssn")]))
    audit = res["audit"]["Massart noise 10%"]
    assert audit["cells_ssn"] == audit["cells"] == 2
    assert audit["replicates_dropped"] == 0
    assert np.isfinite(res["stats"]["Massart noise 10%"]["FTL (exact)"][
        "mean"]).all()
    with pytest.raises(ValueError, match="l2"):
        pt_driver.run_experiment(config_from_args(
            ssn_args + ["--norm", "linf", "--out-dir", str(tmp_path)]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pt_driver.run_experiment(config_from_args(
                ["--device", "cuda", "--out-dir", str(tmp_path)]))


def test_config_cli_round_trip():
    cfg = config_from_args(["--t-max", "500", "--device", "cpu",
                            "--precision", "f32", "--no-check",
                            "--cases", "Label flips"])
    assert cfg.T_grid == (100, 200, 300, 400, 500)
    assert (cfg.device, cfg.precision, cfg.check) == ("cpu", "f32", False)
    assert cfg.cases == ("Label flips",)
    assert ExperimentConfig().device == "cuda"
    assert ExperimentConfig().g_cache_key() != ExperimentConfig(
        device="cpu").g_cache_key()


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
def test_f32_deterministic_families_route_to_golden(title):
    g = {100: 5.0, 200: 7.5}
    got = pt_evaluate.evaluate_stream_with_stats(
        CASES[title], (100, 200), g, dtype=np.float32, progress=False,
        device="cpu")
    from online_convex_optimization_tpu.data.sequences import CASES as JAX_CASES
    want = jax_evaluate.evaluate_stream_with_stats(
        JAX_CASES[title], (100, 200), g, dtype=np.float32, progress=False)
    for k in pt_evaluate.ALGO_KEYS:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])


def test_g_cache_resumes_only_on_matching_provenance(tmp_path):
    cache = str(tmp_path / "g.json")
    g1 = estimate_g((40, 80), runs=5, cache_path=cache, progress=False,
                    device="cpu")
    with open(cache) as f:
        saved = json.load(f)
    assert saved["_meta"]["key"]["device"] == "cpu"
    # Resumed: a doctored value comes back when the provenance matches ...
    saved["40"] = 123.0
    with open(cache, "w") as f:
        json.dump(saved, f)
    assert estimate_g((40, 80), runs=5, cache_path=cache, progress=False,
                      device="cpu")[40] == 123.0
    # ... and is recomputed under another config (eta0 differs).
    g3 = estimate_g((40, 80), runs=5, eta0=math.sqrt(2.0) + 1e-3,
                    cache_path=cache, progress=False, device="cpu")
    assert g3[40] != 123.0 and g1[80] > 0.0


def test_profile_dir_traces_the_evaluation(tmp_path):
    prof_dir = tmp_path / "prof"
    pt_driver.main(["--t-min", "50", "--t-max", "100", "--t-step", "50",
                    "--g-runs", "4", "--runs", "2", "--replicates", "1",
                    "--cases", "Label flips", "--dpi", "20", "--device",
                    "cpu", "--out-dir", str(tmp_path / "out"),
                    "--profile-dir", str(prof_dir)])
    with open(prof_dir / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_check_names_the_horizon_of_a_non_finite_regret():
    with pytest.raises(FloatingPointError, match="T=30"):
        estimate_g((30,), runs=3, eta0=float("nan"), progress=False,
                   device="cpu")
