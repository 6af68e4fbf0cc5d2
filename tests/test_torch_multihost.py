"""The port's multi-process worker (``parallel/multihost.py``), its scaling
harness and the pod-scale demo, on the CPU; and the utilities they use
(``utils/debug.py``, ``utils/profiling.py``).

Two worker processes form a gloo group over a free local port, one rank
each, as ``python -m online_convex_optimization_tpu_torch.parallel.
multihost --device cpu`` runs them.  Their reduced statistics must agree
between the ranks exactly and with one process recomputing both ranks'
shards: the max bit for bit, the means within 1e-12 relative (the ranks'
sums are added in another order).  The stream hand-off must be bitwise.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from online_convex_optimization_tpu_torch.data.device import (
    random_game_batch,
    shard_generators,
)
from online_convex_optimization_tpu_torch.experiments import pod_demo
from online_convex_optimization_tpu_torch.models.linear import (
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.ops import game
from online_convex_optimization_tpu_torch.parallel import multihost, scaling
from online_convex_optimization_tpu_torch.parallel.mesh import free_port
from online_convex_optimization_tpu_torch.utils import debug, profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, BATCH = 64, 32


def _group(n, *args):
    """Run the worker CLI in ``n`` processes of one gloo group; return
    each rank's JSON record."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "online_convex_optimization_tpu_torch.parallel.multihost",
         "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(i), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _shard_regrets(rank, n, eta):
    gen = shard_generators(0, n, device="cpu")[rank]
    z, y = random_game_batch(gen, BATCH, T)
    return simulate_linear_batch(z, y, 0, eta).regret.double().numpy()


@pytest.mark.parametrize("layout", ["data", "hyper", "host"])
def test_two_process_worker_agrees(layout):
    args = {"data": [], "hyper": ["--hyper", "2"],
            "host": ["--host-axis"]}[layout]
    a, b = _group(2, "--t", str(T), "--per-device-batch", str(BATCH), *args)
    for key in ("g_max_by_eta", "mean_by_eta", "g_max", "mean_regret",
                "sem", "total_scenarios", "mesh", "axes", "eta_grid"):
        assert a[key] == b[key], key
    assert a["n_global_devices"] == 2 and a["total_scenarios"] == 2 * BATCH
    eta0 = np.float32(math.sqrt(2.0))
    if layout == "hyper":
        assert a["mesh"] == [1, 2] and a["axes"] == ["data", "hyper"]
        etas = eta0 * np.linspace(1.0, 2.0, 2, dtype=np.float32)
        assert a["eta_grid"] == [float(e) for e in etas]
        regrets = [_shard_regrets(r, 2, float(etas[r])) for r in range(2)]
        assert a["g_max_by_eta"] == [float(np.float32(r.max()))
                                     for r in regrets]
        np.testing.assert_allclose(a["mean_by_eta"],
                                   [r.mean() for r in regrets], rtol=1e-12)
        return
    want_mesh = [2, 1] if layout == "data" else [2, 1, 1]
    assert a["mesh"] == want_mesh
    assert a["axes"][-2:] == ["data", "hyper"]
    regrets = np.concatenate([_shard_regrets(r, 2, float(eta0))
                              for r in range(2)])
    assert a["g_max"] == float(np.float32(regrets.max()))
    assert a["mean_regret"] == pytest.approx(regrets.mean(), rel=1e-12)
    assert a["sem"] == pytest.approx(regrets.std(ddof=1)
                                     / math.sqrt(regrets.size), rel=1e-9)


def test_host_axis_needs_a_divisible_data_axis():
    with pytest.raises(ValueError, match="host axis"):
        multihost._worker_mesh(2, 2, True, "cpu")


def test_stream_handoff_is_bitwise():
    outs = _group(2, "--mode", "stream-handoff", "--t", "64",
                  "--per-device-batch", "8", "--chunks", "8", "--split", "3")
    for o in outs:
        assert o["mode"] == "stream-handoff"
        assert o["bitwise_cum"] and o["bitwise_regret"]
    assert outs[0]["cum_loss"] == outs[1]["cum_loss"]
    assert outs[0]["regret"] == outs[1]["regret"]


def test_single_process_worker_and_handoff():
    """Without a coordinator the worker runs alone, with no process
    group."""
    out = multihost.main(["--t", str(T), "--per-device-batch", str(BATCH),
                          "--device", "cpu", "--bench-reps", "1"])
    assert out["mesh"] == [1, 1] and out["total_scenarios"] == BATCH
    assert out["bench_steps_per_s"] > 0
    regrets = _shard_regrets(0, 1, float(np.float32(math.sqrt(2.0))))
    assert out["g_max"] == float(np.float32(regrets.max()))
    res = multihost.run_stream_handoff(32, 4, chunks=4, split=2, eta0=1.1,
                                       device="cpu")
    assert res["bitwise_cum"] and res["bitwise_regret"]


def test_measure_multihost_small():
    points = scaling.measure_multihost((1, 2), T=32, per_device_batch=16,
                                       bench_reps=1, timeout=120)
    assert [p["n_processes"] for p in points] == [1, 2]
    assert [p["n_global_devices"] for p in points] == [1, 2]
    for p in points:
        assert p["steps_per_s"] > 0 and p["agree_across_hosts"]


def test_measure_scaling_on_one_rank():
    points = scaling.measure_scaling(B_per_dev=16, T=16, reps=2,
                                     device="cpu")
    assert len(points) == 1 and points[0].n_devices == 1
    assert points[0].efficiency == 1.0 and points[0].steps_per_s > 0


def test_pod_demo_record_on_the_cpu(tmp_path):
    out = tmp_path / "pod.json"
    res = pod_demo.main(["--t", "24", "--seqs", "200", "--lane-batch", "8",
                         "--etas", "0.5", "1.5", "--device", "cpu",
                         "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["metric"] == "pod_scale_g_sweep"
    assert res["n_sequences_per_eta"] == 256          # 4 blocks of 64
    assert res["total_steps"] == 2 * 256 * 24
    assert res["device"] == {"type": "cpu"} and res["wall_s"] > 0
    want = [max(float(game.synthetic_regrets(b << 20, eta, T=24,
                                             lane_batch=8,
                                             device="cpu").max())
                for b in range(4)) for eta in (0.5, 1.5)]
    assert list(res["g_max"].values()) == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pod_demo.main(["--t", "8", "--seqs", "8", "--lane-batch", "1"])


def test_finite_or_sentinel_and_stats():
    x = torch.tensor([1.0, float("nan"), 3.0, float("inf"), -2.0])
    np.testing.assert_array_equal(
        debug.finite_or_sentinel(x, -1.0).numpy(), [1.0, -1.0, 3.0, -1.0,
                                                    -2.0])
    assert torch.isnan(debug.finite_or_sentinel(x)[1])
    n, mx, mean = debug.drop_nonfinite_stats(x)
    assert int(n) == 3 and float(mx) == 3.0
    assert float(mean) == pytest.approx(2.0 / 3.0, rel=1e-7)   # float32
    n, mx, mean = debug.drop_nonfinite_stats(torch.tensor([float("nan")]))
    assert int(n) == 0 and float(mx) == -math.inf and float(mean) == 0.0


def test_checked_names_the_non_finite_tensor():
    z = torch.zeros((2, 4, 3), dtype=torch.float64)
    y = torch.ones((2, 4), dtype=torch.float64)
    guarded = debug.checked(simulate_linear_batch)
    assert torch.isfinite(guarded(z, y, 0, 1.0).regret).all()
    z[1, 2, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"simulate_linear_batch\(\)\.cum_loss"):
        guarded(z, y, 0, 1.0)

    def pair():
        return torch.ones(2), torch.tensor([math.inf])

    with pytest.raises(FloatingPointError, match=r"pair\(\)\[1\]"):
        debug.checked(pair)()
    debug.assert_finite(torch.ones(3), "ones")


def test_measure_times_the_host_on_the_cpu(tmp_path):
    calls = []
    timing = profiling.measure(lambda: calls.append(1), warmup=2, runs=3,
                               device="cpu")
    assert len(calls) == 5 and timing.runs == 3 and timing.device == "cpu"
    assert 0 <= timing.best_s <= timing.mean_s
    assert timing.steps_per_s(10) == 10 / timing.best_s
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof.key_averages() is not None
    assert (tmp_path / "trace.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            profiling.measure(lambda: None)
