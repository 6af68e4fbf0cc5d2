"""The port's sharded sweeps (``parallel/``) over gloo process groups on
the CPU, against one process and against the JAX package.

Two- and four-rank groups run in subprocesses (one rank each, free ports)
on the same NumPy inputs, each rank on its ``local_shard``; a module
fixture starts both groups once and every test reads their results.

Tolerances:

- against one process on the concatenated batch: the max bit for bit,
  ``(n, sum, sum_sq)`` within 1e-12 relative in float64 (the ranks' sums
  are added in another order), the per-sequence results bit for bit;
- against the JAX functions on ``make_mesh(4, 2)`` (8 virtual devices):
  1e-9 in x64 for the scans, 1e-4 for the quadratic track (its FTL on
  singular prefixes, ``tests/test_torch_quadratic.py``), 5e-4 and equal
  switch rounds in float32 for the Pallas kernels in interpret mode
  (``tests/test_torch_kernels_plain.py``);
- the synthetic g sweeps: bit for bit, with a stand-in ``regret_fn`` whose
  value is an integer hash of (seed, lane) computed identically in JAX
  uint32 and torch int64 & 0xffffffff arithmetic, so equal answers prove
  equal seed layouts.
"""

import inspect
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_convex_optimization_tpu.ops import pallas_game as jpg
from online_convex_optimization_tpu.parallel import sweep as jax_sweep
from online_convex_optimization_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from online_convex_optimization_tpu_torch.models.linear import (
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.ops import game
from online_convex_optimization_tpu_torch.parallel import sweep
from online_convex_optimization_tpu_torch.parallel.mesh import (
    free_port,
    make_mesh,
)
from online_convex_optimization_tpu_torch.testing.from_jax import (
    synthetic_g_checkpoint_from_jax,
)
from online_convex_optimization_tpu_torch.utils.checkpointing import (
    load_pytree,
    save_pytree,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ETA = math.sqrt(2.0)
ETAS = [0.5, 1.0, 1.5, 2.0]
X64_TOL = 1e-9
F32_TOL = 5e-4
SINGULAR_TOL = 1e-4
STATS_RTOL = 1e-12
MASK = 0xFFFFFFFF
# The worlds and the port's mesh in each: (n_data, n_hyper).
MESHES = {2: (2, 1), 4: (2, 2)}


def torch_hash(seed, eta, *, T, lane_batch, alg_flag, device="cpu"):
    """Stand-in regret_fn: an integer hash of (seed, lane) in [0, 1) times
    eta, in 32-bit unsigned arithmetic carried in int64."""
    s = torch.tensor(seed, dtype=torch.int64) & MASK
    lane = torch.arange(8 * lane_batch, dtype=torch.int64).reshape(
        8, lane_batch)
    u = (s * 40503 + lane * 69069 + T + 7 * alg_flag) & MASK
    u = u ^ (u >> 15)
    u = (u * 739982445) & MASK
    u = u ^ (u >> 12)
    return ((u >> 8).to(torch.float32) / 16777216.0
            * torch.tensor(eta, dtype=torch.float32)).to(device)


def jax_hash(seed, eta, *, T, lane_batch, alg_flag, interpret):
    """The same hash in JAX uint32 arithmetic (the int32 seed's bits)."""
    del interpret
    s = jax.lax.bitcast_convert_type(jnp.asarray(seed, jnp.int32),
                                     jnp.uint32)
    lane = jnp.arange(8 * lane_batch, dtype=jnp.uint32).reshape(
        8, lane_batch)
    u = s * jnp.uint32(40503) + lane * jnp.uint32(69069) + jnp.uint32(
        T + 7 * alg_flag)
    u = u ^ (u >> 15)
    u = u * jnp.uint32(739982445)
    u = u ^ (u >> 12)
    return (u >> 8).astype(jnp.float32) / 16777216.0 * eta


def _clipped(rng, shape):
    z = rng.normal(size=shape)
    return z / np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))


def _inputs():
    rng = np.random.default_rng(0)
    z = _clipped(rng, (64, 48, 5))
    y = np.where(rng.random((64, 48)) < 0.5, -1.0, 1.0)
    z_nan = z.copy()
    z_nan[3] = np.nan
    zk = _clipped(rng, (8192, 16, 5)).astype(np.float32)
    yk = np.where(rng.random((8192, 16)) < 0.5, -1.0, 1.0).astype(np.float32)
    zq = _clipped(rng, (64, 48, 5))
    yq = zq @ (np.ones(5) / np.sqrt(5.0)) + 0.1 * rng.normal(size=(64, 48))
    return {
        "z": z, "y": y, "z_nan": z_nan,
        "thresh": np.linspace(0.2, 6.0, 64),
        "zk_tm": np.ascontiguousarray(zk.transpose(1, 2, 0)),
        "yk_tm": np.ascontiguousarray(yk.T),
        "eta_k": np.linspace(0.2, 3.0, 8192, dtype=np.float32),
        "th_k": rng.uniform(0.6, math.sqrt(32.0), 8192).astype(np.float32),
        "et_k": rng.uniform(0.3, 3.0, 8192).astype(np.float32),
        "zq": zq, "yq": yq,
    }


def _child_run(port, rank, world, tmp, n_data, n_hyper):
    """One rank of a gloo group, in its own process: every sharded function
    on this rank's shard of ``inputs.npz``, saved to
    ``out_<world>_<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from online_convex_optimization_tpu_torch.ops import game
    from online_convex_optimization_tpu_torch.parallel import sweep
    from online_convex_optimization_tpu_torch.parallel.mesh import (
        initialize_distributed, local_shard, make_mesh, make_mesh3)

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    inp = {k: torch.from_numpy(v)
           for k, v in np.load(f"{tmp}/inputs.npz").items()}
    mesh = make_mesh(n_data, n_hyper, device="cpu")
    mesh3 = make_mesh3(2, n_data // 2, n_hyper, device="cpu")

    def sh(key, axis=0):
        return local_shard(mesh, inp[key], axis)

    out = {"shard_index": mesh.shard_index}
    for key, z in (("max", "z"), ("max_nan", "z_nan")):
        out[key] = sweep.sharded_max_regret(mesh, sh(z), sh("y"), 1.3)
    for key, z in (("stats", "z"), ("stats_nan", "z_nan")):
        out[key] = sweep.sharded_regret_stats(mesh, sh(z), sh("y"), 0, 1.3)
    out["smart"] = sweep.sharded_smart_regrets(mesh, sh("z"), sh("y"),
                                               sh("thresh"), 2 ** 0.5)
    zk, yk = sh("zk_tm", 2), sh("yk_tm", 1)
    out["kernel"] = sweep.sharded_kernel_regrets(mesh, zk, yk, sh("eta_k"))
    out["smart_kernel"], out["smart_kernel_tau"] = sweep.sharded_smart_kernel(
        mesh, zk, yk, sh("th_k"), sh("et_k"))
    out["quad"] = sweep.sharded_quadratic_regrets(mesh, sh("zq"), sh("yq"))
    carry = game.zero_stream_carry(zk.shape[2], 5, torch.float32, "cpu")
    for c in range(0, 16, 8):
        carry = sweep.sharded_stream_step(mesh, zk[c:c + 8], yk[c:c + 8],
                                          1.2, c, carry)
    out["stream"] = game.stream_result(carry)[0]

    etas = [0.5, 1.0, 1.5, 2.0]
    for key, m in (("syn_g", mesh), ("syn_g3", mesh3)):
        out[key] = sweep.sharded_synthetic_g(
            m, T=32, eta_grid=etas, blocks_per_device=3, lane_batch=16,
            seed0=5, regret_fn=torch_hash)
    out["syn_g_real"] = sweep.sharded_synthetic_g(
        mesh, T=16, eta_grid=etas[:2], blocks_per_device=1, lane_batch=2)
    resume = dict(T=32, eta_grid=etas, blocks_per_device=8, lane_batch=16)
    out["res_ragged"] = sweep.resumable_synthetic_g(
        mesh, blocks_per_step=3, regret_fn=torch_hash,
        checkpoint_path=f"{tmp}/resume_ragged_{world}.npz", **resume)
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return torch_hash(*args, **kwargs)

    out["res_from_jax"] = sweep.resumable_synthetic_g(
        mesh, blocks_per_step=2, regret_fn=counted,
        checkpoint_path=f"{tmp}/from_jax_{world}.npz", **resume)
    out["res_from_jax_calls"] = calls[0]

    try:
        sweep.sharded_synthetic_g(mesh, T=8, eta_grid=[1.0, 2.0, 3.0],
                                  blocks_per_device=1, lane_batch=1,
                                  regret_fn=torch_hash)
        out["eta_div_error"] = 0
    except ValueError:
        out["eta_div_error"] = 1
    try:
        make_mesh(world + 1, 1, device="cpu")
        out["too_big_error"] = 0
    except ValueError:
        out["too_big_error"] = 1
    x = torch.tensor([float("nan") if rank == 1 else float(rank),
                      float(rank)])
    out["pmax_nan"] = sweep.pmax(mesh, x, mesh.axis_names)
    np.savez(f"{tmp}/out_{world}_{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()


# A child runs the source of torch_hash and _child_run.
_CHILD = ("import sys\nimport torch\nMASK = 0xFFFFFFFF\n"
          + inspect.getsource(torch_hash) + inspect.getsource(_child_run)
          + "port, rank, world, tmp = sys.argv[1:5]\n"
          + f"_child_run(port, int(rank), int(world), tmp, "
            f"*{MESHES!r}[int(world)])\n")


def _jax_sweep_stopped_after(mesh, n_slices, ckpt, **kwargs):
    """A JAX resumable sweep stopped (by an exception) before its slice
    ``n_slices + 1``: its checkpoint holds ``n_slices`` slices."""
    calls = {"n": 0}
    orig = jax_sweep.sharded_synthetic_g

    class Stop(Exception):
        pass

    def counting(*a, **k):
        calls["n"] += 1
        if calls["n"] > n_slices:
            raise Stop
        return orig(*a, **k)

    jax_sweep.sharded_synthetic_g = counting
    try:
        with pytest.raises(Stop):
            jax_sweep.resumable_synthetic_g(mesh, checkpoint_path=ckpt,
                                            **kwargs)
    finally:
        jax_sweep.sharded_synthetic_g = orig


RESUME = dict(T=32, eta_grid=ETAS, blocks_per_device=8, blocks_per_step=2,
              lane_batch=16, regret_fn=None)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    # The JAX package begins each group's resumable sweep, on a mesh of the
    # group's shape, and stops after two slices; the port resumes it.
    for world, (n_data, n_hyper) in MESHES.items():
        jckpt = str(tmp / f"jax_g_{world}.npz")
        _jax_sweep_stopped_after(jax_make_mesh(n_data, n_hyper), 2, jckpt,
                                 **{**RESUME, "regret_fn": jax_hash})
        save_pytree(str(tmp / f"from_jax_{world}.npz"),
                    synthetic_g_checkpoint_from_jax(jckpt))
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = []
    for world in MESHES:
        port = str(free_port())
        procs += [subprocess.Popen(
            [sys.executable, "-c", _CHILD, port, str(r), str(world),
             str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {world: [dict(np.load(tmp / f"out_{world}_{r}.npz"))
                   for r in range(world)] for world in MESHES}
    return out, inp, tmp


def _concat(ranks, key):
    """The ranks' local results in shard order."""
    order = sorted(ranks, key=lambda o: int(o["shard_index"]))
    return np.concatenate([o[key] for o in order])


def _one_process(inp):
    """Every sharded function on the whole batch in this process."""
    mesh = make_mesh(1, 1, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    carry = game.zero_stream_carry(8192, 5, torch.float32, "cpu")
    for c in range(0, 16, 8):
        carry = sweep.sharded_stream_step(mesh, t["zk_tm"][c:c + 8],
                                          t["yk_tm"][c:c + 8], 1.2, c, carry)
    reg_k, tau_k = sweep.sharded_smart_kernel(mesh, t["zk_tm"], t["yk_tm"],
                                              t["th_k"], t["et_k"])
    return {
        "max": sweep.sharded_max_regret(mesh, t["z"], t["y"], 1.3).numpy(),
        "max_nan": sweep.sharded_max_regret(mesh, t["z_nan"], t["y"],
                                            1.3).numpy(),
        "stats": sweep.sharded_regret_stats(mesh, t["z"], t["y"], 0,
                                            1.3).numpy(),
        "stats_nan": sweep.sharded_regret_stats(mesh, t["z_nan"], t["y"], 0,
                                                1.3).numpy(),
        "smart": sweep.sharded_smart_regrets(mesh, t["z"], t["y"],
                                             t["thresh"], ETA).numpy(),
        "kernel": sweep.sharded_kernel_regrets(mesh, t["zk_tm"], t["yk_tm"],
                                               t["eta_k"]).numpy(),
        "smart_kernel": reg_k.numpy(), "smart_kernel_tau": tau_k.numpy(),
        "quad": sweep.sharded_quadratic_regrets(mesh, t["zq"],
                                                t["yq"]).numpy(),
        "stream": game.stream_result(carry)[0].numpy(),
    }


@pytest.fixture(scope="module")
def single(groups):
    return _one_process(groups[1])


@pytest.mark.parametrize("world", sorted(MESHES))
def test_reductions_equal_one_process(groups, single, world):
    ranks = groups[0][world]
    for key in ("max", "max_nan"):
        for o in ranks:
            np.testing.assert_array_equal(o[key], single[key])
    assert np.isfinite(single["max_nan"])
    for key in ("stats", "stats_nan"):
        for o in ranks:
            np.testing.assert_array_equal(o[key], ranks[0][key])
        np.testing.assert_allclose(ranks[0][key], single[key], rtol=STATS_RTOL,
                                   atol=0)
    assert ranks[0]["stats_nan"][0] == 63.0       # the NaN scenario dropped
    mean, ci = sweep.mean_and_ci(torch.from_numpy(ranks[0]["stats"]))
    regrets = simulate_linear_batch(
        torch.from_numpy(groups[1]["z"]), torch.from_numpy(groups[1]["y"]),
        0, 1.3).regret.numpy()
    assert float(mean) == pytest.approx(regrets.mean(), rel=1e-12)
    assert float(ci) == pytest.approx(
        1.96 * regrets.std(ddof=1) / math.sqrt(64), rel=1e-9)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("key", ["smart", "kernel", "smart_kernel",
                                 "smart_kernel_tau", "quad", "stream"])
def test_local_results_equal_one_process(groups, single, world, key):
    np.testing.assert_array_equal(_concat(groups[0][world], key),
                                  single[key])


def test_sharded_functions_match_jax_on_mesh_4x2(groups):
    """The four-rank group's answers against the JAX functions on
    ``make_mesh(4, 2)`` for the same global batch."""
    ranks, inp = groups[0][4], groups[1]
    mesh = jax_make_mesh(4, 2)
    z, y = jnp.asarray(inp["z"]), jnp.asarray(inp["y"])
    want = float(jax_sweep.sharded_max_regret(mesh, z, y, 1.3))
    assert abs(float(ranks[0]["max"]) - want) <= X64_TOL
    want = float(jax_sweep.sharded_max_regret(mesh, jnp.asarray(inp["z_nan"]),
                                              y, 1.3))
    assert abs(float(ranks[0]["max_nan"]) - want) <= X64_TOL
    want = np.asarray(jax_sweep.sharded_regret_stats(mesh, z, y, 0, 1.3))
    np.testing.assert_allclose(ranks[0]["stats"], want, rtol=1e-12, atol=0)
    want = np.asarray(jax_sweep.sharded_smart_regrets(
        mesh, z, y, jnp.asarray(inp["thresh"]), ETA))
    np.testing.assert_allclose(_concat(ranks, "smart"), want, rtol=0,
                               atol=X64_TOL)
    want = np.asarray(jax_sweep.sharded_quadratic_regrets(
        mesh, jnp.asarray(inp["zq"]), jnp.asarray(inp["yq"])))
    np.testing.assert_allclose(_concat(ranks, "quad"), want, rtol=0,
                               atol=SINGULAR_TOL)


def test_sharded_kernels_match_jax_pallas_on_mesh_4x2(groups):
    """K1, K2 and K4 through the group against the JAX Pallas kernels under
    ``shard_map`` on ``make_mesh(4, 2)``, interpret mode, float32."""
    ranks, inp = groups[0][4], groups[1]
    B = 8192
    z = jnp.asarray(inp["zk_tm"].transpose(2, 0, 1))
    y = jnp.asarray(inp["yk_tm"].T)
    zp, yp, _ = jpg.pack_sequences(z, y)
    S = zp.shape[2]
    mesh = jax_make_mesh(4, 2)
    eta = jpg.pack_per_seq(jnp.asarray(inp["eta_k"]), S)
    got = jax_sweep.sharded_pallas_regrets(mesh, zp, yp, eta, interpret=True)
    np.testing.assert_allclose(_concat(ranks, "kernel"),
                               np.asarray(jpg.unpack_result(got, B)), rtol=0,
                               atol=F32_TOL)
    reg, tau = jax_sweep.sharded_smart_pallas(
        mesh, zp, yp, jpg.pack_per_seq(jnp.asarray(inp["th_k"]), S),
        jpg.pack_per_seq(jnp.asarray(inp["et_k"]), S), interpret=True)
    np.testing.assert_allclose(_concat(ranks, "smart_kernel"),
                               np.asarray(jpg.unpack_result(reg, B)), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_array_equal(_concat(ranks, "smart_kernel_tau"),
                                  np.asarray(jpg.unpack_result(tau, B)))
    carry = jpg.zero_stream_carry(B // 8, 5, 8)
    mesh8 = jax_make_mesh(8, 1)
    for c in range(0, 16, 8):
        zc, yc = jpg.pack_time_major(inp["zk_tm"][c:c + 8].transpose(0, 2, 1),
                                     inp["yk_tm"][c:c + 8])
        carry = jax_sweep.sharded_stream_step(mesh8, zc, yc, 1.2, c, carry,
                                              interpret=True)
    want = np.asarray(jpg.unpack_result(jpg.stream_result(carry)[0], B))
    np.testing.assert_allclose(_concat(ranks, "stream"), want, rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_synthetic_g_equals_jax_seed_layout(groups, world):
    """The hash stand-in through each group and through the JAX function
    on a mesh of the same shape: equal in every bit, so every rank drew
    the JAX seed blocks; on a 3-axis mesh as well."""
    n_data, n_hyper = MESHES[world]
    want = np.asarray(jax_sweep.sharded_synthetic_g(
        jax_make_mesh(n_data, n_hyper), T=32, eta_grid=ETAS,
        blocks_per_device=3, lane_batch=16, seed0=5, regret_fn=jax_hash))
    for o in groups[0][world]:
        np.testing.assert_array_equal(o["syn_g"], want)
        np.testing.assert_array_equal(o["syn_g3"], want)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_synthetic_g_mesh_invariant(groups, world):
    """(n_data, n_hyper) with b blocks equals (1, 1) with n_data * b blocks,
    with the stand-in and with K7's plain version, and the explicit max
    over the same seed blocks."""
    n_data, _ = MESHES[world]
    mesh = make_mesh(1, 1, device="cpu")
    one = sweep.sharded_synthetic_g(mesh, T=32, eta_grid=ETAS,
                                    blocks_per_device=3 * n_data,
                                    lane_batch=16, seed0=5,
                                    regret_fn=torch_hash)
    real = sweep.sharded_synthetic_g(mesh, T=16, eta_grid=ETAS[:2],
                                     blocks_per_device=n_data, lane_batch=2)
    want = [max(float(game.synthetic_regrets(b << 20, e, T=16, lane_batch=2,
                                             device="cpu").max())
                for b in range(n_data))
            for e in np.asarray(ETAS[:2], np.float32)]
    np.testing.assert_array_equal(real.numpy(), np.float32(want))
    for o in groups[0][world]:
        np.testing.assert_array_equal(o["syn_g"], one.numpy())
        np.testing.assert_array_equal(o["syn_g_real"], real.numpy())


@pytest.mark.parametrize("world", sorted(MESHES))
def test_resumable_sweeps_equal_single_shot(groups, world):
    """In each group: a sweep sliced with a ragged last slice, and a sweep
    the JAX package began and the port resumed from the JAX checkpoint,
    both equal the uninterrupted sweep in every bit; the resumed one
    evaluated only the blocks the JAX run had not."""
    n_data, n_hyper = MESHES[world]
    want = np.asarray(jax_sweep.sharded_synthetic_g(
        jax_make_mesh(n_data, n_hyper), T=32, eta_grid=ETAS,
        blocks_per_device=8, lane_batch=16, regret_fn=jax_hash))
    tmp = groups[2]
    for o in groups[0][world]:
        np.testing.assert_array_equal(o["res_ragged"], want)
        np.testing.assert_array_equal(o["res_from_jax"], want)
        assert int(o["res_from_jax_calls"]) == 4 * len(ETAS) // n_hyper
    final = load_pytree(str(tmp / f"resume_ragged_{world}.npz"))
    assert int(final["done"]) == 8
    np.testing.assert_array_equal(final["g"], want)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_group_errors(groups, world):
    """An eta grid the hyper axis does not divide, and a mesh larger than
    the world, raise on every rank; NaN travels through pmax as a flag."""
    n_hyper = MESHES[world][1]
    for o in groups[0][world]:
        assert bool(o["eta_div_error"]) == (n_hyper > 1)
        assert bool(o["too_big_error"])
        np.testing.assert_array_equal(np.isnan(o["pmax_nan"]), [True, False])
        assert o["pmax_nan"][1] == world - 1


_KILLED = r"""
import os, sys
import torch
from online_convex_optimization_tpu_torch.parallel import sweep as sw
from online_convex_optimization_tpu_torch.parallel.mesh import make_mesh
MASK = 0xFFFFFFFF
{torch_hash}
calls = {{"n": 0}}
orig = sw.sharded_synthetic_g
def counting(*a, **k):
    calls["n"] += 1
    if calls["n"] == 3:
        os._exit(17)    # preempted mid-flight: slice 3 is lost
    return orig(*a, **k)
sw.sharded_synthetic_g = counting
sw.resumable_synthetic_g(make_mesh(1, 1, device="cpu"), T=32,
                         eta_grid={etas}, blocks_per_device=8,
                         blocks_per_step=2, lane_batch=16,
                         checkpoint_path={ckpt!r}, regret_fn=torch_hash)
os._exit(1)
"""


def test_killed_sweep_resumes_bit_equal(tmp_path):
    """The preemption drill of tests/test_preemption.py on the port: a
    sweep killed at its third slice resumes from its checkpoint (two
    slices done) and ends equal to the uninterrupted sweep."""
    ckpt = str(tmp_path / "g.npz")
    script = _KILLED.format(torch_hash=inspect.getsource(torch_hash),
                            etas=ETAS, ckpt=ckpt)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 17, proc.stderr[-2000:]
    assert int(load_pytree(ckpt)["done"]) == 4
    mesh = make_mesh(1, 1, device="cpu")
    got = sweep.resumable_synthetic_g(mesh, T=32, eta_grid=ETAS,
                                      blocks_per_device=8, blocks_per_step=2,
                                      lane_batch=16, checkpoint_path=ckpt,
                                      regret_fn=torch_hash)
    want = sweep.sharded_synthetic_g(mesh, T=32, eta_grid=ETAS,
                                     blocks_per_device=8, lane_batch=16,
                                     regret_fn=torch_hash)
    np.testing.assert_array_equal(got, want.numpy())


def test_checkpoint_provenance_mismatch_recomputes(tmp_path):
    mesh = make_mesh(1, 1, device="cpu")
    ck = str(tmp_path / "g.npz")
    sweep.resumable_synthetic_g(mesh, T=16, eta_grid=ETAS,
                                blocks_per_device=4, blocks_per_step=2,
                                lane_batch=16, checkpoint_path=ck,
                                regret_fn=torch_hash)
    g = sweep.resumable_synthetic_g(mesh, T=32, eta_grid=ETAS,
                                    blocks_per_device=4, blocks_per_step=2,
                                    lane_batch=16, checkpoint_path=ck,
                                    regret_fn=torch_hash)
    want = sweep.sharded_synthetic_g(mesh, T=32, eta_grid=ETAS,
                                     blocks_per_device=4, lane_batch=16,
                                     regret_fn=torch_hash)
    np.testing.assert_array_equal(g, want.numpy())


def test_ragged_last_slice_single_process(tmp_path):
    mesh = make_mesh(1, 1, device="cpu")
    got = sweep.resumable_synthetic_g(
        mesh, T=32, eta_grid=ETAS, blocks_per_device=7, blocks_per_step=3,
        lane_batch=16, checkpoint_path=str(tmp_path / "g.npz"),
        regret_fn=torch_hash)
    want = jax_sweep.sharded_synthetic_g(
        jax_make_mesh(1, 1), T=32, eta_grid=ETAS, blocks_per_device=7,
        lane_batch=16, regret_fn=jax_hash)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_seed_block_limit_and_its_message():
    """4096 disjoint seed blocks at most; the message names the product it
    means (not the JAX text's "data_axis * blocks_per_device")."""
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError) as err:
        sweep.sharded_synthetic_g(mesh, T=16, eta_grid=[1.0],
                                  blocks_per_device=1,
                                  total_blocks_per_device=4097,
                                  lane_batch=16, regret_fn=torch_hash)
    msg = str(err.value)
    assert "n_data_total * total_blocks_per_device" in msg
    assert "4097" in msg and "4096" in msg and "seed blocks" in msg
    assert "data_axis * blocks_per_device" not in msg
    g = sweep.sharded_synthetic_g(mesh, T=16, eta_grid=[1.0],
                                  blocks_per_device=1,
                                  total_blocks_per_device=4096,
                                  lane_batch=16, regret_fn=torch_hash)
    assert g.shape == (1,)


def test_provenance_key_is_the_jax_key(tmp_path):
    """The port's checkpoint key for a config and mesh shape is the JAX
    package's, so ``synthetic_g_checkpoint_from_jax`` output resumes."""
    ck = str(tmp_path / "jax.npz")
    jax_sweep.resumable_synthetic_g(
        jax_make_mesh(1, 1), T=16, eta_grid=ETAS, blocks_per_device=2,
        blocks_per_step=1, lane_batch=16, checkpoint_path=ck, seed0=3,
        regret_fn=jax_hash)
    state = synthetic_g_checkpoint_from_jax(ck)
    key = sweep.synthetic_g_key(make_mesh(1, 1, device="cpu"), T=16,
                                eta_grid=ETAS, blocks_per_device=2,
                                lane_batch=16, seed0=3, alg_flag=0)
    assert int(state["key"]) == key and int(state["done"]) == 2
    assert state["g"].dtype == np.float32 and state["g"].shape == (4,)


def test_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match="needs 2 ranks, only 1"):
        make_mesh(2, 1, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "hyper": 1} and mesh.size == 1
