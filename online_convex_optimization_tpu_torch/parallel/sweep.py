"""Sharded scenario sweeps on ``torch.distributed``: the distributed
replacement for the reference's nested Python loops (driver.py:87-115) and
sequential g(T) estimation (algorithms.py:150-169).

Counterpart of ``online_convex_optimization_tpu/parallel/sweep.py``.  The
JAX functions are ``shard_map`` programs that take a global array; here
every rank of the mesh calls the function with its own shard
(``parallel/mesh.py::local_shard``), computes locally through the port's
kernels, and the cross-shard statistics are collectives over the mesh's
process groups:

  - g(T): the shard's max regret -> ``all_reduce(MAX)`` (the JAX
    ``lax.pmax``; algorithms.py:166-169), after ``finite_or_sentinel``
    turns a diverged scenario into -inf, so no NaN reaches the collective;
  - mean/CI: the shard's (n, sum, sum of squares) over its finite regrets
    -> ``all_reduce(SUM)`` (the JAX ``lax.psum``; driver.py:114-127's
    mean +- 1.96 SEM as sufficient statistics).

The functions that the JAX package leaves sharded (SMART, the kernels, the
quadratic track, a stream chunk) return this rank's part; they need no
collective and take the mesh only to keep the JAX signature.  The kernel
front ends take the port's time-major layout ``(T, d, B)`` / ``(T, B)`` in
place of the TPU's packed lanes; the TPU's ``B % (128 n)`` lane-tile rule
has no reason here, and ``local_shard`` only needs ``B % n == 0``.

``sharded_synthetic_g`` and ``resumable_synthetic_g`` keep the JAX
semantics: seed blocks ``seed0 + ((dev * total + offset + b) << 20)`` with
``dev`` flattened over every non-hyper axis, the eta grid sharded over
``hyper``, at most 4096 blocks, the injectable ``regret_fn``, the
provenance key of a checkpoint, and slices whose union is the
uninterrupted sweep, bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from online_convex_optimization_tpu_torch.models.linear import (
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.models.quadratic import (
    simulate_quadratic_batch,
)
from online_convex_optimization_tpu_torch.models.smart import (
    simulate_smart_batch,
)
from online_convex_optimization_tpu_torch.ops import game, smart
from online_convex_optimization_tpu_torch.parallel.mesh import (
    HYPER_AXIS,
    Mesh,
)
from online_convex_optimization_tpu_torch.utils import checkpointing
from online_convex_optimization_tpu_torch.utils.debug import finite_or_sentinel
from online_convex_optimization_tpu_torch.utils.logging_utils import get_logger

# Seed blocks are 2^20 apart and the JAX seed space is int32, so there are
# 4096 disjoint blocks; the port keeps the limit (its seeds are 64-bit
# Philox keys, but a sweep's seeds must stay those of the JAX sweep).
SEED_BLOCK_SHIFT = 20
MAX_SEED_BLOCKS = 1 << 12


def sharded_max_regret(mesh: Mesh, z, y, eta0, *, alg_flag: int = 0,
                       length=None) -> torch.Tensor:
    """Max regret over the mesh's scenario batch, this rank holding the
    shard ``z`` ``(B_loc, T, d)``, ``y``, ``length``: the g(T) reduction.
    A non-finite regret counts as -inf.  Returns a 0-d tensor, the same on
    every rank."""
    res = simulate_linear_batch(z, y, alg_flag, eta0, length)
    local = finite_or_sentinel(res.regret, float("-inf")).max().reshape(1)
    return mesh.all_reduce(local, dist.ReduceOp.MAX)[0]


def sharded_regret_stats(mesh: Mesh, z, y, alg_flag, eta0) -> torch.Tensor:
    """Global ``(n, sum, sum_sq)`` of the finite regrets of the mesh's
    scenario batch (this rank's shard ``z``, ``y``), in z's dtype, the same
    on every rank; ``mean_and_ci`` turns it into mean and CI without
    gathering per-scenario results."""
    r = simulate_linear_batch(z, y, alg_flag, eta0).regret
    finite = torch.isfinite(r)
    r = torch.where(finite, r, 0.0)
    stats = torch.stack([finite.sum().to(r.dtype), r.sum(), (r * r).sum()])
    return mesh.all_reduce(stats, dist.ReduceOp.SUM)


def sharded_smart_regrets(mesh: Mesh, z, y, theta_thresh, eta0):
    """SMART regrets of this rank's shard, ``(B_loc,)`` (kernel K2 on the
    card).  ``theta_thresh`` and ``eta0`` are scalars or this shard's part
    of a per-sequence grid, so a hyperparameter sweep rides the batch.  The
    JAX function's ``block_size`` tiles its scan and has no counterpart."""
    return simulate_smart_batch(z, y, theta_thresh, eta0).regret


def sharded_kernel_regrets(mesh: Mesh, z_tm, y_tm, eta, *,
                           alg_flag: int = 0):
    """Regrets of this rank's time-major shard ``(T, d, B_loc)`` /
    ``(T, B_loc)`` through kernel K1 (the JAX ``sharded_pallas_regrets``),
    ``(B_loc,)``.  ``eta`` is a scalar or this shard's ``(B_loc,)``."""
    cum, comp, _ = game.regrets_fused(z_tm.permute(2, 0, 1), y_tm.t(),
                                      alg_flag, eta)
    return cum - comp


def sharded_smart_kernel(mesh: Mesh, z_tm, y_tm, thresh, eta):
    """SMART on this rank's time-major shard through kernel K2 (the JAX
    ``sharded_smart_pallas``): ``(regret, switch_t)``, each ``(B_loc,)``,
    with per-sequence (or scalar) ``thresh`` and ``eta``."""
    cum, comp, _, tau = smart.smart_regrets(z_tm.permute(2, 0, 1), y_tm.t(),
                                            thresh, eta)
    return cum - comp, tau


def sharded_quadratic_regrets(mesh: Mesh, z, y, *, alg_flag: int = 1,
                              eta0: float = 1.0):
    """Quadratic-track regrets of this rank's shard (kernel K8 on the
    card), ``(B_loc,)``; the game needs no collective."""
    return simulate_quadratic_batch(z, y, alg_flag, eta0).regret


def sharded_stream_step(mesh: Mesh, z_tm, y_tm, eta, t0: int, carry, *,
                        alg_flag: int = 0):
    """One streaming advance of this rank's lanes (kernel K4 on the card):
    the chunk ``(CT, d, B_loc)`` / ``(CT, B_loc)`` and the O(B d) carry both
    stay on the rank, so arbitrary horizons run data-parallel with no
    collective.  Finish with ``ops.game.stream_result``."""
    return game.play_stream(z_tm, y_tm, eta, t0, carry, alg_flag=alg_flag)


def pmax(mesh: Mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.pmax`` over ``axes``: NaN if any rank holds a NaN, else the
    max; the NaNs travel as a flag, so none reaches the collective."""
    nan = torch.isnan(x)
    both = torch.stack([torch.where(nan, float("-inf"), x),
                        nan.to(x.dtype)])
    mesh.all_reduce(both, dist.ReduceOp.MAX, axes)
    return torch.where(both[1] > 0, float("nan"), both[0])


def sharded_synthetic_g(mesh: Mesh, *, T: int, eta_grid,
                        blocks_per_device: int, lane_batch: int = 8192,
                        seed0: int = 0, alg_flag: int = 0, regret_fn=None,
                        block_offset: int = 0,
                        total_blocks_per_device: int = 0) -> torch.Tensor:
    """Pod-scale empirical-g sweep (BASELINE config 5): millions of
    sequences x a step-size grid, the data generated inside kernel K7.

    The ``hyper`` axis shards the eta grid (its length divisible by the
    axis size); every non-hyper coordinate (data, and host on 3-axis
    meshes) owns disjoint seed blocks, evaluates its etas on its own
    sequences, and the per-eta worst case is the max over the non-hyper
    ranks.  Seeds depend only on that coordinate, so every eta is scored on
    the same population whatever the mesh: ``g(mesh=(D, H), blocks=b)``
    equals ``g(mesh=(1, 1), blocks=D * b)`` exactly.  Total sequences per
    eta = (non-hyper ranks) * blocks_per_device * 8 * lane_batch.

    ``regret_fn(seed, eta, *, T, lane_batch, alg_flag, device)`` defaults
    to ``ops.game.synthetic_regrets`` and returns ``(8, lane_batch)``
    regrets; a test injects a stand-in.  ``block_offset`` /
    ``total_blocks_per_device`` evaluate blocks ``[block_offset,
    block_offset + blocks_per_device)`` of a sweep of
    ``total_blocks_per_device`` (0 = this call is the whole sweep): seed
    ids are ``dev * total + offset + b``, so the slices' union is the
    uninterrupted sweep, block by block.

    Returns the ``(len(eta_grid),)`` float32 worst-case regrets on
    ``mesh.device``, the same on every rank.
    """
    if regret_fn is None:
        regret_fn = game.synthetic_regrets
    total_bpd = total_blocks_per_device or blocks_per_device
    if block_offset + blocks_per_device > total_bpd:
        raise ValueError((block_offset, blocks_per_device, total_bpd))
    etas = np.asarray(eta_grid, np.float32).reshape(-1)
    n_hyper = mesh.shape[HYPER_AXIS]
    if etas.shape[0] % n_hyper:
        raise ValueError(f"len(eta_grid)={etas.shape[0]} not divisible by "
                         f"hyper axis size {n_hyper}")
    n_data_total = mesh.size // n_hyper
    total_blocks = n_data_total * total_bpd
    if total_blocks > MAX_SEED_BLOCKS:
        raise ValueError(
            f"n_data_total * total_blocks_per_device = {n_data_total} * "
            f"{total_bpd} = {total_blocks} exceeds the {MAX_SEED_BLOCKS} "
            f"disjoint seed blocks available in int32 seed space; raise "
            f"lane_batch instead of the block count")
    dev = mesh.data_index
    per = etas.shape[0] // n_hyper
    h = mesh.coords[HYPER_AXIS]
    g_loc = []
    for eta in etas[h * per:(h + 1) * per]:
        acc = torch.full((), float("-inf"), dtype=torch.float32,
                         device=mesh.device)
        for b in range(blocks_per_device):
            seed = seed0 + ((dev * total_bpd + block_offset + b)
                            << SEED_BLOCK_SHIFT)
            r = regret_fn(seed, float(eta), T=T, lane_batch=lane_batch,
                          alg_flag=alg_flag, device=mesh.device)
            acc = torch.maximum(acc, r.max())
        g_loc.append(acc)
    non_hyper = tuple(a for a in mesh.axis_names if a != HYPER_AXIS)
    g_loc = pmax(mesh, torch.stack(g_loc), non_hyper)
    return mesh.all_gather(g_loc, HYPER_AXIS)


def synthetic_g_key(mesh: Mesh, *, T: int, eta_grid, blocks_per_device: int,
                    lane_batch: int, seed0: int, alg_flag: int) -> int:
    """Provenance key of a resumable sweep's checkpoint: the first 8 bytes
    of the SHA-256 of its config and mesh shape as JSON, as an int64.  The
    same string as the JAX package's, so a JAX checkpoint of the same sweep
    on a mesh of the same shape carries the same key."""
    key_str = json.dumps({
        "T": int(T),
        "etas": [float(v) for v in np.asarray(eta_grid, np.float32)],
        "blocks_per_device": int(blocks_per_device),
        "lane_batch": int(lane_batch), "seed0": int(seed0),
        "alg_flag": int(alg_flag),
        "mesh": {str(k): int(v) for k, v in mesh.shape.items()},
    }, sort_keys=True)
    return int(np.frombuffer(hashlib.sha256(key_str.encode()).digest()[:8],
                             np.int64)[0])


def resumable_synthetic_g(mesh: Mesh, *, T: int, eta_grid,
                          blocks_per_device: int, blocks_per_step: int,
                          checkpoint_path: Optional[str] = None,
                          lane_batch: int = 8192, seed0: int = 0,
                          alg_flag: int = 0, regret_fn=None) -> np.ndarray:
    """Preemption-safe g sweep: ``sharded_synthetic_g`` in slices of
    ``blocks_per_step`` seed blocks per non-hyper rank.

    After each slice the running per-eta max ``g``, the blocks done and
    the provenance key (``synthetic_g_key``) are saved atomically to
    ``checkpoint_path`` (a ``.npz``, ``utils/checkpointing.py``) by rank 0,
    after a barrier.  A restarted sweep with the same arguments reads it on
    every rank and resumes after the last completed slice; a checkpoint
    with another key (another config or mesh shape) is discarded with a
    warning.  The slices use the uninterrupted sweep's seed blocks and max
    is exact, so the result is bit-equal to one ``sharded_synthetic_g``
    call.  Returns the ``(len(eta_grid),)`` float32 maxima.
    """
    etas = np.asarray(eta_grid, np.float32)
    key = synthetic_g_key(mesh, T=T, eta_grid=etas,
                          blocks_per_device=blocks_per_device,
                          lane_batch=lane_batch, seed0=seed0,
                          alg_flag=alg_flag)
    g = np.full(etas.shape, -np.inf, np.float32)
    done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        st = checkpointing.load_pytree(checkpoint_path)
        if int(st["key"]) == key:
            g, done = np.asarray(st["g"], np.float32), int(st["done"])
        else:
            get_logger().warning(
                "resumable_synthetic_g: checkpoint %s was produced under a "
                "different config (key mismatch); recomputing from scratch",
                checkpoint_path)
    while done < blocks_per_device:
        step = min(blocks_per_step, blocks_per_device - done)
        g_slice = sharded_synthetic_g(
            mesh, T=T, eta_grid=etas, blocks_per_device=step,
            total_blocks_per_device=blocks_per_device, block_offset=done,
            lane_batch=lane_batch, seed0=seed0, alg_flag=alg_flag,
            regret_fn=regret_fn)
        g = np.maximum(g, g_slice.cpu().numpy())
        done += step
        if checkpoint_path:
            mesh.barrier()
            if mesh.rank == 0:
                checkpointing.save_pytree(checkpoint_path, {
                    "g": g, "done": np.asarray(done),
                    "key": np.asarray(key, np.int64)})
    return g


def mean_and_ci(stats: torch.Tensor, z_value: float = 1.96):
    """mean +- z * SEM from ``(n, sum, sum_sq)`` (driver.py:59-63's ddof=1
    SEM); the CI is 0 for n <= 1."""
    n, s, ss = stats[0], stats[1], stats[2]
    mean = s / n
    var = (torch.clamp(ss - n * mean * mean, min=0.0)
           / torch.clamp(n - 1.0, min=1.0))
    sem = torch.sqrt(var / n)
    return mean, torch.where(n > 1.0, z_value * sem, 0.0)
