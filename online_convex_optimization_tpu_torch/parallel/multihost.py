"""Multi-process sweep worker: the pod-scale entry point.

Counterpart of ``online_convex_optimization_tpu/parallel/multihost.py``.
Every process is one rank on one device (PyTorch's one-process-per-device
idiom): on a machine with cards each runs on its own card over NCCL, and
without cards the same code runs as N CPU processes over gloo, which is how
the tests exercise true cross-process collectives:

    python -m online_convex_optimization_tpu_torch.parallel.multihost \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 \\
        --device cpu        # and --process-id 1 in a second process

Worker protocol: each rank generates ITS OWN scenario shard on its device
(``data/device.py::shard_generators(seed, n_global)[rank]``), runs the
batched FTRL game locally (kernel K1 on a card), and only the g(T) max and
the (n, sum, sum_sq) regret statistics cross ranks, O(1) bytes per sweep.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from online_convex_optimization_tpu_torch.data.device import (
    random_game_batch,
    shard_generators,
)
from online_convex_optimization_tpu_torch.models.linear import (
    simulate_linear_batch,
)
from online_convex_optimization_tpu_torch.models.streaming import (
    StreamingGame,
)
from online_convex_optimization_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    HOST_AXIS,
    HYPER_AXIS,
    Mesh,
    initialize_distributed,
    world,
)
from online_convex_optimization_tpu_torch.parallel.sweep import pmax
from online_convex_optimization_tpu_torch.utils.profiling import measure


def _worker_mesh(n_global: int, n_hyper: int, host_axis: bool,
                 device) -> Mesh:
    """The sweep's mesh over every rank, in the flat rank order of the JAX
    worker's ``jax.devices()``: ``(data, hyper)``, or with ``host_axis``
    ``(host, data, hyper)`` with one host per process."""
    if n_global % n_hyper:
        raise ValueError(f"n_hyper={n_hyper} must divide {n_global}")
    n_data = n_global // n_hyper
    ranks = np.arange(n_global)
    if not host_axis:
        return Mesh(ranks.reshape(n_data, n_hyper), (DATA_AXIS, HYPER_AXIS),
                    device)
    n_host = n_global
    if n_data % n_host:
        raise ValueError(f"host axis {n_host} must divide data axis "
                         f"{n_data}")
    return Mesh(ranks.reshape(n_host, n_data // n_host, n_hyper),
                (HOST_AXIS, DATA_AXIS, HYPER_AXIS), device)


def run_worker(T: int, per_device_batch: int, *, eta0: float,
               seed: int = 0, coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               n_hyper: int = 1, bench_reps: int = 0,
               host_axis: bool = False, device="cuda") -> dict:
    """Run this rank's share of a global FTRL regret sweep; returns the
    globally reduced statistics (the same on every rank).

    With ``coordinator`` the rank first joins a process group of
    ``num_processes``; without it the sweep runs over the process group
    already started, or alone.  ``n_hyper > 1`` makes the sweep a
    ``(data, hyper)`` program: each hyper column evaluates its own eta
    (``eta0`` times ``linspace(1, 2, n_hyper)``), the statistics reduce
    over the data ranks of each column and the per-eta results are gathered
    over the columns.  ``host_axis=True`` makes the process boundary a
    leading ``host`` axis, one host per process, and the reductions run over
    (host, data).  Rank r's shard is ``shard_generators(seed, n_global)[r]``
    in both layouts, so the layout changes the collectives, not the data.
    ``bench_reps > 0`` times the whole sweep (generation included) that
    many times after a warm-up.
    """
    started = coordinator is not None
    device = initialize_distributed(coordinator, num_processes, process_id,
                                    device)
    try:
        n_global, rank = world()
        mesh = _worker_mesh(n_global, n_hyper, host_axis, device)
        eta_grid = eta0 * np.linspace(1.0, 2.0, n_hyper, dtype=np.float32)
        eta = float(eta_grid[mesh.coords[HYPER_AXIS]])
        non_hyper = tuple(a for a in mesh.axis_names if a != HYPER_AXIS)

        def sweep():
            gen = shard_generators(seed, n_global, device=device)[rank]
            z, y = random_game_batch(gen, per_device_batch, T)
            r = simulate_linear_batch(z, y, 0, eta).regret
            g_max = pmax(mesh, r.max().reshape(1), non_hyper)
            r = r.double()
            stats = torch.stack([r.new_tensor(float(r.numel())), r.sum(),
                                 (r * r).sum()])
            mesh.all_reduce(stats, dist.ReduceOp.SUM, non_hyper)
            return (mesh.all_gather(g_max, HYPER_AXIS).cpu().numpy(),
                    mesh.all_gather(stats, HYPER_AXIS).cpu().numpy()
                    .reshape(n_hyper, 3))

        g_max, stats = sweep()
        n = stats[:, 0]
        mean = stats[:, 1] / n
        var = np.maximum(stats[:, 2] - n * mean * mean, 0.0) / np.maximum(
            n - 1.0, 1.0)
        out = {
            "process_id": rank,
            "device": str(device),
            "n_global_devices": n_global,
            "n_local_devices": 1,
            "mesh": list(mesh.shape.values()),
            "axes": list(mesh.axis_names),
            "total_scenarios": int(n.sum()),
            "g_max_by_eta": [float(v) for v in g_max],
            "mean_by_eta": [float(v) for v in mean],
            "eta_grid": [float(v) for v in eta_grid],
            # Single-axis fields (global over everything).
            "g_max": float(g_max.max()),
            "mean_regret": float(stats[:, 1].sum() / n.sum()),
            "sem": float(np.sqrt(var.mean() / n.sum())),
        }
        if bench_reps > 0:
            timing = measure(sweep, warmup=1, runs=bench_reps, device=device)
            steps = n_global * per_device_batch * T
            out["bench_steps_per_s"] = timing.steps_per_s(steps)
            out["bench_steps_per_s_per_device"] = (timing.steps_per_s(steps)
                                                   / n_global)
        return out
    finally:
        if started:
            dist.destroy_process_group()


def _broadcast_game(game: StreamingGame, src: int) -> None:
    """Overwrite every rank's carry and round counter with rank ``src``'s."""
    for t in game.carry:
        dist.broadcast(t, src=src)
    t = torch.tensor([game.t], dtype=torch.int64, device=game.device)
    dist.broadcast(t, src=src)
    game.t = int(t[0])


def run_stream_handoff(T: int, B: int, *, chunks: int = 8, split: int = 4,
                       eta0: float, seed: int = 0,
                       coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       device="cuda") -> dict:
    """Sequence-parallel hand-off: rank 0 advances the streaming carry
    through chunks [0, split), ships it with ``dist.broadcast``, and rank 1
    finishes chunks [split, chunks): the time axis of ONE stream split
    across processes.  The carry is O(B d) bytes whatever T.

    Every rank also plays the whole stream alone as the reference; the
    hand-off must match it BITWISE (the broadcast moves the carry's bits,
    and the chunks are played by the same kernel in the same order)."""
    started = coordinator is not None
    device = initialize_distributed(coordinator, num_processes, process_id,
                                    device)
    try:
        n, pid = world()
        # In a process group (of one rank too) the carry crosses by
        # broadcast; rank 1 finishes when there is one.
        shipped = dist.is_available() and dist.is_initialized()
        d = 5
        if T % chunks:
            raise ValueError("T must divide into chunks")
        CT = T // chunks
        # A deterministic stream every rank regenerates (contract data).
        rng = np.random.default_rng(seed)
        zs = rng.standard_normal((chunks, CT, B, d)).astype(np.float32)
        zs /= np.maximum(np.linalg.norm(zs, axis=-1, keepdims=True), 1.0)
        ys = np.sign(rng.standard_normal((chunks, CT, B))).astype(np.float32)
        ys[ys == 0] = 1.0

        def replay():
            return ((zs[c], ys[c]) for c in range(chunks))

        ref = StreamingGame(B, d, alg_flag=0, eta0=eta0, device=device)
        for c in range(chunks):
            ref.feed(zs[c], ys[c])
        ref_res = ref.result(replay())

        game = StreamingGame(B, d, alg_flag=0, eta0=eta0, device=device)
        if pid == 0:
            for c in range(split):
                game.feed(zs[c], ys[c])
        if shipped:
            _broadcast_game(game, 0)
        finisher = 1 if n > 1 else 0
        if pid == finisher:
            for c in range(split, chunks):
                game.feed(zs[c], ys[c])
        if shipped:
            _broadcast_game(game, finisher)
        res = game.result(replay())
        cum, reg = res.cum_loss.cpu().numpy(), res.regret.cpu().numpy()
        return {
            "process_id": pid,
            "mode": "stream-handoff",
            "chunks": chunks,
            "split": split,
            "cum_loss": [float(v) for v in cum],
            "regret": [float(v) for v in reg],
            "bitwise_cum": bool((cum == ref_res.cum_loss.cpu().numpy())
                                .all()),
            "bitwise_regret": bool((reg == ref_res.regret.cpu().numpy())
                                   .all()),
        }
    finally:
        if started:
            dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-process OCO sweep worker")
    p.add_argument("--t", type=int, default=256)
    p.add_argument("--per-device-batch", type=int, default=1024)
    p.add_argument("--eta0", type=float, default=float(np.sqrt(2.0)))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (omit to run alone)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--hyper", type=int, default=1,
                   help="size of the hyperparameter mesh axis")
    p.add_argument("--bench-reps", type=int, default=0,
                   help="time the sweep this many times (0 = off)")
    p.add_argument("--host-axis", action="store_true",
                   help="3-axis (host, data, hyper) mesh with the "
                        "process boundary as the leading axis")
    p.add_argument("--mode", choices=["sweep", "stream-handoff"],
                   default="sweep")
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--split", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one card per process) or cpu (gloo)")
    args = p.parse_args(argv)
    if args.mode == "stream-handoff":
        out = run_stream_handoff(args.t, args.per_device_batch,
                                 chunks=args.chunks, split=args.split,
                                 eta0=args.eta0, seed=args.seed,
                                 coordinator=args.coordinator,
                                 num_processes=args.num_processes,
                                 process_id=args.process_id,
                                 device=args.device)
    else:
        out = run_worker(args.t, args.per_device_batch, eta0=args.eta0,
                         seed=args.seed, coordinator=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, n_hyper=args.hyper,
                         bench_reps=args.bench_reps,
                         host_axis=args.host_axis, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
