"""Rank meshes and process-group start-up on ``torch.distributed``.

Counterpart of ``online_convex_optimization_tpu/parallel/mesh.py``.  The
JAX package has one controller over many devices: a ``jax.sharding.Mesh``
of devices, ``shard_map`` programs over it and XLA collectives.  PyTorch's
idiom is one process per device: every rank of the default process group
runs the same program on its own device and its own shard of the work, and
the cross-shard reductions are ``torch.distributed`` collectives (NCCL on
CUDA devices, gloo on the CPU).  So a mesh here is a layout of RANKS on
named axes:

  - ``data``  shards the scenario batch (sequences, seed blocks);
  - ``hyper`` shards a hyperparameter grid (eta0 / theta_thresh sweeps);
  - ``host``  (3-axis meshes) names the process boundary of a pod.

``make_mesh`` and ``make_mesh3`` lay the ranks out as the JAX functions lay
out ``jax.devices()``.  A mesh may use fewer ranks than the world; it never
uses more (``ValueError``).  Each reduction reduces over some of the axes,
so the mesh holds one ``dist.new_group`` per set of ranks that differ only
along those axes, for three sets of axes: all of them (``sharded_max_regret``,
``sharded_regret_stats``), every axis but ``hyper`` (the per-eta maxima of
``sharded_synthetic_g``), and ``hyper`` (gathering the per-eta results).
Every rank of the world creates every group, in the same order, as
``dist.new_group`` requires.

Without a process group (a single process) the mesh has one rank and does
no collective: a mesh of size 1 has nothing to reduce.  A process group of
size 1 (``initialize_distributed`` with one process) does run the
collectives, on a group of one.

The JAX ``scenario_sharding`` and ``replicated`` describe where XLA places
a global array; with one process per rank each rank holds only its own
part, so they become ``local_shard``: this rank's slice of a global batch.
A replicated value is simply the same value on every rank.
"""

from __future__ import annotations

import datetime
import itertools
import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from online_convex_optimization_tpu_torch.utils.devices import resolve_device

DATA_AXIS = "data"
HYPER_AXIS = "hyper"
HOST_AXIS = "host"      # 3-axis meshes: (host, data, hyper)

# A peer that never arrives makes start-up and collectives fail after this
# long instead of hanging.
TIMEOUT = datetime.timedelta(seconds=300)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a coordinator
    address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> torch.device:
    """Join the default process group; return this rank's device.

    ``coordinator`` is ``host:port`` of rank 0 (any free port); without it
    the process runs alone with no process group.  The backend is NCCL for
    a CUDA device (each rank on card ``process_id % device_count``) and gloo
    for ``device="cpu"``.  A failure to start the group raises.
    """
    device = resolve_device(device)
    if coordinator is None:
        if (num_processes or 1) > 1:
            raise ValueError(f"num_processes={num_processes} needs a "
                             f"coordinator address (host:port)")
        return device
    world, rank = num_processes or 1, process_id or 0
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return device


def world() -> Tuple[int, int]:
    """``(world size, rank)`` of the default process group, ``(1, 0)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Ranks laid out on named axes, this rank's place in them, and the
    process groups of the reductions.

    ``ranks`` is an integer array, one axis per name, holding the global
    rank at each coordinate (the counterpart of the JAX ``Mesh``'s device
    array).  ``shape`` maps each axis name to its size, in order;
    ``coords`` maps each to this rank's coordinate (None for a rank outside
    the mesh); ``device`` is where this rank computes.
    """

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device="cuda"):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d rank array for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.device = resolve_device(device)
        self.world_size, self.rank = world()
        dims = "x".join(str(s) for s in ranks.shape)
        if self.size > self.world_size:
            raise ValueError(f"mesh {dims} needs {self.size} ranks, only "
                             f"{self.world_size} available")
        if sorted(ranks.reshape(-1).tolist()) != list(range(self.size)):
            raise ValueError(f"mesh {dims} must hold ranks 0..{self.size - 1}"
                             f" once each")
        where = np.argwhere(ranks == self.rank)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(self.axis_names, (int(c) for c in where[0])))
            if len(where) else None)
        self._groups = {}
        if dist.is_available() and dist.is_initialized():
            non_hyper = tuple(a for a in self.axis_names if a != HYPER_AXIS)
            for axes in (self.axis_names, non_hyper, (HYPER_AXIS,)):
                self._groups[axes] = self._build_groups(axes)

    def _build_groups(self, axes):
        """One process group per set of ranks that differ only along
        ``axes``; returns this rank's group (None for a rank outside the
        mesh)."""
        along = [i for i, a in enumerate(self.axis_names) if a in axes]
        other = [i for i in range(len(self.axis_names)) if i not in along]
        mine = None
        for fixed in itertools.product(*(range(self.ranks.shape[i])
                                         for i in other)):
            index = [slice(None)] * self.ranks.ndim
            for i, c in zip(other, fixed):
                index[i] = c
            members = sorted(self.ranks[tuple(index)].reshape(-1).tolist())
            group = (dist.group.WORLD if len(members) == self.world_size
                     else dist.new_group(members, timeout=TIMEOUT))
            if self.rank in members:
                mine = group
        return mine

    def _member(self) -> Dict[str, int]:
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh "
                             f"{self.shape}")
        return self.coords

    @property
    def shard_index(self) -> int:
        """This rank's shard of a batch split over every axis: the
        row-major index of its coordinates (JAX ``P(mesh.axis_names)``)."""
        coords = self._member()
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names),
            tuple(self.shape.values())))

    @property
    def data_index(self) -> int:
        """This rank's index over the flattened non-hyper axes (host, data),
        row-major: the owner of disjoint seed blocks."""
        coords = self._member()
        idx = 0
        for a in self.axis_names:
            if a != HYPER_AXIS:
                idx = idx * self.shape[a] + coords[a]
        return idx

    def all_reduce(self, t: torch.Tensor, op, axes=None) -> torch.Tensor:
        """Reduce ``t`` in place over the ranks that differ from this one
        along ``axes`` (default: every axis); returns ``t``.  No-op without
        a process group."""
        self._member()
        axes = self.axis_names if axes is None else tuple(axes)
        if self._groups:
            dist.all_reduce(t, op=op, group=self._groups[axes])
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Concatenate ``t`` from the ranks that differ from this one only
        along ``axis``, in the order of their coordinate on it."""
        self._member()
        if not self._groups:
            return t
        group = self._groups[(axis,)]
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        k = self.axis_names.index(axis)
        members = dist.get_process_group_ranks(group)
        place = {r: int(np.argwhere(self.ranks == r)[0][k]) for r in members}
        order = sorted(range(len(parts)), key=lambda i: place[members[i]])
        return torch.cat([parts[i] for i in order])

    def barrier(self) -> None:
        """Wait for every rank of the mesh (no-op without a process
        group)."""
        self._member()
        if self._groups:
            dist.barrier(group=self._groups[self.axis_names])


def make_mesh(n_data: Optional[int] = None, n_hyper: int = 1, *,
              device="cuda") -> Mesh:
    """A ``(data, hyper)`` mesh over the first ``n_data * n_hyper`` ranks,
    laid out as the JAX ``make_mesh`` lays out devices (data varying
    fastest).  ``n_data`` defaults to the world size over ``n_hyper``."""
    size, _ = world()
    if n_data is None:
        n_data = size // n_hyper
    ranks = np.arange(n_data * n_hyper).reshape(n_hyper, n_data).T
    return Mesh(ranks, (DATA_AXIS, HYPER_AXIS), device)


def make_mesh3(n_host: int, n_data: int, n_hyper: int = 1, *,
               device="cuda") -> Mesh:
    """A 3-axis ``(host, data, hyper)`` mesh, ranks in row-major order as
    the JAX ``make_mesh3`` lays out devices."""
    ranks = np.arange(n_host * n_data * n_hyper).reshape(n_host, n_data,
                                                         n_hyper)
    return Mesh(ranks, (HOST_AXIS, DATA_AXIS, HYPER_AXIS), device)


def local_shard(mesh: Mesh, x, axis: int = 0):
    """This rank's part of a global batch split evenly over the whole mesh
    along ``axis`` (the JAX ``scenario_sharding``): part ``shard_index`` of
    ``mesh.size``.  The batch must divide evenly."""
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"batch of {n} does not split over {mesh.size} "
                         f"ranks")
    per = n // mesh.size
    start = mesh.shard_index * per
    return x[(slice(None),) * axis + (slice(start, start + per),)]
