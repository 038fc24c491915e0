"""Device-mesh construction for multi-chip / multi-host runs.

Capability parity (SURVEY.md §3.3): the reference has no parallel runtime —
the distribution layer is pure new capability, expressed the JAX way:
``jax.sharding.Mesh`` + NamedSharding/shard_map, with XLA collectives (NCCL
on the GPU) and no hand-rolled transport. The cards of one host are joined
all to all (NVLink), so a mesh follows the algorithm, not a network
topology: one axis per kind of parallelism.

Axis conventions used across ndtpu.dist:

- ``"batch"`` — data parallelism over concurrent registrations (loop-closure
  candidates, multi-robot scans, odometry windows).
- ``"space"`` — spatial partitioning of the NDT grid into x-slabs and of
  pose/factor shards (the sequence-parallel analogue, SURVEY.md §6
  "Long-context").
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["P", "NamedSharding", "batch_mesh", "space_mesh", "grid_mesh",
           "multihost_mesh"]


def batch_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh over all (or the first n) local devices: axis ``"batch"``."""
    devs = list(devices or jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), axis_names=("batch",))


def space_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh with axis ``"space"`` for grid-slab / pose-shard layouts."""
    devs = list(devices or jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), axis_names=("space",))


def grid_mesh(n_batch: int, n_space: int, devices=None) -> Mesh:
    """2D ``("batch", "space")`` mesh: concurrent registrations x map slabs."""
    devs = np.asarray(list(devices or jax.devices())[: n_batch * n_space])
    return Mesh(devs.reshape(n_batch, n_space), axis_names=("batch", "space"))


def multihost_mesh(axis: str = "space") -> Mesh:
    """Mesh spanning all processes after ``jax.distributed.initialize()``.

    Uses the process-major device order so the mesh axis maps shard index ->
    host, putting the Schur all-reduce (SURVEY.md §3.3 'Distributed solve')
    on the inter-host network exactly once per solve. Single-process:
    identical to the local mesh.
    """
    return Mesh(np.asarray(jax.devices()), axis_names=(axis,))
