"""Device-mesh helpers for ray/point data parallelism."""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "default_mesh",
    "sharded_rays",
    "replicated",
    "initialize_distributed",
    "RAY_AXIS",
]

RAY_AXIS = "rays"


def initialize_distributed(**kwargs) -> None:
    """Multi-process bring-up: jax.distributed.initialize(**kwargs), once
    per process before building meshes, for one global mesh over every
    process's GPUs (collectives go to NCCL: NVLink within a host, the
    network across hosts). Pass ``coordinator_address``,
    ``num_processes`` and ``process_id`` where no cluster manager
    provides them. Without a coordinator (one process) it is a no-op."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # already initialized, or single-process without coordinator config
        pass


def default_mesh(devices=None) -> Mesh:
    """1D mesh over all (or the given) devices with axis "rays".

    Queries/rays are embarrassingly data parallel (no communication in the
    forward pass), so a flat 1D mesh is the right default topology;
    multi-host setups reuse it unchanged after jax.distributed.initialize.
    """
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def sharded_rays(mesh: Mesh) -> NamedSharding:
    """Sharding for a (N, ...) point/ray batch: leading dim over chips."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding for SDF structure arrays: replicated on every chip."""
    return NamedSharding(mesh, P())


def pad_to_shards(n: int, mesh: Mesh) -> int:
    """Smallest multiple of the mesh size >= n."""
    k = mesh.devices.size
    return -(-n // k) * k
