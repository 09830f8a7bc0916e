"""Multi-chip execution: shard query points / rays over a device mesh.

The reference parallelizes with OpenMP threads inside one host
(reference: src/sdf/OctreeSdfDepthFirst.h:417-527, OpenMP task-per-subtree)
and has no distributed backend (SURVEY.md S2.4). The scaling model here
(SURVEY.md S5.7-5.8) is: query points / rays are pure data parallel over
devices, SDF structures (flat arrays) are replicated when they fit, and
coefficient gradients all-reduce — all expressed with jax.sharding + jit,
letting XLA insert the collectives (NCCL on GPUs).
"""
from .mesh import (
    default_mesh,
    initialize_distributed,
    replicated,
    sharded_rays,
)
from .query import sharded_distance, sharded_distance_and_gradient
from .render import sharded_trace
from .fit import data_parallel_fit_step

__all__ = [
    "default_mesh",
    "initialize_distributed",
    "replicated",
    "sharded_rays",
    "sharded_distance",
    "sharded_distance_and_gradient",
    "sharded_trace",
    "data_parallel_fit_step",
]
