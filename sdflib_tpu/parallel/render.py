"""Sharded sphere tracing: rays data-parallel over the mesh.

The reference dispatches one GL compute workgroup per 16x16 pixel tile on
a single GPU (reference: src/render_engine/RenderSdf.cpp:187); here the
ray batch is sharded over devices and each device marches its rays against
a replicated octree — no inter-chip traffic until the image is gathered.

Implementation: jax.shard_map over the host-sync-free fused trace
(`_trace_rays_fused`), so every compaction sort, prefix slice, and scatter
in the march scheduler is LOCAL to its shard. The previous version ran
`trace_octree` (whose scheduler syncs an active count to the host between
rounds) on globally-sharded arrays; under GSPMD its full-array sorts and
prefix slices became cross-device resharding collectives and total
throughput collapsed from 1 to 8 virtual devices while pure shard_map
queries stayed flat.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..render.sphere_trace import (
    _TRACE_BLOCK,
    TraceResult,
    _trace_rays_fused,
)
from ..sdf.octree import OctreeSdf
from .mesh import RAY_AXIS, default_mesh, replicated, sharded_rays
from .query import _device_put_structure

__all__ = ["sharded_trace"]


@lru_cache(maxsize=32)
def _sharded_trace_program(mesh, **statics):
    """The jitted shard_map of the fused trace, one per mesh and static
    configuration: built afresh, it would be traced and compiled again on
    every call."""
    shd = P(RAY_AXIS)
    return jax.jit(jax.shard_map(
        partial(_trace_rays_fused, **statics),
        mesh=mesh,
        in_specs=(P(), P(), P(), shd, shd, shd) + (P(),) * 6,
        out_specs=(shd, shd, shd, shd, shd),
    ))


def sharded_trace(
    octree,
    origins,
    dirs,
    mesh=None,
    *,
    eps: float = 1e-5,
    far: float = 4.0,
    max_iters: int = 1024,
    beam: int | None = None,
) -> TraceResult:
    """trace_octree with rays sharded over the mesh's chips; each shard
    runs the whole march schedule locally (zero forward communication —
    rays are pure data parallelism, SURVEY.md S5.7).

    The beam prepass defaults OFF here: its per-tile reductions
    (segment_sum/max over rays) group CONSECUTIVE rays of the local shard,
    so tile membership — and therefore start depths — differs from the
    single-chip 2D tiling, breaking the bit-equality this module otherwise
    guarantees vs the single-chip trace (the determinism test standing in
    for the reference's absent race detection, SURVEY.md S5.2). Pass
    beam=4 to trade that for the empty-space skip."""
    mesh = default_mesh() if mesh is None else mesh
    octree = _device_put_structure(octree, mesh)

    o = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(dirs, jnp.float32).reshape(-1, 3)
    R = o.shape[0]
    ndev = mesh.devices.size

    # Per-shard padding: every shard gets Rl rays, a whole number of
    # march blocks (the pyramid reshapes the shard into (nb, B) blocks).
    Rl0 = -(-R // ndev)
    B = min(_TRACE_BLOCK, 1 << max(Rl0 - 1, 1).bit_length())
    Rl = -(-Rl0 // B) * B
    Rp = Rl * ndev

    sh = sharded_rays(mesh)
    o = jax.device_put(jnp.pad(o, [(0, Rp - R), (0, 0)]), sh)
    # padded rays march a unit direction so step sizes stay finite...
    d_pad = jnp.pad(d, [(0, Rp - R), (0, 0)])
    d_pad = jnp.where(
        (jnp.arange(Rp) < R)[:, None], d_pad, jnp.array([1.0, 0.0, 0.0])
    )
    d = jax.device_put(d_pad, sh)
    # ...and start inactive
    active0 = jax.device_put(
        (jnp.arange(Rp) < R).astype(jnp.float32), sh
    )

    # Stepping grid (fat if built) + thin grid for normals, as in
    # trace_octree; exit-stepping is only sound for eps below the proven
    # free-cell margin.
    grid = getattr(octree, "_fat_grid", None)
    grid_fat = grid is not None
    if grid is None:
        grid = getattr(octree, "_query_grid", None)
    if grid is not None and eps > OctreeSdf._FREE_CELL_MARGIN:
        grid = None
        grid_fat = False
    thin_grid = getattr(octree, "_query_grid", None)
    grid_arr = grid if grid is not None else jnp.zeros((1, 2), jnp.uint32)
    thin_arr = (
        thin_grid if thin_grid is not None else jnp.zeros((1, 2), jnp.uint32)
    )
    rep = replicated(mesh)
    grid_arr = jax.device_put(grid_arr, rep)
    thin_arr = jax.device_put(thin_arr, rep)

    box_size = float(octree.box.size[0])
    thr = float(getattr(octree, "termination_threshold", 1e-3))
    mapped = _sharded_trace_program(
        mesh,
        levels=octree.max_depth - octree.start_depth,
        num_coeff=octree.num_coefficients,
        interpolation=octree.interpolation,
        max_iters=max_iters,
        grid_depth=octree.max_depth if grid is not None else None,
        fast=octree._fast_layout,
        grid_fat=grid_fat,
        B=min(B, Rl),
        beam=beam,
        beam_margin=eps * box_size + 4.0 * thr,
        normals_grid_depth=(
            octree.max_depth if thin_grid is not None else None
        ),
    )
    hit, pos, acc, normal, iters = mapped(
        octree.octree_data, grid_arr, thin_arr, o, d, active0,
        jnp.asarray(octree.box.min),
        jnp.float32(box_size),
        jnp.int32(octree.start_grid_size),
        jnp.float32(octree.min_border_value),
        jnp.float32(eps),
        jnp.float32(far),
    )

    shape = jnp.asarray(origins).shape[:-1]
    return TraceResult(
        hit[:R].reshape(shape),
        pos[:R].reshape(shape + (3,)),
        acc[:R].reshape(shape),
        normal[:R].reshape(shape + (3,)),
        iters[:R].reshape(shape),
    )
