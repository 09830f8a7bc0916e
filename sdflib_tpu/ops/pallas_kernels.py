"""Pallas kernel (Triton route) for the nearest-triangle sweep.

``nearest_triangle_pallas`` is the fused points x triangles sweep behind
the RealSdf oracle (reference src/sdf/RealSdf.cpp:10-25), the uniform-grid
build and both octree builders' seed lattice. The XLA path
(``point_triangle.nearest_triangle``) scans triangle chunks with a running
min over ``(P, chunk)`` distance blocks; this kernel keeps the whole
region-classified distance (TriangleUtils.h:76-135 semantics) and the
running (min, argmin) in registers, so only the final (P,) best distance
and index reach device memory.

Layout, for the GPU's block model:
  * the grid runs over point blocks only — blocks run in parallel and in no
    order, so nothing is carried between them;
  * each block walks ALL triangles in a ``lax.fori_loop`` of
    ``tile_t``-wide steps, holding its points' running (min, argmin);
  * triangle fields are stored field-major, ``(19, T_pad)``, so each field
    of a step is one contiguous ``tile_t`` vector load;
  * block sizes are powers of two (Triton's requirement); the triangle axis
    is padded to a ``tile_t`` multiple and padded triangles are masked.

Ties keep the lowest triangle index: ``argmin`` inside a step returns the
first minimum, and the strict ``<`` across ascending steps keeps the earlier
one (OctreeSdfUtils.h:24 semantics). All math is elementwise float32 — no
matrix unit, so no TF32 rounding.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..triangle import TriangleDataSoA
from .point_triangle import (
    NUM_PACKED_FIELDS as _NUM_FIELDS,
    pack_triangle_fields,
    sq_dist_from_field_fn,
)

__all__ = ["nearest_triangle_pallas"]


def _nearest_kernel(px_ref, py_ref, pz_ref, tf_ref, best_ref, idx_ref, *,
                    tile_t: int, num_tris: int):
    tile_p = px_ref.shape[0]
    px = px_ref[...][:, None]                         # (TP, 1)
    py = py_ref[...][:, None]
    pz = pz_ref[...][:, None]

    def step(j, carry):
        best, bidx = carry
        t0 = j * tile_t
        field = lambda r: tf_ref[r, pl.ds(t0, tile_t)][None, :]  # (1, TT)
        sq = sq_dist_from_field_fn(px, py, pz, field)             # (TP, TT)
        tid = t0 + jax.lax.broadcasted_iota(jnp.int32, (1, tile_t), 1)
        sq = jnp.where(tid < num_tris, sq, jnp.inf)
        local = jnp.min(sq, axis=1)
        local_idx = jnp.argmin(sq, axis=1).astype(jnp.int32) + t0
        take = local < best
        return jnp.where(take, local, best), jnp.where(take, local_idx, bidx)

    init = (
        jnp.full((tile_p,), jnp.inf, jnp.float32),
        jnp.zeros((tile_p,), jnp.int32),
    )
    best, bidx = jax.lax.fori_loop(0, tf_ref.shape[1] // tile_t, step, init)
    best_ref[...] = best
    idx_ref[...] = bidx


@partial(
    jax.jit,
    static_argnames=("tile_p", "tile_t", "num_warps", "num_stages", "interpret"),
)
def _nearest_call(points, tf, *, tile_p, tile_t, num_warps, num_stages,
                  interpret):
    P = points.shape[0]
    T = tf.shape[0]
    Pp = -(-P // tile_p) * tile_p
    Tp = -(-T // tile_t) * tile_t
    pts = jnp.pad(points, [(0, Pp - P), (0, 0)]).T    # (3, Pp)
    tf_t = jnp.pad(tf, [(0, Tp - T), (0, 0)]).T        # (19, Tp)
    pspec = pl.BlockSpec((tile_p,), lambda i: (i,))
    best, idx = pl.pallas_call(
        partial(_nearest_kernel, tile_t=tile_t, num_tris=T),
        grid=(Pp // tile_p,),
        in_specs=[
            pspec, pspec, pspec,
            pl.BlockSpec((_NUM_FIELDS, Tp), lambda i: (0, 0)),
        ],
        out_specs=[pspec, pspec],
        out_shape=[
            jax.ShapeDtypeStruct((Pp,), jnp.float32),
            jax.ShapeDtypeStruct((Pp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="nearest_triangle",
    )(pts[0], pts[1], pts[2], tf_t)
    return best[:P], idx[:P]


def nearest_triangle_pallas(
    points,
    tris: TriangleDataSoA,
    tile_p: int = 64,
    tile_t: int = 32,
    num_warps: int = 4,
    num_stages: int = 2,
    interpret: bool = False,
):
    """(squared distance, index) of the nearest triangle per point.

    Drop-in replacement for ``ops.point_triangle.nearest_triangle``.
    Compiles for the GPU through Triton; ``interpret=True`` runs the same
    kernel body on any backend (the CPU tests)."""
    for name, v in (("tile_p", tile_p), ("tile_t", tile_t)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two, got {v}")
    points = jnp.asarray(points, jnp.float32)
    return _nearest_call(
        points, pack_triangle_fields(tris),
        tile_p=tile_p, tile_t=tile_t, num_warps=num_warps,
        num_stages=num_stages, interpret=interpret,
    )
