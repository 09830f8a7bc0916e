"""Plane-cut visualization of an octree SDF (SdfViewer parity).

JAX re-design of the reference plane-cut fragment shader
(reference: src/render_engine/shaders/sdfOctreePlane.frag:1-181): a plane
through the domain is sampled per pixel; color = 7-color distance palette
normalized by octreeValueRange, with isosurface line, isolines, and octree
node-grid overlay blended in black. Screen-space derivatives (dFdx/dFdy)
become finite differences between adjacent pixels.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..sdf.octree import OctreeSdf, _octree_query
from ..sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK

__all__ = ["render_plane_cut", "PALETTE7"]

# sdfOctreePlane.frag:34-43
PALETTE7 = np.asarray(
    [
        [0.0, 0.0, 1.0],
        [0.0, 0.5, 1.0],
        [0.0, 1.0, 1.0],
        [1.0, 1.0, 1.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.5, 0.0],
        [1.0, 0.0, 0.0],
    ],
    np.float32,
)


def _octree_node_metrics(octree: OctreeSdf, points):
    """distToGrid and nodeRelativeLength per point
    (sdfOctreePlane.frag:110-133): descend to the leaf, return the distance
    of the in-leaf frac coords to the leaf faces and the leaf's relative
    size."""
    data = octree.octree_data
    s = octree.start_grid_size
    box_min = jnp.asarray(octree.box.min)
    cell = jnp.float32(octree.box.size[0]) / s

    pts = jnp.asarray(points, jnp.float32)
    frac = (pts - box_min) / cell
    ipos = jnp.clip(jnp.floor(frac).astype(jnp.int32), 0, s - 1)
    frac = frac - jnp.floor(frac)
    word = data[ipos[..., 2] * (s * s) + ipos[..., 1] * s + ipos[..., 0]]
    rel_len = jnp.ones(pts.shape[:-1], jnp.float32)

    leaf_mask = jnp.uint32(IS_LEAF_MASK)
    cidx_mask = jnp.uint32(CHILDREN_INDEX_MASK)
    for _ in range(octree.max_depth - octree.start_depth):
        is_leaf = (word & leaf_mask) != 0
        child = (
            ((frac[..., 2] >= 0.5).astype(jnp.uint32) << 2)
            + ((frac[..., 1] >= 0.5).astype(jnp.uint32) << 1)
            + (frac[..., 0] >= 0.5).astype(jnp.uint32)
        )
        nxt = data[(word & cidx_mask) + child]
        nfrac = 2.0 * frac
        nfrac = nfrac - jnp.floor(nfrac)
        word = jnp.where(is_leaf, word, nxt)
        frac = jnp.where(is_leaf[..., None], frac, nfrac)
        rel_len = jnp.where(is_leaf, rel_len, rel_len * 0.5)

    dist_axis = 0.5 - jnp.abs(frac - 0.5)
    return dist_axis, rel_len


def render_plane_cut(
    octree: OctreeSdf,
    resolution: int = 512,
    *,
    axis: int = 2,
    offset: float = 0.5,
    print_grid: bool = True,
    print_isolines: bool = True,
    surface_thickness: float = 3.5,
    grid_thickness: float = 0.01,
    lines_thickness: float = 2.5,
    lines_space: float = 0.03,
) -> np.ndarray:
    """Render an axis-aligned plane cut to an (R, R, 3) float image.

    ``axis`` is the plane normal axis; ``offset`` in [0,1] positions the
    plane inside the box. Defaults mirror the shader uniforms
    (sdfOctreePlane.frag:20-31).
    """
    u = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    gu, gv = np.meshgrid(u, u, indexing="xy")
    coords = [None, None, None]
    axes2d = [a for a in range(3) if a != axis]
    coords[axes2d[0]] = gu
    coords[axes2d[1]] = gv
    coords[axis] = np.full_like(gu, offset)
    unit = np.stack(coords, axis=-1)  # (R, R, 3) in [0,1]^3
    pts = octree.box.min + unit * octree.box.size[None, None]

    d = np.asarray(octree.get_distance(pts))

    # Screen-space derivative dDist ~ |d/dx, d/dy| via pixel differences
    # (stands in for dFdx/dFdy; clamped like the shader :152).
    ddx = np.diff(d, axis=1, append=d[:, -1:])
    ddy = np.diff(d, axis=0, append=d[-1:, :])
    ddist = np.maximum(np.hypot(ddx, ddy), 0.0008)

    # Isosurface band (:155); thickness <= 0 disables it (the |d|/0 -> inf
    # route produced the right pixels but a divide RuntimeWarning).
    if surface_thickness > 0.0:
        surface_w = np.clip(
            1.0 - (np.abs(d) / (ddist * surface_thickness)) ** 8, 0, 1
        )
    else:
        surface_w = np.zeros_like(d)

    # Node grid overlay (:158): distToGrid masked by the plane normal axis
    dist_axis, rel_len = _octree_node_metrics(octree, pts.reshape(-1, 3))
    dist_axis = np.asarray(dist_axis).reshape(resolution, resolution, 3)
    rel_len = np.asarray(rel_len).reshape(resolution, resolution)
    dist_to_grid = np.min(
        np.stack([dist_axis[..., a] for a in axes2d], axis=-1), axis=-1
    )
    grid_w = (
        float(print_grid)
        * np.clip(1.0 - (dist_to_grid * rel_len / grid_thickness) ** 8, 0, 1)
    )

    # Isolines (:161-163)
    dist_to_level = 0.5 - np.abs(np.modf(np.abs(d) / lines_space)[0] - 0.5)
    dd_level = ddist / lines_space
    lines_w = (
        float(print_isolines)
        * 0.5
        * np.clip(1.0 - (dist_to_level / (dd_level * lines_thickness)) ** 8, 0, 1)
    )

    # 7-color heat map (:166-169)
    value_range = max(octree.value_range, 1e-8)
    t = 0.5 + 0.5 * d / value_range
    idx = np.clip(t * 6.0, 0.0, 6.0 - 0.01)
    i0 = idx.astype(np.int64)
    fr = (idx - i0)[..., None]
    color = PALETTE7[i0] * (1.0 - fr) + PALETTE7[np.minimum(i0 + 1, 6)] * fr

    dark = np.maximum(np.maximum(surface_w, grid_w), lines_w)[..., None]
    return (color * (1.0 - dark)).astype(np.float32)
