"""Dense uniform grid SDF with trilinear queries.

JAX re-design of the reference UniformGridSdf
(reference: include/SdfLib/UniformGridSdf.h:15-74,
src/sdf/UniformGridSdf.cpp:9-118). Grid layout matches the reference:
``grid_size`` corner samples per axis spaced ``cell_size`` apart starting at
``box.min`` (so the sampled extent is (grid_size-1)*cell_size,
UniformGridSdf.cpp:19-20). BASIC init evaluates the exact SDF at every
corner with the batched brute-force kernel; the reference's serial
triple loop + OpenMP becomes one device-wide batch.

The reference's gradient query is a TODO stub (UniformGridSdf.cpp:115-118);
here it is implemented as the analytic trilinear gradient.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import BoundingBox, Mesh
from ..triangle import calculate_mesh_triangle_data
from ..ops.point_triangle import signed_distance_batch
from ..ops.interpolation import trilinear_gradient, trilinear_interpolate
from .sdf_function import SdfFormat, SdfFunction

__all__ = ["UniformGridSdf"]


def _build_grid_values(mesh: Mesh, points, chunk: int = 512, batch: int = 65536):
    """Exact SDF at grid corner points, batched to bound device memory."""
    tris = jax.tree.map(jnp.asarray, calculate_mesh_triangle_data(mesh))
    out = []
    for i in range(0, points.shape[0], batch):
        out.append(
            np.asarray(
                signed_distance_batch(points[i : i + batch], tris, chunk=chunk)
            )
        )
    return np.concatenate(out)


class UniformGridSdf(SdfFunction):
    def __init__(
        self,
        mesh: Mesh | None = None,
        box: BoundingBox | None = None,
        depth: int | None = None,
        cell_size: float | None = None,
        init_algorithm: str = "basic",
        _state: dict | None = None,
    ):
        if _state is not None:
            self.box = BoundingBox(_state["box_min"], _state["box_max"])
            self.grid = jnp.asarray(_state["grid"], jnp.float32)
            self.grid_size = tuple(int(x) for x in _state["grid_size"])
            size = self.box.size
            self.cell_size = float(size[0]) / float(self.grid_size[0] - 1)
            return

        assert mesh is not None and box is not None
        if depth is not None:
            gs = 1 << depth
            bb_size = box.size
            self.cell_size = float(np.max(bb_size)) / gs
            self.grid_size = (gs, gs, gs)
        else:
            assert cell_size is not None
            self.cell_size = float(cell_size)
            gs3 = np.ceil(box.size / cell_size).astype(int) + 1
            self.grid_size = tuple(int(x) for x in gs3)

        # Reference: sampled extent = (grid_size - 1) * cell_size from
        # box.min (UniformGridSdf.cpp:19-20).
        gmin = np.asarray(box.min, np.float32)
        gmax = gmin + self.cell_size * (np.asarray(self.grid_size, np.float32) - 1)
        self.box = BoundingBox(gmin, gmax)

        nx, ny, nz = self.grid_size
        xs = gmin[0] + self.cell_size * np.arange(nx, dtype=np.float32)
        ys = gmin[1] + self.cell_size * np.arange(ny, dtype=np.float32)
        zs = gmin[2] + self.cell_size * np.arange(nz, dtype=np.float32)
        # Reference storage: index = z * XY + y * X + x (z-major).
        gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

        # Both inits produce identical exact values (the reference's
        # octree variant is an acceleration, UniformGridSdfOctree.cpp:42-226).
        if init_algorithm == "octree":
            # Octree-accelerated init: corners evaluate through a shallow
            # exact octree's culled leaf lists instead of all T triangles —
            # the same maxMinDist-style culling the reference descends
            # with, reused from the exact-octree builder. A half-cell
            # margin keeps every corner strictly inside the (cubified)
            # octree domain so no corner hits the out-of-box fallback.
            from .exact_octree import ExactOctreeSdf

            acc_depth = max(3, min(6, int(np.log2(max(self.grid_size)))))
            acc = ExactOctreeSdf(
                mesh,
                self.box.add_margin(0.5 * self.cell_size),
                max_depth=acc_depth,
                start_depth=min(2, acc_depth - 1),
                min_triangles_per_node=64,
            )
            values = np.asarray(acc.get_distance(jnp.asarray(pts)))
        else:
            values = _build_grid_values(mesh, pts)
        self.grid = jnp.asarray(values.reshape(nz, ny, nx), jnp.float32)

    # -- queries -------------------------------------------------------------

    def _gather_corners(self, points):
        pts = jnp.asarray(points, jnp.float32)
        frac = (pts - jnp.asarray(self.box.min)) / self.cell_size
        ipos = jnp.floor(frac).astype(jnp.int32)
        frac = frac - ipos
        nx, ny, nz = self.grid_size
        # Clamp so out-of-domain queries read border cells (the reference
        # has UB there; clamping is the safe batched equivalent).
        ix = jnp.clip(ipos[..., 0], 0, nx - 2)
        iy = jnp.clip(ipos[..., 1], 0, ny - 2)
        iz = jnp.clip(ipos[..., 2], 0, nz - 2)
        g = self.grid
        corners = jnp.stack(
            [
                g[iz, iy, ix],
                g[iz, iy, ix + 1],
                g[iz, iy + 1, ix],
                g[iz, iy + 1, ix + 1],
                g[iz + 1, iy, ix],
                g[iz + 1, iy, ix + 1],
                g[iz + 1, iy + 1, ix],
                g[iz + 1, iy + 1, ix + 1],
            ],
            axis=-1,
        )
        return corners, frac

    def get_distance(self, points):
        corners, frac = self._gather_corners(points)
        return trilinear_interpolate(corners, frac)

    def get_distance_and_gradient(self, points):
        corners, frac = self._gather_corners(points)
        d = trilinear_interpolate(corners, frac)
        g = trilinear_gradient(corners, frac) / self.cell_size
        return d, g

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.GRID

    # -- serialization -------------------------------------------------------

    def _state_arrays(self) -> dict:
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "grid_size": np.asarray(self.grid_size, np.int32),
            "grid": np.asarray(self.grid, np.float32),
        }

    @classmethod
    def _from_state_arrays(cls, state: dict) -> "UniformGridSdf":
        return cls(_state=state)
