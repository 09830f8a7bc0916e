"""Brute-force exact SDF over all triangles — the ground-truth oracle.

JAX re-design of the reference RealSdf (src/sdf/RealSdf.cpp:10-31).
The reference's per-point serial loop becomes the chunked batched argmin
kernel in ops/point_triangle.py; unlike the reference, the gradient variant
is implemented (the reference leaves it as a TODO stub, RealSdf.cpp:27-31) —
we use the analytic per-region gradient.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import BoundingBox, Mesh
from ..triangle import TriangleDataSoA, calculate_mesh_triangle_data
from ..ops.point_triangle import (
    signed_distance_batch,
    signed_distance_grad_batch,
)
from .sdf_function import SdfFormat, SdfFunction

__all__ = ["RealSdf"]


class RealSdf(SdfFunction):
    """Exact signed distance via brute force over every triangle."""

    def __init__(self, mesh: Mesh, chunk: int = 512):
        self.mesh = mesh
        self.chunk = int(chunk)
        soa = calculate_mesh_triangle_data(mesh)
        self.triangles: TriangleDataSoA = jax.tree.map(jnp.asarray, soa)

    def get_distance(self, points):
        pts = jnp.asarray(points, jnp.float32)
        flat = pts.reshape(-1, 3)
        d = signed_distance_batch(flat, self.triangles, chunk=self.chunk)
        return d.reshape(pts.shape[:-1])

    def get_distance_and_gradient(self, points):
        pts = jnp.asarray(points, jnp.float32)
        flat = pts.reshape(-1, 3)
        d, g = signed_distance_grad_batch(flat, self.triangles, chunk=self.chunk)
        return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)

    def get_sample_area(self) -> BoundingBox:
        return self.mesh.bounding_box

    def get_format(self) -> SdfFormat:
        return SdfFormat.NONE
