"""Procedural test meshes (icosphere, cube, plane, torus).

JAX equivalent of the reference PrimitivesFactory
(reference: src/utils/PrimitivesFactory.cpp, include/SdfLib/utils/
PrimitivesFactory.h:11-14). These are the standard meshes used by tests and
benchmarks since the repo carries no model assets.
"""
from __future__ import annotations

import numpy as np

from ..mesh import Mesh

__all__ = ["make_icosphere", "make_cube", "make_plane", "make_torus"]


def make_icosphere(subdivisions: int = 2, radius: float = 0.5, center=(0, 0, 0)) -> Mesh:
    """Icosahedron subdivided ``subdivisions`` times, projected to a sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        dtype=np.int64,
    )

    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)

    verts = verts * radius + np.asarray(center, np.float64)
    return Mesh(verts.astype(np.float32), faces.astype(np.uint32))


def make_cube(size: float = 1.0, center=(0, 0, 0)) -> Mesh:
    h = 0.5 * size
    c = np.asarray(center, np.float64)
    corners = np.array(
        [[x, y, z] for z in (-h, h) for y in (-h, h) for x in (-h, h)],
        dtype=np.float64,
    ) + c
    # 12 triangles, outward winding (CCW seen from outside)
    faces = np.array(
        [
            (0, 2, 1), (1, 2, 3),  # z = -h
            (4, 5, 6), (5, 7, 6),  # z = +h
            (0, 1, 4), (1, 5, 4),  # y = -h
            (2, 6, 3), (3, 6, 7),  # y = +h
            (0, 4, 2), (2, 4, 6),  # x = -h
            (1, 3, 5), (3, 7, 5),  # x = +h
        ],
        dtype=np.uint32,
    )
    return Mesh(corners.astype(np.float32), faces)


def make_plane(size: float = 1.0, center=(0, 0, 0), res: int = 1) -> Mesh:
    """Flat z=0 quad grid (open surface, exercises boundary pseudonormals)."""
    xs = np.linspace(-0.5 * size, 0.5 * size, res + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
    verts = verts + np.asarray(center, np.float64)
    faces = []
    for i in range(res):
        for j in range(res):
            a = i * (res + 1) + j
            b = a + 1
            cidx = a + (res + 1)
            d = cidx + 1
            # wound so face normals point +z
            faces += [(a, cidx, b), (b, cidx, d)]
    return Mesh(verts.astype(np.float32), np.asarray(faces, np.uint32))


def make_torus(R: float = 0.35, r: float = 0.15, nu: int = 48, nv: int = 24) -> Mesh:
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    gu, gv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(gv)) * np.cos(gu)
    y = (R + r * np.cos(gv)) * np.sin(gu)
    z = r * np.sin(gv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = i * nv + (j + 1) % nv
            d = ((i + 1) % nu) * nv + (j + 1) % nv
            faces += [(a, b, c), (b, d, c)]
    return Mesh(verts.astype(np.float32), np.asarray(faces, np.uint32))
