"""Batched point-triangle distance kernels (the #1 hot loop).

JAX re-design of the reference scalar kernels
(reference: include/SdfLib/utils/TriangleUtils.h:76-401). The branchy
Voronoi-region classification becomes a branchless ``where``-ladder over a
region code so it vectorizes; tie-breaking (``>=`` vs ``<=``)
matches the reference exactly since sign flips at region boundaries would
break allclose parity (SURVEY.md "hard parts").

Region codes: 0=v1, 1=v2, 2=v3, 3=edge1(v1v2), 4=edge2(v2v3),
5=edge3(v3v1), 6=face.

All functions operate on a single (point, triangle) pair with scalar math
and are lifted with ``jax.vmap``; the chunked brute-force reductions at the
bottom are the RealSdf oracle (reference src/sdf/RealSdf.cpp:10-25 and
OctreeSdfUtils.h:13-36 semantics: argmin over *squared* unsigned distance
with first-triangle-wins ties, then one signed evaluation of the winner).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..triangle import TriangleDataSoA

__all__ = [
    "project_point",
    "region_code",
    "sq_dist_pair",
    "signed_dist_pair",
    "signed_dist_grad_pair",
    "sq_dist_naive",
    "sq_dist_naive_from_cols",
    "sq_dist_from_vertex_cols",
    "nearest_triangle",
    "signed_distance_batch",
    "signed_distance_grad_batch",
    "pack_triangle_fields",
    "pack_triangle_full_fields",
    "signed_dist_from_rows",
    "sq_dist_packed",
    "sq_dist_from_field_fn",
    "NUM_PACKED_FIELDS",
]

# Region codes
V1, V2, V3, E1, E2, E3, FACE = 0, 1, 2, 3, 4, 5, 6


def _dot(a, b):
    """Elementwise dot. Deliberately NOT ``a @ b``: a float32 matrix product
    may run in TF32 on a GPU (bf16 on other accelerators) at default
    precision, destroying distance parity (SURVEY.md "Numerics").
    sum(a*b) stays elementwise fp32."""
    return jnp.sum(a * b, axis=-1)


def _matvec(m, v):
    """(3,3) @ (3,) as elementwise fp32 (see _dot)."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def project_point(point, tri: TriangleDataSoA):
    """World point -> triangle-space (TriangleUtils.h:78)."""
    return _matvec(tri.transform, point - tri.origin)


def region_code(pp, tri: TriangleDataSoA):
    """Classify the projected point into one of 7 Voronoi features.

    Exactly mirrors the nested branch structure and tie-breaking of
    TriangleUtils.h:84-134.
    """
    x, y = pp[0], pp[1]
    de1 = -y
    de2 = (x - tri.v2x) * tri.b[1] - y * tri.b[0]
    de3 = x * tri.c[1] - y * tri.c[0]

    # Region 1 (edge v1-v2 outside): vertex/edge selection
    r1 = jnp.where(x <= 0.0, V1, jnp.where(x >= tri.v2x, V2, E1))
    # Region 2 (edge v2-v3 outside)
    dot_b_v2 = (x - tri.v2x) * tri.b[0] + y * tri.b[1]
    dot_b_v3 = (x - tri.v3xy[0]) * tri.b[0] + (y - tri.v3xy[1]) * tri.b[1]
    r2 = jnp.where(dot_b_v2 <= 0.0, V2, jnp.where(dot_b_v3 >= 0.0, V3, E2))
    # Region 3 (edge v3-v1 outside)
    dot_c_v1 = x * tri.c[0] + y * tri.c[1]
    dot_c_v3 = (x - tri.v3xy[0]) * tri.c[0] + (y - tri.v3xy[1]) * tri.c[1]
    r3 = jnp.where(dot_c_v1 >= 0.0, V1, jnp.where(dot_c_v3 <= 0.0, V3, E3))

    code = jnp.where(
        de1 >= 0.0,
        r1,
        jnp.where(de2 >= 0.0, r2, jnp.where(de3 >= 0.0, r3, FACE)),
    )
    return code, (de1, de2, de3)


def _feature_offsets(pp, tri: TriangleDataSoA):
    """Relative vectors from the three vertices in triangle space."""
    p_v1 = pp
    p_v2 = pp - jnp.array([1.0, 0.0, 0.0], pp.dtype) * tri.v2x
    p_v3 = pp - jnp.stack([tri.v3xy[0], tri.v3xy[1], jnp.zeros((), pp.dtype)])
    return p_v1, p_v2, p_v3


def _select_by_code(code, cands):
    """7-way select as a where-ladder. A ``stack(...)[code]`` gather would
    materialize a (..., 7) array inside the brute-force sweeps; the ladder
    stays fully elementwise."""
    out = cands[6]
    for k in range(5, -1, -1):
        out = jnp.where(code == k, cands[k], out)
    return out


def sq_dist_pair(point, tri: TriangleDataSoA):
    """Unsigned squared distance, one (point, triangle) pair.

    Parity target: TriangleUtils.h:76-135 (getSqDistPointAndTriangle).
    """
    pp = project_point(point, tri)
    code, (de1, de2, de3) = region_code(pp, tri)
    p_v1, p_v2, p_v3 = _feature_offsets(pp, tri)
    z2 = pp[2] * pp[2]
    cands = (
        _dot(p_v1, p_v1),
        _dot(p_v2, p_v2),
        _dot(p_v3, p_v3),
        de1 * de1 + z2,
        de2 * de2 + z2,
        de3 * de3 + z2,
        z2,
    )
    return _select_by_code(code, cands)


def _region_sign(code, pp, tri: TriangleDataSoA):
    """Pseudonormal sign test per region (TriangleUtils.h:137-196)."""
    p_v1, p_v2, p_v3 = _feature_offsets(pp, tri)
    vn = tri.vertices_normal
    en = tri.edges_normal
    dots = (
        _dot(vn[0], p_v1),
        _dot(vn[1], p_v2),
        _dot(vn[2], p_v3),
        _dot(en[0], pp),
        _dot(en[1], p_v2),
        _dot(en[2], pp),
        pp[2],
    )
    return jnp.sign(_select_by_code(code, dots))


def signed_dist_pair(point, tri: TriangleDataSoA):
    """Signed distance, one pair (TriangleUtils.h:137-196).

    The face region returns ``pp.z`` directly; other regions return
    sign(pseudonormal . rel) * sqrt(sq_dist).
    """
    pp = project_point(point, tri)
    code, _ = region_code(pp, tri)
    sq = sq_dist_pair(point, tri)
    sign = _region_sign(code, pp, tri)
    return jnp.where(code == FACE, pp[2], sign * jnp.sqrt(sq))


def _safe_normalize(vec, fallback):
    """normalize with NaN fallback (TriangleUtils.h:208-212)."""
    n2 = _dot(vec, vec)
    inv = jnp.where(n2 > 0.0, jax.lax.rsqrt(jnp.maximum(n2, 1e-38)), 0.0)
    return jnp.where(n2 > 0.0, vec * inv, fallback)


def signed_dist_grad_pair(point, tri: TriangleDataSoA):
    """Signed distance + world-space gradient, one pair.

    Parity target: TriangleUtils.h:198-290 (the v1/v2/v3 variant used by
    TriCubicInterpolation::calculatePointValues, InterpolationMethods.h:282).
    Returns (dist, grad).
    """
    pp = project_point(point, tri)
    code, (de1, de2, de3) = region_code(pp, tri)
    sq = sq_dist_pair(point, tri)
    sign = _region_sign(code, pp, tri)
    dist = jnp.where(code == FACE, pp[2], sign * jnp.sqrt(sq))

    tn = tri.transform[2, :]  # world-space unit normal (row 2)
    tt = tri.transform.T

    # Vertex-region normals: normalize(point - vertex_world)
    n_v1 = _safe_normalize(point - tri.v_world[0], tn)
    n_v2 = _safe_normalize(point - tri.v_world[1], tn)
    n_v3 = _safe_normalize(point - tri.v_world[2], tn)

    # Edge-region normals: perpendicular component, back to world space
    n_e1 = _safe_normalize(
        _matvec(tt, jnp.stack([jnp.zeros((), pp.dtype), pp[1], pp[2]])), tn
    )
    dot_b = (pp[0] - tri.v2x) * tri.b[0] + pp[1] * tri.b[1]
    n_e2 = _safe_normalize(
        _matvec(
            tt,
            jnp.stack(
                [(pp[0] - tri.v2x) - dot_b * tri.b[0], pp[1] - dot_b * tri.b[1], pp[2]]
            ),
        ),
        tn,
    )
    dot_c = pp[0] * tri.c[0] + pp[1] * tri.c[1]
    n_e3 = _safe_normalize(
        _matvec(
            tt,
            jnp.stack([pp[0] - dot_c * tri.c[0], pp[1] - dot_c * tri.c[1], pp[2]]),
        ),
        tn,
    )

    normals = (n_v1, n_v2, n_v3, n_e1, n_e2, n_e3, tn)
    grad = jnp.where(code == FACE, tn, sign * _select_by_code(code, normals))
    return dist, grad


# ---------------------------------------------------------------------------
# Packed-field kernels: triangle fields flattened to a 19-float row so bulk
# sweeps fetch them as contiguous row gathers / lane-broadcast tiles.
# ---------------------------------------------------------------------------

NUM_PACKED_FIELDS = 19
_F_ORIGIN = 0       # 0:3   origin xyz
_F_TRANSFORM = 3    # 3:12  world->tri transform, row-major
_F_B = 12           # 12:14 edge v2->v3 2D direction
_F_C = 14           # 14:16 edge v3->v1 2D direction
_F_V2X = 16         # v2.x in triangle space
_F_V3 = 17          # 17:19 v3.xy in triangle space


def pack_triangle_fields(tris: TriangleDataSoA):
    """(T, 19) fp32 matrix of the fields sq_dist needs, one row per
    triangle (gather-friendly layout)."""
    t = jax.tree.map(jnp.asarray, tris)
    rows = [
        t.origin[:, 0], t.origin[:, 1], t.origin[:, 2],
        t.transform[:, 0, 0], t.transform[:, 0, 1], t.transform[:, 0, 2],
        t.transform[:, 1, 0], t.transform[:, 1, 1], t.transform[:, 1, 2],
        t.transform[:, 2, 0], t.transform[:, 2, 1], t.transform[:, 2, 2],
        t.b[:, 0], t.b[:, 1],
        t.c[:, 0], t.c[:, 1],
        t.v2x,
        t.v3xy[:, 0], t.v3xy[:, 1],
    ]
    return jnp.stack(rows, axis=-1).astype(jnp.float32)


def sq_dist_from_field_fn(px, py, pz, f):
    """Region-classified squared distance from a field accessor.

    px/py/pz: broadcastable point coords; ``f(r)`` returns packed field row
    ``r`` (``pack_triangle_fields`` layout) broadcastable against them. All
    elementwise fp32 with the exact tie-breaking of
    TriangleUtils.h:76-135. The accessor indirection lets callers pick a
    layout that avoids relayouts (field vectors in the Pallas kernel,
    trailing field axes in XLA)."""

    dx = px - f(_F_ORIGIN)
    dy = py - f(_F_ORIGIN + 1)
    dz = pz - f(_F_ORIGIN + 2)

    ppx = f(_F_TRANSFORM + 0) * dx + f(_F_TRANSFORM + 1) * dy + f(_F_TRANSFORM + 2) * dz
    ppy = f(_F_TRANSFORM + 3) * dx + f(_F_TRANSFORM + 4) * dy + f(_F_TRANSFORM + 5) * dz
    ppz = f(_F_TRANSFORM + 6) * dx + f(_F_TRANSFORM + 7) * dy + f(_F_TRANSFORM + 8) * dz

    b0, b1 = f(_F_B), f(_F_B + 1)
    c0, c1 = f(_F_C), f(_F_C + 1)
    v2x = f(_F_V2X)
    v3x, v3y = f(_F_V3), f(_F_V3 + 1)

    de1 = -ppy
    de2 = (ppx - v2x) * b1 - ppy * b0
    de3 = ppx * c1 - ppy * c0
    z2 = ppz * ppz

    d_v1 = ppx * ppx + ppy * ppy + z2
    rx2 = ppx - v2x
    d_v2 = rx2 * rx2 + ppy * ppy + z2
    rx3, ry3 = ppx - v3x, ppy - v3y
    d_v3 = rx3 * rx3 + ry3 * ry3 + z2

    r1 = jnp.where(
        ppx <= 0.0, d_v1, jnp.where(ppx >= v2x, d_v2, de1 * de1 + z2)
    )
    dot_b_v2 = rx2 * b0 + ppy * b1
    dot_b_v3 = rx3 * b0 + ry3 * b1
    r2 = jnp.where(
        dot_b_v2 <= 0.0, d_v2, jnp.where(dot_b_v3 >= 0.0, d_v3, de2 * de2 + z2)
    )
    dot_c_v1 = ppx * c0 + ppy * c1
    dot_c_v3 = rx3 * c0 + ry3 * c1
    r3 = jnp.where(
        dot_c_v1 >= 0.0, d_v1, jnp.where(dot_c_v3 <= 0.0, d_v3, de3 * de3 + z2)
    )
    return jnp.where(
        de1 >= 0.0, r1, jnp.where(de2 >= 0.0, r2, jnp.where(de3 >= 0.0, r3, z2))
    )


def sq_dist_packed(px, py, pz, fields):
    """sq_dist_from_field_fn with fields (..., 19) on the trailing axis."""
    return sq_dist_from_field_fn(px, py, pz, lambda r: fields[..., r])


# Extended 37-float record (the TriangleData serialization layout,
# TriangleUtils.h:50-54): packed 19 fields + 3 transformed edge
# pseudonormals + 3 transformed vertex pseudonormals.
NUM_FULL_FIELDS = 37
_F_EDGE_N = 19      # 19:28  edges_normal, 3 x 3
_F_VERT_N = 28      # 28:37  vertices_normal, 3 x 3


def pack_triangle_full_fields(tris: TriangleDataSoA):
    """(T, 37) fp32 matrix: everything the SIGNED evaluation needs in one
    gatherable row. The winner-evaluation step previously gathered ~12
    separate SoA arrays per point (12 row-gather passes — measured as the
    dominant cost of the whole exact query at 2M points); one fused row
    makes it a single pass."""
    t = jax.tree.map(jnp.asarray, tris)
    base = pack_triangle_fields(t)                      # (T, 19)
    en = t.edges_normal.reshape(-1, 9)
    vn = t.vertices_normal.reshape(-1, 9)
    return jnp.concatenate([base, en, vn], axis=1).astype(jnp.float32)


def signed_dist_from_rows(px, py, pz, f):
    """Signed distance from a 37-field row accessor (``f(r)`` returns
    column r broadcastable against px/py/pz). Same region classification,
    tie-breaking, and pseudonormal sign logic as signed_dist_pair
    (TriangleUtils.h:137-196), columnized so the winner evaluation is one
    row gather + elementwise math."""
    dx = px - f(_F_ORIGIN)
    dy = py - f(_F_ORIGIN + 1)
    dz = pz - f(_F_ORIGIN + 2)
    ppx = f(_F_TRANSFORM + 0) * dx + f(_F_TRANSFORM + 1) * dy + f(_F_TRANSFORM + 2) * dz
    ppy = f(_F_TRANSFORM + 3) * dx + f(_F_TRANSFORM + 4) * dy + f(_F_TRANSFORM + 5) * dz
    ppz = f(_F_TRANSFORM + 6) * dx + f(_F_TRANSFORM + 7) * dy + f(_F_TRANSFORM + 8) * dz

    b0, b1 = f(_F_B), f(_F_B + 1)
    c0, c1 = f(_F_C), f(_F_C + 1)
    v2x = f(_F_V2X)
    v3x, v3y = f(_F_V3), f(_F_V3 + 1)

    de1 = -ppy
    de2 = (ppx - v2x) * b1 - ppy * b0
    de3 = ppx * c1 - ppy * c0
    z2 = ppz * ppz

    rx2 = ppx - v2x
    rx3, ry3 = ppx - v3x, ppy - v3y
    d_v1 = ppx * ppx + ppy * ppy + z2
    d_v2 = rx2 * rx2 + ppy * ppy + z2
    d_v3 = rx3 * rx3 + ry3 * ry3 + z2

    def vdot(base, rx, ry, rz):
        return f(base) * rx + f(base + 1) * ry + f(base + 2) * rz

    # per-region (sq distance, pseudonormal dot) pairs; the where-ladder
    # mirrors region_code exactly (TriangleUtils.h:84-134)
    s_v1 = vdot(_F_VERT_N + 0, ppx, ppy, ppz)
    s_v2 = vdot(_F_VERT_N + 3, rx2, ppy, ppz)
    s_v3 = vdot(_F_VERT_N + 6, rx3, ry3, ppz)
    s_e1 = vdot(_F_EDGE_N + 0, ppx, ppy, ppz)
    s_e2 = vdot(_F_EDGE_N + 3, rx2, ppy, ppz)
    s_e3 = vdot(_F_EDGE_N + 6, ppx, ppy, ppz)

    dot_b_v2 = rx2 * b0 + ppy * b1
    dot_b_v3 = rx3 * b0 + ry3 * b1
    dot_c_v1 = ppx * c0 + ppy * c1
    dot_c_v3 = rx3 * c0 + ry3 * c1

    in_r1 = de1 >= 0.0
    in_r2 = ~in_r1 & (de2 >= 0.0)
    in_r3 = ~in_r1 & ~in_r2 & (de3 >= 0.0)
    face = ~in_r1 & ~in_r2 & ~in_r3

    sq_r1 = jnp.where(
        ppx <= 0.0, d_v1, jnp.where(ppx >= v2x, d_v2, de1 * de1 + z2)
    )
    sg_r1 = jnp.where(ppx <= 0.0, s_v1, jnp.where(ppx >= v2x, s_v2, s_e1))
    sq_r2 = jnp.where(
        dot_b_v2 <= 0.0, d_v2,
        jnp.where(dot_b_v3 >= 0.0, d_v3, de2 * de2 + z2),
    )
    sg_r2 = jnp.where(
        dot_b_v2 <= 0.0, s_v2, jnp.where(dot_b_v3 >= 0.0, s_v3, s_e2)
    )
    sq_r3 = jnp.where(
        dot_c_v1 >= 0.0, d_v1,
        jnp.where(dot_c_v3 <= 0.0, d_v3, de3 * de3 + z2),
    )
    sg_r3 = jnp.where(
        dot_c_v1 >= 0.0, s_v1, jnp.where(dot_c_v3 <= 0.0, s_v3, s_e3)
    )

    sq = jnp.where(
        in_r1, sq_r1, jnp.where(in_r2, sq_r2, jnp.where(in_r3, sq_r3, z2))
    )
    sgn = jnp.sign(
        jnp.where(in_r1, sg_r1, jnp.where(in_r2, sg_r2, sg_r3))
    )
    return jnp.where(face, ppz, sgn * jnp.sqrt(sq))


def sq_dist_from_vertex_cols(px, py, pz, v):
    """EXACT region-classified squared distance derived on the fly from a
    vertex-format column accessor (``v(r)`` -> component r of
    [ax ay az bx by bz cx cy cz]).

    The triangle frame (TriangleUtils.h:23-41) is an orthonormal basis
    (sx = normalize(e1), sz = normalize(e1 x e2), sy = sz x sx), so the
    frame transform's inverse is its transpose — the projected point and
    the b/c edge directions come straight from dot products, and the
    region ladder is the same as sq_dist_from_field_fn. This makes
    vertex-format scan buckets (9 floats/triangle, 2.1x smaller than the
    19-field rows) selection-exact: the naive 3-vertex formula is NOT
    usable for selection — its inside/outside classification flips near
    shared-edge boundaries and underestimates by ~1e-4, enough to pick
    the wrong winner. Frame derivation costs ~60 flops per triangle,
    amortized over every point in the group."""
    ax, ay, az = v(0), v(1), v(2)
    bx, by, bz = v(3), v(4), v(5)
    cx, cy, cz = v(6), v(7), v(8)

    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az

    il1 = jax.lax.rsqrt(e1x * e1x + e1y * e1y + e1z * e1z)
    sxx, sxy, sxz = e1x * il1, e1y * il1, e1z * il1
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    iln = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz)
    szx, szy, szz = nx * iln, ny * iln, nz * iln
    syx = szy * sxz - szz * sxy
    syy = szz * sxx - szx * sxz
    syz = szx * sxy - szy * sxx

    dx, dy, dz = px - ax, py - ay, pz - az
    ppx = sxx * dx + sxy * dy + sxz * dz
    ppy = syx * dx + syy * dy + syz * dz
    ppz = szx * dx + szy * dy + szz * dz

    v2x = sxx * e1x + sxy * e1y + sxz * e1z      # = |e1|
    v3x = sxx * e2x + sxy * e2y + sxz * e2z
    v3y = syx * e2x + syy * e2y + syz * e2z

    # b = normalize2(frame * (v3 - v2)); c = normalize2(frame * (v1 - v3))
    bx2, by2 = v3x - v2x, v3y
    ilb = jax.lax.rsqrt(bx2 * bx2 + by2 * by2)
    b0, b1 = bx2 * ilb, by2 * ilb
    cx2, cy2 = -v3x, -v3y
    ilc = jax.lax.rsqrt(cx2 * cx2 + cy2 * cy2)
    c0, c1 = cx2 * ilc, cy2 * ilc

    # Region ladder — identical structure/tie-breaking to
    # sq_dist_from_field_fn (TriangleUtils.h:76-135).
    de1 = -ppy
    de2 = (ppx - v2x) * b1 - ppy * b0
    de3 = ppx * c1 - ppy * c0
    z2 = ppz * ppz

    d_v1 = ppx * ppx + ppy * ppy + z2
    rx2 = ppx - v2x
    d_v2 = rx2 * rx2 + ppy * ppy + z2
    rx3, ry3 = ppx - v3x, ppy - v3y
    d_v3 = rx3 * rx3 + ry3 * ry3 + z2

    r1 = jnp.where(
        ppx <= 0.0, d_v1, jnp.where(ppx >= v2x, d_v2, de1 * de1 + z2)
    )
    dot_b_v2 = rx2 * b0 + ppy * b1
    dot_b_v3 = rx3 * b0 + ry3 * b1
    r2 = jnp.where(
        dot_b_v2 <= 0.0, d_v2, jnp.where(dot_b_v3 >= 0.0, d_v3, de2 * de2 + z2)
    )
    dot_c_v1 = ppx * c0 + ppy * c1
    dot_c_v3 = rx3 * c0 + ry3 * c1
    r3 = jnp.where(
        dot_c_v1 >= 0.0, d_v1, jnp.where(dot_c_v3 <= 0.0, d_v3, de3 * de3 + z2)
    )
    return jnp.where(
        de1 >= 0.0, r1, jnp.where(de2 >= 0.0, r2, jnp.where(de3 >= 0.0, r3, z2))
    )


def sq_dist_naive_from_cols(px, py, pz, v):
    """Naive 3-vertex squared distance (TriangleUtils.h:383-401) from a
    column accessor: ``v(r)`` returns component r of the vertex-format
    row [ax ay az bx by bz cx cy cz], broadcastable against px/py/pz.
    Same formula as sq_dist_naive, componentized so vertex-format scan
    buckets (9 floats/triangle — 2.1x smaller than the 19-field frame
    rows) evaluate without any relayout. Used for CANDIDATE SELECTION
    only; the winner is re-evaluated with the frame kernel, so parity of
    the final distance holds to fp rounding."""
    ax, ay, az = v(0), v(1), v(2)
    bx, by, bz = v(3), v(4), v(5)
    cx, cy, cz = v(6), v(7), v(8)

    bax, bay, baz = bx - ax, by - ay, bz - az
    pax, pay, paz = px - ax, py - ay, pz - az
    cbx, cby, cbz = cx - bx, cy - by, cz - bz
    pbx, pby, pbz = px - bx, py - by, pz - bz
    acx, acy, acz = ax - cx, ay - cy, az - cz
    pcx, pcy, pcz = px - cx, py - cy, pz - cz

    nx = bay * acz - baz * acy
    ny = baz * acx - bax * acz
    nz = bax * acy - bay * acx

    def edge(ex, ey, ez, rx, ry, rz):
        ee = ex * ex + ey * ey + ez * ez
        t = jnp.clip((ex * rx + ey * ry + ez * rz) / ee, 0.0, 1.0)
        dx = ex * t - rx
        dy = ey * t - ry
        dz = ez * t - rz
        return dx * dx + dy * dy + dz * dz

    def side(ex, ey, ez, rx, ry, rz):
        # sign(dot(cross(edge, normal), rel))
        sx = ey * nz - ez * ny
        sy = ez * nx - ex * nz
        sz = ex * ny - ey * nx
        return jnp.sign(sx * rx + sy * ry + sz * rz)

    outside = (
        side(bax, bay, baz, pax, pay, paz)
        + side(cbx, cby, cbz, pbx, pby, pbz)
        + side(acx, acy, acz, pcx, pcy, pcz)
    ) < 2.0
    edge_d = jnp.minimum(
        jnp.minimum(
            edge(bax, bay, baz, pax, pay, paz),
            edge(cbx, cby, cbz, pbx, pby, pbz),
        ),
        edge(acx, acy, acz, pcx, pcy, pcz),
    )
    dn = nx * pax + ny * pay + nz * paz
    n2 = nx * nx + ny * ny + nz * nz
    face_d = dn * dn / n2
    return jnp.where(outside, edge_d, face_d)


def sq_dist_naive(p, a, b, c):
    """Naive 3-vertex formula (TriangleUtils.h:383-401) — the property-test
    oracle used by the reference's TriangleDistanceTest. Broadcasts over
    leading batch dims of p/a/b/c."""
    ba, pa = b - a, p - a
    cb, pb = c - b, p - b
    ac, pc = a - c, p - c
    normal = jnp.cross(ba, ac)

    def d2(v):
        return _dot(v, v)

    def edge(e, rel):
        t = jnp.clip(_dot(e, rel) / d2(e), 0.0, 1.0)
        return d2(e * t[..., None] - rel)

    outside = (
        jnp.sign(_dot(jnp.cross(ba, normal), pa))
        + jnp.sign(_dot(jnp.cross(cb, normal), pb))
        + jnp.sign(_dot(jnp.cross(ac, normal), pc))
    ) < 2.0
    edge_d = jnp.minimum(
        jnp.minimum(edge(ba, pa), edge(cb, pb)), edge(ac, pc)
    )
    face_d = _dot(normal, pa) * _dot(normal, pa) / d2(normal)
    return jnp.where(outside, edge_d, face_d)


# ---------------------------------------------------------------------------
# Brute-force reductions (RealSdf oracle)
# ---------------------------------------------------------------------------

_sq_dist_pt = jax.vmap(sq_dist_pair, in_axes=(None, 0))           # point vs T tris
_sq_dist_grid = jax.vmap(_sq_dist_pt, in_axes=(0, None))          # P points vs T


def _pad_tris(tris: TriangleDataSoA, chunk: int):
    T = tris.num_triangles
    n_chunks = max(1, -(-T // chunk))
    pad = n_chunks * chunk - T

    def _pad(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(jnp.asarray(x), widths)

    padded = TriangleDataSoA(*(_pad(f) for f in tris))
    reshaped = TriangleDataSoA(
        *(f.reshape((n_chunks, chunk) + f.shape[1:]) for f in padded)
    )
    return reshaped, T, pad


@partial(jax.jit, static_argnames=("chunk",))
def nearest_triangle(points, tris: TriangleDataSoA, chunk: int = 512):
    """For each point, the (squared distance, index) of the nearest triangle.

    Scans triangle chunks with a running min to bound memory at
    P*chunk floats. Ties: lowest triangle index wins, matching the strict
    ``<`` update in the reference (OctreeSdfUtils.h:24).
    """
    points = jnp.asarray(points)
    P = points.shape[0]
    chunked, T, pad = _pad_tris(tris, chunk)
    n_chunks = chunked.origin.shape[0]

    def body(carry, args):
        best, bidx = carry
        tri_chunk, chunk_i = args
        d = _sq_dist_grid(points, tri_chunk)  # (P, chunk)
        # Mask padded triangles
        tri_ids = chunk_i * chunk + jnp.arange(chunk)
        d = jnp.where(tri_ids[None, :] < T, d, jnp.inf)
        local_best = jnp.min(d, axis=1)
        local_idx = jnp.argmin(d, axis=1) + chunk_i * chunk
        take = local_best < best
        return (
            jnp.where(take, local_best, best),
            jnp.where(take, local_idx, bidx),
        ), None

    init = (jnp.full((P,), jnp.inf, points.dtype), jnp.zeros((P,), jnp.int32))
    (best, bidx), _ = jax.lax.scan(
        body, init, (chunked, jnp.arange(n_chunks, dtype=jnp.int32))
    )
    return best, bidx


def _gather_tris(tris: TriangleDataSoA, idx):
    return TriangleDataSoA(*(jnp.asarray(f)[idx] for f in tris))


def _on_one_gpu(points) -> bool:
    """True when ``points`` lives on exactly one GPU: where the Triton
    kernel compiles and needs no partitioning. Numpy inputs go to the
    default device; tracers and multi-device arrays stay on XLA."""
    if isinstance(points, jax.core.Tracer):
        return False
    if isinstance(points, jax.Array):
        devs = points.devices()
    else:
        dev = jax.config.jax_default_device or jax.devices()[0]
        if isinstance(dev, str):
            return dev == "gpu" or dev == "cuda"
        devs = {dev}
    return len(devs) == 1 and next(iter(devs)).platform == "gpu"


def _nearest_dispatch(points, tris: TriangleDataSoA, chunk: int, impl: str):
    """impl: "auto" (the fused Triton kernel of ops/pallas_kernels.py for
    points on one GPU, where it was measured faster; the XLA scan above
    otherwise), "pallas" (compiled for the GPU; fails elsewhere) or
    "xla"."""
    if impl == "auto":
        impl = "pallas" if _on_one_gpu(points) else "xla"
    if impl == "pallas":
        from .pallas_kernels import nearest_triangle_pallas

        return nearest_triangle_pallas(points, tris)
    if impl != "xla":
        raise ValueError(f"unknown nearest-triangle impl {impl!r}")
    return nearest_triangle(points, tris, chunk=chunk)


@jax.jit
def _eval_winner_signed(points, tris: TriangleDataSoA, idx):
    return jax.vmap(signed_dist_pair)(
        jnp.asarray(points), _gather_tris(tris, idx)
    )


@jax.jit
def _eval_winner_signed_grad(points, tris: TriangleDataSoA, idx):
    return jax.vmap(signed_dist_grad_pair)(
        jnp.asarray(points), _gather_tris(tris, idx)
    )


def signed_distance_batch(
    points, tris: TriangleDataSoA, chunk: int = 512, impl: str = "auto",
):
    """Exact signed distance for a batch of points (RealSdf.cpp:10-25)."""
    _, idx = _nearest_dispatch(points, tris, chunk, impl)
    return _eval_winner_signed(points, tris, idx)


def signed_distance_grad_batch(
    points, tris: TriangleDataSoA, chunk: int = 512, impl: str = "auto",
):
    """Exact signed distance + analytic gradient for a batch of points."""
    _, idx = _nearest_dispatch(points, tris, chunk, impl)
    return _eval_winner_signed_grad(points, tris, idx)
