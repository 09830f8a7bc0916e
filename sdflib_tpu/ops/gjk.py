"""Batched convex distance tests (GJK role): box-vs-triangle culling
predicates.

JAX re-design of the reference GJK module
(reference: src/utils/GJK.cpp — simplex GJK :9-310, box-triangle
``getMinDistance`` :476-517, and the Frank-Wolfe style ``IsNearMinimize``
:564-600 capped at 15 iterations, the variant the influence strategies
actually call, TrianglesInfluence.h:149,438,822).

Neither branchy simplex GJK nor capped Frank-Wolfe (which zig-zags
sublinearly when the solution lies in a face interior) suits a vector
machine. Instead the box-triangle distance is computed EXACTLY by
complete feature-pair enumeration — the closest pair between convex
polyhedra is always realized vertex-vs-face or edge-vs-edge, so

    d = min( 3 triangle-vertex-to-box distances,
             8 box-vertex-to-triangle distances,
             36 triangle-edge-to-box-edge distances )
    (= 0 when the 13-axis SAT test reports overlap)

with every term a closed form and the whole batch elementwise fp32. This is *tighter* than the reference's 15-iteration bound at similar
cost. The Frank-Wolfe minimizer is kept for general convex hulls (the
influence-region tests over box (+) per-vertex-radius hulls,
GJK.cpp:661-867).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .point_triangle import sq_dist_naive

__all__ = [
    "box_triangle_distance",
    "box_triangle_overlap",
    "gjk_min_distance",
    "gjk_is_near",
    "gjk_max_distance",
    "minkowski_box_triangle",
    "frank_wolfe_min_norm",
    "corner_sphere_hull_tri_lower",
    "GJK_ITERATIONS",
]

# Box corner signs in {-1,1}^3, corner index c = cx + 2cy + 4cz.
_BOX_SIGNS = np.array(
    [[(c & 1) * 2 - 1, ((c >> 1) & 1) * 2 - 1, ((c >> 2) & 1) * 2 - 1]
     for c in range(8)],
    np.float32,
)

# The 12 box edges as (corner index, axis) pairs.
_BOX_EDGES = [
    (c, ax)
    for ax in range(3)
    for c in range(8)
    if not (c >> ax) & 1
]
assert len(_BOX_EDGES) == 12

GJK_ITERATIONS = 15  # reference cap (GJK.cpp:567)


def _point_box_sq(p, half):
    """Squared distance from box-centered point p (..., 3) to the origin
    box with half extents half (..., 3)."""
    q = jnp.maximum(jnp.abs(p) - half, 0.0)
    return jnp.sum(q * q, axis=-1)


def _seg_seg_sq(p1, d1, p2, d2):
    """Squared distance between segments p1+t*d1 and p2+s*d2, t,s in [0,1]
    (Ericson, Real-Time Collision Detection 5.1.9, branchless)."""
    r = p1 - p2
    a = jnp.sum(d1 * d1, axis=-1)
    e = jnp.sum(d2 * d2, axis=-1)
    f = jnp.sum(d2 * r, axis=-1)
    c = jnp.sum(d1 * r, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    denom = a * e - b * b

    t = jnp.where(denom > 1e-20, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-20), 0.0, 1.0), 0.0)
    s = (b * t + f) / jnp.maximum(e, 1e-20)
    s_cl = jnp.clip(s, 0.0, 1.0)
    # re-optimize t for clamped s
    t2 = jnp.clip((b * s_cl - c) / jnp.maximum(a, 1e-20), 0.0, 1.0)
    t = jnp.where((s < 0.0) | (s > 1.0), t2, t)
    s = s_cl

    diff = (p1 + d1 * t[..., None]) - (p2 + d2 * s[..., None])
    return jnp.sum(diff * diff, axis=-1)


def box_triangle_overlap(box_center, box_half, tri_verts):
    """13-axis separating-axis test (Akenine-Moller), batched elementwise.

    True when the triangle intersects the axis-aligned box."""
    c = jnp.asarray(box_center, jnp.float32)
    h = jnp.broadcast_to(jnp.asarray(box_half, jnp.float32), c.shape)
    v = jnp.asarray(tri_verts, jnp.float32) - c[..., None, :]  # (..., 3, 3)

    sep = jnp.zeros(c.shape[:-1], bool)

    # 3 box axes
    for ax in range(3):
        lo = jnp.min(v[..., :, ax], axis=-1)
        hi = jnp.max(v[..., :, ax], axis=-1)
        sep = sep | (lo > h[..., ax]) | (hi < -h[..., ax])

    # triangle normal axis
    e0 = v[..., 1, :] - v[..., 0, :]
    e1 = v[..., 2, :] - v[..., 1, :]
    n = jnp.cross(e0, e1)
    d = jnp.sum(n * v[..., 0, :], axis=-1)
    r = jnp.sum(h * jnp.abs(n), axis=-1)
    sep = sep | (jnp.abs(d) > r)

    # 9 cross-product axes: a = e_i x unit_j
    e2 = v[..., 0, :] - v[..., 2, :]
    for e in (e0, e1, e2):
        for j in range(3):
            unit = jnp.zeros(3, jnp.float32).at[j].set(1.0)
            a = jnp.cross(e, jnp.broadcast_to(unit, e.shape))
            p = jnp.sum(v * a[..., None, :], axis=-1)  # (..., 3)
            lo = jnp.min(p, axis=-1)
            hi = jnp.max(p, axis=-1)
            ra = jnp.sum(h * jnp.abs(a), axis=-1)
            sep = sep | (lo > ra) | (hi < -ra)

    return ~sep


@jax.jit
def box_triangle_distance(box_center, box_half, tri_verts):
    """EXACT min distance between an axis-aligned box and a triangle
    (0 when overlapping), via complete feature-pair enumeration. Batched
    over leading dims; box_half broadcastable to (..., 3)."""
    c = jnp.asarray(box_center, jnp.float32)
    h = jnp.broadcast_to(jnp.asarray(box_half, jnp.float32), c.shape)
    v = jnp.asarray(tri_verts, jnp.float32) - c[..., None, :]  # box frame

    best = jnp.full(c.shape[:-1], jnp.inf, jnp.float32)

    # (a) triangle vertices vs box
    for i in range(3):
        best = jnp.minimum(best, _point_box_sq(v[..., i, :], h))

    # (b) box vertices vs triangle
    corners = jnp.asarray(_BOX_SIGNS) * h[..., None, :]       # (..., 8, 3)
    for k in range(8):
        best = jnp.minimum(
            best,
            sq_dist_naive(
                corners[..., k, :], v[..., 0, :], v[..., 1, :], v[..., 2, :]
            ),
        )

    # (c) triangle edges vs box edges
    tri_starts = (v[..., 0, :], v[..., 1, :], v[..., 2, :])
    tri_dirs = (
        v[..., 1, :] - v[..., 0, :],
        v[..., 2, :] - v[..., 1, :],
        v[..., 0, :] - v[..., 2, :],
    )
    for corner, ax in _BOX_EDGES:
        p2 = jnp.asarray(_BOX_SIGNS[corner]) * h
        d2 = jnp.zeros(3, jnp.float32).at[ax].set(2.0) * h
        for p1, d1 in zip(tri_starts, tri_dirs):
            best = jnp.minimum(
                best,
                _seg_seg_sq(
                    p1, d1, p2, jnp.broadcast_to(d2, p1.shape)
                ),
            )

    dist = jnp.sqrt(best)
    zero = jnp.zeros_like(dist)
    return jnp.where(
        box_triangle_overlap(box_center, box_half, tri_verts), zero, dist
    )


# ---------------------------------------------------------------------------
# Frank-Wolfe minimizer over general convex hulls (influence-region tests)
# ---------------------------------------------------------------------------

def minkowski_box_triangle(box_center, box_half, tri_verts):
    """Vertices of box (-) triangle: (..., 24, 3)."""
    box_center = jnp.asarray(box_center, jnp.float32)
    tri_verts = jnp.asarray(tri_verts, jnp.float32)
    half = jnp.broadcast_to(
        jnp.asarray(box_half, jnp.float32), box_center.shape
    )
    corners = (
        box_center[..., None, :] + jnp.asarray(_BOX_SIGNS) * half[..., None, :]
    )  # (..., 8, 3)
    diff = corners[..., :, None, :] - tri_verts[..., None, :, :]
    return diff.reshape(diff.shape[:-3] + (24, 3))


def frank_wolfe_min_norm(verts, iterations: int = GJK_ITERATIONS):
    """min_{x in conv(verts)} |x| via fixed-iteration Frank-Wolfe with
    exact line search: an UPPER bound on the true distance, the batched
    equivalent of the reference's IsNearMinimize loop (GJK.cpp:564-600).
    verts (..., V, 3) -> (...,)."""
    x = verts[..., 0, :]

    def body(_, x):
        dots = jnp.sum(verts * x[..., None, :], axis=-1)      # (..., V)
        best = jnp.argmin(dots, axis=-1)
        oh = best[..., None] == jnp.arange(verts.shape[-2])
        s = jnp.sum(jnp.where(oh[..., None], verts, 0.0), axis=-2)
        d = s - x
        dd = jnp.sum(d * d, axis=-1)
        gamma = jnp.where(
            dd > 0.0,
            jnp.clip(
                -jnp.sum(x * d, axis=-1) / jnp.maximum(dd, 1e-30), 0.0, 1.0
            ),
            0.0,
        )
        return x + gamma[..., None] * d

    x = jax.lax.fori_loop(0, iterations, body, x)
    return jnp.sqrt(jnp.sum(x * x, axis=-1))


@partial(jax.jit, static_argnames=("iterations",))
def gjk_min_distance(
    box_center, box_half, tri_verts, iterations: int | None = None
):
    """Box-triangle min distance. Exact by default; pass ``iterations`` to
    use the reference-parity Frank-Wolfe upper bound instead."""
    if iterations is None:
        return box_triangle_distance(box_center, box_half, tri_verts)
    return frank_wolfe_min_norm(
        minkowski_box_triangle(box_center, box_half, tri_verts), iterations
    )


@jax.jit
def gjk_is_near(box_center, box_half, tri_verts, threshold):
    """IsNearMinimize role (GJK.cpp:564-600): True when the box-triangle
    distance is below threshold — exact here, so no missed-near cases."""
    return box_triangle_distance(
        box_center, box_half, tri_verts
    ) < jnp.asarray(threshold, jnp.float32)


@jax.jit
def gjk_max_distance(box_center, box_half, tri_verts):
    """Exact max distance between box and triangle: attained at vertices
    of both convex hulls (getMinMaxDistance role, GJK.cpp:617)."""
    diff = minkowski_box_triangle(box_center, box_half, tri_verts)
    return jnp.sqrt(jnp.max(jnp.sum(diff * diff, axis=-1), axis=-1))


def corner_sphere_hull_tri_lower(
    center, half, radii, tri_verts, iterations: int = GJK_ITERATIONS
):
    """LOWER bound on dist(conv(tri_verts), H) where H is the convex hull
    of eight spheres centered at the node corners with per-corner radii —
    the box (+) per-vertex-radius influence hulls of the reference's
    Precise/PerVertex strategies (GJK.cpp:661-867 isInsideConvexHull /
    IsNearMinimize over vertices+radius support points).

    Frank-Wolfe over D = conv(tri) (-) H with the standard dual bound:
    for any iterate x != 0 and LMO vertex v, every y in D satisfies
    |y| >= (x . v)/|x|; the max of that bound over iterations is returned.
    The linear oracle needs only the support of H,
    S_H(g) = max_c (corner_c . g + r_c |g|) — no explicit sphere
    tessellation. A lower bound makes the CULL decision conservative
    (only provably-outside triangles are dropped), unlike the reference's
    upper-bound Frank-Wolfe which can over-cull below its 15-iteration
    convergence; exactness tests therefore remain strict.

    center (..., 3), half scalar, radii (..., 8), tri_verts (..., 3, 3)
    -> (...,). Negative values mean "possibly intersecting".
    """
    center = jnp.asarray(center, jnp.float32)
    tri_verts = jnp.asarray(tri_verts, jnp.float32)
    radii = jnp.asarray(radii, jnp.float32)
    corners = (
        center[..., None, :]
        + jnp.asarray(_BOX_SIGNS) * jnp.asarray(half, jnp.float32)
    )  # (..., 8, 3)

    x0 = jnp.mean(tri_verts, axis=-2) - center  # centroid - center: in D
    big_neg = jnp.asarray(-jnp.inf, jnp.float32)

    def body(_, carry):
        x, best = carry
        xn = jnp.sqrt(jnp.sum(x * x, axis=-1))
        safe = jnp.maximum(xn, 1e-30)
        # LMO over D: nearest triangle vertex minus farthest hull point.
        td = jnp.sum(tri_verts * x[..., None, :], axis=-1)      # (..., 3)
        t_oh = (
            jnp.argmin(td, axis=-1)[..., None]
            == jnp.arange(3)
        )
        a = jnp.sum(jnp.where(t_oh[..., None], tri_verts, 0.0), axis=-2)
        hd = jnp.sum(corners * x[..., None, :], axis=-1) + radii * xn[..., None]
        h_oh = (
            jnp.argmax(hd, axis=-1)[..., None]
            == jnp.arange(8)
        )
        b_corner = jnp.sum(jnp.where(h_oh[..., None], corners, 0.0), axis=-2)
        b_r = jnp.sum(jnp.where(h_oh, radii, 0.0), axis=-1)
        v = a - b_corner - b_r[..., None] * (x / safe[..., None])
        lower = jnp.sum(x * v, axis=-1) / safe
        best = jnp.maximum(best, jnp.where(xn > 1e-20, lower, big_neg))
        # FW step with exact line search toward v.
        d = v - x
        dd = jnp.sum(d * d, axis=-1)
        gamma = jnp.where(
            dd > 0.0,
            jnp.clip(
                -jnp.sum(x * d, axis=-1) / jnp.maximum(dd, 1e-30), 0.0, 1.0
            ),
            0.0,
        )
        return x + gamma[..., None] * d, best

    _, best = jax.lax.fori_loop(
        0, iterations, body,
        (x0, jnp.full(x0.shape[:-1], big_neg, jnp.float32)),
    )
    return best
