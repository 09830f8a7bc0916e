"""Box-triangle distance vs sampled ground truth (GJKtest parity,
reference src/tools/GJKtest/main.cpp). The batched implementation enumerates
feature pairs exactly, so tolerances are tight; the Frank-Wolfe variant
is only checked as an upper bound."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdflib_tpu.ops.gjk import (
    box_triangle_distance,
    box_triangle_overlap,
    gjk_is_near,
    gjk_max_distance,
    gjk_min_distance,
)
from sdflib_tpu.ops.point_triangle import sq_dist_naive


def _sampled_min_distance(center, half, tri, n=32):
    """Dense-sample the box, exact point-triangle distance per sample —
    an upper bound converging to the true min distance."""
    t = np.linspace(-1.0, 1.0, n)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    pts = center + np.stack([gx, gy, gz], -1).reshape(-1, 3) * half
    d2 = np.asarray(
        jax.vmap(sq_dist_naive, in_axes=(0, None, None, None))(
            jnp.asarray(pts, jnp.float32),
            jnp.asarray(tri[0]), jnp.asarray(tri[1]), jnp.asarray(tri[2]),
        )
    )
    return float(np.sqrt(d2.min()))


def _random_cases(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    halves = rng.uniform(0.05, 0.4, (n, 1)).astype(np.float32)
    halves = np.broadcast_to(halves, (n, 3)).copy()
    tris = rng.uniform(-1.5, 1.5, (n, 3, 3)).astype(np.float32)
    return centers, halves, tris


def test_exact_distance_vs_sampled_ground_truth():
    centers, halves, tris = _random_cases(0, 64)
    d = np.asarray(box_triangle_distance(centers, halves, tris))
    for i in range(len(centers)):
        d_ref = _sampled_min_distance(centers[i], halves[i], tris[i])
        # exact <= any sampled upper bound; sampling slack is O(half/n)
        slack = float(halves[i][0]) * (2.0 * np.sqrt(3.0) / 31)
        assert d[i] <= d_ref + 1e-5, (i, d[i], d_ref)
        assert d[i] >= d_ref - slack - 1e-4, (i, d[i], d_ref)


def test_overlap_distance_is_exactly_zero():
    center = np.zeros((1, 3), np.float32)
    half = np.full((1, 3), 0.3, np.float32)
    tri = np.array(
        [[[-1.0, 0.0, 0.0], [1.0, 0.1, 0.0], [0.0, 0.0, 1.0]]], np.float32
    )
    assert bool(np.asarray(box_triangle_overlap(center, half, tri))[0])
    assert float(np.asarray(box_triangle_distance(center, half, tri))[0]) == 0.0


def test_separated_axis_case_exact():
    # triangle in plane x = 1, box [-0.5, 0.5]^3: distance exactly 0.5
    center = np.zeros((1, 3), np.float32)
    half = np.full((1, 3), 0.5, np.float32)
    tri = np.array(
        [[[1.0, -1.0, -1.0], [1.0, 2.0, -1.0], [1.0, 0.0, 2.0]]], np.float32
    )
    d = float(np.asarray(box_triangle_distance(center, half, tri))[0])
    assert abs(d - 0.5) < 1e-6, d


def test_edge_edge_case_exact():
    # box [-0.5,0.5]^3; a sliver triangle along (1,1,z): nearest feature is
    # the box corner edge at (0.5, 0.5, z) -> distance sqrt(2)/2
    center = np.zeros((1, 3), np.float32)
    half = np.full((1, 3), 0.5, np.float32)
    tri = np.array(
        [[[1.0, 1.0, -2.0], [1.0, 1.0, 2.0], [1.0, 1.001, 0.0]]], np.float32
    )
    d = float(np.asarray(box_triangle_distance(center, half, tri))[0])
    assert abs(d - np.sqrt(0.5)) < 1e-3, d


def test_frank_wolfe_is_upper_bound():
    centers, halves, tris = _random_cases(1, 64)
    d_exact = np.asarray(box_triangle_distance(centers, halves, tris))
    d_fw = np.asarray(gjk_min_distance(centers, halves, tris, iterations=15))
    assert np.all(d_fw >= d_exact - 1e-5)


def test_is_near_consistent():
    centers, halves, tris = _random_cases(2, 64)
    d = np.asarray(box_triangle_distance(centers, halves, tris))
    near = np.asarray(gjk_is_near(centers, halves, tris, 0.5))
    np.testing.assert_array_equal(near, d < 0.5)


def test_max_distance_exact():
    center = np.zeros((1, 3), np.float32)
    half = np.full((1, 3), 0.5, np.float32)
    tri = np.array(
        [[[2.0, 0.0, 0.0], [2.5, 0.0, 0.0], [2.0, 0.5, 0.0]]], np.float32
    )
    d = float(np.asarray(gjk_max_distance(center, half, tri))[0])
    # farthest pair: box corner (-0.5,±0.5,±0.5) vs vertex (2.5,0,0)
    expect = np.sqrt(3.0**2 + 0.5**2 + 0.5**2)
    assert abs(d - expect) < 1e-5
