"""Pallas (Triton route) kernel tests, in interpret mode on the CPU.

The compiled kernel is checked on the card by tests/test_gpu.py.

The nearest-triangle kernel must agree with the XLA scan path on squared
distances exactly up to fp32 contraction order; argmin indices may differ
only on last-ulp ties, in which case the signed distances through either
winner must still agree.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdflib_tpu.triangle import TriangleDataSoA, calculate_mesh_triangle_data
from sdflib_tpu.ops.point_triangle import (
    _eval_winner_signed,
    nearest_triangle,
    signed_dist_pair,
    signed_distance_batch,
)
from sdflib_tpu.ops.pallas_kernels import nearest_triangle_pallas
from sdflib_tpu.utils.primitives import make_icosphere, make_torus


@pytest.fixture(scope="module")
def tris():
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    return jax.tree.map(jnp.asarray, calculate_mesh_triangle_data(mesh))


def _gather(tris, idx):
    return TriangleDataSoA(*(jnp.asarray(f)[idx] for f in tris))


def test_pallas_nearest_matches_xla(tris):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    b0, i0 = nearest_triangle(pts, tris)
    b1, i1 = nearest_triangle_pallas(pts, tris, interpret=True)
    np.testing.assert_allclose(
        np.asarray(b0), np.asarray(b1), atol=1e-7, rtol=1e-5
    )
    # tie-broken indices: signed distance through either winner agrees
    d0 = np.asarray(jax.vmap(signed_dist_pair)(jnp.asarray(pts), _gather(tris, i0)))
    d1 = np.asarray(jax.vmap(signed_dist_pair)(jnp.asarray(pts), _gather(tris, i1)))
    np.testing.assert_allclose(d0, d1, atol=1e-6)


def test_pallas_nearest_unaligned_sizes():
    """Point counts not divisible by the tile and tiny triangle counts."""
    mesh = make_torus(R=0.3, r=0.1, nu=7, nv=5)  # 70 triangles
    tris = jax.tree.map(jnp.asarray, calculate_mesh_triangle_data(mesh))
    rng = np.random.default_rng(1)
    for n in (1, 3, 130, 513):
        pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        b0, _ = nearest_triangle(pts, tris)
        b1, _ = nearest_triangle_pallas(pts, tris, interpret=True)
        np.testing.assert_allclose(
            np.asarray(b0), np.asarray(b1), atol=1e-7, rtol=1e-5
        )


def test_signed_distance_batch_impl_dispatch(tris):
    """The kernel's winners, evaluated as signed_distance_batch evaluates
    them, give the XLA sweep's signed distances."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 0.5, (128, 3)).astype(np.float32)
    d_xla = np.asarray(signed_distance_batch(pts, tris, impl="xla"))
    _, idx = nearest_triangle_pallas(pts, tris, interpret=True)
    d_pal = np.asarray(_eval_winner_signed(pts, tris, idx))
    np.testing.assert_allclose(d_xla, d_pal, atol=1e-6)


def test_auto_dispatch_stays_on_xla_off_the_gpu(tris, monkeypatch):
    """On the CPU "auto" takes the XLA sweep and never the kernel."""
    from sdflib_tpu.ops import pallas_kernels

    def boom(*a, **k):
        raise AssertionError("the kernel was chosen off the GPU")

    monkeypatch.setattr(pallas_kernels, "nearest_triangle_pallas", boom)
    pts = np.random.default_rng(3).uniform(-0.5, 0.5, (64, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        np.asarray(signed_distance_batch(pts, tris)),
        np.asarray(signed_distance_batch(pts, tris, impl="xla")),
    )


@pytest.mark.parametrize(
    "impl, on_gpu, kernel_called",
    [("pallas", False, True), ("pallas", True, True), ("auto", True, True),
     ("auto", False, False), ("xla", True, False)],
)
def test_dispatch_never_picks_interpret_mode(tris, monkeypatch, impl,
                                             on_gpu, kernel_called):
    """The dispatch calls the kernel compiled, never in interpret mode;
    "auto" takes the kernel exactly when the points sit on one GPU."""
    from sdflib_tpu.ops import pallas_kernels, point_triangle

    seen = []

    def record(points, t, **kwargs):
        seen.append(kwargs)
        return nearest_triangle(points, t)

    monkeypatch.setattr(pallas_kernels, "nearest_triangle_pallas", record)
    monkeypatch.setattr(point_triangle, "_on_one_gpu", lambda p: on_gpu)
    pts = np.zeros((8, 3), np.float32)
    signed_distance_batch(pts, tris, impl=impl)
    assert seen == ([{}] if kernel_called else [])


def test_dispatch_rejects_unknown_impl(tris):
    with pytest.raises(ValueError, match="impl"):
        signed_distance_batch(np.zeros((4, 3), np.float32), tris, impl="bogus")


def test_kernel_block_sizes_must_be_powers_of_two(tris):
    with pytest.raises(ValueError, match="power of two"):
        nearest_triangle_pallas(np.zeros((4, 3), np.float32), tris,
                                tile_p=48, interpret=True)
