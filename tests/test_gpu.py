"""Checks that need the card: each compares a GPU result with a plain
reference. They skip on the CPU (the ``gpu`` fixture decides, at run
time); ``python chip_smoke.py`` runs them on the GPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdflib_tpu.ops.point_triangle import (
    nearest_triangle,
    pack_triangle_fields,
)
from sdflib_tpu.triangle import calculate_mesh_triangle_data
from sdflib_tpu.utils.primitives import make_torus

pytestmark = pytest.mark.gpu


def _torus_tris(nu, nv, device):
    soa = calculate_mesh_triangle_data(make_torus(R=0.3, r=0.12, nu=nu, nv=nv))
    return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), device), soa)


def test_nearest_kernel_compiled_matches_xla(gpu):
    """The Triton-route kernel, compiled for the card, against XLA's
    chunked scan on the same card (same formula: squared distances to
    float32 rounding; winners may differ only on exact ties)."""
    from sdflib_tpu.ops.pallas_kernels import nearest_triangle_pallas

    tris = _torus_tris(96, 48, gpu)
    pts = jax.device_put(
        np.random.default_rng(0).uniform(-0.5, 0.5, (1 << 16, 3))
        .astype(np.float32), gpu,
    )
    b0, _ = nearest_triangle(pts, tris)
    b1, _ = nearest_triangle_pallas(pts, tris)
    np.testing.assert_allclose(
        np.asarray(b1), np.asarray(b0), rtol=1e-5, atol=1e-7
    )


def test_precise_cull_gpu_matches_cpu(gpu):
    """The precise cull's keep mask on the card equals the CPU device's:
    its region radii are an exact select, so no TF32 rounding can move a
    candidate across the cull threshold."""
    from sdflib_tpu.sdf.exact_octree import _precise_cull_chunk

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(1)
    C, K = 16, 64
    centers = rng.uniform(-0.3, 0.3, (C, 3)).astype(np.float32)
    cand = rng.integers(0, 288, (C, K)).astype(np.int32)
    valid = np.ones((C, K), bool)
    out = {}
    for dev in (gpu, cpu):
        tris = _torus_tris(24, 12, dev)
        keep, cnt, _ = _precise_cull_chunk(
            pack_triangle_fields(tris), tris.v_world,
            *(jax.device_put(a, dev) for a in (centers, cand, valid)),
            jax.device_put(np.float32(0.06), dev),
        )
        out[dev.platform] = (np.asarray(keep), np.asarray(cnt))
    np.testing.assert_array_equal(out["gpu"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["gpu"][1], out["cpu"][1])


def test_exact_octree_on_gpu_matches_bruteforce(gpu):
    """A small exact octree built and queried on the card returns the
    brute-force distances under both scan backends."""
    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf
    from sdflib_tpu.sdf.real import RealSdf

    mesh = make_torus(R=0.3, r=0.12, nu=32, nv=16)
    box = mesh.bounding_box.add_margin(0.14)
    ex = ExactOctreeSdf(mesh, box, max_depth=4, start_depth=2,
                        min_triangles_per_node=32)
    pts = np.random.default_rng(2).uniform(
        box.min, box.max, (1 << 14, 3)).astype(np.float32)
    ref = np.asarray(RealSdf(mesh).get_distance(pts))
    for impl in ("xla", "xla_window"):
        ex.set_scan_impl(impl)
        np.testing.assert_allclose(
            np.asarray(ex.get_distance(pts)), ref, rtol=0, atol=1e-4
        )
