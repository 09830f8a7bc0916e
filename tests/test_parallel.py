"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates that sharded queries/renders/fits match their single-device
results bit-for-bit (pure data parallelism must not change arithmetic)
and that the outputs actually carry the expected shardings.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdflib_tpu import parallel
from sdflib_tpu.diff.query import octree_coefficients
from sdflib_tpu.sdf import RealSdf
from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf
from sdflib_tpu.sdf.octree import OctreeSdf
from sdflib_tpu.utils.primitives import make_icosphere


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return parallel.default_mesh()


@pytest.fixture(scope="module")
def sphere():
    return make_icosphere(subdivisions=2, radius=0.35)


@pytest.fixture(scope="module")
def octree(sphere):
    box = sphere.bounding_box.add_margin(0.14)
    return OctreeSdf(sphere, box, max_depth=4, start_depth=1,
                     termination_threshold=1e-3)


def test_sharded_distance_matches_single_device(octree, mesh8):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.4, 0.4, (1000, 3)).astype(np.float32)  # not %8
    d_single = np.asarray(octree.get_distance(pts))
    d_shard = np.asarray(parallel.sharded_distance(octree, pts, mesh8))
    np.testing.assert_array_equal(d_single, d_shard)


def test_sharded_gradient_matches(octree, mesh8):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.3, 0.3, (256, 3)).astype(np.float32)
    d0, g0 = octree.get_distance_and_gradient(pts)
    d1, g1 = parallel.sharded_distance_and_gradient(octree, pts, mesh8)
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    np.testing.assert_array_equal(np.asarray(g0), np.asarray(g1))


def test_sharded_exact_octree(sphere, mesh8):
    box = sphere.bounding_box.add_margin(0.14)
    ex = ExactOctreeSdf(sphere, box, max_depth=4, start_depth=1,
                        min_triangles_per_node=32)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.4, 0.4, (512, 3)).astype(np.float32)
    d_single = np.asarray(ex.get_distance(pts))
    d_shard = np.asarray(parallel.sharded_distance(ex, pts, mesh8))
    np.testing.assert_array_equal(d_single, d_shard)


def test_sharded_real_sdf(sphere, mesh8):
    real = RealSdf(sphere)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.4, 0.4, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(real.get_distance(pts)),
        np.asarray(parallel.sharded_distance(real, pts, mesh8)),
    )


def test_sharded_trace_matches(octree, mesh8):
    from sdflib_tpu.render.sphere_trace import trace_octree

    rng = np.random.default_rng(4)
    n = 200
    origins = np.tile([[0.0, 0.0, -1.2]], (n, 1)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 2.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    # beam=None on both sides: the prepass reduces across rays, and
    # reduction order differs under sharding (see sharded_trace docstring)
    r0 = trace_octree(octree, origins, dirs, max_iters=128, beam=None)
    r1 = parallel.sharded_trace(octree, origins, dirs, mesh8, max_iters=128)
    np.testing.assert_array_equal(np.asarray(r0.hit), np.asarray(r1.hit))
    np.testing.assert_allclose(
        np.asarray(r0.depth), np.asarray(r1.depth), atol=1e-6
    )


def test_sharded_trace_compiles_once(octree, mesh8):
    """A second call with the same mesh and settings reuses the compiled
    program: a warm sharded_trace compiles nothing."""
    origins = np.tile([[0.0, 0.0, -1.2]], (64, 1)).astype(np.float32)
    origins[:, 0] = np.linspace(-0.3, 0.3, 64)
    dirs = np.tile([[0.0, 0.0, 1.0]], (64, 1)).astype(np.float32)
    r0 = parallel.sharded_trace(octree, origins, dirs, mesh8, max_iters=64)
    compiles = []

    def listen(event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append(duration)

    jax.monitoring.register_event_duration_secs_listener(listen)
    try:
        r1 = parallel.sharded_trace(octree, origins, dirs, mesh8,
                                    max_iters=64)
        jax.block_until_ready(r1.depth)
    finally:
        jax.monitoring.unregister_event_duration_listener(listen)
    assert compiles == []
    np.testing.assert_array_equal(np.asarray(r0.depth), np.asarray(r1.depth))


def test_data_parallel_fit_step_reduces_loss(octree, mesh8):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.35, 0.35, (2048, 3)).astype(np.float32)
    targets = (np.linalg.norm(pts, axis=-1) - 0.35).astype(np.float32)

    coeffs = octree_coefficients(octree.octree_data)
    loss0, coeffs1 = parallel.data_parallel_fit_step(
        octree, coeffs, pts, targets, mesh8, lr=1e-2
    )
    loss1, _ = parallel.data_parallel_fit_step(
        octree, coeffs1, pts, targets, mesh8, lr=1e-2
    )
    assert np.isfinite(float(loss0)) and float(loss1) <= float(loss0)
    # updated coefficients are replicated (gradient was all-reduced)
    assert coeffs1.sharding.is_fully_replicated


def test_scaling_throughput_bounds():
    """Scaling plumbing on the virtual 8-device CPU mesh: all devices
    share the host's cores, so per-device efficiency says nothing, and the
    meaningful assertion is that TOTAL sharded throughput stays close to
    the single-device total (the sharding itself must not shrink the pie)
    — for QUERIES and for RAYS (rays once collapsed 7x under GSPMD while
    queries stayed flat; the shard_map'd fused trace fixes that and this
    bound keeps it fixed). Scaling on GPUs is measured on the cards."""
    import time

    mesh_geo = make_icosphere(subdivisions=1, radius=0.35)
    box = mesh_geo.bounding_box.add_margin(0.12)
    oct_ = OctreeSdf(mesh_geo, box, max_depth=4, start_depth=1,
                     termination_threshold=1e-3)
    oct_.build_query_grid()
    rng = np.random.default_rng(0)
    n = 1 << 18
    pts = rng.uniform(
        oct_.box.min + 1e-4, oct_.box.max - 1e-4, (n, 3)
    ).astype(np.float32)

    nr = 1 << 15
    u = rng.uniform(-0.5, 0.5, (nr, 2)).astype(np.float32)
    origins = np.concatenate([u, np.full((nr, 1), -1.2, np.float32)], -1)
    ray_dirs = np.tile([[0.0, 0.0, 1.0]], (nr, 1)).astype(np.float32)

    devices = jax.devices()
    rates = {}
    ray_rates = {}
    for c in (1, len(devices)):
        m = parallel.default_mesh(devices[:c])
        d = parallel.sharded_distance(oct_, pts, m)
        jax.block_until_ready(d)
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            d = parallel.sharded_distance(oct_, pts, m)
            jax.block_until_ready(d)
            best = min(best, time.perf_counter() - t0)
        rates[c] = n / best

        r = parallel.sharded_trace(oct_, origins, ray_dirs, m, max_iters=256)
        jax.block_until_ready(r.depth)
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            r = parallel.sharded_trace(oct_, origins, ray_dirs, m,
                                       max_iters=256)
            jax.block_until_ready(r.depth)
            best = min(best, time.perf_counter() - t0)
        ray_rates[c] = nr / best
    n_dev = len(devices)
    # shared-core virtual mesh: sharding overhead must not eat the pie
    total = rates[n_dev] / rates[1]
    assert total >= 0.35, f"sharded query total collapsed to {total:.2%}"
    rtotal = ray_rates[n_dev] / ray_rates[1]
    assert rtotal >= 0.35, f"sharded ray total collapsed to {rtotal:.2%}"


def test_sharded_exact_query_id_only_structure():
    """Id-only structures (bucket tables over the byte budget) never
    materialize bucket_ids; the sharded query's device-put must still
    carry the CSR fallback's tri_flat (r5 review finding)."""
    mesh_geo = make_icosphere(subdivisions=1, radius=0.35)
    box = mesh_geo.bounding_box.add_margin(0.12)
    ex = ExactOctreeSdf(mesh_geo, box, max_depth=3, start_depth=1,
                        min_triangles_per_node=16, bucket_byte_budget=0)
    assert ex.bucket_fields is None and ex.bucket_ids is None
    mesh8 = parallel.default_mesh(jax.devices())
    rng = np.random.default_rng(2)
    pts = rng.uniform(ex.box.min + 1e-4, ex.box.max - 1e-4,
                      (1 << 12, 3)).astype(np.float32)
    d_single = np.asarray(ex.get_distance(pts))
    d_shard = np.asarray(parallel.sharded_distance(ex, pts, mesh8))
    np.testing.assert_array_equal(d_single, d_shard)
