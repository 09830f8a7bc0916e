"""ExactOctreeSdf: queries must be EXACTLY the brute-force oracle.

This is the core exactness guarantee of the influence-superset method: the
leaf triangle lists must contain the nearest triangle for every point in
the leaf, so octree queries equal RealSdf everywhere in the domain.
"""
import numpy as np
import pytest

from sdflib_tpu.sdf import RealSdf, SdfFunction
from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf
from sdflib_tpu.utils.primitives import make_icosphere, make_torus


@pytest.fixture(scope="module")
def mesh():
    # subdivisions=2 (1280 tris): the deep-tree regime is covered by
    # max_depth=5 with a small min-triangles cutoff; subdivisions=3 was
    # measured 4x the build time for no extra code paths.
    return make_icosphere(subdivisions=2, radius=0.35)


@pytest.fixture(scope="module")
def exact(mesh):
    box = mesh.bounding_box.add_margin(0.14)
    return ExactOctreeSdf(
        mesh, box, max_depth=5, start_depth=2, min_triangles_per_node=16
    )


@pytest.fixture(scope="module")
def real(mesh):
    return RealSdf(mesh)


def test_exact_matches_oracle_everywhere(exact, real):
    rng = np.random.default_rng(0)
    lo = exact.box.min + 1e-4
    hi = exact.box.max - 1e-4
    pts = rng.uniform(lo, hi, (4096, 3)).astype(np.float32)
    d_e = np.asarray(exact.get_distance(pts))
    d_r = np.asarray(real.get_distance(pts))
    np.testing.assert_allclose(d_e, d_r, rtol=1e-5, atol=1e-6)


def test_exact_near_surface(exact, real, mesh):
    """Points right at the surface — the regime where wrong culling or sign
    flips would show."""
    rng = np.random.default_rng(1)
    v = mesh.vertices[rng.integers(0, mesh.num_vertices, 512)]
    noise = rng.normal(0, 0.01, v.shape).astype(np.float32)
    pts = (v + noise).astype(np.float32)
    d_e = np.asarray(exact.get_distance(pts))
    d_r = np.asarray(real.get_distance(pts))
    np.testing.assert_allclose(d_e, d_r, rtol=1e-5, atol=1e-6)


def test_exact_gradients_match_oracle(exact, real):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.4, 0.4, (512, 3)).astype(np.float32)
    d_e, g_e = exact.get_distance_and_gradient(pts)
    d_r, g_r = real.get_distance_and_gradient(pts)
    np.testing.assert_allclose(np.asarray(d_e), np.asarray(d_r), rtol=1e-5, atol=1e-6)
    # Gradients can differ only on argmin ties between adjacent triangles
    same = np.isclose(np.asarray(g_e), np.asarray(g_r), atol=1e-5).all(axis=-1)
    assert same.mean() > 0.97


def test_exact_out_of_box_fallback(exact):
    """Outside: box distance + sqrt(3)*box_size (ExactOctreeSdf.cpp:44-49)."""
    pts = np.array([[5.0, 0.0, 0.0], [-2.0, 3.0, 1.0]], np.float32)
    d = np.asarray(exact.get_distance(pts))
    center = exact.box.center
    halfs = 0.5 * exact.box.size
    q = np.abs(pts - center) - halfs
    box_d = np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(axis=-1), 0)
    expected = box_d + np.sqrt(3.0) * exact.box.size[0]
    np.testing.assert_allclose(d, expected, rtol=1e-5)


def test_exact_leaf_stats(exact):
    tpl = exact.build_stats["tris_per_leaf"]
    assert len(tpl) > 0
    counts = np.asarray(exact.leaf_count)
    assert max(tpl) == counts.max()
    # CSR memory is O(total kept triangles), not O(leaves * max_count)
    assert exact.tri_flat.size <= 2 * sum(tpl) + 64 * len(tpl)


def test_exact_save_load_roundtrip(tmp_path, exact):
    path = str(tmp_path / "exact.npz")
    exact.save(path)
    loaded = SdfFunction.load(path)
    assert isinstance(loaded, ExactOctreeSdf)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.4, 0.4, (256, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(loaded.get_distance(pts)), np.asarray(exact.get_distance(pts))
    )


def test_exact_torus():
    mesh = make_torus(R=0.3, r=0.12, nu=32, nv=16)
    box = mesh.bounding_box.add_margin(0.1)
    exact = ExactOctreeSdf(mesh, box, max_depth=4, start_depth=1,
                           min_triangles_per_node=16)
    real = RealSdf(mesh)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.4, 0.4, (1024, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(exact.get_distance(pts)),
        np.asarray(real.get_distance(pts)),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize(
    "strategy", ["lattice", "region", "basic", "precise", "per_vertex"]
)
def test_strategies_stay_exact(strategy):
    """Exactness must hold under every culling strategy; the torus's
    equidistant shells are the adversarial case for loose/tight culls.
    The GJK-hull strategies (precise/per_vertex) pay a region factor per
    candidate pair, so they run on a smaller case to keep the suite
    fast — the criterion is exercised identically."""
    small = strategy not in ("lattice", "region")  # defaults: full-size
    mesh = make_torus(
        R=0.3, r=0.12, nu=16 if small else 24, nv=8 if small else 12
    )
    box = mesh.bounding_box.add_margin(0.14)
    ex = ExactOctreeSdf(
        mesh, box, max_depth=3 if small else 4, start_depth=1,
        min_triangles_per_node=16, strategy=strategy,
    )
    real = RealSdf(mesh)
    rng = np.random.default_rng(5)
    pts = rng.uniform(ex.box.min + 1e-4, ex.box.max - 1e-4, (2048, 3)).astype(
        np.float32
    )
    np.testing.assert_allclose(
        np.asarray(ex.get_distance(pts)),
        np.asarray(real.get_distance(pts)),
        rtol=1e-5, atol=1e-6,
    )


def test_futility_none_reference_shaped_tree():
    """futility=None disables the house futility rule: subdivision stops
    only at min-triangles or max-depth (the reference's rules,
    ExactOctreeSdfDepthFirst.h:299-302). The resulting tree must be at
    least as deep/large as the futility-shaped one and queries must stay
    exact."""
    mesh = make_torus(R=0.3, r=0.12, nu=20, nv=10)
    box = mesh.bounding_box.add_margin(0.14)
    kw = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
    fut = ExactOctreeSdf(mesh, box, futility=0.8, **kw)
    ref = ExactOctreeSdf(mesh, box, futility=None, **kw)
    # Reference-shaped trees never terminate early, so every leaf with
    # more than min_triangles sits at max_depth; the tree has at least as
    # many leaves as the futility-shaped one.
    assert len(ref.build_stats["tris_per_leaf"]) >= len(
        fut.build_stats["tris_per_leaf"]
    )
    assert ref.build_stats["nodes_per_depth"].get(4, 0) > 0  # reaches max depth
    real = RealSdf(mesh)
    rng = np.random.default_rng(11)
    pts = rng.uniform(ref.box.min + 1e-4, ref.box.max - 1e-4, (2048, 3)).astype(
        np.float32
    )
    d_ref = np.asarray(real.get_distance(pts))
    np.testing.assert_allclose(
        np.asarray(ref.get_distance(pts)), d_ref, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(fut.get_distance(pts)), d_ref, rtol=1e-5, atol=1e-6
    )


def test_lattice_tighter_than_basic():
    """The house lattice cull must produce lists at least as tight as the
    reference Basic criterion (that's its reason to exist), and the
    default region cull (the reference's own default strategy,
    re-derived) must be tighter still — its relative envelope test is
    the r5 fix for the 17x list bloat vs the reference at depth 7."""
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    box = mesh.bounding_box.add_margin(0.14)
    kw = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
    lat = ExactOctreeSdf(mesh, box, strategy="lattice", **kw)
    bas = ExactOctreeSdf(mesh, box, strategy="basic", **kw)
    reg = ExactOctreeSdf(mesh, box, strategy="region", **kw)
    mean_lat = np.mean(lat.build_stats["tris_per_leaf"])
    mean_bas = np.mean(bas.build_stats["tris_per_leaf"])
    mean_reg = np.mean(reg.build_stats["tris_per_leaf"])
    assert mean_lat <= mean_bas * 1.05, (mean_lat, mean_bas)
    assert mean_reg <= mean_lat * 0.85, (mean_reg, mean_lat)


def test_scan_chunk_rechunk_matches():
    """Re-chunking the bucket tables must not change query results."""
    mesh = make_icosphere(subdivisions=1, radius=0.35)
    box = mesh.bounding_box.add_margin(0.14)
    ex = ExactOctreeSdf(
        mesh, box, max_depth=4, start_depth=1, min_triangles_per_node=16
    )
    rng = np.random.default_rng(6)
    pts = rng.uniform(ex.box.min + 1e-4, ex.box.max - 1e-4, (2048, 3)).astype(
        np.float32
    )
    d64 = np.asarray(ex.get_distance(pts))
    ex.set_scan_chunk(16)
    d16 = np.asarray(ex.get_distance(pts))
    np.testing.assert_array_equal(d64, d16)


def test_vertex_format_tier_stays_exact(monkeypatch):
    """When 19-field buckets exceed the byte budget, the 9-float vertex
    tier must keep queries exact (naive-formula selection + frame-kernel
    finish)."""
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    box = mesh.bounding_box.add_margin(0.14)
    kw = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
    full = ExactOctreeSdf(mesh, box, **kw)
    slots = int(full.bucket_ids.size)
    # budget fits 9-float rows but not 19-field rows
    monkeypatch.setattr(
        ExactOctreeSdf, "_BUCKET_BYTE_BUDGET", slots * 4 * 12
    )
    vex = ExactOctreeSdf(mesh, box, **kw)
    assert vex.bucket_fields is not None
    assert vex.bucket_fields.shape[1] == 9 * vex.scan_chunk

    real = RealSdf(mesh)
    rng = np.random.default_rng(9)
    pts = rng.uniform(vex.box.min + 1e-4, vex.box.max - 1e-4, (4096, 3)).astype(
        np.float32
    )
    np.testing.assert_allclose(
        np.asarray(vex.get_distance(pts)),
        np.asarray(real.get_distance(pts)),
        rtol=1e-5, atol=2e-6,
    )


def test_nonmanifold_seam_mesh_build_and_query():
    """End-to-end build + exact query on a duplicated-seam mesh: the
    union-find vertex merge (triangle.py, reference
    TriangleUtils.cpp:292-420) must feed correct pseudonormals through a
    whole build, not just the kernel property tests."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    from make_goldens import non_manifold_fin_mesh

    mesh = non_manifold_fin_mesh()
    box = mesh.bounding_box.add_margin(0.14)
    ex = ExactOctreeSdf(
        mesh, box, max_depth=4, start_depth=1, min_triangles_per_node=16
    )
    real = RealSdf(mesh)
    rng = np.random.default_rng(21)
    pts = rng.uniform(ex.box.min + 1e-4, ex.box.max - 1e-4, (4096, 3)).astype(
        np.float32
    )
    d_e = np.asarray(ex.get_distance(pts))
    d_r = np.asarray(real.get_distance(pts))
    np.testing.assert_allclose(d_e, d_r, rtol=1e-5, atol=1e-6)
    # signs must be coherent (inside negative): probe the tube center ring
    inside = np.stack([np.full(8, 0.3), np.zeros(8), np.zeros(8)], -1).astype(
        np.float32
    )
    assert np.all(np.asarray(ex.get_distance(inside)) < 0)


def test_streamed_build_matches_unstreamed():
    """A tiny entry_budget forces the builder to stream node groups
    through row-slice splits (the d7/100k-triangle memory path); the
    emitted structure and distances must be identical to the one-shot
    build."""
    mesh = make_torus(R=0.3, r=0.12, nu=24, nv=12)
    box = mesh.bounding_box.add_margin(0.14)
    kw = dict(max_depth=4, start_depth=1, min_triangles_per_node=16)
    one = ExactOctreeSdf(mesh, box, **kw)
    streamed = ExactOctreeSdf(mesh, box, entry_budget=1 << 12, **kw)
    assert streamed.build_stats["build_splits"] > 0
    # slices allocate child blocks in their own order, so the flat array
    # is a PERMUTATION of the one-shot build: same size, same leaf-list
    # length multiset, bit-identical query results.
    assert streamed.octree_data.shape == one.octree_data.shape
    np.testing.assert_array_equal(
        np.sort(np.asarray(streamed.leaf_count)),
        np.sort(np.asarray(one.leaf_count)),
    )
    rng = np.random.default_rng(12)
    pts = rng.uniform(box.min, box.max, (2048, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(streamed.get_distance(pts)),
        np.asarray(one.get_distance(pts)),
    )


def test_auto_scan_impl_flips_for_sparse_batches():
    """The auto default flips window->grouped below ~4 points/leaf
    (sparse batches degenerate the fixed-window gap-jump loop, r5), and
    both backends agree bit-for-bit; an explicit set_scan_impl pins the
    choice."""
    mesh = make_icosphere(subdivisions=2, radius=0.35)
    box = mesh.bounding_box.add_margin(0.14)
    ex = ExactOctreeSdf(mesh, box, max_depth=4, start_depth=1,
                        min_triangles_per_node=16)
    assert ex.scan_impl == "xla_window" and ex._scan_impl_auto
    rng = np.random.default_rng(9)
    small = rng.uniform(ex.box.min + 1e-4, ex.box.max - 1e-4,
                        (64, 3)).astype(np.float32)
    d_auto = np.asarray(ex.get_distance(small))     # sparse: flips to xla
    ex.set_scan_impl("xla_window")
    assert not ex._scan_impl_auto
    d_win = np.asarray(ex.get_distance(small))      # pinned: windows
    np.testing.assert_array_equal(d_auto, d_win)


@pytest.fixture(scope="module")
def torus_mesh():
    return make_torus(R=0.3, r=0.12, nu=20, nv=12)


@pytest.fixture(scope="module")
def torus_sdf(torus_mesh):
    """One shared structure for the impl-parity tests (builds dominate
    their wall time; scan settings are restored by each test)."""
    mesh = torus_mesh
    box = mesh.bounding_box.add_margin(0.1)
    return ExactOctreeSdf(
        mesh, box, max_depth=4, start_depth=1, min_triangles_per_node=16
    )


def test_fused_query_impls_match_xla(torus_sdf):
    """End-to-end: ExactOctreeSdf distances under the window scan equal
    the grouped-scan distances on a real structure."""
    sdf = torus_sdf
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.5, 0.5, size=(768, 3)).astype(np.float32)
    sdf.set_scan_impl("xla")
    d_xla = np.asarray(sdf.get_distance(pts))
    for impl in ("xla_window",):
        sdf.set_scan_impl(impl)
        d_imp = np.asarray(sdf.get_distance(pts))
        np.testing.assert_allclose(d_imp, d_xla, rtol=1e-5, atol=1e-6)

    # gradients route through the winner ids: cover every backend
    sdf.set_scan_impl("xla")
    _, g_ref = sdf.get_distance_and_gradient(pts[:128])
    g_ref = np.asarray(g_ref)
    for impl in ("xla_window",):
        sdf.set_scan_impl(impl)
        _, g_imp = sdf.get_distance_and_gradient(pts[:128])
        np.testing.assert_allclose(
            np.asarray(g_imp), g_ref, rtol=1e-5, atol=1e-6
        )
    sdf.set_scan_impl("xla")


def test_xla_window_widths_and_sparse_batches(torus_sdf):
    """The window scan must stay exact for every window width and for
    SPARSE batches whose windows straddle distant leaves (the gap-jump
    path: rows of non-member leaves are skipped, not truncated)."""
    sdf = torus_sdf
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.5, 0.5, size=(512, 3)).astype(np.float32)
    sdf.set_scan_impl("xla")
    d_xla = np.asarray(sdf.get_distance(pts))
    sdf.set_scan_impl("xla_window")
    for width in (4, 16, 64):
        sdf.window_width = width
        d_w = np.asarray(sdf.get_distance(pts))
        np.testing.assert_allclose(d_w, d_xla, rtol=1e-5, atol=1e-6)
    # a handful of points scattered over the whole domain: every window
    # spans many distant leaves
    sdf.window_width = 8
    few = rng.uniform(-0.5, 0.5, size=(17, 3)).astype(np.float32)
    sdf.set_scan_impl("xla")
    d_ref = np.asarray(sdf.get_distance(few))
    sdf.set_scan_impl("xla_window")
    d_few = np.asarray(sdf.get_distance(few))
    np.testing.assert_allclose(d_few, d_ref, rtol=1e-5, atol=1e-6)
    sdf.set_scan_impl("xla")
    sdf.window_width = 8


def test_wide_scan_chunk_repack(torus_sdf):
    """chunk=128 repacks the CSR into wider spans; distances must be
    unchanged under every scan backend."""
    sdf = torus_sdf
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 0.5, size=(1024, 3)).astype(np.float32)
    sdf.set_scan_impl("xla")
    d64 = np.asarray(sdf.get_distance(pts))
    sdf.set_scan_chunk(128)
    try:
        d128 = np.asarray(sdf.get_distance(pts))
        np.testing.assert_allclose(d128, d64, rtol=1e-6, atol=1e-7)
        for impl in ("xla_window",):
            sdf.set_scan_impl(impl)
            d128i = np.asarray(sdf.get_distance(pts))
            np.testing.assert_allclose(d128i, d64, rtol=1e-6, atol=1e-7)
    finally:
        sdf.set_scan_impl("xla")
        sdf.set_scan_chunk(64)  # restore for other tests on the fixture


def test_precise_cull_keeps_each_points_nearest_candidate():
    """The precise cull takes its region radii by an exact select (a
    float32 one-hot contraction could round in TF32 on a GPU): every kept
    set must still hold the nearest candidate of every point in its
    node, and nothing outside the valid candidates."""
    import jax
    import jax.numpy as jnp

    from sdflib_tpu.ops.point_triangle import (
        pack_triangle_fields,
        sq_dist_packed,
    )
    from sdflib_tpu.sdf.exact_octree import _precise_cull_chunk
    from sdflib_tpu.triangle import calculate_mesh_triangle_data

    tris = jax.tree.map(
        jnp.asarray,
        calculate_mesh_triangle_data(make_torus(R=0.3, r=0.12, nu=16, nv=8)),
    )
    packed = pack_triangle_fields(tris)
    T = packed.shape[0]
    rng = np.random.default_rng(3)
    C, K, half = 8, 64, 0.06
    centers = rng.uniform(-0.3, 0.3, (C, 3)).astype(np.float32)
    # each node's candidates: its K nearest triangles by center distance
    sq_c = np.asarray(
        sq_dist_packed(
            centers[:, 0:1], centers[:, 1:2], centers[:, 2:3],
            np.asarray(packed)[None, :, :],
        )
    )
    cand = np.argsort(sq_c, axis=1)[:, :K].astype(np.int32)
    valid = np.ones((C, K), bool)
    valid[:, -5:] = False
    keep, cnt, _ = _precise_cull_chunk(
        packed, tris.v_world, jnp.asarray(centers), jnp.asarray(cand),
        jnp.asarray(valid), jnp.float32(half),
    )
    keep, cnt = np.asarray(keep), np.asarray(cnt)
    assert not (keep & ~valid).any()
    np.testing.assert_array_equal(cnt, keep.sum(axis=1))
    assert (cnt < valid.sum(axis=1)).any(), "the cull removed nothing"

    fields = np.asarray(packed)[cand]                 # (C, K, 19)
    pts = centers[:, None, :] + rng.uniform(
        -half, half, (C, 256, 3)
    ).astype(np.float32)
    sq = np.asarray(
        sq_dist_packed(
            pts[..., 0:1], pts[..., 1:2], pts[..., 2:3], fields[:, None]
        )
    )                                                 # (C, 256, K)
    sq = np.where(valid[:, None, :], sq, np.inf)
    best = sq.min(axis=2, keepdims=True)
    # every candidate tying for the minimum is acceptable
    kept_best = np.any((sq <= best) & keep[:, None, :], axis=2)
    assert kept_best.all()


def test_bucket_budget_rebuild_keeps_queries_exact(torus_sdf, torus_mesh):
    """The byte budget travels with the saved state and picks the scan
    tables' tier when they are rebuilt: a budget too small for any dense
    tier leaves the id-only fallback, the original one the dense tables.
    Distances stay the brute force's either way, and the window scan
    needs the dense tables."""
    state = torus_sdf._state_arrays()
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.5, 0.5, size=(600, 3)).astype(np.float32)
    ref = np.asarray(RealSdf(torus_mesh).get_distance(pts))

    small = ExactOctreeSdf._from_state_arrays(
        {**state, "bucket_byte_budget": np.int64(1 << 10)})
    assert small.bucket_fields is None
    np.testing.assert_allclose(
        np.asarray(small.get_distance(pts)), ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="dense"):
        small.set_scan_impl("xla_window")

    dense = ExactOctreeSdf._from_state_arrays(state)
    assert dense.bucket_fields is not None
    dense.set_scan_impl("xla_window")
    np.testing.assert_allclose(
        np.asarray(dense.get_distance(pts)), ref, rtol=0, atol=1e-6)
