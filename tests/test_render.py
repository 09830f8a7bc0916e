"""Renderer tests: sphere tracing hits the analytic surface, shading and
plane-cut produce sane images, PNG round-trips."""
import numpy as np
import pytest

from sdflib_tpu.render import (
    Camera,
    normal_color,
    render_plane_cut,
    shade_lambert,
    sphere_trace,
    to_u8,
    trace_octree,
    write_png,
)
from sdflib_tpu.sdf.octree import OctreeSdf
from sdflib_tpu.utils.primitives import make_icosphere, make_torus


@pytest.fixture(scope="module")
def octree():
    mesh = make_icosphere(subdivisions=3, radius=0.35)
    box = mesh.bounding_box.add_margin(0.14)
    return OctreeSdf(mesh, box, max_depth=5, start_depth=2,
                     termination_threshold=1e-3)


def test_sphere_trace_analytic():
    """Trace against an analytic sphere SDF: hit depth == |o| - r."""
    import jax.numpy as jnp

    def dist(p):
        return jnp.linalg.norm(p, axis=-1) - 0.5

    origins = np.array([[0, 0, 2.0], [0, 2.0, 0], [2.0, 0, 0]], np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    hit, pos, depth, it = sphere_trace(dist, origins, dirs, eps=1e-5, far=5.0)
    assert np.all(np.asarray(hit))
    np.testing.assert_allclose(np.asarray(depth), 1.5, atol=1e-3)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(pos), axis=-1), 0.5, atol=1e-3
    )


def test_sphere_trace_miss():
    import jax.numpy as jnp

    def dist(p):
        return jnp.linalg.norm(p, axis=-1) - 0.5

    origins = np.array([[2.0, 2.0, 2.0]], np.float32)
    dirs = np.array([[0.0, 0.0, 1.0]], np.float32)
    hit, _, _, _ = sphere_trace(dist, origins, dirs, eps=1e-5, far=8.0)
    assert not bool(np.asarray(hit)[0])


def test_trace_octree_sphere(octree):
    cam = Camera(position=(0, 0, 1.5), target=(0, 0, 0), fov_y_deg=45)
    origins, dirs = cam.rays(64, 64)
    res = trace_octree(octree, origins, dirs, eps=1e-4, far=4.0, max_iters=256)
    hit = np.asarray(res.hit)
    # Center pixel must hit the r=0.35 sphere, corners must miss
    assert hit[32, 32]
    assert not hit[0, 0] and not hit[-1, -1]
    # Hit points lie on the surface (octree error ~1e-3)
    pos = np.asarray(res.position)[hit]
    np.testing.assert_allclose(
        np.linalg.norm(pos, axis=-1), 0.35, atol=5e-3
    )
    # Normals point outward
    n = np.asarray(res.normal)[hit]
    outward = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    assert np.mean(np.sum(n * outward, axis=-1) > 0.95) > 0.95


def test_shading_and_png(tmp_path, octree):
    cam = Camera(position=(0.9, 0.7, 1.2), target=(0, 0, 0), fov_y_deg=45)
    origins, dirs = cam.rays(64, 64)
    res = trace_octree(octree, origins, dirs, eps=1e-4, far=4.0, max_iters=256)
    img_n = np.asarray(normal_color(res.normal, res.hit))
    img_l = np.asarray(shade_lambert(res.position, res.normal, res.hit,
                                     view_dir=np.asarray(dirs)))
    for img in (img_n, img_l):
        assert img.shape == (64, 64, 3)
        assert np.isfinite(img).all()
        assert img.min() >= 0.0 and img.max() <= 1.0
    # Foreground differs from background
    assert np.abs(img_l[32, 32] - img_l[0, 0]).max() > 0.05

    path = str(tmp_path / "render.png")
    write_png(path, img_l)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 200


def test_plane_cut_image(octree):
    img = render_plane_cut(octree, resolution=96, axis=2, offset=0.5)
    assert img.shape == (96, 96, 3)
    assert np.isfinite(img).all()
    # Inside-sphere pixels are blue-ish (negative distance -> palette low end)
    center = img[48, 48]
    assert center[2] > center[0]
    # Outside pixels are warm-ish (positive distance -> palette high end)
    corner = img[0, 0]
    assert corner[0] > corner[2]
    # The isosurface line darkens the zero crossing to near-black somewhere
    dark = np.all(img < 0.15, axis=-1)
    assert dark.any()
    # Without overlays the crossing region is the palette's white
    img_plain = render_plane_cut(
        octree, resolution=96, axis=2, offset=0.5,
        print_grid=False, print_isolines=False, surface_thickness=0.0,
    )
    assert np.all(img_plain > 0.75, axis=-1).any()


def test_png_grayscale_and_rgba(tmp_path):
    g = np.linspace(0, 1, 32 * 32, dtype=np.float32).reshape(32, 32)
    write_png(str(tmp_path / "g.png"), g)
    rgba = np.random.default_rng(0).uniform(0, 1, (16, 16, 4)).astype(np.float32)
    write_png(str(tmp_path / "rgba.png"), rgba)
    assert to_u8(np.array([0.0, 0.5, 1.0])).tolist() == [0, 128, 255]


def test_pyramid_schedule_matches_dynamic(octree):
    """The fused pyramid march (one dispatch, full-array compaction
    between static rounds) must produce the same hits/depths as the
    per-round dynamic scheduler on a frame large enough to engage it."""
    import numpy as np
    from sdflib_tpu.render.sphere_trace import trace_octree

    R = 256
    u = (np.arange(R, dtype=np.float32) + 0.5) / R - 0.5
    gu, gv = np.meshgrid(u, u)
    origins = np.stack([gu, gv, np.full_like(gu, -1.2)], -1).astype(np.float32)
    dirs = np.broadcast_to(
        np.array([0.0, 0.0, 1.0], np.float32), origins.shape
    ).copy()
    # converged regime (every ray retires within budget): a ray's
    # trajectory is schedule-independent, so results must be identical
    stats = {}
    res_p = trace_octree(octree, origins, dirs, max_iters=1024,
                         pyramid=True, stats_out=stats)
    res_d = trace_octree(octree, origins, dirs, max_iters=1024,
                         pyramid=False)
    assert stats["rounds"][0][0] == "pyramid"  # the fused path actually ran
    np.testing.assert_array_equal(
        np.asarray(res_p.hit), np.asarray(res_d.hit)
    )
    hp = np.asarray(res_p.depth)[np.asarray(res_p.hit)]
    hd = np.asarray(res_d.depth)[np.asarray(res_d.hit)]
    np.testing.assert_allclose(hp, hd, rtol=1e-5, atol=1e-6)


def test_octree_trace_never_steps_through_the_surface():
    """trace_octree's grid steps vs a plain march on the same SDF. Only
    finest CELLS are proven surface-free, not the leaves around them: an
    exit step to the box of a large leaf holding free cells and the
    surface carried rays through it (hits ~1e-2 too deep at this size).
    Where both hit, depths agree to the termination threshold."""
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(
        0.2 * float(np.max(mesh.bounding_box.size)))
    oct_ = OctreeSdf(mesh, box, max_depth=6, start_depth=2,
                     termination_threshold=1e-3, init_algorithm="continuity")
    oct_.build_query_grid()
    R = 128
    u = (np.arange(R, dtype=np.float32) + 0.5) / R - 0.5
    gu, gv = np.meshgrid(u, u)
    origins = np.stack([gu, gv, np.full_like(gu, -1.2)], -1).reshape(-1, 3)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (R * R, 1))
    res = trace_octree(oct_, origins, dirs, max_iters=1024)
    size = float(oct_.box.size[0])
    hit, _, depth, _ = sphere_trace(
        oct_.get_distance, origins, dirs, eps=1e-5 * size, far=4.0 * size,
        max_iters=1024)
    hit, depth = np.asarray(hit), np.asarray(depth)
    got_hit, got_depth = np.asarray(res.hit), np.asarray(res.depth)
    assert hit.mean() > 0.2
    assert np.mean(got_hit != hit) <= 2e-3
    both = got_hit & hit
    assert np.max(np.abs(got_depth[both] - depth[both])) <= 1e-3
