"""Smoke run of sdflib_tpu's main path on one GPU: build -> query -> trace.

    python chip_smoke.py               # one card, every phase in sequence
    python chip_smoke.py --four-cards  # the sdflib_tpu.parallel paths, 4 cards

Every phase drives the public entry points at full width, checks its
results against a plain reference (XLA on the CPU device, the native C++
evaluator, the RealSdf brute force or the plain sphere tracer) and prints
one ``PHASE {...}`` line: seconds including compilation, a rate from a
second (warm) call, and the device's ``peak_bytes_in_use`` so far. A failed
check or phase ends the run with a non-zero exit; nothing is caught and
skipped. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

The script refuses to run where JAX finds no GPU, and starts no second JAX
process: the one child process is ``nvidia-smi`` (and ``g++`` once, for the
native evaluator).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


# -- sizes --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What each phase builds and queries. ``FULL`` is the deployment the
    smoke run proves: the 100,800-triangle torus, SdfExporter's default
    approximate octree, the bench's 1024^2 frame and depth-7 exact octree."""

    torus_nu: int = 420
    torus_nv: int = 120
    oracle_points: int = 1 << 16
    cpu_subset: int = 4096
    approx_depth: int = 6
    approx_start: int = 2
    approx_points: int = 1 << 22
    approx_grad_points: int = 1 << 20
    native_points: int = 65536
    check_points: int = 10000
    frame: int = 1024
    trace_subset: int = 4096
    exact_depth: int = 7
    exact_start: int = 3
    exact_points: int = 1 << 20
    # --four-cards: the bench torus (9,216 triangles), so the four-card
    # call spends its time on the sharded paths, not on builds
    four_nu: int = 96
    four_nv: int = 48
    four_points: int = 1 << 20
    four_frame: int = 512
    four_exact_depth: int = 5


FULL = Sizes()


# -- tolerances ---------------------------------------------------------------
# Same formula on both sides (GPU vs the CPU device, or a sharded vs a
# single-device program): float32 results differ only by contraction and
# reduction order.
SAME_FORMULA_RTOL = 1e-5
SAME_FORMULA_ATOL = 1e-6
# The exact octree must return the brute-force distance (its lists provably
# hold each point's nearest triangle); 1e-4 is bench.py's oracle bound.
EXACT_ORACLE_ATOL = 1e-4
# Gradients of exact structures: equal where both sides pick the same
# nearest triangle; ties between triangles at equal distance may pick
# another feature's normal, so a small share of points may differ.
GRAD_ATOL = 1e-3
GRAD_MISMATCH_FRAC = 1e-3
# The differentiable query on the GPU vs the CPU device: 64-term tricubic
# sums in another order. Measured on an H100: at most 2.7e-6 (gradients;
# 1.8e-7 distances), also with the sums written as default-precision
# dots; with their inputs rounded to TF32 2.4e-2 (4.4e-4 distances). The
# limit sits about 4x above the first and far below the second.
DIFF_RTOL = 0.0
DIFF_ATOL = 1e-5
# Approximate octree vs the brute force: the build's termination threshold
# is 1e-3 (an estimate of the fit error per leaf); 1e-2 flags a wrong
# structure, not an imprecise one.
APPROX_ORACLE_ATOL = 1e-2
# Native C++ evaluator vs the JAX query on the same .bin structure: the
# same tricubic polynomial, summed in another order.
NATIVE_ATOL = 1e-5
# Octree trace vs the plain sphere tracer on OctreeSdf.get_distance: both
# stop at the first point where the approximate SDF is within eps of zero,
# but they approach along other step sequences (beam start depths, the
# grid's free-box steps), and a polynomial SDF that is only within the
# termination threshold (1e-3) of a 1-Lipschitz field can be overshot by a
# fraction of that threshold. Hits must agree on all but a few rays, and
# depths to the threshold.
TRACE_HIT_MISMATCH_FRAC = 2e-3
TRACE_DEPTH_ATOL = 1e-3
# Tiled (structure-sharded) queries vs the replicated structure: the same
# leaf and polynomial, evaluated by another program.
TILED_RTOL = 1e-5
TILED_ATOL = 1e-5


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


# -- comparisons (pure numpy: tested on the CPU) -------------------------------


def require_gpu(devices, count: int | None = None):
    """The devices, if they are GPUs (and ``count`` of them when given);
    otherwise exit with a 'no GPU' message."""
    devices = list(devices)
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU: JAX found platform {found!r}")
    if count is not None and len(devices) < count:
        raise SystemExit(f"no GPU: need {count} GPUs, JAX found {len(devices)}")
    return devices if count is None else devices[:count]


def compare_close(name, got, ref, *, rtol, atol, exact=False):
    """max |got - ref|; raises SmokeFailure beyond the tolerance (or on any
    difference when ``exact``)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise SmokeFailure(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise SmokeFailure(f"{name}: non-finite values")
    err = float(np.max(np.abs(got - ref), initial=0.0))
    if exact:
        if not np.array_equal(got, ref):
            raise SmokeFailure(f"{name}: not identical (max |d| {err:.3g})")
    elif not np.allclose(got, ref, rtol=rtol, atol=atol):
        bad = np.abs(got - ref) > atol + rtol * np.abs(ref)
        raise SmokeFailure(
            f"{name}: {int(bad.sum())} of {bad.size} beyond "
            f"rtol {rtol} / atol {atol} (max |d| {err:.3g})"
        )
    return err


def compare_gradients(name, got, ref, *, atol, max_mismatch_frac):
    """Share of points whose gradient differs by more than ``atol``;
    raises SmokeFailure above ``max_mismatch_frac``."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        raise SmokeFailure(f"{name}: bad gradients {got.shape}")
    off = np.max(np.abs(got - ref), axis=-1) > atol
    frac = float(np.mean(off)) if off.size else 0.0
    if frac > max_mismatch_frac:
        raise SmokeFailure(
            f"{name}: {frac:.2%} of gradients differ by > {atol}"
        )
    return frac


def compare_trace(name, hit, depth, hit_ref, depth_ref, *,
                  max_mismatch_frac, depth_atol):
    """(hit-mask mismatch share, max and 99th-percentile depth difference
    where both hit); raises SmokeFailure beyond either bound."""
    hit = np.asarray(hit, bool).ravel()
    hit_ref = np.asarray(hit_ref, bool).ravel()
    depth = np.asarray(depth, np.float64).ravel()
    depth_ref = np.asarray(depth_ref, np.float64).ravel()
    if hit.shape != hit_ref.shape or depth.shape != hit.shape:
        raise SmokeFailure(f"{name}: shapes differ")
    if not hit_ref.any():
        raise SmokeFailure(f"{name}: the reference hit nothing")
    mismatch = float(np.mean(hit != hit_ref))
    both = hit & hit_ref
    dd = np.abs(depth[both] - depth_ref[both])
    derr = float(np.max(dd, initial=0.0))
    p99 = float(np.percentile(dd, 99)) if dd.size else 0.0
    if mismatch > max_mismatch_frac:
        raise SmokeFailure(f"{name}: hit masks differ on {mismatch:.3%}")
    if not np.all(np.isfinite(depth[both])) or derr > depth_atol:
        raise SmokeFailure(f"{name}: depth differs by {derr:.3g}")
    return mismatch, derr, p99


# -- reporting -----------------------------------------------------------------


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _emit(phase, device, seconds, rate, **fields):
    """One PHASE line: seconds (compilation included), rate (None where
    the phase has none), the phase's own fields, peak device bytes."""
    rec = {"phase": phase, "seconds_incl_compile": seconds, "rate": rate,
           **fields, "peak_bytes_in_use": _peak_bytes(device)}
    print("PHASE " + json.dumps(rec), flush=True)


def _timed(fn, *args, **kwargs):
    """(result, seconds) with the device work fenced."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _uniform(rng, box, n):
    lo = np.asarray(box.min, np.float32) + 1e-4
    hi = np.asarray(box.max, np.float32) - 1e-4
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _frame(res):
    """The bench's orthographic frame: res^2 parallel +z rays."""
    u = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    gu, gv = np.meshgrid(u, u)
    origins = np.stack([gu, gv, np.full_like(gu, -1.2)], -1).astype(np.float32)
    dirs = np.broadcast_to(
        np.array([0.0, 0.0, 1.0], np.float32), origins.shape
    ).copy()
    return origins, dirs


def _cpu_device():
    import jax

    return jax.devices("cpu")[0]


# -- one-card phases -----------------------------------------------------------


def phase_device(ctx, sizes):
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = ctx["device"]
    _emit(
        "device", dev, seconds=0.0, rate=None,
        nvidia_smi=smi, device_kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache_dir=jax.config.jax_compilation_cache_dir,
    )


def phase_oracle(ctx, sizes):
    """RealSdf brute force at full width (its default sweep: the Triton
    kernel on one GPU); a subset against the CPU device, and the whole
    batch against XLA's own sweep on the same device."""
    import jax

    from sdflib_tpu.ops.point_triangle import signed_distance_batch
    from sdflib_tpu.sdf.real import RealSdf

    dev, mesh = ctx["device"], ctx["mesh"]
    rng = np.random.default_rng(1)
    pts = _uniform(rng, ctx["box"], sizes.oracle_points)
    real = RealSdf(mesh)
    ctx["real"] = real
    t0 = time.perf_counter()
    d, s_first = _timed(real.get_distance, pts)
    _, s_warm = _timed(real.get_distance, pts)
    d_xla, x_first = _timed(signed_distance_batch, pts, real.triangles,
                            impl="xla")
    _, x_warm = _timed(signed_distance_batch, pts, real.triangles,
                       impl="xla")
    xla_err = compare_close(
        "oracle vs XLA sweep", d, d_xla,
        rtol=SAME_FORMULA_RTOL, atol=SAME_FORMULA_ATOL,
    )
    sub = pts[: sizes.cpu_subset]
    with jax.default_device(_cpu_device()):
        d_cpu = np.asarray(RealSdf(mesh).get_distance(sub))
    err = compare_close(
        "oracle vs CPU", np.asarray(d)[: sizes.cpu_subset], d_cpu,
        rtol=SAME_FORMULA_RTOL, atol=SAME_FORMULA_ATOL,
    )
    pairs = sizes.oracle_points * ctx["num_tris"]
    _emit(
        "oracle", dev, seconds=time.perf_counter() - t0,
        first_call_s_incl_compile=s_first, warm_s=s_warm,
        rate=pairs / s_warm, rate_unit="point-triangle pairs/s",
        points=sizes.oracle_points, triangles=ctx["num_tris"],
        max_abs_err_vs_cpu=err,
        xla_sweep_first_s_incl_compile=x_first, xla_sweep_warm_s=x_warm,
        xla_sweep_rate=pairs / x_warm, max_abs_err_vs_xla_sweep=xla_err,
    )


def phase_approx(ctx, sizes):
    """SdfExporter's default approximate octree: build, query, .bin round
    trip through the native evaluator, error against the brute force."""
    from sdflib_tpu.io.sdflib_binary import save_sdflib_bin
    from sdflib_tpu.native import NativeSdf
    from sdflib_tpu.sdf.octree import OctreeSdf

    dev, mesh = ctx["device"], ctx["mesh"]
    t0 = time.perf_counter()
    oct_, build_s = _timed(
        OctreeSdf, mesh, ctx["box"], max_depth=sizes.approx_depth,
        start_depth=sizes.approx_start, termination_threshold=1e-3,
        init_algorithm="continuity",
    )
    oct_.build_query_grid()
    ctx["approx"] = oct_
    rng = np.random.default_rng(2)
    pts = _uniform(rng, oct_.box, sizes.approx_points)
    _, q_first = _timed(oct_.get_distance, pts)
    _, q_warm = _timed(oct_.get_distance, pts)
    gpts = pts[: sizes.approx_grad_points]
    (dg, gg), g_first = _timed(oct_.get_distance_and_gradient, gpts)
    _, g_warm = _timed(oct_.get_distance_and_gradient, gpts)
    if not (np.all(np.isfinite(np.asarray(dg)))
            and np.all(np.isfinite(np.asarray(gg)))):
        raise SmokeFailure("approx: non-finite distance or gradient")

    npts = pts[: sizes.native_points]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "approx.bin")
        save_sdflib_bin(oct_, path)
        native = NativeSdf.load(path)
        d_native = native.get_distance(npts)
        native.close()
    native_err = compare_close(
        "approx vs native", oct_.get_distance(npts), d_native,
        rtol=0.0, atol=NATIVE_ATOL,
    )
    cpts = pts[: sizes.check_points]
    oracle_err = compare_close(
        "approx vs RealSdf", oct_.get_distance(cpts),
        ctx["real"].get_distance(cpts), rtol=0.0, atol=APPROX_ORACLE_ATOL,
    )
    _emit(
        "approx", dev, seconds=time.perf_counter() - t0,
        build_s_incl_compile=build_s,
        query_first_s_incl_compile=q_first, query_warm_s=q_warm,
        rate=sizes.approx_points / q_warm, rate_unit="queries/s",
        grad_first_s_incl_compile=g_first,
        grad_rate=sizes.approx_grad_points / g_warm,
        octree_words=int(oct_.octree_data.shape[0]),
        max_abs_err_vs_native=native_err,
        max_abs_err_vs_realsdf=oracle_err,
    )


def phase_trace(ctx, sizes):
    """The fused 1024^2 frame; a ray subset against the plain tracer."""
    import jax.numpy as jnp

    from sdflib_tpu.render.sphere_trace import sphere_trace, trace_octree

    dev, oct_ = ctx["device"], ctx["approx"]
    origins, dirs = _frame(sizes.frame)
    o_dev, d_dev = jnp.asarray(origins), jnp.asarray(dirs)
    t0 = time.perf_counter()
    res, first = _timed(trace_octree, oct_, o_dev, d_dev, max_iters=1024)
    _, warm = _timed(trace_octree, oct_, o_dev, d_dev, max_iters=1024)

    rng = np.random.default_rng(3)
    n = sizes.frame * sizes.frame
    idx = np.sort(rng.choice(n, min(sizes.trace_subset, n), replace=False))
    o_sub = origins.reshape(-1, 3)[idx]
    d_sub = dirs.reshape(-1, 3)[idx]
    # trace_octree's eps/far are in box units; the plain tracer's in world
    size = float(oct_.box.size[0])
    hit_ref, _, depth_ref, _ = sphere_trace(
        oct_.get_distance, o_sub, d_sub, eps=1e-5 * size, far=4.0 * size,
        max_iters=1024,
    )
    mismatch, derr, p99 = compare_trace(
        "trace vs plain sphere_trace",
        np.asarray(res.hit).reshape(-1)[idx],
        np.asarray(res.depth).reshape(-1)[idx],
        hit_ref, depth_ref,
        max_mismatch_frac=TRACE_HIT_MISMATCH_FRAC,
        depth_atol=TRACE_DEPTH_ATOL,
    )
    _emit(
        "trace", dev, seconds=time.perf_counter() - t0,
        first_call_s_incl_compile=first, warm_s=warm,
        rate=n / warm, rate_unit="rays/s", frame=sizes.frame,
        hit_share=float(np.mean(np.asarray(res.hit))),
        hit_mismatch_share=mismatch, max_depth_err=derr,
        p99_depth_err=p99,
    )


def bucket_tier(sdf) -> str:
    """Which storage tier the exact octree's scan tables took."""
    if sdf.bucket_fields is None:
        return "id-only"
    nf = sdf.bucket_fields.shape[1] // sdf.scan_chunk
    return {9: "vertex9", 19: "frame19"}.get(nf, f"nf{nf}")


# Bucket-table budget for the exact phase when the default demotes the
# structure to the id-only tier: a quarter of the ~60 GB a JAX process
# takes on an 80 GB card.
CARD_BUCKET_BUDGET = 16 << 30


def with_bucket_budget(ex, byte_budget):
    """The same exact octree (tree and leaf lists) with its scan tables
    rebuilt under another byte budget, through its save/load state: the
    budget is saved with the structure and picks the tables' tier."""
    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf

    state = ex._state_arrays()
    state["bucket_byte_budget"] = np.int64(byte_budget)
    return ExactOctreeSdf._from_state_arrays(state)


def _exact_queries(ex, impl, pts, cpts, d_ref, g_ref):
    """Time one scan choice at full batch and hold it to the brute force."""
    _, q_first = _timed(ex.get_distance, pts)
    _, q_warm = _timed(ex.get_distance, pts)
    _, g_first = _timed(ex.get_distance_and_gradient, pts)
    _, g_warm = _timed(ex.get_distance_and_gradient, pts)
    d_chk, g_chk = ex.get_distance_and_gradient(cpts)
    err = compare_close(
        f"exact[{impl}] vs RealSdf", ex.get_distance(cpts), d_ref,
        rtol=0.0, atol=EXACT_ORACLE_ATOL,
    )
    compare_close(
        f"exact[{impl}] grad-path distance vs RealSdf", d_chk, d_ref,
        rtol=0.0, atol=EXACT_ORACLE_ATOL,
    )
    gfrac = compare_gradients(
        f"exact[{impl}] gradient vs RealSdf", g_chk, g_ref,
        atol=GRAD_ATOL, max_mismatch_frac=GRAD_MISMATCH_FRAC,
    )
    stats = getattr(ex, "_last_scan_stats", None) or {}
    return {
        "scan": stats.get("impl", "id-only fallback"),
        "query_first_s_incl_compile": q_first,
        "rate": pts.shape[0] / q_warm,
        "grad_first_s_incl_compile": g_first,
        "grad_rate": pts.shape[0] / g_warm,
        "max_abs_err_vs_realsdf": err,
        "grad_mismatch_share": gfrac,
    }


def phase_exact(ctx, sizes):
    """Depth-7 exact octree with the region cull: queries under the
    automatic scan choice and both scans set explicitly, each held to the
    brute force."""
    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf

    dev, mesh = ctx["device"], ctx["mesh"]
    box = mesh.bounding_box.add_margin(0.14)   # bench.py's exact box
    t0 = time.perf_counter()
    ex, build_s = _timed(
        ExactOctreeSdf, mesh, box, max_depth=sizes.exact_depth,
        start_depth=sizes.exact_start, min_triangles_per_node=32,
    )
    default_tier = bucket_tier(ex)
    print(f"exact: built in {build_s:.1f} s, bucket tier {default_tier}",
          flush=True)
    rng = np.random.default_rng(4)
    pts = _uniform(rng, ex.box, sizes.exact_points)
    cpts = pts[: sizes.check_points]
    d_ref, g_ref = ctx["real"].get_distance_and_gradient(cpts)
    out = {"auto@default_budget": _exact_queries(
        ex, "auto", pts, cpts, d_ref, g_ref)}
    tpl = ex.build_stats.get("tris_per_leaf")
    rebucket_s = None
    if ex.bucket_fields is None:
        # the explicit scans need the dense tables
        ex, rebucket_s = _timed(with_bucket_budget, ex, CARD_BUCKET_BUDGET)
    for impl in ("auto", "xla", "xla_window"):
        if impl != "auto":
            ex.set_scan_impl(impl)
        out[impl] = _exact_queries(ex, impl, pts, cpts, d_ref, g_ref)
    _emit(
        "exact", dev, seconds=time.perf_counter() - t0,
        build_s_incl_compile=build_s, depth=sizes.exact_depth,
        rate=out["auto"]["rate"], rate_unit="queries/s (auto scan)",
        bucket_tier_default_budget=default_tier,
        bucket_tier=bucket_tier(ex),
        bucket_budget_bytes=int(ex._BUCKET_BYTE_BUDGET),
        rebucket_s_incl_compile=rebucket_s,
        bucket_field_bytes=(
            0 if ex.bucket_fields is None
            else int(ex.bucket_fields.size) * 4
        ),
        slots=int(ex.tri_flat.shape[0]),
        leaves=int(ex.leaf_count.shape[0]),
        mean_tris_per_leaf=None if tpl is None else float(np.mean(tpl)),
        by_impl=out,
    )


def phase_diff(ctx, sizes):
    """The differentiable query (forward with gradients) of
    ``__graft_entry__.entry()`` on the GPU, and the same step — same
    structure, same inputs — on the CPU device."""
    import copy

    import jax

    import __graft_entry__ as graft

    dev = ctx["device"]
    t0 = time.perf_counter()
    oct_ = graft._tiny_octree()
    fn, args = graft.entry(oct_)
    step = jax.jit(fn)
    out, first = _timed(step, *args)
    _, warm = _timed(step, *args)
    cpu = _cpu_device()
    oct_cpu = copy.copy(oct_)
    oct_cpu.octree_data = jax.device_put(oct_.octree_data, cpu)
    with jax.default_device(cpu):
        fn_c, args_c = graft.entry(oct_cpu)
        out_c = jax.jit(fn_c)(*args_c)
    errs = [
        compare_close(
            f"diff output {i} vs CPU", a, b, rtol=DIFF_RTOL, atol=DIFF_ATOL,
        )
        for i, (a, b) in enumerate(
            zip(jax.tree.leaves(out), jax.tree.leaves(out_c))
        )
    ]
    _emit(
        "diff", dev, seconds=time.perf_counter() - t0,
        rate=args[1].shape[0] / warm,
        rate_unit="points/s (forward with gradients)",
        first_call_s_incl_compile=first, warm_s=warm,
        max_abs_err_vs_cpu=max(errs),
    )


def phase_gpu_tests(ctx, sizes):
    """The repository's GPU-marked tests, in this process."""
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["SDFLIB_TESTS_ON_GPU"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider",
        os.path.join(here, "tests", "test_gpu.py"),
    ])
    if rc != 0:
        raise SmokeFailure(f"GPU tests failed (pytest exit {rc})")
    _emit("gpu_tests", ctx["device"], seconds=time.perf_counter() - t0,
          rate=None)


ONE_CARD_PHASES = (
    phase_device, phase_oracle, phase_approx, phase_trace, phase_exact,
    phase_diff, phase_gpu_tests,
)


# -- four-card phases ----------------------------------------------------------


def phase_four_cards(ctx, sizes):
    """sdflib_tpu.parallel on a 1-D mesh over four cards, each path against
    its single-device result."""
    from sdflib_tpu import parallel
    from sdflib_tpu.diff.query import octree_coefficients
    from sdflib_tpu.parallel.tiles import TiledExactOctreeSdf, TiledOctreeSdf
    from sdflib_tpu.render.sphere_trace import trace_octree
    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf
    from sdflib_tpu.sdf.octree import OctreeSdf
    from sdflib_tpu.utils.primitives import make_torus

    devs = ctx["devices"]
    dev = devs[0]
    mesh4 = parallel.default_mesh(devs)
    mesh1 = parallel.default_mesh(devs[:1])
    tmesh = make_torus(R=0.3, r=0.12, nu=sizes.four_nu, nv=sizes.four_nv)
    box = tmesh.bounding_box.add_margin(0.2 * float(
        np.max(tmesh.bounding_box.size)))
    t0 = time.perf_counter()
    oct_ = OctreeSdf(tmesh, box, max_depth=6, start_depth=2,
                     termination_threshold=1e-3, init_algorithm="continuity")
    oct_.build_query_grid()
    rng = np.random.default_rng(5)
    pts = _uniform(rng, oct_.box, sizes.four_points)
    report = {"build_s": time.perf_counter() - t0}

    def spread(name, arr):
        """Fail if a sharded result did not land on all four cards."""
        n = len({sh.device for sh in arr.addressable_shards})
        if n != len(devs):
            raise SmokeFailure(f"{name}: result on {n} of {len(devs)} cards")

    # sharded_distance: bit-identical to the single-device query
    d1 = oct_.get_distance(pts)
    d4, s = _timed(parallel.sharded_distance, oct_, pts, mesh4)
    _, warm = _timed(parallel.sharded_distance, oct_, pts, mesh4)
    spread("sharded_distance", d4)
    compare_close("sharded_distance", d4, d1, rtol=0, atol=0, exact=True)
    report["sharded_distance"] = {
        "first_s_incl_compile": s, "rate": sizes.four_points / warm,
        "identical": True,
    }

    # sharded_trace: bit-identical to trace_octree with the beam off. Both
    # are timed, and so is sharded_trace on one card, so that its rate on
    # four cards reads against the same march on one card and against the
    # one-device tracer.
    origins, dirs = _frame(sizes.four_frame)
    rays = sizes.four_frame ** 2
    r1, s1 = _timed(trace_octree, oct_, origins, dirs, max_iters=1024,
                    beam=None)
    _, warm1 = _timed(trace_octree, oct_, origins, dirs, max_iters=1024,
                      beam=None)
    _, s_one = _timed(parallel.sharded_trace, oct_, origins, dirs, mesh1,
                      max_iters=1024)
    _, warm_one = _timed(parallel.sharded_trace, oct_, origins, dirs, mesh1,
                         max_iters=1024)
    r4, s = _timed(parallel.sharded_trace, oct_, origins, dirs, mesh4,
                   max_iters=1024)
    _, warm = _timed(parallel.sharded_trace, oct_, origins, dirs, mesh4,
                     max_iters=1024)
    spread("sharded_trace", r4.depth)
    compare_close("sharded_trace hit", np.asarray(r4.hit).ravel(),
                  np.asarray(r1.hit).ravel(), rtol=0, atol=0, exact=True)
    compare_close("sharded_trace depth", np.asarray(r4.depth).ravel(),
                  np.asarray(r1.depth).ravel(), rtol=0, atol=0, exact=True)
    report["sharded_trace"] = {
        "first_s_incl_compile": s, "rate": rays / warm, "identical": True,
        "one_card_first_s_incl_compile": s_one,
        "one_card_rate": rays / warm_one,
        "trace_octree_beam_none_first_s_incl_compile": s1,
        "trace_octree_beam_none_rate": rays / warm1,
    }

    # data_parallel_fit_step: loss and updated coefficients against the
    # same step on a one-device mesh (the gradient all-reduce sums in
    # another order, so equality is to reduction order)
    coeffs = octree_coefficients(oct_.octree_data)
    fpts = pts[: 1 << 16]
    targets = (np.linalg.norm(fpts, axis=-1) - 0.3).astype(np.float32)
    loss1, c1 = parallel.data_parallel_fit_step(oct_, coeffs, fpts, targets,
                                                mesh1)
    (loss4, c4), s = _timed(parallel.data_parallel_fit_step, oct_, coeffs,
                            fpts, targets, mesh4)
    if not c4.sharding.is_fully_replicated or len(c4.devices()) != len(devs):
        raise SmokeFailure("fit step: coefficients not replicated on 4 cards")
    fit = {
        "first_s_incl_compile": s,
        "loss_identical": bool(float(loss1) == float(loss4)),
        "coeffs_identical": bool(np.array_equal(np.asarray(c1),
                                                np.asarray(c4))),
        "loss_abs_diff": abs(float(loss1) - float(loss4)),
    }
    fit["coeffs_max_abs_diff"] = compare_close(
        "fit step coeffs", c4, c1, rtol=SAME_FORMULA_RTOL,
        atol=SAME_FORMULA_ATOL,
    )
    compare_close("fit step loss", float(loss4), float(loss1),
                  rtol=SAME_FORMULA_RTOL, atol=SAME_FORMULA_ATOL)
    report["data_parallel_fit_step"] = fit

    # TiledOctreeSdf: the fused grid in z-slabs over the four cards
    toct = TiledOctreeSdf(_octree=oct_, device_mesh=mesh4)
    report["TiledOctreeSdf"] = _tiled_report(toct, oct_, pts)

    # TiledExactOctreeSdf: the exact structure partitioned by start cells
    ebox = tmesh.bounding_box.add_margin(0.14)
    t1 = time.perf_counter()
    ex1 = ExactOctreeSdf(tmesh, ebox, max_depth=sizes.four_exact_depth,
                         start_depth=2, min_triangles_per_node=32,
                         strategy="region")
    tex = TiledExactOctreeSdf(tmesh, ebox, max_depth=sizes.four_exact_depth,
                              start_depth=2, min_triangles_per_node=32,
                              strategy="region", device_mesh=mesh4)
    rep = _tiled_report(tex, ex1, pts)
    rep["build_s_both"] = time.perf_counter() - t1
    rep["per_card_bucket_bytes"] = tex.per_chip_bucket_bytes()
    report["TiledExactOctreeSdf"] = rep
    _emit("four_cards", dev, seconds=time.perf_counter() - t0,
          rate=report["sharded_distance"]["rate"],
          rate_unit="queries/s (sharded_distance)", count=len(devs),
          **report)


def _tiled_report(tiled, single, pts):
    d1, g1 = single.get_distance_and_gradient(pts)
    (_, _), s = _timed(tiled.get_distance_and_gradient, pts)
    (dt, gt), warm = _timed(tiled.get_distance_and_gradient, pts)
    d_only = tiled.get_distance(pts)
    return {
        "first_s_incl_compile": s,
        "rate": pts.shape[0] / warm,
        "max_abs_err_distance": compare_close(
            "tiled distance", dt, d1, rtol=TILED_RTOL, atol=TILED_ATOL),
        "max_abs_err_distance_only": compare_close(
            "tiled distance-only", d_only, d1, rtol=TILED_RTOL,
            atol=TILED_ATOL),
        "grad_mismatch_share": compare_gradients(
            "tiled gradient", gt, g1, atol=GRAD_ATOL,
            max_mismatch_frac=GRAD_MISMATCH_FRAC),
    }


# -- driver --------------------------------------------------------------------


def run(phases, ctx, sizes):
    for phase in phases:
        phase(ctx, sizes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sdflib_tpu.parallel paths, on 4 GPUs",
    )
    args = ap.parse_args(argv)

    import jax

    from sdflib_tpu.utils.primitives import make_torus

    count = 4 if args.four_cards else None
    devices = require_gpu(jax.devices(), count)
    sizes = FULL
    ctx = {"device": devices[0], "devices": devices}
    if args.four_cards:
        run((phase_device, phase_four_cards), ctx, sizes)
    else:
        mesh = make_torus(R=0.3, r=0.12, nu=sizes.torus_nu, nv=sizes.torus_nv)
        ctx["mesh"] = mesh
        ctx["num_tris"] = int(mesh.indices.size // 3)
        # SdfExporter's default box: a 20% margin (ROADMAP §2.8)
        ctx["box"] = mesh.bounding_box.add_margin(
            0.2 * float(np.max(mesh.bounding_box.size))
        )
        run(ONE_CARD_PHASES, ctx, sizes)
    dev = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
