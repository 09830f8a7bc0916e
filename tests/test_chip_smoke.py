"""chip_smoke.py on the CPU: its device check refuses the CPU, and each
comparison it makes on the card works (passes good results, fails bad
ones) — the phases themselves run here at a tiny size."""
import json
import os
import sys
import types

import numpy as np
import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from sdflib_tpu.utils.primitives import make_torus  # noqa: E402

TINY = cs.Sizes(
    torus_nu=32, torus_nv=16, oracle_points=2048, cpu_subset=256,
    approx_depth=5, approx_start=2, approx_points=1 << 12,
    approx_grad_points=1 << 10, native_points=1024, check_points=1000,
    frame=192, trace_subset=512, exact_depth=4, exact_start=2,
    exact_points=1 << 12, four_nu=24, four_nv=12, four_points=1 << 11,
    four_frame=64, four_exact_depth=3,
)


def _fake_devices(platform, n):
    return [types.SimpleNamespace(platform=platform) for _ in range(n)]


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.require_gpu(jax.devices())


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize(
    "platform, n, count, ok",
    [("gpu", 1, None, True), ("gpu", 4, 4, True), ("gpu", 1, 4, False),
     ("cpu", 4, None, False)],
)
def test_require_gpu_counts(platform, n, count, ok):
    devs = _fake_devices(platform, n)
    if ok:
        assert len(cs.require_gpu(devs, count)) == (count or n)
    else:
        with pytest.raises(SystemExit, match="no GPU"):
            cs.require_gpu(devs, count)


def test_compare_close():
    ref = np.linspace(-1.0, 1.0, 101)
    assert cs.compare_close("x", ref + 1e-7, ref, rtol=0, atol=1e-6) > 0
    with pytest.raises(cs.SmokeFailure, match="beyond"):
        cs.compare_close("x", ref + 1e-3, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(cs.SmokeFailure, match="non-finite"):
        cs.compare_close("x", ref * np.nan, ref, rtol=1, atol=1)
    with pytest.raises(cs.SmokeFailure, match="shape"):
        cs.compare_close("x", ref[:-1], ref, rtol=1, atol=1)
    assert cs.compare_close("x", ref, ref, rtol=0, atol=0, exact=True) == 0
    with pytest.raises(cs.SmokeFailure, match="not identical"):
        cs.compare_close("x", ref + 1e-12, ref, rtol=0, atol=0, exact=True)


def test_compare_gradients():
    g = np.tile([[0.0, 0.0, 1.0]], (1000, 1))
    bad = g.copy()
    bad[0] = [1.0, 0.0, 0.0]
    assert cs.compare_gradients("g", bad, g, atol=1e-3,
                                max_mismatch_frac=1e-3) == 1e-3
    bad[1] = [1.0, 0.0, 0.0]
    with pytest.raises(cs.SmokeFailure, match="gradients differ"):
        cs.compare_gradients("g", bad, g, atol=1e-3, max_mismatch_frac=1e-3)


def test_compare_trace():
    hit = np.array([True, True, False, True])
    depth = np.array([1.0, 2.0, 9.0, 3.0])
    mism, err, p99 = cs.compare_trace(
        "t", hit, depth + 1e-4, hit, depth, max_mismatch_frac=0,
        depth_atol=1e-3)
    assert mism == 0 and err == pytest.approx(1e-4) and p99 <= err
    with pytest.raises(cs.SmokeFailure, match="hit masks"):
        cs.compare_trace("t", ~hit, depth, hit, depth,
                         max_mismatch_frac=0.1, depth_atol=1)
    with pytest.raises(cs.SmokeFailure, match="depth differs"):
        cs.compare_trace("t", hit, depth + 0.1, hit, depth,
                         max_mismatch_frac=0, depth_atol=1e-3)
    with pytest.raises(cs.SmokeFailure, match="hit nothing"):
        cs.compare_trace("t", hit, depth, hit & False, depth,
                         max_mismatch_frac=1, depth_atol=1)


def test_bucket_tier_names():
    sdf = types.SimpleNamespace(bucket_fields=None, scan_chunk=64)
    assert cs.bucket_tier(sdf) == "id-only"
    sdf.bucket_fields = np.zeros((2, 9 * 64), np.float32)
    assert cs.bucket_tier(sdf) == "vertex9"
    sdf.bucket_fields = np.zeros((2, 19 * 64), np.float32)
    assert cs.bucket_tier(sdf) == "frame19"


@pytest.fixture(scope="module")
def ctx():
    mesh = make_torus(R=0.3, r=0.12, nu=TINY.torus_nu, nv=TINY.torus_nv)
    return {
        "device": jax.devices()[0],
        "devices": jax.devices()[:4],
        "mesh": mesh,
        "num_tris": int(mesh.indices.size // 3),
        "box": mesh.bounding_box.add_margin(
            0.2 * float(np.max(mesh.bounding_box.size))),
    }


def test_phases_at_a_tiny_size(ctx, capsys, monkeypatch):
    """oracle -> approx (native .bin round trip) -> trace (against the plain
    tracer) -> exact -> diff, each holding its own checks, on the CPU. The
    default bucket budget is shrunk so that the exact phase takes the path
    it takes at full width on the card: demoted to the id-only tier, then
    rebuilt with dense tables for the explicit scans."""
    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf

    monkeypatch.setattr(ExactOctreeSdf, "_BUCKET_BYTE_BUDGET", 1 << 10)
    for phase in (cs.phase_oracle, cs.phase_approx, cs.phase_trace,
                  cs.phase_exact, cs.phase_diff):
        phase(ctx, TINY)
    recs = [json.loads(l[len("PHASE "):])
            for l in capsys.readouterr().out.splitlines()
            if l.startswith("PHASE ")]
    assert [r["phase"] for r in recs] == [
        "oracle", "approx", "trace", "exact", "diff"]
    for r in recs:
        assert r["seconds_incl_compile"] > 0 and r["rate"] > 0
        assert "peak_bytes_in_use" in r
    exact = recs[3]
    assert exact["bucket_tier_default_budget"] == "id-only"
    assert exact["bucket_tier"] == "vertex9"
    assert exact["bucket_budget_bytes"] == cs.CARD_BUCKET_BUDGET
    assert exact["by_impl"]["xla_window"]["scan"] == "xla_window"


def test_four_card_phase_on_virtual_devices(ctx, capsys):
    """The --four-cards phase on four of the virtual CPU devices: sharded
    results identical to one device, tiled ones within tolerance, and
    every sharded result spread over all four devices."""
    assert len(ctx["devices"]) == 4
    cs.phase_four_cards(ctx, TINY)
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith("PHASE "))
    rec = json.loads(line[len("PHASE "):])
    assert rec["phase"] == "four_cards"
    trace = rec["sharded_trace"]
    assert trace["identical"]
    for key in ("rate", "one_card_rate", "trace_octree_beam_none_rate"):
        assert trace[key] > 0
