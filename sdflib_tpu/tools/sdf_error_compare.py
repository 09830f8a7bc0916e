"""sdf-error-compare: error histogram bucketed by distance to the surface.

Parity with the reference SdfErrorCompare tool
(src/tools/SdfErrorCompare/main.cpp:382-425): N million uniform samples,
RMSE/MAE per |exact distance| bucket, plus overall metrics and throughput
for each structure under comparison. External baselines (ICG/CGAL/OpenVDB)
are compile-gated in the reference and out of scope here; any number of
our own containers can be compared against the exact reference instead.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdf-error-compare")
    p.add_argument("exact_path",
                   help="Ground truth: exact container or a mesh file")
    p.add_argument("sdf_paths", nargs="+",
                   help="SDF containers to evaluate against the ground truth")
    p.add_argument("-m", "--millions_of_samples", type=float, default=1.0)
    p.add_argument("--histogram_bins", type=int, default=20)
    p.add_argument("--histogram_range", type=float, default=None,
                   help="Max |distance| for the histogram (default: auto)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    return p


def _load(path):
    from ..io.sdflib_binary import load_sdflib_bin
    from ..mesh import load_mesh
    from ..sdf import RealSdf, SdfFunction

    if path.endswith((".ply", ".obj", ".stl", ".off")):
        return RealSdf(load_mesh(path))
    if path.endswith(".bin"):
        return load_sdflib_bin(path)
    return SdfFunction.load(path)


def main(argv=None) -> int:
    import jax.numpy as jnp

    args = build_parser().parse_args(argv)
    exact = _load(args.exact_path)

    n = int(1e6 * args.millions_of_samples)
    rng = np.random.default_rng(args.seed)
    area = exact.get_sample_area()
    samples = (
        area.center + (rng.uniform(0, 1, (n, 3)) - 0.5) * (area.size - 1e-5)
    ).astype(np.float32)

    d_exact = np.asarray(exact.get_distance(jnp.asarray(samples)))
    hist_max = args.histogram_range or float(np.quantile(np.abs(d_exact), 0.99))
    edges = np.linspace(0.0, hist_max, args.histogram_bins + 1)
    bucket = np.clip(
        np.digitize(np.abs(d_exact), edges) - 1, 0, args.histogram_bins - 1
    )

    results = []
    for path in args.sdf_paths:
        sdf = _load(path)
        pts = jnp.asarray(samples)
        d = sdf.get_distance(pts)
        d.block_until_ready()
        t0 = time.perf_counter()
        d = sdf.get_distance(pts)
        d.block_until_ready()
        dt = time.perf_counter() - t0
        d = np.asarray(d)

        diff = d.astype(np.float64) - d_exact.astype(np.float64)
        per_bucket = []
        for b in range(args.histogram_bins):
            m = bucket == b
            if not m.any():
                per_bucket.append(None)
                continue
            per_bucket.append(
                {
                    "lo": float(edges[b]),
                    "hi": float(edges[b + 1]),
                    "rmse": float(np.sqrt(np.mean(diff[m] ** 2))),
                    "mae": float(np.mean(np.abs(diff[m]))),
                    "count": int(m.sum()),
                }
            )
        res = {
            "path": path,
            "us_per_query": dt * 1e6 / n,
            "rmse": float(np.sqrt(np.mean(diff**2))),
            "mae": float(np.mean(np.abs(diff))),
            "max_error": float(np.abs(diff).max()),
            "histogram": per_bucket,
        }
        results.append(res)

        print(f"== {path}")
        print(f"  us/query: {res['us_per_query']:.4f}   RMSE: {res['rmse']:.3e}"
              f"   MAE: {res['mae']:.3e}   max: {res['max_error']:.3e}")
        print("  |d| bucket        RMSE         MAE       n")
        for pb in per_bucket:
            if pb is None:
                continue
            print(
                f"  [{pb['lo']:.4f},{pb['hi']:.4f})"
                f"  {pb['rmse']:.3e}  {pb['mae']:.3e}  {pb['count']}"
            )

    if args.json:
        print(json.dumps({"samples": n, "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
