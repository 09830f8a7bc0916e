"""A/B the exact-query scan backends and chunk widths on the GPU.

Builds the bench torus exact octree (depth 6, 9,216 triangles), then times
the fused query at 2M points under the grouped scan ("xla") and the window
scan at several window widths, for each scan chunk width, printing one
JSON line per configuration. Timings are fenced by block_until_ready.

Usage: python scripts/scan_ab_bench.py [n_points_log2=21] [cache.npz] [chunks=64,128]

With a cache path, the built structure is saved there on first run and
loaded on later runs.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf
    from sdflib_tpu.sdf.sdf_function import SdfFunction
    from sdflib_tpu.utils.primitives import make_torus

    n = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 21)
    cache = sys.argv[2] if len(sys.argv) > 2 else None
    if cache and not cache.endswith(".npz"):
        cache += ".npz"  # np.savez appends it; keep the exists() check honest
    t0 = time.perf_counter()
    if cache and os.path.exists(cache):
        ex = SdfFunction.load(cache)
        print(f"load: {time.perf_counter() - t0:.1f}s", flush=True)
    else:
        mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
        box = mesh.bounding_box.add_margin(0.14)
        ex = ExactOctreeSdf(
            mesh, box, max_depth=6, start_depth=2, min_triangles_per_node=32
        )
        print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
        if cache:
            ex.save(cache)

    rng = np.random.default_rng(0)
    lo = np.asarray(ex.box.min) + 1e-4
    hi = np.asarray(ex.box.max) - 1e-4
    pts = jnp.asarray(rng.uniform(lo, hi, (n, 3)).astype(np.float32))

    # impl sweep: "xla_window@G" entries set the window width
    impls = ["xla", "xla_window@4", "xla_window@8", "xla_window@16",
             "xla_window@32"]
    chunks = (64, 128)
    if len(sys.argv) > 3:
        chunks = tuple(int(c) for c in sys.argv[3].split(","))

    results = {}
    for chunk in chunks:
        try:
            ex.set_scan_chunk(chunk)
        except ValueError as e:
            print(json.dumps({"chunk": chunk, "error": repr(e)}), flush=True)
            continue
        for impl_spec in impls:
            impl, _, width = impl_spec.partition("@")
            key = f"{impl_spec}-{chunk}"
            try:
                ex.set_scan_impl(impl)
                if width:
                    ex.window_width = int(width)
                cks = float(jnp.sum(ex.get_distance(pts)))
                ts = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    jax.block_until_ready(ex.get_distance(pts))
                    ts.append(time.perf_counter() - t0)
                best = min(ts)
                results[key] = {"qps": n / best, "checksum": cks}
                print(json.dumps({
                    "impl": key, "qps": n / best, "best_ms": best * 1e3,
                    "all_ms": [round(t * 1e3, 1) for t in ts],
                    "checksum": cks, "stats": {
                        k: v for k, v in ex._last_scan_stats.items()
                        if isinstance(v, (int, float))
                    },
                }), flush=True)
            except Exception as e:  # keep the other configs if one dies
                print(json.dumps({"impl": key, "error": repr(e)}), flush=True)

    if "xla-64" in results:
        base = results["xla-64"]
        summary = {
            k: {
                "speedup_vs_xla64": v["qps"] / base["qps"],
                "checksum_agrees": bool(
                    abs(v["checksum"] - base["checksum"])
                    <= 1e-3 * max(1.0, abs(base["checksum"]))
                ),
            }
            for k, v in results.items() if k != "xla-64"
        }
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
