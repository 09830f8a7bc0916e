"""Measured influence-strategy comparison table.

Builds the same exact octree under every culling strategy and reports
list tightness (mean/median/max triangles per leaf), build wall time and
query throughput. Run it on the GPU for numbers worth recording; it runs
on the CPU too (slower, with --cpu).

Usage: python scripts/strategy_table.py [--depth 6] [--big]
"""
from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--start_depth", type=int, default=2)
    ap.add_argument("--min_tris", type=int, default=32)
    ap.add_argument("--big", action="store_true",
                    help="96x48 torus (9216 tris) instead of 48x24")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--queries", type=int, default=1 << 20)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sdflib_tpu.sdf.exact_octree import ExactOctreeSdf
    from sdflib_tpu.utils.primitives import make_torus

    nu, nv = (96, 48) if args.big else (48, 24)
    mesh = make_torus(R=0.3, r=0.12, nu=nu, nv=nv)
    box = mesh.bounding_box.add_margin(0.14)
    rng = np.random.default_rng(0)

    print(f"# torus {nu}x{nv} ({mesh.indices.shape[0]} tris), depth "
          f"{args.depth}, start {args.start_depth}, min_tris {args.min_tris}")
    print(f"{'strategy':>10} {'leaves':>8} {'mean':>8} {'median':>8} "
          f"{'max':>6} {'build_s':>8} {'Mq/s':>8}")
    for strategy in ("region", "lattice", "basic", "precise", "per_vertex"):
        t0 = time.perf_counter()
        ex = ExactOctreeSdf(
            mesh, box, max_depth=args.depth, start_depth=args.start_depth,
            min_triangles_per_node=args.min_tris, strategy=strategy,
        )
        t_build = time.perf_counter() - t0
        cnts = np.asarray(ex.leaf_count)
        cnts = cnts[cnts > 0]
        pts = jnp.asarray(rng.uniform(
            np.asarray(ex.box.min) + 1e-4, np.asarray(ex.box.max) - 1e-4,
            (args.queries, 3),
        ).astype(np.float32))
        jax.block_until_ready(ex.get_distance(pts))  # compile + warm
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(ex.get_distance(pts))
            ts.append(time.perf_counter() - t0)
        rate = args.queries / min(ts) / 1e6
        print(f"{strategy:>10} {len(cnts):>8} {cnts.mean():>8.1f} "
              f"{np.median(cnts):>8.1f} {cnts.max():>6} "
              f"{t_build:>8.1f} {rate:>8.2f}")


if __name__ == "__main__":
    main()
