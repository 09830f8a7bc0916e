"""scaling-bench: rays/queries-per-second scaling over device counts.

Measures sharded query and sphere-trace throughput on 1, 2, 4, ... device
sub-meshes of whatever is attached (GPUs, or the virtual CPU mesh for
plumbing validation) and reports parallel efficiency. In a multi-host
setup run one process per host with
``sdflib_tpu.parallel.initialize_distributed(...)`` first.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="scaling-bench")
    p.add_argument("-m", "--millions_of_samples", type=float, default=2.0)
    p.add_argument("--rays", type=int, default=1 << 19)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from .. import parallel
    from ..sdf.octree import OctreeSdf
    from ..render.sphere_trace import trace_octree
    from ..utils.primitives import make_torus

    mesh_geo = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh_geo.bounding_box.add_margin(0.12)
    oct_ = OctreeSdf(mesh_geo, box, max_depth=args.depth, start_depth=2,
                     termination_threshold=1e-3)
    oct_.build_query_grid()

    devices = jax.devices()
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= len(devices)]

    n = int(1e6 * args.millions_of_samples)
    rng = np.random.default_rng(0)
    pts = rng.uniform(
        oct_.box.min + 1e-4, oct_.box.max - 1e-4, (n, 3)
    ).astype(np.float32)

    nr = args.rays
    u = rng.uniform(-0.5, 0.5, (nr, 2)).astype(np.float32)
    origins = np.concatenate([u, np.full((nr, 1), -1.2, np.float32)], -1)
    dirs = np.tile([[0.0, 0.0, 1.0]], (nr, 1)).astype(np.float32)

    rows = []
    for c in counts:
        m = parallel.default_mesh(devices[:c])

        d = parallel.sharded_distance(oct_, pts, m)
        jax.block_until_ready(d)
        t0 = time.perf_counter()
        d = parallel.sharded_distance(oct_, pts, m)
        jax.block_until_ready(d)
        qps = n / (time.perf_counter() - t0)

        r = parallel.sharded_trace(oct_, origins, dirs, m, max_iters=512)
        jax.block_until_ready(r.depth)
        t0 = time.perf_counter()
        r = parallel.sharded_trace(oct_, origins, dirs, m, max_iters=512)
        jax.block_until_ready(r.depth)
        rps = nr / (time.perf_counter() - t0)

        rows.append({"devices": c, "queries_per_s": qps, "rays_per_s": rps})

    base_q = rows[0]["queries_per_s"]
    base_r = rows[0]["rays_per_s"]
    print(f"{'devices':>8} {'queries/s':>14} {'q-eff':>7} "
          f"{'rays/s':>14} {'r-eff':>7}")
    for row in rows:
        c = row["devices"]
        row["query_efficiency"] = row["queries_per_s"] / (base_q * c)
        row["ray_efficiency"] = row["rays_per_s"] / (base_r * c)
        print(f"{c:>8} {row['queries_per_s']:>14.3e} "
              f"{row['query_efficiency']:>7.2%} "
              f"{row['rays_per_s']:>14.3e} {row['ray_efficiency']:>7.2%}")

    if args.json:
        print(json.dumps({"platform": jax.default_backend(), "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
