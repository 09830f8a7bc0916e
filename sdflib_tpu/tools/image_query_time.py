"""image-query-time: per-pixel query value/cost images of a plane of queries.

Parity with the reference ImageQueryTime tool
(src/tools/ImageQueryTime/main.cpp:255-403): a width^2 plane of query
points rendered to PNGs. The reference times each query individually on
the CPU; here queries run batched, so the per-pixel "time" image is
replaced by a per-pixel COST proxy (octree leaf depth — the number of
descent steps paid for that pixel) plus the batched wall-clock throughput,
and the distance-value image matches the reference's value output.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="image-query-time")
    p.add_argument("sdf_path")
    p.add_argument("output_prefix", help="writes <prefix>_value.png and "
                                         "<prefix>_cost.png")
    p.add_argument("-w", "--width", type=int, default=512)
    p.add_argument("--axis", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--offset", type=float, default=0.5)
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None) -> int:
    import jax.numpy as jnp

    args = build_parser().parse_args(argv)

    from ..io.sdflib_binary import load_sdflib_bin
    from ..render.image import write_png
    from ..sdf import SdfFunction
    from ..sdf.octree import OctreeSdf

    sdf = (
        load_sdflib_bin(args.sdf_path)
        if args.sdf_path.endswith(".bin")
        else SdfFunction.load(args.sdf_path)
    )
    area = sdf.get_sample_area()

    R = args.width
    u = (np.arange(R, dtype=np.float32) + 0.5) / R
    gu, gv = np.meshgrid(u, u, indexing="xy")
    coords = [None, None, None]
    axes2d = [a for a in range(3) if a != args.axis]
    coords[axes2d[0]] = gu
    coords[axes2d[1]] = gv
    coords[args.axis] = np.full_like(gu, args.offset)
    unit = np.stack(coords, axis=-1)
    pts = (area.min + unit * area.size[None, None]).astype(np.float32)

    dev_pts = jnp.asarray(pts.reshape(-1, 3))
    d = sdf.get_distance(dev_pts)
    d.block_until_ready()
    t0 = time.perf_counter()
    d = sdf.get_distance(dev_pts)
    d.block_until_ready()
    dt = time.perf_counter() - t0
    d = np.asarray(d).reshape(R, R)

    # value image: signed distance, blue outside / red inside (reference
    # palette convention: negative = inside)
    rng = max(float(np.abs(d).max()), 1e-9)
    t = 0.5 + 0.5 * np.clip(d / rng, -1, 1)
    value_img = np.stack([1.0 - t, 0.2 + 0.3 * (1 - np.abs(2 * t - 1)), t], -1)
    write_png(args.output_prefix + "_value.png", value_img)

    # cost proxy: leaf depth per pixel for octrees, constant otherwise
    if isinstance(sdf, OctreeSdf):
        from ..render.plane_cut import _octree_node_metrics

        _, rel_len = _octree_node_metrics(sdf, dev_pts)
        depth = -np.log2(np.maximum(np.asarray(rel_len), 1e-9))
        depth = depth.reshape(R, R) + sdf.start_depth
        cost = depth / max(sdf.max_depth, 1)
    else:
        cost = np.full((R, R), 0.5, np.float32)
    write_png(args.output_prefix + "_cost.png", cost)

    us = dt * 1e6 / (R * R)
    print(f"{R}x{R} queries: {dt*1e3:.2f} ms total, {us:.4f} us/query "
          f"({R*R/dt:.3e} queries/s)")
    if args.json:
        print(json.dumps({"width": R, "us_per_query": us,
                          "queries_per_s": R * R / dt}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
