"""Time the nearest-triangle sweep on the GPU: XLA's compilation of
``ops.point_triangle.nearest_triangle`` against the Triton-route Pallas
kernel (``ops.pallas_kernels.nearest_triangle_pallas``).

    python scripts/nearest_kernel_bench.py

Shapes: 2^20 points x 9,216 triangles (the bench torus) and 2^16 points x
100,800 triangles (the smoke run's oracle). Each configuration is checked
against the XLA result (squared distances to rtol 1e-5) before it is
timed; the time is the median of 5 calls fenced by ``block_until_ready``.
Prints one JSON line per configuration, then the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_s(fn, reps=5):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import jax
    import jax.numpy as jnp

    from sdflib_tpu.ops.pallas_kernels import nearest_triangle_pallas
    from sdflib_tpu.ops.point_triangle import nearest_triangle
    from sdflib_tpu.triangle import calculate_mesh_triangle_data
    from sdflib_tpu.utils.primitives import make_torus

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found platform {dev.platform!r}")
    cases = [((96, 48), 1 << 20), ((420, 120), 1 << 16)]
    for (nu, nv), P in cases:
        mesh = make_torus(R=0.3, r=0.12, nu=nu, nv=nv)
        tris = jax.tree.map(jnp.asarray, calculate_mesh_triangle_data(mesh))
        T = int(tris.v2x.shape[0])
        box = mesh.bounding_box.add_margin(0.14)
        pts = jnp.asarray(
            np.random.default_rng(0)
            .uniform(box.min, box.max, (P, 3)).astype(np.float32)
        )
        ref, _ = nearest_triangle(pts, tris)
        ref = np.asarray(ref)
        for chunk in (256, 512, 1024, 2048):
            s = _median_s(lambda: nearest_triangle(pts, tris, chunk=chunk))
            print(json.dumps({"impl": "xla", "points": P, "triangles": T,
                              "chunk": chunk, "median_s": s,
                              "pairs_per_s": P * T / s}), flush=True)
        for tp, tt, nw, ns in ((64, 32, 4, 2), (128, 32, 4, 2),
                               (128, 32, 8, 2), (64, 64, 4, 2),
                               (256, 16, 4, 2), (128, 16, 4, 1),
                               (32, 32, 2, 2)):
            fn = lambda: nearest_triangle_pallas(
                pts, tris, tile_p=tp, tile_t=tt, num_warps=nw, num_stages=ns
            )
            got = np.asarray(fn()[0])
            ok = bool(np.allclose(got, ref, rtol=1e-5, atol=1e-7))
            s = _median_s(fn)
            print(json.dumps({"impl": "pallas_triton", "points": P,
                              "triangles": T, "tile_p": tp, "tile_t": tt,
                              "num_warps": nw, "num_stages": ns,
                              "matches_xla": ok, "median_s": s,
                              "pairs_per_s": P * T / s}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip())
    print(json.dumps({"device_kind": dev.device_kind}))


if __name__ == "__main__":
    main()
