"""Level-synchronous (breadth-first) octree builder.

JAX re-design of the reference's depth-first recursive builder
(reference: src/sdf/OctreeSdfDepthFirst.h:31-558). The reference walks a
per-thread stack, filtering triangles per node and sampling 19 midpoints;
here every level is one batched device computation over all active nodes:

  1. sample the exact SDF (distance + gradient) at the 19 mid-edge/face/
     center points of every active node, brute-forcing only each node's
     *candidate triangle list*;
  2. fit leaf polynomial coefficients from the 8 corner values
     (InterpolationMethods.h:292-378 semantics);
  3. evaluate the termination rule (OctreeSdfUtils.h:61-238) — nodes whose
     error integral < threshold^2 become leaves
     (OctreeSdfDepthFirst.h:210);
  4. cull each node's candidate list for its children with the conservative
     center-distance criterion  d(tri, center) <= min_t d(t, center) + diag,
     which provably preserves the globally nearest triangle for every point
     in the node (the role VHQueries' BVH / BasicTrianglesInfluence's GJK
     tests play in the reference, TrianglesInfluence.h:119-168);
  5. allocate children with prefix sums; children inherit the parent's
     27-point value lattice (corner sharing, OctreeSdfDepthFirst.h:225-336).

The output flat u32 array layout is byte-identical in meaning to the
reference's (OctreeSdf.h:39-98): dense z-major start grid first, inner node
= u32 children index, leaf = bit31 | coefficient index, coefficients stored
bitcast in the same array.
"""
from __future__ import annotations

import time as _time
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..triangle import TriangleDataSoA
from ..ops.point_triangle import (
    signed_dist_grad_pair,
    sq_dist_pair,
    signed_distance_grad_batch,
)
from ..ops.interpolation import (
    MIDPOINT_POSITIONS,
    estimate_error_by_distance,
    estimate_error_simpson,
    estimate_error_trapezoid,
    tricubic_fit,
    tricubic_interpolate,
    trilinear_interpolate,
)

__all__ = ["build_octree", "OctreeBuildResult", "IS_LEAF_MASK", "CHILDREN_INDEX_MASK"]

IS_LEAF_MASK = np.uint32(1 << 31)
MARK_MASK = np.uint32(1 << 30)
CHILDREN_INDEX_MASK = np.uint32(~(IS_LEAF_MASK | MARK_MASK) & 0xFFFFFFFF)

# Midpoint offsets in node-local coords {-1,0,1} (node half-size units),
# identical ordering to the reference's nodeSamplePoints
# (OctreeSdfDepthFirst.h:139-162) and MIDPOINT_POSITIONS.
MID_OFFSETS = (2.0 * MIDPOINT_POSITIONS - 1.0).astype(np.float32)  # (19, 3)


def _lattice_source_tables():
    """For each of the 27 half-step lattice points of a node, whether it is
    one of the 8 corners (and which) or one of the 19 midpoints (and which).
    Lattice index l = ix + 3*iy + 9*iz with coords in {0,1,2}."""
    corner_of = np.full(27, -1, np.int64)
    mid_of = np.full(27, -1, np.int64)
    mid_counter = 0
    for iz in range(3):
        for iy in range(3):
            for ix in range(3):
                l = ix + 3 * iy + 9 * iz
                if ix % 2 == 0 and iy % 2 == 0 and iz % 2 == 0:
                    corner_of[l] = (ix // 2) + 2 * (iy // 2) + 4 * (iz // 2)
                else:
                    mid_of[l] = mid_counter
                    mid_counter += 1
    assert mid_counter == 19
    return corner_of, mid_of


_CORNER_OF, _MID_OF = _lattice_source_tables()

# child_corner_lattice[child, corner] -> lattice index (27) of that corner.
_CHILD_CORNER_LATTICE = np.zeros((8, 8), np.int64)
for _c in range(8):
    _cx, _cy, _cz = _c & 1, (_c >> 1) & 1, (_c >> 2) & 1
    for _i in range(8):
        _ix, _iy, _iz = _i & 1, (_i >> 1) & 1, (_i >> 2) & 1
        _CHILD_CORNER_LATTICE[_c, _i] = (
            (_cx + _ix) + 3 * (_cy + _iy) + 9 * (_cz + _iz)
        )


class OctreeBuildResult(NamedTuple):
    octree_u32: np.ndarray       # flat node/coefficient array
    value_range: float           # max |corner distance| over leaves
    min_border_value: float      # min interpolated value on the box border
    leaf_centers: np.ndarray     # (L, 3) world centers of leaves
    leaf_halves: np.ndarray      # (L,) half edge lengths
    leaf_coeff_idx: np.ndarray   # (L,) u32-array index of each leaf's coeffs
    leaf_depths: np.ndarray      # (L,)
    stats: dict                  # per-depth build statistics


def _fit(corner_vals, node_size, interpolation):
    if interpolation == "tricubic":
        return tricubic_fit(corner_vals, node_size)
    return corner_vals[..., 0]  # trilinear: the 8 corner distances


def _error(coeffs, mid_f, rule, decay, interpolation):
    if rule == "trapezoid":
        return estimate_error_trapezoid(coeffs, mid_f, interpolation)
    if rule == "simpson":
        return estimate_error_simpson(coeffs, mid_f, interpolation)
    if rule == "by_distance":
        return estimate_error_by_distance(coeffs, mid_f, decay, interpolation)
    # rule == "none": never terminate early
    return jnp.full(coeffs.shape[:-1], jnp.inf, coeffs.dtype)


@partial(jax.jit, static_argnames=("rule", "interpolation", "strategy"))
def _level_chunk(
    tris: TriangleDataSoA,
    centers,        # (C, 3)
    corner_vals,    # (C, 8, 8)
    cand_idx,       # (C, K) int32
    cand_valid,     # (C, K) bool
    half,           # scalar: node half edge
    decay,          # by-distance decay parameter
    packed=None,    # (T, 19) packed fields (influence strategies only)
    geo=None,       # (T, 6) AABBs / (T, 3, 3) vertices (strategies only)
    *,
    rule: str,
    interpolation: str,
    strategy: str = "distance",
):
    """One chunk of one level: midpoint sampling + fit + error + culling."""
    # Gather candidate triangle SoA rows: (C, K, ...)
    cand = jax.tree.map(lambda a: a[cand_idx], tris)

    pts = centers[:, None, :] + jnp.asarray(MID_OFFSETS)[None] * half  # (C,19,3)

    # Squared distances (C, 19, K)
    sqd = jax.vmap(                      # over nodes C
        jax.vmap(                        # over points 19
            jax.vmap(sq_dist_pair, in_axes=(None, 0)),  # over triangles K
            in_axes=(0, None),
        )
    )(pts, cand)
    sqd = jnp.where(cand_valid[:, None, :], sqd, jnp.inf)

    win_local = jnp.argmin(sqd, axis=2)                       # (C, 19)
    win_global = jnp.take_along_axis(cand_idx, win_local, axis=1)  # (C, 19)
    win_tris = jax.tree.map(lambda a: a[win_global], tris)    # (C, 19, ...)
    d, g = jax.vmap(jax.vmap(signed_dist_grad_pair))(pts, win_tris)
    zeros = jnp.zeros(d.shape + (4,), d.dtype)
    mid_vals = jnp.concatenate([d[..., None], g, zeros], axis=-1)  # (C,19,8)

    # Conservative culling for children. The default ("distance") rule —
    # keep t iff d(t, center) <= min_t d(t, center) + full-diagonal — costs
    # nothing extra (the center distances fall out of the midpoint pass);
    # the named influence strategies reuse the exact builder's safe-superset
    # culls (TrianglesInfluence.h role) for tighter lists at more flops.
    if strategy == "distance":
        dc = jnp.sqrt(sqd[:, 9, :])  # midpoint 9 is the node center
        minc = jnp.min(dc, axis=1, keepdims=True)
        diag = 2.0 * jnp.sqrt(jnp.asarray(3.0, dc.dtype)) * half
        keep = (dc <= minc + diag) & cand_valid
    else:
        # late import: exact_octree imports this module at load time
        from . import exact_octree as _ex

        cull = {
            "lattice": _ex._lattice_cull_chunk,
            "basic": _ex._basic_cull_chunk,
            "precise": _ex._precise_cull_chunk,
            "per_vertex": _ex._per_vertex_cull_chunk,
        }[strategy]
        keep, _, _ = cull(packed, geo, centers, cand_idx, cand_valid, half)
    keep_count = jnp.sum(keep, axis=1)

    coeffs = _fit(corner_vals, 2.0 * half, interpolation)
    err = _error(coeffs, mid_vals[..., 0], rule, decay, interpolation)
    return mid_vals, coeffs, err, keep, keep_count


@partial(jax.jit, static_argnames=("interpolation",))
def _fit_only(corner_vals, node_size, *, interpolation):
    return _fit(corner_vals, node_size, interpolation)


def _round_pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def build_octree(
    tris: TriangleDataSoA,
    box_min,
    box_size: float,
    max_depth: int,
    start_depth: int,
    termination_rule: str = "trapezoid",
    termination_threshold: float = 1e-3,
    error_decay: float = 0.0,
    interpolation: str = "tricubic",
    pair_budget: int = 1 << 21,
    strategy: str = "distance",
) -> OctreeBuildResult:
    """Build the approximate octree. ``box`` must already be cubified.

    ``strategy`` selects the child-list cull: "distance" (free center-
    distance rule) or any exact-builder influence strategy
    ("lattice"/"basic"/"precise"/"per_vertex") for tighter lists — all
    safe supersets, so the emitted structure's VALUES are identical.

    Returns the flat u32 array in the reference layout plus leaf metadata.
    """
    tris_dev = jax.tree.map(jnp.asarray, tris)
    # late import: exact_octree imports this module at load time
    from .exact_octree import _PRECISE_MAX_REGIONS, prepare_cull_inputs

    packed_s, geo_s = prepare_cull_inputs(tris_dev, strategy)
    T = tris.num_triangles
    box_min = np.asarray(box_min, np.float32)
    box_size = np.float32(box_size)
    num_coeff = 64 if interpolation == "tricubic" else 8
    sq_threshold = np.float32(termination_threshold) ** 2

    s = 1 << start_depth
    n0 = s * s * s

    # ---- Seed: sample dist+grad at the (s+1)^3 corner lattice --------------
    cell = box_size / s
    ax = box_min[None, 0] + cell * np.arange(s + 1, dtype=np.float32)
    ay = box_min[None, 1] + cell * np.arange(s + 1, dtype=np.float32)
    az = box_min[None, 2] + cell * np.arange(s + 1, dtype=np.float32)
    gz, gy, gx = np.meshgrid(az, ay, ax, indexing="ij")
    lat_pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    d0, g0 = signed_distance_grad_batch(lat_pts, tris_dev)
    lat_vals = np.zeros((lat_pts.shape[0], 8), np.float32)
    lat_vals[:, 0] = np.asarray(d0)
    lat_vals[:, 1:4] = np.asarray(g0)
    lat_vals = lat_vals.reshape(s + 1, s + 1, s + 1, 8)  # [z, y, x]

    # Per-seed-node corners, z-major node ordering (OctreeSdf.cpp:106).
    zi, yi, xi = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    corner_vals = np.zeros((n0, 8, 8), np.float32)
    for ci in range(8):
        cx, cy, cz = ci & 1, (ci >> 1) & 1, (ci >> 2) & 1
        corner_vals[:, ci] = lat_vals[
            (zi + cz).ravel(), (yi + cy).ravel(), (xi + cx).ravel()
        ]
    centers = np.stack(
        [
            box_min[0] + cell * (xi.ravel() + 0.5),
            box_min[1] + cell * (yi.ravel() + 0.5),
            box_min[2] + cell * (zi.ravel() + 0.5),
        ],
        axis=-1,
    ).astype(np.float32)

    cand_idx = np.broadcast_to(np.arange(T, dtype=np.int32), (n0, T)).copy()
    cand_valid = np.ones((n0, T), bool)

    # ---- Flat array management ---------------------------------------------
    blocks: list[np.ndarray] = [np.zeros(n0, np.uint32)]
    total_len = n0
    node_slots = np.arange(n0, dtype=np.int64)

    leaf_centers, leaf_halves, leaf_coeff_idx, leaf_depths = [], [], [], []
    value_range = 0.0
    stats: dict = {
        "nodes_per_depth": {},
        "leaves_per_depth": {},
        "tris_per_node": {},
        # dispatch-vs-transfer split of the level kernels: "enqueue" is
        # the async dispatch cost, "device_and_d2h" covers kernel execution
        # plus the host transfer forced by np.asarray.
        "level_enqueue_s": 0.0,
        "level_device_and_d2h_s": 0.0,
    }

    depth = start_depth
    half = 0.5 * cell

    def _emit_leaves(mask, coeffs_np, cvals, cents, hlf, dpt, slots):
        nonlocal total_len, value_range
        idxs = np.nonzero(mask)[0]
        if len(idxs) == 0:
            return
        L = len(idxs)
        # Align the coefficient block to num_coeff words so every leaf's
        # coefficients form one aligned row of a (W/num_coeff, num_coeff)
        # view — queries then fetch them as a single row gather instead
        # of per-element gathers.
        align_pad = (-total_len) % num_coeff
        if align_pad:
            blocks.append(np.zeros(align_pad, np.uint32))
            total_len += align_pad
        coeff_block = coeffs_np[idxs].astype(np.float32).view(np.uint32)
        starts = total_len + num_coeff * np.arange(L, dtype=np.int64)
        blocks.append(coeff_block.reshape(-1))
        total_len += num_coeff * L
        # point the leaf nodes at their coefficients
        leaf_words = (starts.astype(np.uint32) | IS_LEAF_MASK)
        _set_slots(slots[idxs], leaf_words)
        leaf_centers.append(cents[idxs])
        leaf_halves.append(np.full(L, hlf, np.float32))
        leaf_coeff_idx.append(starts)
        leaf_depths.append(np.full(L, dpt, np.int32))
        value_range = max(
            value_range, float(np.abs(cvals[idxs, :, 0]).max(initial=0.0))
        )

    slot_patches: list[tuple[np.ndarray, np.ndarray]] = []

    def _set_slots(slots, words):
        slot_patches.append((slots.copy(), words.astype(np.uint32)))

    while centers.shape[0] > 0:
        N = centers.shape[0]
        K = cand_idx.shape[1]
        node_size = 2.0 * half
        stats["nodes_per_depth"][depth] = N

        if depth == max_depth:
            # Final level: fit from corners and emit everything as leaves
            # (OctreeSdfDepthFirst.h:372-390).
            coeffs = np.asarray(
                _fit_only(
                    jnp.asarray(corner_vals),
                    jnp.float32(node_size),
                    interpolation=interpolation,
                )
            )
            _emit_leaves(
                np.ones(N, bool), coeffs, corner_vals, centers, half, depth,
                node_slots,
            )
            stats["leaves_per_depth"][depth] = N
            break

        # ---- chunked level kernel ------------------------------------------
        # Candidate width quantized to 8*4^j (not every pow2): each
        # distinct (C, Kp) is a fresh executable whose per-process
        # first call pays a compile; x4 steps halve the variant count
        # for <=2x masked pad evals in the (cheap) cull portion.
        Kp = 8
        while Kp < K:
            Kp *= 4
        C = max(1, _round_pow2(pair_budget // max(Kp, 1) // 2, 1))
        if strategy == "precise":
            # the precise cull's pair state carries an extra region factor
            C = max(1, C // _PRECISE_MAX_REGIONS)
        Np = -(-N // C) * C
        pad = Np - N

        def _padded(a, fill=0):
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, widths, constant_values=fill)

        cen_p = _padded(centers)
        cv_p = _padded(corner_vals)
        ci_p = np.pad(cand_idx, [(0, pad), (0, Kp - K)], constant_values=0)
        va_p = np.pad(cand_valid, [(0, pad), (0, Kp - K)], constant_values=False)
        va_p[N:, 0] = True  # padded nodes need >=1 valid candidate (argmin)

        mids = np.zeros((Np, 19, 8), np.float32)
        coeffs = np.zeros((Np, num_coeff), np.float32)
        errs = np.zeros(Np, np.float32)
        keeps = np.zeros((Np, Kp), bool)
        kcounts = np.zeros(Np, np.int64)
        for i in range(0, Np, C):
            sl = slice(i, i + C)
            t0 = _time.perf_counter()
            m, c, e, k, kc = _level_chunk(
                tris_dev,
                jnp.asarray(cen_p[sl]),
                jnp.asarray(cv_p[sl]),
                jnp.asarray(ci_p[sl]),
                jnp.asarray(va_p[sl]),
                jnp.float32(half),
                jnp.float32(error_decay),
                packed_s,
                geo_s,
                rule=termination_rule,
                interpolation=interpolation,
                strategy=strategy,
            )
            stats["level_enqueue_s"] += _time.perf_counter() - t0
            t0 = _time.perf_counter()
            mids[sl], coeffs[sl], errs[sl] = map(np.asarray, (m, c, e))
            keeps[sl], kcounts[sl] = np.asarray(k), np.asarray(kc)
            stats["level_device_and_d2h_s"] += _time.perf_counter() - t0

        mids, coeffs, errs = mids[:N], coeffs[:N], errs[:N]
        # Drop padded rows AND padded candidate columns (indices >= K would
        # be out of bounds for cand_idx).
        keeps, kcounts = keeps[:N, :K], kcounts[:N]
        stats["tris_per_node"][depth] = float(kcounts.mean())

        terminal = errs < sq_threshold
        stats["leaves_per_depth"][depth] = int(terminal.sum())

        _emit_leaves(terminal, coeffs, corner_vals, centers, half, depth, node_slots)

        # ---- subdivide the rest --------------------------------------------
        t_epi = _time.perf_counter()
        sub = np.nonzero(~terminal)[0]
        if len(sub) == 0:
            break
        M = len(sub)

        # Children block allocation: 8 contiguous slots per subdividing node.
        child_base = total_len + 8 * np.arange(M, dtype=np.int64)
        blocks.append(np.zeros(8 * M, np.uint32))
        total_len += 8 * M
        _set_slots(node_slots[sub], child_base.astype(np.uint32))

        # 27-point value lattice per subdividing node.
        lattice = np.zeros((M, 27, 8), np.float32)
        is_corner = _CORNER_OF >= 0
        lattice[:, is_corner] = corner_vals[sub][:, _CORNER_OF[is_corner]]
        lattice[:, ~is_corner] = mids[sub][:, _MID_OF[~is_corner]]

        new_corner_vals = lattice[:, _CHILD_CORNER_LATTICE]  # (M, 8, 8, 8)
        new_corner_vals = new_corner_vals.reshape(M * 8, 8, 8)

        child_offsets = np.array(
            [[(c & 1) * 2 - 1, ((c >> 1) & 1) * 2 - 1, ((c >> 2) & 1) * 2 - 1]
             for c in range(8)],
            np.float32,
        )  # (8,3) in {-1,1}
        new_centers = (
            centers[sub][:, None, :] + child_offsets[None] * (0.5 * half)
        ).reshape(M * 8, 3)

        new_slots = (child_base[:, None] + np.arange(8)[None]).reshape(-1)

        # Children candidate lists = parent's culled list, compacted.
        # Counting compaction (O(M*K)) instead of a stable argsort
        # (O(M*K log K)) — the sort was the dominant term of the host
        # epilogue PERF.md §4 attributes (~5 s at 9k tris, depth 6).
        K_next = max(1, int(kcounts[sub].max(initial=1)))
        kp = keeps[sub]
        dest = np.cumsum(kp, axis=1) - 1          # kept -> front, in order
        dest[~kp] = K_next                        # dropped -> spill column
        rows = np.arange(M)[:, None]
        new_cand = np.zeros((M, K_next + 1), cand_idx.dtype)
        new_cand[rows, dest] = cand_idx[sub]
        new_valid = np.zeros((M, K_next + 1), bool)
        new_valid[rows, dest] = kp
        new_cand = new_cand[:, :K_next]
        new_valid = new_valid[:, :K_next]

        centers = new_centers
        corner_vals = new_corner_vals.astype(np.float32)
        node_slots = new_slots
        cand_idx = np.repeat(new_cand, 8, axis=0)
        cand_valid = np.repeat(new_valid, 8, axis=0)
        half = 0.5 * half
        depth += 1
        stats["level_host_epilogue_s"] = (
            stats.get("level_host_epilogue_s", 0.0)
            + (_time.perf_counter() - t_epi)
        )

    # ---- assemble the flat array -------------------------------------------
    # Trailing pad to a whole number of 64-word rows (query-side reshapes).
    tail_pad = (-total_len) % 64
    if tail_pad:
        blocks.append(np.zeros(tail_pad, np.uint32))
        total_len += tail_pad
    octree = np.concatenate(blocks)
    assert octree.shape[0] == total_len
    for slots, words in slot_patches:
        octree[slots] = words

    leaf_centers = np.concatenate(leaf_centers) if leaf_centers else np.zeros((0, 3), np.float32)
    leaf_halves = np.concatenate(leaf_halves) if leaf_halves else np.zeros(0, np.float32)
    leaf_coeff_idx = np.concatenate(leaf_coeff_idx) if leaf_coeff_idx else np.zeros(0, np.int64)
    leaf_depths = np.concatenate(leaf_depths) if leaf_depths else np.zeros(0, np.int32)

    min_border = _compute_min_border_value(
        octree, leaf_centers, leaf_halves, leaf_coeff_idx,
        box_min, box_size, num_coeff, interpolation,
    )

    return OctreeBuildResult(
        octree_u32=octree,
        value_range=float(value_range),
        min_border_value=float(min_border),
        leaf_centers=leaf_centers,
        leaf_halves=leaf_halves,
        leaf_coeff_idx=leaf_coeff_idx,
        leaf_depths=leaf_depths,
        stats=stats,
    )


def _compute_min_border_value(
    octree, leaf_centers, leaf_halves, leaf_coeff_idx,
    box_min, box_size, num_coeff, interpolation,
):
    """Minimum interpolated value at leaf corners lying on the domain border
    (OctreeSdf.cpp:155-230 semantics, vectorized over all leaves)."""
    if leaf_centers.shape[0] == 0:
        return np.inf
    corners_unit = np.array(
        [[(c & 1), ((c >> 1) & 1), ((c >> 2) & 1)] for c in range(8)], np.float32
    )
    corner_world = (
        leaf_centers[:, None, :]
        + (2.0 * corners_unit[None] - 1.0) * leaf_halves[:, None, None]
    )
    t = (corner_world - box_min[None, None]) / box_size
    on_border = np.any((t < 1e-4) | (t > 1.0 - 1e-4), axis=-1)  # (L, 8)
    if not on_border.any():
        return np.inf
    coeffs = octree.view(np.float32)[
        leaf_coeff_idx[:, None] + np.arange(num_coeff)[None]
    ]
    fn = tricubic_interpolate if interpolation == "tricubic" else trilinear_interpolate
    vals = np.asarray(
        fn(jnp.asarray(coeffs)[:, None, :], jnp.asarray(corners_unit)[None])
    )  # (L, 8)
    return float(np.where(on_border, vals, np.inf).min())
