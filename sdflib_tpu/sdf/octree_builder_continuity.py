"""CONTINUITY octree builder (approximate C0 across leaf faces).

JAX re-design of the reference's breadth-first no-delay continuity
algorithm (reference: src/sdf/OctreeSdfBreadthFirstNoDelay.h:83-1226).
The reference threads 6 face-neighbor pointers down the tree per node and
uses 24 bit-masks to find midpoint samples shared with already-terminated
leaves; those samples are overwritten with the neighbor leaf's interpolated
value when the difference is within the termination threshold, otherwise
the offending leaf is queued for re-subdivision (:419-515, :740-1176).

The batched equivalent here is level-synchronous and fully vectorized:

  * every level is one batched device computation over all active nodes
    (the same ``_level_chunk`` kernel as the NO_CONTINUITY path);
  * terminated leaves are registered in flat arrays keyed by an int64
    (depth, x, y, z) code; the neighbor-of-a-midpoint lookup becomes a
    ``searchsorted`` of 42 candidate neighbor codes per node over the
    sorted leaf codes, walked up through ancestors (a leaf partition hits
    at most one ancestor level) — no pointers, no masks;
  * midpoint overwrites and the neighbor re-interpolation run as one
    batched device evaluation of the neighbor polynomials;
  * leaves queued for re-subdivision are re-opened (their node word is
    re-patched from leaf to children pointer) and re-enter the per-depth
    work list as forced-subdivide nodes; the loop always processes the
    shallowest depth with pending work, so the fixed-point iteration the
    reference implements with an explicit queue falls out of the schedule.

Coefficient storage is allocated only at final assembly, so re-opened
leaves never leave dead coefficient slots (the reference recycles slots
explicitly, :740-780).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..triangle import TriangleDataSoA
from ..ops.point_triangle import signed_distance_grad_batch, sq_dist_pair
from ..ops.interpolation import (
    gradient_at,
    interpolate_at,
)
from .octree_builder import (
    CHILDREN_INDEX_MASK,
    IS_LEAF_MASK,
    MID_OFFSETS,
    OctreeBuildResult,
    _CHILD_CORNER_LATTICE,
    _CORNER_OF,
    _MID_OF,
    _compute_min_border_value,
    _fit_only,
    _level_chunk,
    _round_pow2,
)

__all__ = ["build_octree_continuity"]


def _neighbor_deltas():
    """Per-midpoint neighbor cell deltas. Returns (mid_idx, delta) pairs:
    face centers have 1 sharing neighbor, edge midpoints 3 (two
    face-adjacent + one edge-diagonal); the node center (midpoint 9) has
    none. Face-direction deltas come first so they win ties, matching the
    reference's face-neighbor masks (OctreeSdfBreadthFirstNoDelay.h:139-176).
    """
    pairs = []
    for m in range(19):
        o = MID_OFFSETS[m].astype(np.int64)  # in {-1,0,1}
        nz = [i for i in range(3) if o[i] != 0]
        if not nz:
            continue  # center
        singles, diag = [], []
        for i in nz:
            d = np.zeros(3, np.int64)
            d[i] = o[i]
            singles.append(d)
        if len(nz) > 1:
            d = np.zeros(3, np.int64)
            for i in nz:
                d[i] = o[i]
            diag.append(d)
        for d in singles + diag:
            pairs.append((m, d))
    mids = np.array([p[0] for p in pairs], np.int64)
    deltas = np.stack([p[1] for p in pairs])  # (42, 3)
    assert len(pairs) == 42
    return mids, deltas


_NB_MIDS, _NB_DELTAS = _neighbor_deltas()


def _code(depth, x, y, z):
    """Pack (depth, x, y, z) into one int64 key (depth <= 15, coord < 2^16)."""
    return (
        (np.asarray(depth, np.int64) << 48)
        | (np.asarray(x, np.int64) << 32)
        | (np.asarray(y, np.int64) << 16)
        | np.asarray(z, np.int64)
    )


class _LeafRegistry:
    """Growable flat arrays of terminated leaves, searchable by coord code.

    ``alive`` persists across appends — re-opened leaves stay dead even
    after later levels add new leaves (the cached sort index is the only
    thing rebuilt on append)."""

    def __init__(self, num_coeff: int):
        self.num_coeff = num_coeff
        self.codes = np.zeros(0, np.int64)
        self.coeffs = np.zeros((0, num_coeff), np.float32)
        self.corner_vals = np.zeros((0, 8, 8), np.float32)
        self.centers = np.zeros((0, 3), np.float32)
        self.halves = np.zeros(0, np.float32)
        self.slots = np.zeros(0, np.int64)
        self.depths = np.zeros(0, np.int32)
        self.alive = np.zeros(0, bool)
        self._sort_idx = None

    def add(self, codes, coeffs, corner_vals, centers, halves, slots, depths):
        if len(codes) == 0:
            return
        self.codes = np.concatenate([self.codes, np.asarray(codes, np.int64)])
        self.coeffs = np.concatenate(
            [self.coeffs, np.asarray(coeffs, np.float32)]
        )
        self.corner_vals = np.concatenate(
            [self.corner_vals, np.asarray(corner_vals, np.float32)]
        )
        self.centers = np.concatenate(
            [self.centers, np.asarray(centers, np.float32)]
        )
        self.halves = np.concatenate(
            [self.halves, np.asarray(halves, np.float32)]
        )
        self.slots = np.concatenate([self.slots, np.asarray(slots, np.int64)])
        self.depths = np.concatenate(
            [self.depths, np.asarray(depths, np.int32)]
        )
        self.alive = np.concatenate([self.alive, np.ones(len(codes), bool)])
        self._sort_idx = None

    @property
    def sort_idx(self):
        if self._sort_idx is None:
            self._sort_idx = np.argsort(self.codes, kind="stable")
        return self._sort_idx


def _lookup_leaves(reg: _LeafRegistry, codes):
    """Row indices into the registry for each code (-1 if absent/dead)."""
    if reg.codes.shape[0] == 0:
        return np.full(codes.shape, -1, np.int64)
    si = reg.sort_idx
    sorted_codes = reg.codes[si]
    pos = np.searchsorted(sorted_codes, codes)
    pos_c = np.clip(pos, 0, sorted_codes.shape[0] - 1)
    hit = sorted_codes[pos_c] == codes
    rows = np.where(hit, si[pos_c], -1)
    rows = np.where((rows >= 0) & reg.alive[np.clip(rows, 0, None)], rows, -1)
    return rows


@jax.jit
def _cull_chunk(tris: TriangleDataSoA, centers, half):
    """Center-distance triangle cull for re-opened leaves: keep t iff
    d(t, center) <= min_t d(t, center) + full diagonal (the same
    conservative criterion as the main builder)."""
    sqd = jax.vmap(
        jax.vmap(sq_dist_pair, in_axes=(None, 0)), in_axes=(0, None)
    )(centers, tris)  # (R, T)
    dc = jnp.sqrt(sqd)
    minc = jnp.min(dc, axis=1, keepdims=True)
    diag = 2.0 * jnp.sqrt(jnp.asarray(3.0, dc.dtype)) * half
    return dc <= minc + diag


def build_octree_continuity(
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
    """Build the approximate octree with C0 continuity correction.

    ``strategy`` selects the child-list cull (see build_octree)."""
    tris_dev = jax.tree.map(jnp.asarray, tris)
    # late import: exact_octree imports the builder modules at load time
    from .exact_octree import _PRECISE_MAX_REGIONS, prepare_cull_inputs

    packed_s, geo_s = prepare_cull_inputs(tris_dev, strategy)
    T = tris.num_triangles
    box_min = np.asarray(box_min, np.float32)
    box_size = np.float32(box_size)
    num_coeff = 64 if interpolation == "tricubic" else 8
    sq_threshold = np.float32(termination_threshold) ** 2
    threshold = np.float32(termination_threshold)

    s = 1 << start_depth
    n0 = s * s * s

    # ---- Seed (identical to the NO_CONTINUITY path) -------------------------
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
    lat_vals = lat_vals.reshape(s + 1, s + 1, s + 1, 8)

    zi, yi, xi = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    corner_vals0 = np.zeros((n0, 8, 8), np.float32)
    for ci in range(8):
        cx, cy, cz = ci & 1, (ci >> 1) & 1, (ci >> 2) & 1
        corner_vals0[:, ci] = lat_vals[
            (zi + cz).ravel(), (yi + cy).ravel(), (xi + cx).ravel()
        ]
    centers0 = np.stack(
        [
            box_min[0] + cell * (xi.ravel() + 0.5),
            box_min[1] + cell * (yi.ravel() + 0.5),
            box_min[2] + cell * (zi.ravel() + 0.5),
        ],
        axis=-1,
    ).astype(np.float32)
    coords0 = np.stack([xi.ravel(), yi.ravel(), zi.ravel()], axis=-1).astype(
        np.int64
    )

    # ---- State ---------------------------------------------------------------
    total_nodes = n0  # words used by node blocks (start grid + 8-blocks)
    node_patches: list[tuple[np.ndarray, np.ndarray]] = []
    registry = _LeafRegistry(num_coeff)
    value_range = 0.0
    stats: dict = {
        "nodes_per_depth": {},
        "leaves_per_depth": {},
        "tris_per_node": {},
        "resubdivided": 0,
        "midpoints_clamped": 0,
    }

    # active[depth] -> list of batches
    # batch = dict(centers, corner_vals, coords, slots, cand_idx, cand_valid,
    #              forced)
    active: dict[int, list[dict]] = {
        start_depth: [
            dict(
                centers=centers0,
                corner_vals=corner_vals0,
                coords=coords0,
                slots=np.arange(n0, dtype=np.int64),
                cand_idx=np.broadcast_to(
                    np.arange(T, dtype=np.int32), (n0, T)
                ).copy(),
                cand_valid=np.ones((n0, T), bool),
                forced=np.zeros(n0, bool),
            )
        ]
    }

    def _emit_leaves(depth, mask, coords, coeffs, cvals, cents, hlf, slots):
        nonlocal value_range
        idxs = np.nonzero(mask)[0]
        if len(idxs) == 0:
            return
        codes = _code(depth, coords[idxs, 0], coords[idxs, 1], coords[idxs, 2])
        registry.add(
            codes,
            coeffs[idxs],
            cvals[idxs],
            cents[idxs],
            np.full(len(idxs), hlf, np.float32),
            slots[idxs],
            np.full(len(idxs), depth, np.int32),
        )
        value_range = max(
            value_range, float(np.abs(cvals[idxs, :, 0]).max(initial=0.0))
        )
        stats["leaves_per_depth"][depth] = (
            stats["leaves_per_depth"].get(depth, 0) + len(idxs)
        )

    def _run_level_kernel(centers, corner_vals, cand_idx, cand_valid, half, rule):
        """Chunked device kernel: midpoint samples + fit + error + culling."""
        N, K = cand_idx.shape
        # Candidate width quantized to 8*4^j (not every pow2): each
        # distinct (C, Kp) is a fresh executable whose per-process
        # first call pays a compile; x4 steps halve the variant count
        # for <=2x masked pad evals in the (cheap) cull portion.
        Kp = 8
        while Kp < K:
            Kp *= 4
        C = max(1, _round_pow2(pair_budget // max(Kp, 1) // 2, 1))
        if strategy == "precise":
            # extra region factor in the pair state
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
        va_p[N:, 0] = True

        mids = np.zeros((Np, 19, 8), np.float32)
        coeffs = np.zeros((Np, num_coeff), np.float32)
        errs = np.zeros(Np, np.float32)
        keeps = np.zeros((Np, Kp), bool)
        kcounts = np.zeros(Np, np.int64)
        for i in range(0, Np, C):
            sl = slice(i, i + C)
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
                rule=rule,
                interpolation=interpolation,
                strategy=strategy,
            )
            mids[sl], coeffs[sl], errs[sl] = map(np.asarray, (m, c, e))
            keeps[sl], kcounts[sl] = np.asarray(k), np.asarray(kc)
        return (
            mids[:N],
            coeffs[:N],
            errs[:N],
            keeps[:N, :K],
            kcounts[:N],
        )

    def _continuity_pass(depth, sub_idx, coords, centers, half, mids):
        """Clamp midpoint samples shared with terminated leaves; queue
        offending leaves for re-subdivision. Mutates ``mids`` in place and
        returns registry row indices to re-open.

        Known limitation: the neighbor lookup walks ANCESTORS only, so a
        re-opened node processed after its original level cannot see
        terminated leaves DEEPER than itself (the reference's re-subdivision
        pass has the same asymmetry); any missed clamp stays within the
        termination error bound."""
        M = len(sub_idx)
        if M == 0:
            return np.zeros(0, np.int64)
        if registry.codes.shape[0] == 0:
            return np.zeros(0, np.int64)

        dim = 1 << depth
        sub_coords = coords[sub_idx]  # (M, 3)
        # Neighbor cells (M, 42, 3)
        nb = sub_coords[:, None, :] + _NB_DELTAS[None]
        in_dom = np.all((nb >= 0) & (nb < dim), axis=-1)  # (M, 42)

        # Ancestor walk: at most one ancestor level is a leaf.
        rows = np.full((M, 42), -1, np.int64)
        for k in range(0, depth - start_depth + 1):
            anc = nb >> k
            codes = _code(depth - k, anc[..., 0], anc[..., 1], anc[..., 2])
            found = _lookup_leaves(registry, codes.reshape(-1)).reshape(M, 42)
            rows = np.where((rows < 0) & in_dom, found, rows)

        any_hit = rows >= 0
        if not any_hit.any():
            return np.zeros(0, np.int64)

        # Batched polynomial evaluation of neighbor leaves at midpoints.
        hit_n, hit_j = np.nonzero(any_hit)
        hit_rows = rows[hit_n, hit_j]
        hit_mid = _NB_MIDS[hit_j]
        mid_world = (
            centers[sub_idx][hit_n]
            + MID_OFFSETS[hit_mid] * half
        )  # (H, 3)
        L_half = registry.halves[hit_rows]
        L_min = registry.centers[hit_rows] - L_half[:, None]
        L_size = 2.0 * L_half
        frac = (mid_world - L_min) / L_size[:, None]
        frac = np.clip(frac, 0.0, 1.0)
        L_coeffs = registry.coeffs[hit_rows]
        v = np.asarray(
            interpolate_at(
                jnp.asarray(L_coeffs), jnp.asarray(frac), interpolation
            )
        )
        g = np.asarray(
            gradient_at(jnp.asarray(L_coeffs), jnp.asarray(frac), interpolation)
        ) / L_size[:, None]

        sample = mids[sub_idx[hit_n], hit_mid, 0]
        ok = np.abs(sample - v) <= threshold

        # First OK hit per (node, midpoint) wins: scan hits in hit order
        # (deltas are ordered face-first) and keep the first.
        key = hit_n.astype(np.int64) * 19 + hit_mid
        order = np.argsort(key, kind="stable")
        key_s, ok_s = key[order], ok[order]
        first_of_key = np.ones(len(order), bool)
        first_of_key[1:] = key_s[1:] != key_s[:-1]
        # Vectorized "first OK hit per (node, midpoint) group": mark OK
        # positions, pick the earliest per group with np.minimum.at.
        take = np.zeros(len(order), bool)
        grp_start = np.nonzero(first_of_key)[0]
        grp_id = np.cumsum(first_of_key) - 1
        pos_in_all = np.arange(len(order))
        big = len(order) + 1
        cand_pos = np.where(ok_s, pos_in_all, big)
        first_ok_pos = np.full(len(grp_start), big, np.int64)
        np.minimum.at(first_ok_pos, grp_id, cand_pos)
        sel = first_ok_pos[first_ok_pos < big]
        take[sel] = True
        take_orig = order[take]

        tn, tm = hit_n[take_orig], hit_mid[take_orig]
        mids[sub_idx[tn], tm, 0] = v[take_orig]
        mids[sub_idx[tn], tm, 1:4] = g[take_orig]
        stats["midpoints_clamped"] += int(len(take_orig))

        # Queue every neighbor leaf whose interpolation is out of tolerance
        # at a shared midpoint (the reference queues the checked neighbor,
        # OctreeSdfBreadthFirstNoDelay.h:486-515).
        bad_rows = np.unique(hit_rows[~ok])
        return bad_rows

    def _reopen(rows):
        """Convert registry leaves back into forced-subdivide active nodes."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return
        rows = rows[registry.alive[rows]]
        if len(rows) == 0:
            return
        registry.alive[rows] = False
        stats["resubdivided"] += int(len(rows))

        codes = registry.codes[rows]
        depths_r = (codes >> 48).astype(np.int64)
        xs = (codes >> 32) & 0xFFFF
        ys = (codes >> 16) & 0xFFFF
        zs = codes & 0xFFFF

        for d in np.unique(depths_r):
            m = depths_r == d
            r = rows[m]
            R = len(r)
            cents = registry.centers[r]
            halves = registry.halves[r]
            # Fresh candidate lists via chunked center cull.
            keep = np.zeros((R, T), bool)
            chunk = max(1, pair_budget // max(T, 1))
            for i in range(0, R, chunk):
                keep[i : i + chunk] = np.asarray(
                    _cull_chunk(
                        tris_dev,
                        jnp.asarray(cents[i : i + chunk]),
                        jnp.float32(halves[0]),
                    )
                )
            kmax = max(1, int(keep.sum(axis=1).max(initial=1)))
            orderk = np.argsort(~keep, axis=1, kind="stable")[:, :kmax]
            cand_idx = np.broadcast_to(
                np.arange(T, dtype=np.int32), (R, T)
            )
            cand_idx = np.take_along_axis(cand_idx, orderk, axis=1)
            cand_valid = np.take_along_axis(keep, orderk, axis=1)

            batch = dict(
                centers=cents,
                corner_vals=registry.corner_vals[r],
                coords=np.stack([xs[m], ys[m], zs[m]], axis=-1),
                slots=registry.slots[r],
                cand_idx=cand_idx.copy(),
                cand_valid=cand_valid,
                forced=np.ones(R, bool),
            )
            active.setdefault(int(d), []).append(batch)

    # ---- Main loop: always process the shallowest pending depth -------------
    while active:
        depth = min(active)
        batches = active.pop(depth)
        centers = np.concatenate([b["centers"] for b in batches])
        corner_vals = np.concatenate([b["corner_vals"] for b in batches])
        coords = np.concatenate([b["coords"] for b in batches])
        slots = np.concatenate([b["slots"] for b in batches])
        forced = np.concatenate([b["forced"] for b in batches])
        Kmax = max(b["cand_idx"].shape[1] for b in batches)

        def _padK(a, fill):
            return np.pad(
                a, [(0, 0), (0, Kmax - a.shape[1])], constant_values=fill
            )

        cand_idx = np.concatenate([_padK(b["cand_idx"], 0) for b in batches])
        cand_valid = np.concatenate(
            [_padK(b["cand_valid"], False) for b in batches]
        )

        N = centers.shape[0]
        half = np.float32(box_size / (1 << (depth + 1)))
        node_size = 2.0 * half
        stats["nodes_per_depth"][depth] = (
            stats["nodes_per_depth"].get(depth, 0) + N
        )

        if depth == max_depth:
            coeffs = np.asarray(
                _fit_only(
                    jnp.asarray(corner_vals),
                    jnp.float32(node_size),
                    interpolation=interpolation,
                )
            )
            _emit_leaves(
                depth, np.ones(N, bool), coords, coeffs, corner_vals,
                centers, half, slots,
            )
            continue

        mids, coeffs, errs, keeps, kcounts = _run_level_kernel(
            centers, corner_vals, cand_idx, cand_valid, half, termination_rule
        )
        stats["tris_per_node"][depth] = float(kcounts.mean())

        terminal = (errs < sq_threshold) & ~forced
        _emit_leaves(depth, terminal, coords, coeffs, corner_vals, centers,
                     half, slots)

        sub = np.nonzero(~terminal)[0]
        if len(sub) == 0:
            continue
        M = len(sub)

        # ---- continuity: clamp shared midpoints, queue bad neighbors --------
        bad_rows = _continuity_pass(depth, sub, coords, centers, half, mids)
        _reopen(bad_rows)

        # ---- subdivide -------------------------------------------------------
        child_base = total_nodes + 8 * np.arange(M, dtype=np.int64)
        total_nodes += 8 * M
        node_patches.append((slots[sub].copy(), child_base.astype(np.uint32)))

        lattice = np.zeros((M, 27, 8), np.float32)
        is_corner = _CORNER_OF >= 0
        lattice[:, is_corner] = corner_vals[sub][:, _CORNER_OF[is_corner]]
        lattice[:, ~is_corner] = mids[sub][:, _MID_OF[~is_corner]]
        new_corner_vals = lattice[:, _CHILD_CORNER_LATTICE].reshape(M * 8, 8, 8)

        child_offsets = np.array(
            [[(c & 1) * 2 - 1, ((c >> 1) & 1) * 2 - 1, ((c >> 2) & 1) * 2 - 1]
             for c in range(8)],
            np.float32,
        )
        new_centers = (
            centers[sub][:, None, :] + child_offsets[None] * (0.5 * half)
        ).reshape(M * 8, 3)
        child_bits = np.array(
            [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
        )
        new_coords = (
            2 * coords[sub][:, None, :] + child_bits[None]
        ).reshape(M * 8, 3)
        new_slots = (child_base[:, None] + np.arange(8)[None]).reshape(-1)

        K_next = max(1, int(kcounts[sub].max(initial=1)))
        orderk = np.argsort(~keeps[sub], axis=1, kind="stable")[:, :K_next]
        new_cand = np.take_along_axis(cand_idx[sub], orderk, axis=1)
        new_valid = np.take_along_axis(keeps[sub], orderk, axis=1)

        active.setdefault(depth + 1, []).append(
            dict(
                centers=new_centers,
                corner_vals=new_corner_vals.astype(np.float32),
                coords=new_coords,
                slots=new_slots,
                cand_idx=np.repeat(new_cand, 8, axis=0),
                cand_valid=np.repeat(new_valid, 8, axis=0),
                forced=np.zeros(M * 8, bool),
            )
        )

    # ---- Final assembly -------------------------------------------------------
    a_idx = np.nonzero(registry.alive)[0]
    L = len(a_idx)
    # Align the coefficient section to num_coeff words (row-gather queries)
    # and the total to 64-word rows.
    coeff_base = total_nodes + ((-total_nodes) % num_coeff)
    total_words = coeff_base + num_coeff * L
    total_words += (-total_words) % 64
    octree = np.zeros(total_words, np.uint32)
    for slots_p, words in node_patches:
        octree[slots_p] = words

    coeff_starts = coeff_base + num_coeff * np.arange(L, dtype=np.int64)
    octree[registry.slots[a_idx]] = (
        coeff_starts.astype(np.uint32) | IS_LEAF_MASK
    )
    coeff_block = registry.coeffs[a_idx].astype(np.float32).view(np.uint32)
    octree[coeff_base : coeff_base + num_coeff * L] = coeff_block.reshape(-1)

    leaf_centers = registry.centers[a_idx]
    leaf_halves = registry.halves[a_idx]
    leaf_depths = registry.depths[a_idx]

    min_border = _compute_min_border_value(
        octree, leaf_centers, leaf_halves, coeff_starts,
        box_min, box_size, num_coeff, interpolation,
    )

    return OctreeBuildResult(
        octree_u32=octree,
        value_range=float(value_range),
        min_border_value=float(min_border),
        leaf_centers=leaf_centers,
        leaf_halves=leaf_halves,
        leaf_coeff_idx=coeff_starts,
        leaf_depths=leaf_depths,
        stats=stats,
    )
