"""Approximate octree SDF with polynomial leaves — structure + queries.

JAX re-design of the reference OctreeSdf
(reference: include/SdfLib/OctreeSdf.h:20-292, src/sdf/OctreeSdf.cpp:18-152).
The flat u32 array layout is kept identical in meaning (leaf bit 31,
29-bit children/coefficient index, dense z-major start grid first,
coefficients bitcast inline) so serialized structures are interchangeable
with the reference; on device the descent is a fixed-depth masked loop
(bounded by max_depth) over the whole query batch — the batched
equivalent of the per-sample pointer walk (OctreeSdf.cpp:108-116).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..mesh import BoundingBox, Mesh
from ..triangle import calculate_mesh_triangle_data
from ..ops.box import box_distance, box_distance_gradient
from ..ops.interpolation import (
    tricubic_gradient,
    tricubic_interpolate,
    trilinear_gradient,
    trilinear_interpolate,
)
from .octree_builder import (
    CHILDREN_INDEX_MASK,
    IS_LEAF_MASK,
    OctreeBuildResult,
    build_octree,
)
from .sdf_function import SdfFormat, SdfFunction

__all__ = ["OctreeSdf"]

_RULES = {"trapezoid", "simpson", "by_distance", "none"}


def _select8(rows, lane):
    """rows (..., 8), lane (...,) in [0,8) -> (...,). One-hot sum select:
    an in-row 8-way pick as elementwise work instead of a second gather."""
    oh = lane[..., None] == jnp.arange(8, dtype=lane.dtype)
    return jnp.sum(jnp.where(oh, rows, jnp.zeros_like(rows)), axis=-1)


@partial(
    jax.jit,
    static_argnames=(
        "levels", "num_coeff", "interpolation", "with_gradient", "fast"
    ),
)
def _octree_query(
    octree_u32,
    points,
    box_min,
    box_size,
    start_grid_size,
    min_border_value,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    with_gradient: bool,
    fast: bool = True,
):
    """Batched descent + polynomial evaluation (OctreeSdf.cpp:93-152).

    fast=True requires the aligned layout our builders emit (children
    blocks 8-aligned, coefficient blocks num_coeff-aligned, length a
    multiple of 64): every fetch is then a contiguous ROW gather instead of
    scattered per-element gathers. fast=False
    is the layout-agnostic fallback for foreign (reference .bin) arrays.
    """
    pts = points
    s = start_grid_size
    cell = box_size / s

    frac = (pts - box_min) / cell
    ipos = jnp.floor(frac).astype(jnp.int32)
    frac = frac - ipos
    in_box = jnp.all((ipos >= 0) & (ipos < s), axis=-1)
    ic = jnp.clip(ipos, 0, s - 1)
    node_idx = ic[..., 2] * (s * s) + ic[..., 1] * s + ic[..., 0]

    leaf_mask = jnp.uint32(IS_LEAF_MASK)
    cidx_mask = jnp.uint32(CHILDREN_INDEX_MASK)

    if fast:
        view8 = octree_u32.reshape(-1, 8)
        rows = view8[node_idx >> 3]
        word = _select8(rows, (node_idx & 7).astype(jnp.uint32))
    else:
        word = octree_u32[node_idx]

    for _ in range(levels):
        is_leaf = (word & leaf_mask) != 0
        # roundFloat: >= 0.5 (OctreeSdf.cpp:88-91)
        child = (
            ((frac[..., 2] >= 0.5).astype(jnp.uint32) << 2)
            + ((frac[..., 1] >= 0.5).astype(jnp.uint32) << 1)
            + (frac[..., 0] >= 0.5).astype(jnp.uint32)
        )
        base = word & cidx_mask
        if fast:
            # children blocks are 8-aligned: one row gather + in-row select
            rows = view8[(base >> 3).astype(jnp.int32)]
            nxt = _select8(rows, child)
        else:
            nxt = octree_u32[base + child]
        nfrac = 2.0 * frac
        nfrac = nfrac - jnp.floor(nfrac)
        word = jnp.where(is_leaf, word, nxt)
        frac = jnp.where(is_leaf[..., None], frac, nfrac)

    base = (word & cidx_mask).astype(jnp.int32)
    if fast:
        shift = 6 if num_coeff == 64 else 3
        viewc = octree_u32.reshape(-1, num_coeff)
        coeffs_u32 = viewc[base >> shift]
    else:
        coeffs_u32 = octree_u32[
            base[..., None] + jnp.arange(num_coeff, dtype=jnp.int32)
        ]
    coeffs = jax.lax.bitcast_convert_type(coeffs_u32, jnp.float32)

    if interpolation == "tricubic":
        d_in = tricubic_interpolate(coeffs, frac)
    else:
        d_in = trilinear_interpolate(coeffs, frac)

    center = box_min + 0.5 * box_size
    size3 = jnp.full((3,), box_size, pts.dtype)
    if with_gradient:
        if interpolation == "tricubic":
            g_in = tricubic_gradient(coeffs, frac)
        else:
            g_in = trilinear_gradient(coeffs, frac)
        norm = jnp.sqrt(jnp.sum(g_in * g_in, axis=-1, keepdims=True))
        g_in = g_in / jnp.maximum(norm, 1e-30)
        d_out, g_out = box_distance_gradient(pts, center, size3)
        d = jnp.where(in_box, d_in, d_out + min_border_value)
        g = jnp.where(in_box[..., None], g_in, g_out)
        return d, g
    d_out = box_distance(pts, center, size3)
    return jnp.where(in_box, d_in, d_out + min_border_value)


def _layout_is_aligned(
    data: np.ndarray, start_grid_size: int, num_coeff: int
) -> bool:
    """Host-side walk validating the row-gather layout invariants: total
    length a multiple of 64, children blocks 8-aligned, coefficient blocks
    num_coeff-aligned. Structures built here always satisfy them; arrays
    imported from reference .bin files may not."""
    if data.shape[0] % 64:
        return False
    frontier = data[: start_grid_size**3]
    for _ in range(32):
        is_leaf = (frontier & IS_LEAF_MASK) != 0
        bases = (frontier & CHILDREN_INDEX_MASK).astype(np.int64)
        if np.any(bases[is_leaf] % num_coeff):
            return False
        inner = bases[~is_leaf]
        if inner.size == 0:
            return True
        if np.any(inner % 8):
            return False
        frontier = data[(inner[:, None] + np.arange(8)).reshape(-1)]
    return False  # deeper than any valid octree: be safe


@partial(
    jax.jit,
    static_argnames=(
        "grid_depth", "num_coeff", "interpolation", "with_gradient",
        "grid_fat",
    ),
)
def _octree_query_grid(
    octree_u32,
    grid_u32,        # (2^d^3, 2): [leaf word, leaf depth] per finest cell
    points,          # (fat layout: [word, depth, num_coeff coeffs] rows)
    box_min,
    box_size,
    min_border_value,
    *,
    grid_depth: int,
    num_coeff: int,
    interpolation: str,
    with_gradient: bool,
    grid_fat: bool = False,
):
    """O(1)-descent query via a dense leaf-id grid at max_depth resolution:
    the per-point tree walk (OctreeSdf.cpp:108-116) becomes ONE 8-byte row
    gather — a redesign trading device memory for gather count."""
    pts = points
    g = 1 << grid_depth
    rel = (pts - box_min) / box_size            # [0,1) inside the box
    in_box = jnp.all((rel >= 0.0) & (rel < 1.0), axis=-1)
    cell = jnp.clip((rel * g).astype(jnp.int32), 0, g - 1)
    lin = (cell[..., 2] * g + cell[..., 1]) * g + cell[..., 0]

    row = grid_u32[lin]                          # (..., 2) row gather
    word = row[..., 0]
    # low 16 bits = leaf depth; bit 16 = "surface-free cell" march flag
    # (written by build_query_grid, consumed by the sphere tracer).
    depth = (row[..., 1] & jnp.uint32(0xFFFF)).astype(jnp.int32)

    # frac within the leaf: p scaled to the leaf's depth
    scale = jnp.exp2(depth.astype(pts.dtype))
    f = rel * scale[..., None]
    frac = f - jnp.floor(f)

    if grid_fat:
        # coefficients ride the SAME gathered row (the tracer's fat march
        # grid): one gather per query instead of two dependent ones
        coeffs_u32 = row[..., 2 : 2 + num_coeff]
    else:
        base = (word & jnp.uint32(CHILDREN_INDEX_MASK)).astype(jnp.int32)
        shift = 6 if num_coeff == 64 else 3
        coeffs_u32 = octree_u32.reshape(-1, num_coeff)[base >> shift]
    coeffs = jax.lax.bitcast_convert_type(coeffs_u32, jnp.float32)

    if interpolation == "tricubic":
        d_in = tricubic_interpolate(coeffs, frac)
    else:
        d_in = trilinear_interpolate(coeffs, frac)

    center = box_min + 0.5 * box_size
    size3 = jnp.full((3,), box_size, pts.dtype)
    if with_gradient:
        if interpolation == "tricubic":
            g_in = tricubic_gradient(coeffs, frac)
        else:
            g_in = trilinear_gradient(coeffs, frac)
        norm = jnp.sqrt(jnp.sum(g_in * g_in, axis=-1, keepdims=True))
        g_in = g_in / jnp.maximum(norm, 1e-30)
        d_out, g_out = box_distance_gradient(pts, center, size3)
        d = jnp.where(in_box, d_in, d_out + min_border_value)
        gr = jnp.where(in_box[..., None], g_in, g_out)
        return d, gr
    d_out = box_distance(pts, center, size3)
    return jnp.where(in_box, d_in, d_out + min_border_value)


def _build_leaf_grid(
    octree_np: np.ndarray, start_grid_size: int, max_depth: int
) -> np.ndarray:
    """Dense (2^max_depth^3, 2) uint32 grid of [leaf word, leaf depth] —
    host-side level expansion of the flat octree."""
    g = 1 << max_depth
    grid = np.zeros((g, g, g, 2), np.uint32)

    s = start_grid_size
    start_depth = int(np.log2(s))
    zi, yi, xi = np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                             indexing="ij")
    coords = np.stack([xi, yi, zi], -1).reshape(-1, 3).astype(np.int64)
    words = octree_np[: s * s * s]
    depth = start_depth

    while len(words):
        is_leaf = (words & IS_LEAF_MASK) != 0
        # write leaves: each covers a (g >> depth)^3 block of finest cells
        ls = np.nonzero(is_leaf)[0]
        if len(ls):
            b = g >> depth
            base = coords[ls] * b
            # vectorized block fill via broadcasting per block offset
            off = np.arange(b)
            ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
            blk = np.stack([ox, oy, oz], -1).reshape(-1, 3)  # (b^3, 3)
            cells = base[:, None, :] + blk[None]             # (L, b^3, 3)
            cx = cells[..., 0].ravel()
            cy = cells[..., 1].ravel()
            cz = cells[..., 2].ravel()
            grid[cz, cy, cx, 0] = np.repeat(words[ls], b**3)
            grid[cz, cy, cx, 1] = depth
        # expand inner nodes
        inner = np.nonzero(~is_leaf)[0]
        if len(inner) == 0 or depth == max_depth:
            break
        bases = (words[inner] & CHILDREN_INDEX_MASK).astype(np.int64)
        child = np.arange(8)
        idx = (bases[:, None] + child[None]).reshape(-1)
        words = octree_np[idx]
        bits = np.stack([child & 1, (child >> 1) & 1, (child >> 2) & 1], -1)
        coords = (
            2 * coords[inner][:, None, :] + bits[None]
        ).reshape(-1, 3)
        depth += 1
    return grid.reshape(-1, 2)


def _build_fat_grid(
    octree_np: np.ndarray, grid: np.ndarray, num_coeff: int
) -> np.ndarray:
    """Fuse the dense leaf grid with the leaf coefficients: one
    (2 + num_coeff)-word row per finest cell = [leaf word, depth|flags,
    coefficients...]. Queries and march steps then cost ONE row gather
    instead of two DEPENDENT gathers (grid row -> coefficient row); on
    the latency-bound gather unit (PERF.md §1) that halves the per-step
    cost of the sphere tracer's hot loop."""
    base = (grid[:, 0] & CHILDREN_INDEX_MASK).astype(np.int64)
    # Row width padded to a power of two (128 for tricubic): a 66-word row
    # straddles two 128-lane tiles, making every gather a double fetch —
    # measured as a 2x approx-query regression before alignment.
    width = 128 if num_coeff > 6 else 16
    out = np.zeros((grid.shape[0], width), np.uint32)
    out[:, 0] = grid[:, 0]
    out[:, 1] = grid[:, 1]
    out[:, 2 : 2 + num_coeff] = octree_np[base[:, None] + np.arange(num_coeff)]
    return out


@partial(
    jax.jit,
    static_argnames=("grid_depth", "num_coeff", "interpolation",
                     "with_gradient"),
)
def _octree_query_fat(
    fat_u32,         # (2^d^3, 2+num_coeff) fused rows
    points,
    box_min,
    box_size,
    min_border_value,
    *,
    grid_depth: int,
    num_coeff: int,
    interpolation: str,
    with_gradient: bool,
):
    """Dense-grid query over fused rows: ONE row gather per point."""
    pts = points
    g = 1 << grid_depth
    rel = (pts - box_min) / box_size
    in_box = jnp.all((rel >= 0.0) & (rel < 1.0), axis=-1)
    cell = jnp.clip((rel * g).astype(jnp.int32), 0, g - 1)
    lin = (cell[..., 2] * g + cell[..., 1]) * g + cell[..., 0]

    row = fat_u32[lin]                               # (..., width)
    depth = (row[..., 1] & jnp.uint32(0xFFFF)).astype(jnp.int32)
    scale = jnp.exp2(depth.astype(pts.dtype))
    f = rel * scale[..., None]
    frac = f - jnp.floor(f)
    coeffs = jax.lax.bitcast_convert_type(
        row[..., 2 : 2 + num_coeff], jnp.float32
    )

    if interpolation == "tricubic":
        d_in = tricubic_interpolate(coeffs, frac)
    else:
        d_in = trilinear_interpolate(coeffs, frac)

    center = box_min + 0.5 * box_size
    size3 = jnp.full((3,), box_size, pts.dtype)
    if with_gradient:
        if interpolation == "tricubic":
            g_in = tricubic_gradient(coeffs, frac)
        else:
            g_in = trilinear_gradient(coeffs, frac)
        norm = jnp.sqrt(jnp.sum(g_in * g_in, axis=-1, keepdims=True))
        g_in = g_in / jnp.maximum(norm, 1e-30)
        d_out, g_out = box_distance_gradient(pts, center, size3)
        d = jnp.where(in_box, d_in, d_out + min_border_value)
        gr = jnp.where(in_box[..., None], g_in, g_out)
        return d, gr
    d_out = box_distance(pts, center, size3)
    return jnp.where(in_box, d_in, d_out + min_border_value)


class OctreeSdf(SdfFunction):
    """Octree with trilinear/tricubic polynomial leaves.

    init_algorithm: "uniform" (subdivide everything, OctreeSdf.h:25),
    "no_continuity" (per-node termination, the default reference path), or
    "continuity" (C0 across leaf faces — see octree_builder_continuity).

    strategy: the per-level candidate cull — "distance" (free center-
    distance rule) or an influence strategy ("lattice"/"basic"/"precise"/
    "per_vertex", the reference TrianglesInfluence.h family). All are safe
    supersets, so the structure's VALUES are unchanged; tighter strategies
    trade cull flops for smaller per-level candidate matrices.

    ``build_query_grid()`` enables O(1)-descent queries through a dense
    leaf-id grid (8 bytes per finest-resolution cell).
    """

    def __init__(
        self,
        mesh: Mesh | None = None,
        box: BoundingBox | None = None,
        max_depth: int = 6,
        start_depth: int = 1,
        termination_threshold: float = 1e-3,
        termination_rule: str = "trapezoid",
        error_decay: float = 0.0,
        init_algorithm: str = "no_continuity",
        interpolation: str = "tricubic",
        strategy: str = "distance",
        _state: dict | None = None,
    ):
        if _state is not None:
            self._load_state(_state)
            return

        assert mesh is not None and box is not None
        assert termination_rule in _RULES, termination_rule
        # Cubify the box around its center (OctreeSdf.cpp:43-46).
        cbox = box.cubified()
        self.box = cbox
        self.max_depth = int(max_depth)
        self.start_depth = int(start_depth)
        self.start_grid_size = 1 << self.start_depth
        self.interpolation = interpolation
        self.termination_threshold = float(termination_threshold)

        tris = calculate_mesh_triangle_data(mesh)
        if init_algorithm == "uniform":
            rule = "none"
        elif init_algorithm in ("no_continuity", "continuity"):
            rule = termination_rule
        else:
            raise ValueError(init_algorithm)

        if init_algorithm == "continuity":
            from .octree_builder_continuity import build_octree_continuity

            result: OctreeBuildResult = build_octree_continuity(
                tris,
                cbox.min,
                float(cbox.size[0]),
                self.max_depth,
                self.start_depth,
                termination_rule=rule,
                termination_threshold=termination_threshold,
                error_decay=error_decay,
                interpolation=interpolation,
                strategy=strategy,
            )
        else:
            result = build_octree(  # uniform / no_continuity
                tris,
                cbox.min,
                float(cbox.size[0]),
                self.max_depth,
                self.start_depth,
                termination_rule=rule,
                termination_threshold=termination_threshold,
                error_decay=error_decay,
                interpolation=interpolation,
                strategy=strategy,
            )
        self._init_from_result(result)

    def _init_from_result(self, result: OctreeBuildResult):
        self.octree_data = jnp.asarray(result.octree_u32)
        self.value_range = float(result.value_range)
        self.min_border_value = float(result.min_border_value)
        self.build_stats = result.stats
        self._leaf_depths = result.leaf_depths
        self._fast_layout = _layout_is_aligned(
            result.octree_u32, self.start_grid_size, self.num_coefficients
        )
        self._query_grid = None
        self._fat_grid = None

    # -- queries --------------------------------------------------------------

    @property
    def num_coefficients(self) -> int:
        return 64 if self.interpolation == "tricubic" else 8

    def build_query_grid(self, march_flags: bool = True) -> None:
        """Precompute the dense leaf-id grid for O(1)-descent queries
        (8 bytes x 8^max_depth; requires the aligned fast layout).

        march_flags additionally marks provably surface-free cells (bit 16
        of the depth word) so the sphere tracer can take cell-exit-sized
        steps through empty space instead of crawling at the local
        distance value (the round-1 tracer's measured bottleneck)."""
        if not self._fast_layout:
            raise ValueError(
                "query grid requires the aligned (builder-emitted) layout"
            )
        grid = _build_leaf_grid(
            np.asarray(self.octree_data),
            self.start_grid_size,
            self.max_depth,
        )
        if march_flags:
            grid = self._mark_free_cells(grid)
        self._query_grid = jnp.asarray(grid)
        nc = self.num_coefficients
        fat_bytes = grid.shape[0] * (128 if nc > 6 else 16) * 4
        if fat_bytes <= self._FAT_GRID_BYTE_BUDGET:
            self._fat_grid = jnp.asarray(
                _build_fat_grid(np.asarray(self.octree_data), grid, nc)
            )
        else:
            self._fat_grid = None

    # Fused grid rows above this byte size stay unbuilt (the two-gather
    # path is used instead): depth 6 tricubic = 69 MB, depth 7 = 553 MB.
    _FAT_GRID_BYTE_BUDGET = 1 << 30

    # Cells flagged surface-free keep the polynomial above this (in
    # box-size units) with the error budget below; tracers must use
    # eps <= this margin for exit-stepping to be sound.
    _FREE_CELL_MARGIN = 1e-4
    # Fit-error budget in units of the termination threshold: the true SDF
    # is 1-Lipschitz and the builder drives the (integral) fit error below
    # the threshold, so 10x threshold covers the pointwise deviation of
    # error-terminated leaves with a wide margin. Max-depth leaves (whose
    # error is not rule-bounded) sit next to the surface where the distance
    # test fails anyway.
    _FREE_CELL_ERR_BUDGET = 10.0

    def _mark_free_cells(self, grid: np.ndarray) -> np.ndarray:
        """Set bit 16 of the depth word for cells that provably contain no
        surface:

            d_poly(center) > (sqrt(3)/2) * cell_size + err_budget + margin

        Because the true SDF is 1-Lipschitz, d_true > 0 throughout the
        cell, and the polynomial (within its fit-error budget of the true
        SDF) stays above the tracer's hit threshold — so stepping to the
        cell exit cannot skip a hit.

        Bits 17-21 additionally store a quantized FREE RADIUS r ∈
        {0,1,3,7,15}: every cell within Chebyshev distance r is also
        free, so the tracer may step to the exit of the (2r+1)-cell box —
        one gather crosses a whole empty REGION, not just the current
        leaf (a ray skimming a shell of small free leaves pays one step
        per leaf otherwise). Computed by erosion doubling: three
        separable axis min-filters per level, radii composing additively."""
        g = 1 << self.max_depth
        box_min = np.asarray(self.box.min, np.float32)
        box_size = float(self.box.size[0])
        cell_size = box_size / g

        thr = float(getattr(self, "termination_threshold", 1e-3))
        cut = (
            0.5 * np.sqrt(3.0) * cell_size
            + self._FREE_CELL_ERR_BUDGET * thr
            + self._FREE_CELL_MARGIN * box_size
        )

        n_cells = g * g * g
        free = np.zeros(n_cells, bool)
        chunk = 1 << 20
        zi, yi, xi = np.meshgrid(
            np.arange(g), np.arange(g), np.arange(g), indexing="ij"
        )
        centers_all = np.stack(
            [xi.ravel(), yi.ravel(), zi.ravel()], -1
        ).astype(np.float32)
        for i in range(0, n_cells, chunk):
            centers = box_min + (centers_all[i : i + chunk] + 0.5) * cell_size
            d = np.asarray(self.get_distance(jnp.asarray(centers)))
            free[i : i + chunk] = d > cut

        # free radius by erosion doubling (box min-filters are separable;
        # erosions compose additively in radius). Out-of-grid treated as
        # free: beyond the box the SDF is the exact box fallback, which
        # the march handles with its own safe step.
        def _erode(a: np.ndarray, r: int) -> np.ndarray:
            for ax in range(3):
                m = a
                for s in range(1, r + 1):
                    lo = np.ones_like(a)
                    hi = np.ones_like(a)
                    sl_lo = [slice(None)] * 3
                    sl_hi = [slice(None)] * 3
                    sl_lo[ax] = slice(s, None)
                    sl_hi[ax] = slice(None, -s)
                    lo[tuple(sl_hi)] = a[tuple(sl_lo)]
                    hi[tuple(sl_lo)] = a[tuple(sl_hi)]
                    m = m & lo & hi
                a = m
            return a

        f3 = free.reshape(g, g, g)
        radius = f3.astype(np.uint32)  # 1 where the cell itself is free
        er, r_acc = f3, 1
        for step in (1, 2, 4, 8):
            if 2 * (r_acc + step) + 1 > g:
                break
            er = _erode(er, step)
            r_acc += step
            np.maximum(radius, er.astype(np.uint32) * r_acc, out=radius)
        # radius semantics for the tracer: all cells within Chebyshev
        # (radius - 1) of a free cell are free; store radius - 1.
        rad_m1 = np.where(radius > 0, radius - 1, 0).astype(np.uint32)

        out = grid.copy()
        out[:, 1] |= free.astype(np.uint32) << 16
        out[:, 1] |= (rad_m1.reshape(-1) & 0x1F) << 17
        return out

    def _query(self, points, with_gradient: bool):
        pts = jnp.asarray(points, jnp.float32)
        flat = pts.reshape(-1, 3)
        # The fused fat rows serve the sphere tracer (1 gather per march
        # step); plain queries stay on the thin grid — the fat row doubles
        # bytes per point and measured 2x SLOWER for bandwidth-bound bulk
        # queries (27 vs 57 M q/s), while the two thin gathers pipeline.
        if self._query_grid is not None:
            out = _octree_query_grid(
                self.octree_data,
                self._query_grid,
                flat,
                jnp.asarray(self.box.min),
                jnp.float32(self.box.size[0]),
                jnp.float32(self.min_border_value),
                grid_depth=self.max_depth,
                num_coeff=self.num_coefficients,
                interpolation=self.interpolation,
                with_gradient=with_gradient,
            )
            if with_gradient:
                d, g = out
                return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
            return out.reshape(pts.shape[:-1])
        out = _octree_query(
            self.octree_data,
            flat,
            jnp.asarray(self.box.min),
            jnp.float32(self.box.size[0]),
            self.start_grid_size,
            jnp.float32(self.min_border_value),
            levels=self.max_depth - self.start_depth,
            num_coeff=self.num_coefficients,
            interpolation=self.interpolation,
            with_gradient=with_gradient,
            fast=self._fast_layout,
        )
        if with_gradient:
            d, g = out
            return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
        return out.reshape(pts.shape[:-1])

    def get_distance(self, points):
        return self._query(points, with_gradient=False)

    def get_distance_and_gradient(self, points):
        return self._query(points, with_gradient=True)

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.OCTREE

    def get_depth_density(self) -> np.ndarray:
        """Leaf area per depth, total area 1 (OctreeSdf.cpp:232-277)."""
        density = np.zeros(self.max_depth + 1, np.float64)
        if len(self._leaf_depths):
            for d in range(self.max_depth + 1):
                density[d] = np.sum(self._leaf_depths == d) * 0.125**d
        return density.astype(np.float32)

    # -- serialization ----------------------------------------------------------

    def _state_arrays(self) -> dict:
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "start_grid_size": np.int32(self.start_grid_size),
            "max_depth": np.int32(self.max_depth),
            "value_range": np.float32(self.value_range),
            "min_border_value": np.float32(self.min_border_value),
            "octree_data": np.asarray(self.octree_data, np.uint32),
            "interpolation": np.array(self.interpolation),
            "leaf_depths": np.asarray(self._leaf_depths, np.int32),
            "termination_threshold": np.float32(
                getattr(self, "termination_threshold", 1e-3)
            ),
        }

    def _load_state(self, state: dict):
        self.box = BoundingBox(state["box_min"], state["box_max"])
        self.start_grid_size = int(state["start_grid_size"])
        self.start_depth = int(np.log2(self.start_grid_size))
        self.max_depth = int(state["max_depth"])
        self.value_range = float(state["value_range"])
        self.min_border_value = float(state["min_border_value"])
        self.octree_data = jnp.asarray(state["octree_data"])
        self.interpolation = str(state.get("interpolation", "tricubic"))
        self.termination_threshold = float(
            state.get("termination_threshold", 1e-3)
        )
        self._leaf_depths = np.asarray(state.get("leaf_depths", []), np.int32)
        self.build_stats = {}
        self._fast_layout = _layout_is_aligned(
            np.asarray(self.octree_data),
            self.start_grid_size,
            self.num_coefficients,
        )
        self._query_grid = None
        self._fat_grid = None

    @classmethod
    def _from_state_arrays(cls, state: dict) -> "OctreeSdf":
        return cls(_state=state)
