"""Batched sphere tracing over an octree SDF.

JAX re-design of the reference GPU sphere tracer
(reference: src/render_engine/shaders/sdfOctreeRender.comp:392-409
``raycast`` — march while lastDistance > 1e-5, accumulated distance < far,
iterations < MAX_ITERATIONS=1024). The per-pixel GLSL loop becomes one
``lax.while_loop`` over the whole ray batch with per-lane active masks;
distances are evaluated in octree-normalized space with
distanceScale = 1 / boxSize (RenderSdf.cpp:127-128), minus the reference
demo's Perlin-noise/floor composition (SURVEY.md S7.6).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..sdf.octree import (
    CHILDREN_INDEX_MASK,
    OctreeSdf,
    _octree_query,
    _octree_query_grid,
)
from ..ops.box import box_distance
from ..ops.interpolation import tricubic_interpolate, trilinear_interpolate

__all__ = ["TraceResult", "sphere_trace", "trace_octree"]


def _grid_distance_and_step(
    octree_u32,
    grid_u32,
    pts,
    dirs,
    box_min,
    box_size,
    min_border_value,
    *,
    grid_depth: int,
    num_coeff: int,
    interpolation: str,
    grid_fat: bool = False,
    shrink=None,
):
    """Distance + SAFE STEP in one pass over the dense leaf grid.

    For cells flagged surface-free (bit 16 of the depth word, proven by
    build_query_grid's per-leaf Lipschitz bound), the step extends to the
    cell-exit distance along the ray: grazing rays stop crawling at the
    tiny local distance value and cross empty cells in one step each —
    the step count becomes O(cells crossed) instead of O(distance/d_min).
    Out-of-box points use the box fallback distance (itself an exact lower
    bound, so marching by it is safe).

    ``shrink`` (per-point, world units) makes the exit step safe for a
    BEAM of that radius: the free box is contracted by ``shrink`` on all
    faces and the step is taken only when the center already sits at
    least ``shrink`` inside every wall — then every member path of the
    tube stays inside the proven-free region for the whole step (the
    center moves monotonically per axis, so start+end containment gives
    containment throughout)."""
    g = 1 << grid_depth
    rel = (pts - box_min) / box_size
    in_box = jnp.all((rel >= 0.0) & (rel < 1.0), axis=-1)
    cell = jnp.clip((rel * g).astype(jnp.int32), 0, g - 1)
    lin = (cell[..., 2] * g + cell[..., 1]) * g + cell[..., 0]

    row = grid_u32[lin]
    word = row[..., 0]
    dw = row[..., 1]
    depth = (dw & jnp.uint32(0xFFFF)).astype(jnp.int32)
    free = (dw >> 16) & jnp.uint32(1)

    scale = jnp.exp2(depth.astype(pts.dtype))
    f = rel * scale[..., None]
    frac = f - jnp.floor(f)
    if grid_fat:
        # coefficients live in the SAME row: one gather per march step
        # instead of two dependent ones (PERF.md §1: the gather unit is
        # the tracer's whole cost)
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
    d = jnp.where(
        in_box, d_in, box_distance(pts, center, size3) + min_border_value
    )

    # Exit distance (world units) of the proven-free box around the
    # current cell. Only finest CELLS are proven free (build_query_grid),
    # not whole leaves: a large leaf can hold free cells and the surface,
    # so a leaf-box exit would step through the surface. The overshoot
    # epsilon stays at finest-cell scale to keep the hit position error
    # bound independent of the box size.
    cell_size = box_size / g
    if shrink is not None:
        sh = shrink[0][..., None]      # tube radius at the current point
        gr = shrink[1][..., None]      # radius growth per unit arclength

    def box_exit(bmin, bsize):
        if shrink is None:
            far_face = bmin + (dirs > 0).astype(pts.dtype) * bsize
            t_ax = jnp.where(dirs != 0.0, (far_face - pts) / dirs, jnp.inf)
            return jnp.min(t_ax, axis=-1)
        # Beam-tube exit: each of the six wall gaps (contracted by the
        # tube radius) is LINEAR in t — near-wall gap changes at
        # dir_a - gr, far-wall at -dir_a - gr — so the first zero
        # crossing is exact; -inf when the center is not already
        # `shrink`-contained (a member could stick out at the start).
        gapN = pts - bmin - sh
        gapF = bmin + bsize - pts - sh
        contained = jnp.all((gapN >= 0.0) & (gapF >= 0.0), axis=-1)
        rateN = gr - dirs              # >0 where the near gap shrinks
        rateF = gr + dirs
        tN = jnp.where(rateN > 0.0, gapN / jnp.maximum(rateN, 1e-20),
                       jnp.inf)
        tF = jnp.where(rateF > 0.0, gapF / jnp.maximum(rateF, 1e-20),
                       jnp.inf)
        t = jnp.minimum(jnp.min(tN, axis=-1), jnp.min(tF, axis=-1))
        return jnp.where(contained, t, -jnp.inf)

    # Free-RADIUS box (build_query_grid bits 17-21): every cell within
    # Chebyshev distance `rad` is also free, so one step crosses the whole
    # (2*rad+1)-cell box — an empty region of many cells and leaves.
    rad = ((dw >> 17) & jnp.uint32(0x1F)).astype(pts.dtype)
    rbox_min = box_min + (cell.astype(pts.dtype) - rad[..., None]) * cell_size
    rbox_size = (2.0 * rad + 1.0)[..., None] * cell_size
    t_exit = box_exit(rbox_min, rbox_size) + 1e-3 * cell_size

    if shrink is not None:
        # exit-only credit: the caller owns the distance-based step (its
        # margin/growth bookkeeping differs); the tiny overshoot epsilon
        # above is absorbed by the beam margin
        return d, jnp.where((free == 1) & in_box, t_exit, -jnp.inf)
    step = jnp.where(
        (free == 1) & in_box,
        jnp.maximum(d, t_exit),
        jnp.maximum(d, 0.0),
    )
    return d, step


class TraceResult(NamedTuple):
    hit: jax.Array        # (...,) bool
    position: jax.Array   # (..., 3) world hit position (last march point)
    depth: jax.Array      # (...,) accumulated world-space distance
    normal: jax.Array     # (..., 3) normalized SDF gradient at the hit
    iterations: jax.Array  # (...,) int32 march steps taken


def sphere_trace_state(
    distance_fn,
    state,
    dirs,
    *,
    eps: float = 1e-5,
    far: float = 10.0,
    max_iters: int = 1024,
    distance_step_fn=None,
    fixed_trips: bool = False,
):
    """Resumable batched ray march. ``state`` = (pos, acc, last_d, active)
    per ray; returns the advanced state plus iterations run. Loop semantics
    mirror raycast (comp shader :392-409): march by max(d, 0), stop when
    d <= eps (hit), accumulated > far, or iteration cap.

    distance_step_fn(pos) -> (d, step) optionally supplies a safe step
    larger than d (e.g. cell-exit skipping through provably empty cells);
    the hit test always uses d.

    fixed_trips=True runs exactly max_iters trips (lax.fori_loop) instead
    of a while_loop: every march step is a serialized latency unit, and
    the while cond's ``jnp.any(active)`` is a full-batch reduction ON that
    serial path each step (it gates whether the next trip runs). Large
    pyramid rounds are sized so the prefix never converges early — there
    the early-exit test is pure overhead. The returned iteration count
    stays accurate either way: the fixed loop tracks the last trip entered
    with any active lane, a reduction that runs in PARALLEL with the next
    trip's gather (nothing downstream depends on it inside the loop)."""
    dirs = jnp.asarray(dirs, jnp.float32)

    def step_fn(st):
        pos, acc, last_d, active = st
        if distance_step_fn is not None:
            d, step = distance_step_fn(pos)
        else:
            d = distance_fn(pos)
            step = jnp.maximum(d, 0.0)
        new_pos = pos + dirs * (step * active)[..., None]
        new_acc = acc + step * active
        new_last = jnp.where(active > 0, d, last_d)
        new_active = (
            active * (new_last > eps).astype(jnp.float32)
            * (new_acc < far).astype(jnp.float32)
        )
        return new_pos, new_acc, new_last, new_active

    if fixed_trips:
        def body(i, carry):
            last, st = carry
            last = jnp.where(jnp.any(st[3] > 0), i + 1, last)
            return last, step_fn(st)

        # int carry derives from the state so its varying-axes type under
        # shard_map matches the data-dependent loop output
        it0 = (state[3][(0,) * state[3].ndim] * 0).astype(jnp.int32)
        it, state = jax.lax.fori_loop(0, max_iters, body, (it0, state))
    else:
        def cond(carry):
            it, st = carry
            return jnp.logical_and(it < max_iters, jnp.any(st[3] > 0))

        def wbody(carry):
            it, st = carry
            return it + 1, step_fn(st)

        it, state = jax.lax.while_loop(cond, wbody, (jnp.int32(0), state))
    return it, state


def sphere_trace(
    distance_fn,
    origins,
    dirs,
    *,
    eps: float = 1e-5,
    far: float = 10.0,
    max_iters: int = 1024,
):
    """Generic batched ray march from fresh origins. Returns
    (hit, position, depth, iterations)."""
    origins = jnp.asarray(origins, jnp.float32)
    shape = origins.shape[:-1]
    init = (
        origins,
        jnp.zeros(shape, jnp.float32),
        jnp.full(shape, jnp.inf, jnp.float32),
        jnp.ones(shape, jnp.float32),
    )
    it, (pos, acc, last_d, _) = sphere_trace_state(
        distance_fn, init, dirs, eps=eps, far=far, max_iters=max_iters
    )
    hit = last_d <= eps
    return hit, pos, acc, it


@partial(jax.jit, static_argnames=("levels", "num_coeff", "interpolation",
                                   "max_iters", "grid_depth", "fast",
                                   "grid_fat", "fixed_trips"))
def _march_state_jit(
    octree_u32,
    grid_u32,     # dense leaf grid, or a dummy when grid_depth is None
    state,        # (pos, acc, last_d, active)
    dirs,
    box_min,
    box_size,
    start_grid_size,
    min_border_value,
    eps,
    far,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    max_iters: int,
    grid_depth: int | None = None,
    fast: bool = True,
    grid_fat: bool = False,
    fixed_trips: bool = False,
):
    # The reference shader marches in octree-normalized space with
    # distanceScale = 1/boxSize (RenderSdf.cpp:128). Equivalent here: march
    # in world space and scale eps/far by boxSize.
    def dist_fn(points):
        return _octree_query(
            octree_u32, points, box_min, box_size, start_grid_size,
            min_border_value,
            levels=levels, num_coeff=num_coeff, interpolation=interpolation,
            with_gradient=False, fast=fast,
        )

    dist_step_fn = None
    if grid_depth is not None:
        def dist_step_fn(points):
            return _grid_distance_and_step(
                octree_u32, grid_u32, points, dirs, box_min, box_size,
                min_border_value,
                grid_depth=grid_depth, num_coeff=num_coeff,
                interpolation=interpolation, grid_fat=grid_fat,
            )

    it, state = sphere_trace_state(
        dist_fn, state, dirs,
        eps=eps * box_size, far=far * box_size, max_iters=max_iters,
        distance_step_fn=dist_step_fn, fixed_trips=fixed_trips,
    )
    return it, state


@partial(jax.jit, static_argnames=(
    "levels", "num_coeff", "interpolation", "max_iters", "grid_depth",
    "fast", "grid_fat", "n_blk", "B",
))
def _march_round_jit(
    octree_u32,
    grid_u32,
    state,        # (pos, acc, last_d, active) over ALL Rp rays
    dirs,         # (Rp, 3) in current permutation
    perm,         # (Rp,) current order -> original ray index
    iters_used,   # (Rp,) per original ray
    box_min,
    box_size,
    start_grid_size,
    min_border_value,
    eps,
    far,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    max_iters: int,
    grid_depth: int | None,
    fast: bool,
    grid_fat: bool,
    n_blk: int,
    B: int,
):
    """One march ROUND as a single compiled program: march the first n_blk
    rays in B-sized blocks (lax.map), account iterations, then re-pack the
    still-active rays to the front of the prefix. Returns the updated
    (state, dirs, perm, iters_used) and the active count — the only value
    that crosses to the host between rounds. The previous scheduler ran
    the compaction as ~10 eager ops per round, each paying its own
    dispatch latency."""
    head = jax.tree.map(lambda a: a[:n_blk], state)
    hdirs = dirs[:n_blk]

    def blk(args):
        st, db = args
        it, new = _march_state_jit(
            octree_u32, grid_u32, st, db,
            box_min, box_size, start_grid_size, min_border_value, eps, far,
            levels=levels, num_coeff=num_coeff, interpolation=interpolation,
            max_iters=max_iters, grid_depth=grid_depth, fast=fast,
            grid_fat=grid_fat,
        )
        return it, new

    nb = n_blk // B
    its, head = jax.lax.map(
        blk,
        (
            jax.tree.map(lambda a: a.reshape((nb, B) + a.shape[1:]), head),
            hdirs.reshape(nb, B, 3),
        ),
    )
    head = jax.tree.map(
        lambda a: a.reshape((n_blk,) + a.shape[2:]), head
    )
    state = jax.tree.map(
        lambda h, full: jnp.concatenate([h, full[n_blk:]]), head, state
    )
    iters_used = iters_used.at[perm[:n_blk]].add(
        jnp.repeat(its, B), mode="drop"
    )

    active = state[3][:n_blk] > 0
    n_active = jnp.sum(active.astype(jnp.int32))
    order = jnp.argsort(~active)
    reorder = lambda a: jnp.concatenate([a[:n_blk][order], a[n_blk:]])
    state = jax.tree.map(reorder, state)
    perm = reorder(perm)
    dirs = reorder(dirs)
    return state, dirs, perm, iters_used, n_active


@partial(jax.jit, static_argnames=(
    "levels", "num_coeff", "interpolation", "grid_depth",
    "fast", "grid_fat", "schedule", "B",
))
def _march_pyramid_jit(
    octree_u32,
    grid_u32,
    state,        # (pos, acc, last_d, active) over ALL Rp rays
    dirs,
    perm,
    iters_used,
    box_min,
    box_size,
    start_grid_size,
    min_border_value,
    eps,
    far,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    grid_depth: int | None,
    fast: bool,
    grid_fat: bool,
    schedule: tuple,   # ((iters, n_blk), ...) static pyramid
    B: int,
):
    """The WHOLE multi-round march as ONE compiled program: a static
    pyramid of (iters, prefix) rounds with a compaction between rounds
    (one multi-operand lax.sort keyed on ~active, prefix-width with a
    queue floor — see round_step), so active rays sit at the front.
    Replaces the per-round host syncs of the dynamic scheduler (~6 per
    1M-ray frame) with a single dispatch; the caller makes ONE final sync and hands
    any stragglers (a scene where actives outnumber a pyramid prefix)
    to the dynamic loop, which is exact."""
    def round_step(state, dirs, perm, iters_used, k, n_blk, sort_w):
        head = jax.tree.map(lambda a: a[:n_blk], state)
        hdirs = dirs[:n_blk]

        def blk(args):
            st, db = args
            return _march_state_jit(
                octree_u32, grid_u32, st, db,
                box_min, box_size, start_grid_size, min_border_value,
                eps, far,
                levels=levels, num_coeff=num_coeff,
                interpolation=interpolation,
                max_iters=k, grid_depth=grid_depth, fast=fast,
                grid_fat=grid_fat,
                # Big prefixes never converge inside their round (they
                # are sized TO the active count): run exact trips and
                # keep the any(active) reduction off the serial path.
                fixed_trips=n_blk >= (1 << 16),
            )

        Bb = min(B, n_blk)
        nb = n_blk // Bb
        its, head = jax.lax.map(
            blk,
            (
                jax.tree.map(
                    lambda a: a.reshape((nb, Bb) + a.shape[1:]), head
                ),
                hdirs.reshape(nb, Bb, 3),
            ),
        )
        head = jax.tree.map(
            lambda a: a.reshape((n_blk,) + a.shape[2:]), head
        )
        state = jax.tree.map(
            lambda h, full: jnp.concatenate([h, full[n_blk:]]), head, state
        )
        iters_used = iters_used.at[perm[:n_blk]].add(
            jnp.repeat(its, Bb), mode="drop"
        )
        # FULL compaction: actives to the global front (stable 11-operand
        # sort; the payload rides the comparator network nearly free).
        # PREFIX-width sort: a full-array sort here would reorder rows the
        # tail never touches, in every round. The width keeps a queue floor (32k) over the marched
        # head so stranded actives keep draining into the padded tail
        # rounds as the head retires, and the FINAL round sorts full
        # width so every downstream handler (straggler loop, dynamic
        # leftovers) still sees all actives compacted at the global
        # front. Scenes with >32k still-active rays past round 2 strand
        # some until that final sort — they retire in the straggler
        # loop's full remaining budget, so results are unchanged.
        pos, acc, last_d, active = state
        W = sort_w
        key = (active[:W] <= 0).astype(jnp.int32)
        (_, px, py, pz, a_, ld, av, dx, dy, dz, pm) = jax.lax.sort(
            (key, pos[:W, 0], pos[:W, 1], pos[:W, 2], acc[:W], last_d[:W],
             active[:W], dirs[:W, 0], dirs[:W, 1], dirs[:W, 2], perm[:W]),
            num_keys=1, is_stable=True,
        )
        head_state = (jnp.stack([px, py, pz], -1), a_, ld, av)
        state = jax.tree.map(
            lambda h, full: jnp.concatenate([h, full[W:]]), head_state, state
        )
        dirs = jnp.concatenate([jnp.stack([dx, dy, dz], -1), dirs[W:]])
        perm = jnp.concatenate([pm, perm[W:]])
        return state, dirs, perm, iters_used

    Rp = state[0].shape[0]
    for i, (k, n_blk) in enumerate(schedule):
        sort_w = (
            Rp
            if i == len(schedule) - 1
            else min(Rp, max(n_blk, 1 << 15))
        )
        state, dirs, perm, iters_used = round_step(
            state, dirs, perm, iters_used, k, n_blk, sort_w
        )
    n_active = jnp.sum((state[3] > 0).astype(jnp.int32))
    return state, dirs, perm, iters_used, n_active


@partial(jax.jit,
         static_argnames=("levels", "num_coeff", "interpolation", "fast"))
def _trace_normals_jit(
    octree_u32, pos, box_min, box_size, start_grid_size, min_border_value,
    *, levels: int, num_coeff: int, interpolation: str, fast: bool = True,
):
    _, normal = _octree_query(
        octree_u32, pos, box_min, box_size, start_grid_size, min_border_value,
        levels=levels, num_coeff=num_coeff, interpolation=interpolation,
        with_gradient=True, fast=fast,
    )
    return normal


@partial(jax.jit, static_argnames=("levels", "num_coeff", "interpolation",
                                   "max_iters", "grid_depth", "fast",
                                   "grid_fat"))
def _beam_prepass_jit(
    octree_u32,
    grid_u32,
    origins,      # (B, 3) one conservative ray per tile
    dirs,         # (B, 3)
    r0,           # (B,) tile radius at t=0 (max member-ray origin offset)
    rd,           # (B,) radius growth per unit t (max member-dir divergence)
    box_min,
    box_size,
    start_grid_size,
    min_border_value,
    margin,       # world-space safety: eps + fit-error budget
    far,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    max_iters: int,
    grid_depth: int | None = None,
    fast: bool = True,
    grid_fat: bool = False,
):
    """Beam (tile) prepass: march one ray per tile with the hit test
    expanded by the tile radius r(t) = r0 + t*rd, stepping by
    d - r(t) - margin. Every member ray's path stays within r(t) of the
    beam ray, and the true SDF is 1-Lipschitz, so no member ray can hit
    before the beam's stopping depth — member rays then START at that
    depth, skipping the whole empty-space approach (the bulk of marching
    cost: every step is one data-dependent gather).

    Mirrors the role of the reference renderer's per-tile GPU dispatch
    coherence (RenderSdf.cpp:187, 16x16 tiles), recast as an explicit
    two-level batch schedule."""
    def dist_fn(points, radius):
        if grid_depth is not None:
            # exit step made tube-safe by contracting the free box by the
            # beam radius (+margin) with exact per-wall growth handling —
            # beams cross proven-empty space in one step each instead of
            # crawling by d - r (the prepass was 197 ms of the 1024^2
            # frame before this, ~179 latency-bound serial trips)
            return _grid_distance_and_step(
                octree_u32, grid_u32, points, dirs, box_min, box_size,
                min_border_value,
                grid_depth=grid_depth, num_coeff=num_coeff,
                interpolation=interpolation, grid_fat=grid_fat,
                shrink=(radius + margin, rd),
            )
        d = _octree_query(
            octree_u32, points, box_min, box_size, start_grid_size,
            min_border_value,
            levels=levels, num_coeff=num_coeff, interpolation=interpolation,
            with_gradient=False, fast=fast,
        )
        return d, jnp.full_like(d, -jnp.inf)

    def cond(carry):
        it, _, _, active = carry
        return jnp.logical_and(it < max_iters, jnp.any(active))

    def body(carry):
        it, pos, acc, active = carry
        radius = r0 + acc * rd
        d, fstep = dist_fn(pos, radius)
        # /(1+rd): the radius keeps growing over the step interval; this
        # keeps d >= r(t) + margin at every point along the step.
        dstep = jnp.maximum((d - radius - margin) / (1.0 + rd), 0.0)
        step = jnp.maximum(dstep, fstep)
        new_pos = pos + dirs * (step * active)[..., None]
        new_acc = acc + step * active
        # Stop on proximity (step == 0) — AND on stagnation: a grazing
        # beam skimming the silhouette at d ~ r+margin crawls in
        # sub-margin steps for hundreds of trips (measured: the 1024^2
        # prepass ran to its 256-trip cap and was still creeping,
        # 205 ms). Stopping early is always safe — the stop depth is a
        # lower bound on every member's first hit wherever it is — and
        # member rays march the grazing stretch themselves anyway.
        new_active = active * (step > 0.5 * margin) * (new_acc < far)
        return it + 1, new_pos, new_acc, new_active

    # zero/one carries derive from origins so their varying-axes type under
    # shard_map matches the loop outputs (invariant constants would not)
    zb = origins[:, 0] * 0.0
    _, _, acc, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), origins, zb, zb + 1.0)
    )
    return acc


@partial(jax.jit, static_argnames=("ntiles",))
def _beam_setup_jit(o, d, seg, *, ntiles: int):
    """Per-tile beam parameters in one compiled call: mean origin,
    normalized mean direction, and the radius bound r(t) = r0 + t*rd
    covering every member ray's path."""
    cnt = jax.ops.segment_sum(jnp.ones(o.shape[0], jnp.float32), seg,
                              num_segments=ntiles)
    o_c = jax.ops.segment_sum(o, seg, num_segments=ntiles) / cnt[:, None]
    d_sum = jax.ops.segment_sum(d, seg, num_segments=ntiles)
    d_c = d_sum / jnp.maximum(
        jnp.sqrt(jnp.sum(d_sum * d_sum, -1, keepdims=True)), 1e-20
    )
    r0 = jax.ops.segment_max(
        jnp.sqrt(jnp.sum(jnp.square(o - o_c[seg]), -1)),
        seg, num_segments=ntiles,
    )
    rd = jax.ops.segment_max(
        jnp.sqrt(jnp.sum(jnp.square(d - d_c[seg]), -1)),
        seg, num_segments=ntiles,
    )
    return o_c, d_c, r0, rd


# Rays per march block; the while_loop pays the slowest ray in a block, so
# unfinished rays are re-packed together between rounds.
_TRACE_BLOCK = 1 << 17
# March-round schedule: every ray pays at least the first round, so it is
# short (with the beam prepass most hit rays finish inside it); rounds
# grow geometrically so stragglers (silhouette-grazing rays) pay
# ever-larger chunks while the finished bulk stops costing gathers —
# every march step is one data-dependent gather, the tracer's measured
# unit cost.
_FIRST_ROUND_ITERS = 8


def _build_pyramid_schedule(
    Rp: int, max_iters: int, B: int, dense: bool = False
) -> tuple:
    """Static ((iters, prefix), ...) pyramid: rounds grow geometrically in
    iterations while their prefixes shrink with the measured geometric decay
    of active rays (PERF.md §3). Shared by the single-chip scheduler and the
    fused per-shard trace so both march identical trajectories.

    dense=True slows the prefix shrink (for beam-less traces: without the
    prepass most rays are still marching the empty-space approach after the
    first rounds, and the beam-tuned prefixes would dump them into the
    full-width straggler path — measured as a 14x single-device rays/s
    collapse on the CPU mesh). Both variants PAD tail rounds at the final
    divisor until the whole iteration budget is covered: a padded round is
    a tiny prefix (cheap) and every ray it retires skips the full-width
    cleanup loop entirely."""
    divs = (1, 1, 2, 4, 8, 16, 32, 64) if dense else (1, 8, 32, 128, 256, 512)
    schedule = []
    k, rem = min(_FIRST_ROUND_ITERS, max_iters), max_iters
    i = 0
    while rem > 0:
        div = divs[min(i, len(divs) - 1)]
        nbk = max(Rp // div, min(1 << 10, Rp))
        if nbk >= B:
            nbk = min(-(-nbk // B) * B, Rp)   # whole B-blocks
        else:
            nbk = 1 << (max(nbk - 1, 1)).bit_length()  # pow2 <= B
        schedule.append((min(k, rem), nbk))
        rem -= k
        k = min(k * 2, 256)
        i += 1
    return tuple(schedule)


def _trace_rays_fused(
    octree_u32,
    grid_u32,
    thin_grid_u32,  # thin query grid for normals, or a dummy
    o,            # (Rl, 3) ray origins (already padded)
    d,            # (Rl, 3) unit directions (padding rows unit-x)
    active0,      # (Rl,) 1.0 for real rays, 0.0 for padding
    box_min,
    box_size,
    start_grid_size,
    min_border_value,
    eps,
    far,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    max_iters: int,
    grid_depth: int | None,
    fast: bool,
    grid_fat: bool,
    B: int,
    beam: int | None,
    beam_margin: float,
    normals_grid_depth: int | None,
    image_hw: tuple | None = None,
):
    """The WHOLE trace as one traceable program with NO host syncs: beam
    prepass (flat consecutive-ray tiles, or 2D beam x beam pixel tiles
    when ``image_hw=(H, W)`` is given and covers the batch), static march
    pyramid, then an early-exiting full-width while_loop for any
    stragglers the pyramid's prefixes missed. Safe to wrap in
    jax.shard_map — every op is local to the shard (reductions like the
    while cond's any(active) stay per-shard), so rays scale with zero
    communication (SURVEY.md S5.7: rays are pure DP). The dynamic
    scheduler in trace_octree syncs an active count to the host between
    rounds; under GSPMD those global sorts/prefix-slices turned into
    cross-device resharding and collapsed throughput 7x on an 8-device
    scaling curve — this fused form replaces it on the sharded path, and
    it IS the single-device frame path too (one dispatch per frame instead
    of the eager wrapper ops around per-piece dispatches)."""
    Rl = o.shape[0]
    common = (box_min, box_size, start_grid_size, min_border_value, eps, far)
    statics = dict(
        levels=levels, num_coeff=num_coeff, interpolation=interpolation,
        grid_depth=grid_depth, fast=fast, grid_fat=grid_fat,
    )

    # Derive the zero/inf initial carries from a sharded input: under
    # shard_map, while_loop carries must enter with the same varying-axes
    # type they leave with, and a plain jnp.zeros is axis-invariant.
    zero_v = o[:, 0] * 0.0
    start_t = zero_v
    beam_on = beam is not None and Rl >= beam * beam
    if beam_on:
        bb = beam * beam
        if (
            image_hw is not None
            and image_hw[0] * image_hw[1] == Rl
            and image_hw[0] % beam == 0
            and image_hw[1] % beam == 0
        ):
            # 2D pixel tiles (compact beams) — jnp-derived so no (Rl,)
            # constant is embedded in the program
            H, W = image_hw
            i = jnp.arange(Rl)
            seg = (
                (i // W // beam) * (W // beam) + (i % W) // beam
            ).astype(jnp.int32)
            ntiles = (H // beam) * (W // beam)
        else:
            # jnp-derived, like the 2D branch: an np.arange here embeds
            # an (Rl,)-sized literal in every compile variant
            seg = (jnp.arange(Rl) // bb).astype(jnp.int32)
            ntiles = -(-Rl // bb)
        o_c, d_c, r0, rd = _beam_setup_jit(o, d, seg, ntiles=ntiles)
        beam_t = _beam_prepass_jit(
            octree_u32, grid_u32, o_c, d_c, r0, rd,
            *common[:4], jnp.float32(beam_margin),
            far * box_size, max_iters=256, **statics,
        )
        start_t = beam_t[seg]

    state = (
        o + d * start_t[:, None],
        start_t + zero_v,
        zero_v + jnp.inf,
        active0,
    )
    perm = jnp.arange(Rl)
    iters_used = jnp.zeros(Rl, jnp.int32)
    d_cur = d
    remaining = max_iters

    if Rl >= (1 << 15) and max_iters >= 64:
        schedule = _build_pyramid_schedule(
            Rl, max_iters, B, dense=not beam_on
        )
        state, d_cur, perm, iters_used, _ = _march_pyramid_jit(
            octree_u32, grid_u32, state, d_cur, perm, iters_used,
            *common, **statics, schedule=schedule, B=B,
        )
        # Budget = what the least-marched active ray may still need (a ray
        # overflowing every prefix was only offered the first round).
        remaining = max(max_iters - schedule[0][0], 0)

    if remaining > 0:
        # Stragglers finish in one early-exiting while_loop over the full
        # shard: actives sit compacted at the front after the pyramid, and
        # the loop exits on the first trip when none are left — the common
        # case — so the full-width trips only happen when real work exists.
        act_in = state[3]
        it, state = _march_state_jit(
            octree_u32, grid_u32, state, d_cur, *common,
            max_iters=remaining, **statics,
        )
        iters_used = iters_used.at[perm].add(jnp.where(act_in > 0, it, 0))

    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(Rl))
    state = jax.tree.map(lambda a: a[inv], state)
    pos, acc, last_d, _ = state
    hit = last_d <= eps * box_size

    if normals_grid_depth is not None:
        # ride the FAT grid when the march has one: coeffs come inline
        # with the row, halving the normals pass to one gather
        _, normal = _octree_query_grid(
            octree_u32, grid_u32 if grid_fat else thin_grid_u32, pos,
            box_min, box_size, min_border_value,
            grid_depth=normals_grid_depth, num_coeff=num_coeff,
            interpolation=interpolation, with_gradient=True,
            grid_fat=grid_fat,
        )
    else:
        normal = _trace_normals_jit(
            octree_u32, pos, *common[:4],
            levels=levels, num_coeff=num_coeff,
            interpolation=interpolation, fast=fast,
        )
    return hit, pos, acc, normal, iters_used


@partial(jax.jit, static_argnames=(
    "Rp", "levels", "num_coeff", "interpolation", "max_iters", "grid_depth",
    "fast", "grid_fat", "B", "beam", "beam_margin", "normals_grid_depth",
    "image_hw",
))
def _trace_frame_jit(octree_u32, grid_u32, thin_grid_u32, origins, dirs,
                     box_min, box_size, start_grid_size, min_border_value,
                     eps, far, *, Rp, **statics):
    """jit entry for the whole-frame fused trace (single-chip path).
    Takes RAW image- or flat-shaped origins/dirs and owns the pad /
    padding-ray setup / final unpad+reshape, which as eager ops would each
    pay a dispatch."""
    shape = origins.shape
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    R = o.shape[0]
    o = jnp.pad(o, [(0, Rp - R), (0, 0)])
    d_pad = jnp.pad(d, [(0, Rp - R), (0, 0)])
    # padded rays get a unit direction so steps stay finite, and start
    # inactive
    d = jnp.where(
        (jnp.arange(Rp) < R)[:, None], d_pad, jnp.array([1.0, 0.0, 0.0])
    )
    active0 = (jnp.arange(Rp) < R).astype(jnp.float32)
    hit, pos, acc, normal, iters_used = _trace_rays_fused(
        octree_u32, grid_u32, thin_grid_u32, o, d, active0,
        box_min, box_size, start_grid_size, min_border_value, eps, far,
        **statics,
    )
    res = TraceResult(hit, pos, acc, normal, iters_used)
    return jax.tree.map(
        lambda a: a[:R].reshape(
            shape[:-1] + a.shape[1:] if a.ndim > 1 else shape[:-1]
        ),
        res,
    )


def trace_octree(
    octree: OctreeSdf,
    origins,
    dirs,
    *,
    eps: float = 1e-5,
    far: float = 4.0,
    max_iters: int = 1024,
    block_size: int | None = None,
    beam: int | None = 4,
    pyramid: bool = True,
    stats_out: dict | None = None,
) -> TraceResult:
    """Sphere-trace rays against an OctreeSdf. eps/far are in normalized
    octree space (box edge = 1), matching the reference shader.

    Three-phase schedule: a BEAM PREPASS (one radius-expanded ray per
    beam x beam tile — image-shaped (H, W, 3) inputs tile in 2D, flat
    inputs tile consecutive rays — whose stopping depth is a proven-safe
    starting depth for every ray in the tile, skipping the empty-space
    approach, where each step costs one data-dependent gather), then a
    fixed warmup march over all rays, then the unfinished rays are
    compacted (argsort by active mask) and only they continue — the
    batch-level replacement for the per-pixel divergence a GPU shader
    absorbs per warp (RenderSdf.cpp:187, 16x16 tile dispatch). beam=None disables
    the prepass."""
    origins = jnp.asarray(origins, jnp.float32)
    dirs = jnp.asarray(dirs, jnp.float32)
    shape = origins.shape

    R = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    B = min(block_size or _TRACE_BLOCK, max(R, 1))
    Rp = -(-R // B) * B

    common = (
        jnp.asarray(octree.box.min),
        jnp.float32(octree.box.size[0]),
        octree.start_grid_size,
        jnp.float32(octree.min_border_value),
        jnp.float32(eps),
        jnp.float32(far),
    )
    # The free-cell flags guarantee poly > _FREE_CELL_MARGIN * box_size in
    # flagged cells; exit-stepping is only sound for hit thresholds below
    # that margin (default eps=1e-5 is).
    grid = getattr(octree, "_fat_grid", None)
    grid_fat = grid is not None
    if grid is None:
        grid = getattr(octree, "_query_grid", None)
    if grid is not None and eps > OctreeSdf._FREE_CELL_MARGIN:
        grid = None
        grid_fat = False
    statics = dict(
        levels=octree.max_depth - octree.start_depth,
        num_coeff=octree.num_coefficients,
        interpolation=octree.interpolation,
        grid_depth=octree.max_depth if grid is not None else None,
        fast=octree._fast_layout,
        grid_fat=grid_fat,
    )
    grid_arr = grid if grid is not None else jnp.zeros((1, 2), jnp.uint32)

    # Large frames: the WHOLE trace (beam, pyramid, straggler loop,
    # normals, unsort) as ONE jitted program, instead of ~20 eager ops +
    # 1 host sync around jitted pieces.
    if pyramid and Rp >= (1 << 15) and max_iters >= 64:
        thin_grid = getattr(octree, "_query_grid", None)
        thin_arr = (
            thin_grid if thin_grid is not None
            else jnp.zeros((1, 2), jnp.uint32)
        )
        thr = float(getattr(octree, "termination_threshold", 1e-3))
        image_hw = None
        if len(shape) == 3 and shape[0] * shape[1] == Rp:
            image_hw = (int(shape[0]), int(shape[1]))
        res = _trace_frame_jit(
            octree.octree_data, grid_arr, thin_arr, origins, dirs,
            *common,
            Rp=Rp,
            levels=statics["levels"], num_coeff=statics["num_coeff"],
            interpolation=statics["interpolation"], max_iters=max_iters,
            grid_depth=statics["grid_depth"], fast=statics["fast"],
            grid_fat=grid_fat, B=B, beam=beam,
            beam_margin=float(eps * float(octree.box.size[0]) + 4.0 * thr),
            normals_grid_depth=(
                octree.max_depth
                if (grid is not None or thin_grid is not None)
                else None
            ),
            image_hw=image_hw,
        )
        if stats_out is not None:
            beam_on = beam is not None and R >= beam * beam
            stats_out["rounds"] = [(
                "pyramid",
                tuple(_build_pyramid_schedule(
                    Rp, max_iters, B, dense=not beam_on
                )),
                0,
            )]
        return res

    # ---- dynamic path (small frames / pyramid=False): eager setup ----
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    o = jnp.pad(o, [(0, Rp - R), (0, 0)])
    d_pad = jnp.pad(d, [(0, Rp - R), (0, 0)])
    # padded rays get a unit direction so steps stay finite...
    d = jnp.where(
        (jnp.arange(Rp) < R)[:, None], d_pad, jnp.array([1.0, 0.0, 0.0])
    )
    # ...and start inactive
    pad_active = (jnp.arange(Rp) < R).astype(jnp.float32)

    start_t = jnp.zeros(Rp, jnp.float32)
    beam_on = beam is not None and R >= beam * beam
    if beam_on:
        bb = beam * beam
        if len(shape) == 3 and shape[0] % beam == 0 and shape[1] % beam == 0:
            H, W = shape[0], shape[1]
            i = np.arange(R)
            tile_of_ray = (i // W // beam) * (W // beam) + (i % W) // beam
            ntiles = (H // beam) * (W // beam)
        else:
            tile_of_ray = np.arange(R) // bb
            ntiles = -(-R // bb)
        seg = jnp.asarray(tile_of_ray.astype(np.int32))
        o_c, d_c, r0, rd = _beam_setup_jit(o[:R], d[:R], seg, ntiles=ntiles)
        # Safety margin: hit threshold + fit-error budget (the Lipschitz
        # argument runs through the TRUE distance; the polynomial tracks
        # it within the builder's termination threshold).
        thr = float(getattr(octree, "termination_threshold", 1e-3))
        margin = jnp.float32(
            eps * float(octree.box.size[0]) + 4.0 * thr
        )
        beam_t = _beam_prepass_jit(
            octree.octree_data, grid_arr, o_c, d_c, r0, rd,
            *common[:4], margin, jnp.float32(far * float(octree.box.size[0])),
            max_iters=256,
            **statics,
        )
        start_t = jnp.pad(beam_t[seg], (0, Rp - R))

    state = (
        o + d * start_t[:, None],
        start_t,
        jnp.full(Rp, jnp.inf, jnp.float32),
        pad_active,
    )

    # Multi-round march with compaction: rounds grow geometrically; after
    # each round the still-active rays are re-packed to the front so the
    # finished bulk stops paying march gathers.
    perm = jnp.arange(Rp)
    d_cur = d
    iters_used = jnp.zeros(Rp, jnp.int32)
    n_cur = Rp
    remaining = max_iters
    rounds_log = []
    round_iters = min(_FIRST_ROUND_ITERS, max_iters)

    # (Large pyramid-eligible frames returned above through the fully
    # fused path; from here on this is the exact dynamic scheduler —
    # per-round host syncs — used by small frames, pyramid=False, and the
    # equality tests that pin the fused path's results.)
    while remaining > 0 and n_cur > 0:
        k = min(round_iters, remaining)
        # pow2 prefix sizing (bounds compile variants); a small floor so
        # tail rounds with few stragglers stop re-marching a full block
        n_blk = min(1 << 10, Rp)
        while n_blk < n_cur:
            n_blk *= 2
        n_blk = min(n_blk, Rp)
        state, d_cur, perm, iters_used, n_active = _march_round_jit(
            octree.octree_data, grid_arr, state, d_cur, perm, iters_used,
            *common,
            max_iters=k, **statics,
            n_blk=n_blk, B=min(B, n_blk),
        )
        n_cur = int(n_active)      # the round's single host sync
        rounds_log.append((k, n_blk, n_cur))
        remaining -= k
        round_iters = min(round_iters * 2, 256)

    if stats_out is not None:
        stats_out["rounds"] = rounds_log   # (iters, marched, still_active)

    # Restore original ray order.
    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(Rp))
    state = jax.tree.map(lambda a: a[inv], state)

    pos, acc, last_d, _ = state
    eps_w = eps * float(octree.box.size[0])
    hit = last_d <= eps_w
    thin_grid = getattr(octree, "_query_grid", None)
    fat_grid = getattr(octree, "_fat_grid", None)
    if thin_grid is not None or fat_grid is not None:
        # normals prefer the FAT rows when the march built them: coeffs
        # ride the same gathered row, so the pass is ONE gather per ray
        # instead of two dependent ones (gathers are count-bound, not
        # byte-bound — PERF.md §1)
        use_fat = fat_grid is not None
        _, normal = _octree_query_grid(
            octree.octree_data, fat_grid if use_fat else thin_grid, pos,
            *common[:2], common[3],
            grid_depth=octree.max_depth,
            num_coeff=octree.num_coefficients,
            interpolation=octree.interpolation,
            with_gradient=True,
            grid_fat=use_fat,
        )
    else:
        normal = _trace_normals_jit(
            octree.octree_data, pos, *common[:4],
            **{k: v for k, v in statics.items()
               if k not in ("grid_depth", "grid_fat")},
        )
    res = TraceResult(hit, pos, acc, normal, iters_used)
    return jax.tree.map(
        lambda a: a[:R].reshape(
            shape[:-1] + a.shape[1:] if a.ndim > 1 else shape[:-1]
        ),
        res,
    )
