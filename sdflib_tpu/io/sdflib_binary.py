"""Reference-format (.bin) serialization interop.

Reads and writes the reference's cereal PortableBinaryArchive containers
(reference: src/sdf/SdfFunction.cpp:9-79) so structures built by either
implementation are interchangeable:

  byte 0      : archive endianness flag (0x01 = little endian, cereal
                portable_binary.hpp writes a bool on construction)
  int32       : SdfFormat enum (GRID=0, OCTREE=1, EXACT_OCTREE=2;
                SdfFunction.h:16-22)
  GRID        : BoundingBox (6 f32) + ivec3 gridSize (3 i32)
                + vector<float> grid (u64 count + data)
                (UniformGridSdf.h:39-58)
  OCTREE      : BoundingBox + int32 startGridSize + u32 maxDepth
                + f32 valueRange + f32 minBorderValue
                + vector<OctreeNode> (u64 count + u32 data)
                (OctreeSdf.h:222-238)

  EXACT_OCTREE: BoundingBox + i32 startGridSize + u32 startDepth
                + u32 minTrianglesInLeafs + u32 maxTrianglesInLeafs
                + u32 maxTrianglesEncodedInLeafs + u32 bitEncodingStartDepth
                + u32 bitsPerIndex + u32 maxDepth
                + vector<OctreeNode{childrenIndex u32, trianglesArrayIndex u32}>
                + vector<u32> trianglesSets (count-prefixed packed index
                  sets, bitsPerIndex bits each, MSB-first)
                + vector<u8> trianglesMasks (per-parent-triangle bitmasks)
                + vector<TriangleData> (37 f32 each: origin 3, mat3 columns
                  9, b 2, c 2, v2 1, v3 2, edgesNormal 9, verticesNormal 9)
                (ExactOctreeSdf.h:138-199)

EXACT_OCTREE import decodes the bit encoding into this framework's flat
leaf lists (decode semantics: ExactOctreeSdf.cpp:70-175); export re-encodes
flat lists into the two-tier bit encoding (_save_exact_bin below).
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["save_sdflib_bin", "load_sdflib_bin"]

_FMT_GRID, _FMT_OCTREE, _FMT_EXACT = 0, 1, 2


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("Truncated .bin container")
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def f32v(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype="<f4").copy()

    def vec_u32(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(4 * n), dtype="<u4").copy()

    def vec_f32(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(4 * n), dtype="<f4").copy()


def load_sdflib_bin(path: str):
    """Load a reference .bin container into the native structures."""
    from ..mesh import BoundingBox
    from ..sdf.grid import UniformGridSdf
    from ..sdf.octree import OctreeSdf

    with open(path, "rb") as f:
        r = _Reader(f.read())

    endian = r.u8()
    if endian != 1:
        raise ValueError("Only little-endian .bin containers are supported")
    fmt = r.i32()

    if fmt == _FMT_OCTREE:
        box_min = r.f32v(3)
        box_max = r.f32v(3)
        start_grid_size = r.i32()
        max_depth = r.u32()
        value_range = r.f32()
        min_border = r.f32()
        octree_data = r.vec_u32()
        state = {
            "box_min": box_min,
            "box_max": box_max,
            "start_grid_size": np.int32(start_grid_size),
            "max_depth": np.int32(max_depth),
            "value_range": np.float32(value_range),
            "min_border_value": np.float32(min_border),
            "octree_data": octree_data,
            "interpolation": np.array("tricubic"),
            "leaf_depths": np.zeros(0, np.int32),
        }
        return OctreeSdf._from_state_arrays(state)

    if fmt == _FMT_GRID:
        box_min = r.f32v(3)
        box_max = r.f32v(3)
        gs = np.frombuffer(r.take(12), dtype="<i4").copy()
        grid = r.vec_f32()
        state = {
            "box_min": box_min,
            "box_max": box_max,
            "grid_size": gs,
            # reference stores z-major flat; native layout is (nz, ny, nx)
            "grid": grid.reshape(gs[2], gs[1], gs[0]),
        }
        return UniformGridSdf._from_state_arrays(state)

    if fmt == _FMT_EXACT:
        return _load_exact_bin(r)
    raise ValueError(f"Unknown SdfFormat {fmt} in {path!r}")


def _decode_packed_set(sets: np.ndarray, start: int, bpi: int):
    """Decode one count-prefixed packed triangle-index set
    (ExactOctreeSdf.cpp:70-87): bpi-bit big-endian indices in a u32 stream.
    Returns (ids ndarray, position after the count word)."""
    count = int(sets[start])
    base = start + 1
    if count == 0:
        return np.zeros(0, np.int64), base
    b_idx = np.arange(count, dtype=np.int64) * bpi
    word = b_idx >> 5
    bit = b_idx & 31
    w0 = sets[base + word].astype(np.uint64)
    w1 = sets[base + word + 1].astype(np.uint64)
    lo = (w0 << bit.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    ids = (lo >> np.uint64(32 - bpi)) | (
        w1 >> (np.uint64(64) - (bit.astype(np.uint64) + np.uint64(bpi)))
    )
    return ids.astype(np.int64), base


def _load_exact_bin(r: "_Reader"):
    """Decode a reference EXACT_OCTREE container into the native structure
    (walks the two-word-node tree, expanding packed sets and per-parent
    bitmasks into flat leaf triangle lists)."""
    from ..mesh import BoundingBox
    from ..sdf.exact_octree import ExactOctreeSdf, _LEAF_CHUNK
    from ..triangle import TriangleDataSoA

    box_min = r.f32v(3)
    box_max = r.f32v(3)
    start_grid_size = r.i32()
    start_depth = r.u32()
    min_tris = r.u32()
    _max_tris = r.u32()
    _max_encoded = r.u32()
    bit_start_depth = r.u32()
    bpi = r.u32()
    max_depth = r.u32()
    n_nodes = r.u64()
    nodes = np.frombuffer(r.take(8 * n_nodes), dtype="<u4").reshape(-1, 2)
    # one zero pad word: the packed-set decode always touches word idx+1
    sets = np.concatenate([r.vec_u32(), np.zeros(1, np.uint32)])
    n_masks = r.u64()
    masks_bits = np.unpackbits(
        np.frombuffer(r.take(n_masks), dtype=np.uint8)
    )  # MSB-first per byte, matching the decode loop
    n_tris = r.u64()
    tdata = np.frombuffer(r.take(4 * 37 * n_tris), dtype="<f4").reshape(-1, 37)

    IS_LEAF = 1 << 31
    CMASK = IS_LEAF - 1

    # ---- triangles: reference TriangleData -> SoA (v_world reconstructed:
    # the transform is orthonormal, so its inverse is the transpose)
    origin = tdata[:, 0:3]
    transform = tdata[:, 3:12].reshape(-1, 3, 3).transpose(0, 2, 1)  # glm cols
    b = tdata[:, 12:14]
    c = tdata[:, 14:16]
    v2x = tdata[:, 16]
    v3xy = tdata[:, 17:19]
    edges_normal = tdata[:, 19:28].reshape(-1, 3, 3)
    vertices_normal = tdata[:, 28:37].reshape(-1, 3, 3)
    inv = transform.transpose(0, 2, 1)
    v1w = origin
    v2w = origin + inv[:, :, 0] * v2x[:, None]
    v3w = origin + np.einsum(
        "tij,tj->ti", inv[:, :, :2], v3xy
    )
    v_world = np.stack([v1w, v2w, v3w], axis=1).astype(np.float32)
    soa = TriangleDataSoA(
        origin.astype(np.float32).copy(),
        transform.astype(np.float32).copy(),
        b.astype(np.float32).copy(),
        c.astype(np.float32).copy(),
        v2x.astype(np.float32).copy(),
        v3xy.astype(np.float32).copy(),
        edges_normal.astype(np.float32).copy(),
        vertices_normal.astype(np.float32).copy(),
        v_world,
    )

    # ---- walk the tree, materializing per-leaf triangle lists --------------
    s = start_grid_size
    cell = (box_max[0] - box_min[0]) / s
    new_nodes: list[np.ndarray] = [np.zeros(s**3, np.uint32)]
    total_words = s**3
    patches: list[tuple[int, int]] = []
    leaf_lists: list[np.ndarray] = []
    leaf_centers: list[np.ndarray] = []

    # stack entries: (ref node idx, our slot, depth, center, tri list or None)
    # start grid is z-major in both layouts: ref idx == our slot == lin
    stack = []
    for z in range(s):
        for y in range(s):
            for x in range(s):
                lin = (z * s + y) * s + x
                center = box_min + cell * (np.array([x, y, z]) + 0.5)
                stack.append((lin, lin, start_depth, center, None))

    child_off = np.array(
        [[(i & 1), (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.float64
    )

    while stack:
        ridx, slot, depth, center, tri_list = stack.pop()
        word, tri_idx = int(nodes[ridx, 0]), int(nodes[ridx, 1])
        is_leaf = bool(word & IS_LEAF)

        # Every node BELOW the bit-encoding depth (inner or leaf) filters the
        # inherited list by its own bitmask on entry
        # (ExactOctreeSdf.cpp:108-163); nodes AT it carry a packed set.
        if not is_leaf and depth == bit_start_depth:
            tri_list, _ = _decode_packed_set(sets, tri_idx, bpi)
        elif depth > bit_start_depth:
            n = len(tri_list)
            bits = masks_bits[tri_idx * 8 : tri_idx * 8 + n]
            tri_list = tri_list[bits[:n].astype(bool)]

        if is_leaf:
            if depth <= bit_start_depth:
                ids, _ = _decode_packed_set(sets, tri_idx, bpi)
            else:
                ids = tri_list
            leaf_id = len(leaf_lists)
            leaf_lists.append(np.asarray(ids, np.int32))
            leaf_centers.append(center.astype(np.float32))
            patches.append((slot, leaf_id | IS_LEAF))
            continue

        children = word & CMASK
        base = total_words
        new_nodes.append(np.zeros(8, np.uint32))
        total_words += 8
        patches.append((slot, base))
        node_size = cell / (1 << (depth - start_depth))
        for ci in range(8):
            ccenter = center + (child_off[ci] - 0.5) * 0.5 * node_size
            stack.append(
                (children + ci, base + ci, depth + 1, ccenter, tri_list)
            )

    pad = (-total_words) % 64
    if pad:
        new_nodes.append(np.zeros(pad, np.uint32))
        total_words += pad
    octree = np.concatenate(new_nodes)
    for slot, wordv in patches:
        octree[slot] = wordv

    # CSR spans padded to _LEAF_CHUNK
    spans = np.array(
        [-(-max(len(l), 1) // _LEAF_CHUNK) * _LEAF_CHUNK for l in leaf_lists]
        or [_LEAF_CHUNK],
        np.int64,
    )
    leaf_offset = np.zeros(max(len(leaf_lists), 1), np.int32)
    leaf_count = np.zeros(max(len(leaf_lists), 1), np.int32)
    if len(leaf_lists):
        leaf_offset[: len(spans)] = np.concatenate(
            [[0], np.cumsum(spans)[:-1]]
        )
        leaf_count[: len(leaf_lists)] = [len(l) for l in leaf_lists]
    tri_flat = np.full(int(spans.sum()), -1, np.int32)
    for i, l in enumerate(leaf_lists):
        tri_flat[leaf_offset[i] : leaf_offset[i] + len(l)] = l

    state = {
        "box_min": box_min,
        "box_max": box_max,
        "start_grid_size": np.int32(start_grid_size),
        "max_depth": np.int32(max_depth),
        "min_triangles_per_node": np.int32(min_tris),
        "octree_data": octree,
        "leaf_offset": leaf_offset,
        "leaf_count": leaf_count,
        "tri_flat": tri_flat,
        **{
            f"tri_{name}": np.asarray(arr, np.float32)
            for name, arr in soa._asdict().items()
        },
    }
    sdf = ExactOctreeSdf._from_state_arrays(state)
    # Lists keep the reference's order (NOT distance-sorted): leaf_centers
    # is deliberately absent from the state so _load_state disabled the
    # sorted-list early exit; the centers are still useful metadata
    # (host-resident, like the builder's).
    sdf.leaf_centers = (
        np.stack(leaf_centers).astype(np.float32)
        if leaf_centers
        else np.zeros((1, 3), np.float32)
    )
    sdf._leaf_centers_dev_cache = None
    return sdf


def _pack_index_set(ids: np.ndarray, bpi: int) -> np.ndarray:
    """Pack triangle ids MSB-first at bpi bits each into u32 words
    (the encoding ExactOctreeSdf.cpp:70-87 decodes)."""
    n = len(ids)
    acc = 0
    for v in ids:
        acc = (acc << bpi) | int(v)
    total_bits = n * bpi
    pad = (-total_bits) % 32
    acc <<= pad
    n_words = (total_bits + pad) // 32
    out = np.empty(n_words, np.uint32)
    for i in range(n_words - 1, -1, -1):
        out[i] = acc & 0xFFFFFFFF
        acc >>= 32
    return out


def _save_exact_bin(sdf, out: bytearray) -> None:
    """Encode an ExactOctreeSdf into the reference's bit-encoded container
    (ExactOctreeSdf.h:138-165 field order). Inner-node sets are rebuilt
    bottom-up as sorted unions of descendant leaf lists, exactly the
    structure the reference's 8-way merge produces
    (ExactOctreeSdfDepthFirst.h:195-283)."""
    from ..sdf.exact_octree import _LEAF_CHUNK
    from ..sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK

    octree = np.asarray(sdf.octree_data)
    offs = np.asarray(sdf.leaf_offset)
    cnts = np.asarray(sdf.leaf_count)
    flat = np.asarray(sdf.tri_flat)
    T = sdf.triangles.origin.shape[0]
    s = sdf.start_grid_size
    start_depth = sdf.start_depth
    max_depth = sdf.max_depth
    bit_start = max(start_depth, max_depth - 2)
    bpi = max(1, int(np.ceil(np.log2(max(T, 2)))))

    def leaf_ids_sorted(word):
        lid = int(word & CHILDREN_INDEX_MASK)
        ids = flat[offs[lid] : offs[lid] + cnts[lid]]
        return np.sort(ids.astype(np.int64))

    # Pass 1: recursive list computation (sorted unions above leaves).
    import sys
    sys.setrecursionlimit(100000)

    lists: dict[int, np.ndarray] = {}  # our node slot -> sorted list

    def node_list(slot: int) -> np.ndarray:
        word = octree[slot]
        if word & IS_LEAF_MASK:
            l = leaf_ids_sorted(word)
        else:
            base = int(word & CHILDREN_INDEX_MASK)
            l = np.unique(np.concatenate(
                [node_list(base + c) for c in range(8)]
            ))
        lists[slot] = l
        return l

    for lin in range(s**3):
        node_list(lin)

    # Pass 2: emit reference nodes + sets + masks (BFS, allocation order).
    ref_nodes: list[list[int]] = [[0, 0] for _ in range(s**3)]
    sets_words: list[np.ndarray] = []
    sets_len = 0
    masks_bytes: list[np.ndarray] = []
    masks_len = 0
    max_encoded = 0

    def emit_set(ids) -> int:
        nonlocal sets_len, max_encoded
        start = sets_len
        packed = _pack_index_set(ids, bpi)
        sets_words.append(np.array([len(ids)], np.uint32))
        sets_words.append(packed)
        sets_len += 1 + len(packed)
        max_encoded = max(max_encoded, len(ids))
        return start

    def emit_mask(parent_list, child_list) -> int:
        nonlocal masks_len
        bits = np.isin(parent_list, child_list)
        packed = np.packbits(bits)  # MSB-first
        masks_bytes.append(packed)
        start = masks_len
        masks_len += len(packed)
        return start

    queue = [(lin, lin, start_depth, None) for lin in range(s**3)]
    qi = 0
    while qi < len(queue):
        slot, ref_idx, depth, parent_list = queue[qi]
        qi += 1
        word = octree[slot]
        is_leaf = bool(word & IS_LEAF_MASK)
        node = ref_nodes[ref_idx]

        tri_idx = 0
        if is_leaf and depth <= bit_start:
            tri_idx = emit_set(lists[slot])
        elif not is_leaf and depth == bit_start:
            tri_idx = emit_set(lists[slot])
        elif depth > bit_start:
            tri_idx = emit_mask(parent_list, lists[slot])

        if is_leaf:
            node[0] = 0x80000000
            node[1] = tri_idx
            continue
        child_base = len(ref_nodes)
        ref_nodes.extend([[0, 0] for _ in range(8)])
        node[0] = child_base
        node[1] = tri_idx
        our_base = int(word & CHILDREN_INDEX_MASK)
        nxt_parent = lists[slot] if depth >= bit_start else None
        for c in range(8):
            queue.append((our_base + c, child_base + c, depth + 1, nxt_parent))

    all_counts = cnts[: max(len(offs), 1)]
    out += struct.pack("<i", 2)  # EXACT_OCTREE
    out += np.asarray(sdf.box.min, "<f4").tobytes()
    out += np.asarray(sdf.box.max, "<f4").tobytes()
    out += struct.pack("<i", s)
    out += struct.pack("<I", start_depth)
    out += struct.pack("<I", int(sdf.min_triangles_per_node))
    out += struct.pack("<I", int(all_counts.max(initial=0)))
    out += struct.pack("<I", int(max_encoded))
    out += struct.pack("<I", bit_start)
    out += struct.pack("<I", bpi)
    out += struct.pack("<I", max_depth)
    nodes_arr = np.asarray(ref_nodes, np.uint32)
    out += struct.pack("<Q", len(nodes_arr))
    out += nodes_arr.astype("<u4").tobytes()
    sets_arr = (
        np.concatenate(sets_words) if sets_words else np.zeros(0, np.uint32)
    )
    out += struct.pack("<Q", len(sets_arr))
    out += sets_arr.astype("<u4").tobytes()
    masks_arr = (
        np.concatenate(masks_bytes) if masks_bytes else np.zeros(0, np.uint8)
    )
    out += struct.pack("<Q", len(masks_arr))
    out += masks_arr.tobytes()

    # TriangleData records (37 f32 each; glm mat3 stored column-major)
    tris = sdf.triangles
    n = T
    rec = np.zeros((n, 37), "<f4")
    rec[:, 0:3] = np.asarray(tris.origin)
    rec[:, 3:12] = np.asarray(tris.transform).transpose(0, 2, 1).reshape(n, 9)
    rec[:, 12:14] = np.asarray(tris.b)
    rec[:, 14:16] = np.asarray(tris.c)
    rec[:, 16] = np.asarray(tris.v2x)
    rec[:, 17:19] = np.asarray(tris.v3xy)
    rec[:, 19:28] = np.asarray(tris.edges_normal).reshape(n, 9)
    rec[:, 28:37] = np.asarray(tris.vertices_normal).reshape(n, 9)
    out += struct.pack("<Q", n)
    out += rec.tobytes()


def save_sdflib_bin(sdf, path: str) -> None:
    """Write a reference-compatible .bin container."""
    from ..sdf.grid import UniformGridSdf
    from ..sdf.octree import OctreeSdf

    out = bytearray()
    out += b"\x01"  # little-endian archive flag

    if isinstance(sdf, OctreeSdf):
        if sdf.interpolation != "tricubic":
            raise ValueError(
                ".bin export requires tricubic octrees (the reference's "
                "compiled interpolation method, OctreeSdf.cpp:16)"
            )
        out += struct.pack("<i", _FMT_OCTREE)
        out += np.asarray(sdf.box.min, "<f4").tobytes()
        out += np.asarray(sdf.box.max, "<f4").tobytes()
        out += struct.pack("<i", sdf.start_grid_size)
        out += struct.pack("<I", sdf.max_depth)
        out += struct.pack("<f", sdf.value_range)
        out += struct.pack("<f", sdf.min_border_value)
        data = np.asarray(sdf.octree_data, "<u4")
        out += struct.pack("<Q", data.size)
        out += data.tobytes()
    elif isinstance(sdf, UniformGridSdf):
        out += struct.pack("<i", _FMT_GRID)
        out += np.asarray(sdf.box.min, "<f4").tobytes()
        out += np.asarray(sdf.box.max, "<f4").tobytes()
        nx, ny, nz = sdf.grid_size
        out += struct.pack("<3i", nx, ny, nz)
        grid = np.asarray(sdf.grid, "<f4")  # (nz, ny, nx) -> z-major flat
        out += struct.pack("<Q", grid.size)
        out += grid.tobytes()
    else:
        from ..sdf.exact_octree import ExactOctreeSdf

        if isinstance(sdf, ExactOctreeSdf):
            _save_exact_bin(sdf, out)
        else:
            raise NotImplementedError(
                f".bin export not supported for {type(sdf).__name__}"
            )

    with open(path, "wb") as f:
        f.write(bytes(out))
