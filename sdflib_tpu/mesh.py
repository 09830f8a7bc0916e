"""Triangle mesh container, bounding box, and mesh file IO.

JAX re-design of the reference geometry layer
(reference: include/SdfLib/utils/Mesh.h:16-106, src/utils/Mesh.cpp:9-139).
The mesh lives on host as numpy arrays; device kernels consume the
precomputed per-triangle SoA (see sdflib_tpu/triangle.py).

Mesh IO is a dependency-free parser for PLY (ascii + binary_little_endian),
OBJ, STL (ascii + binary) and OFF, replacing the reference's assimp usage
(src/utils/Mesh.cpp:9-26). A native C++ fast path can override `_load_*`.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["BoundingBox", "Mesh", "load_mesh"]


@dataclass
class BoundingBox:
    """Axis-aligned box with its own exact box SDF.

    Mirrors the reference BoundingBox (utils/Mesh.h:16-70) including the
    out-of-domain fallback semantics: `distance` is the exact SDF of the box
    surface, used by octree queries for samples outside the domain
    (src/sdf/OctreeSdf.cpp:99-104).
    """

    min: np.ndarray = field(default_factory=lambda: np.full(3, np.inf, np.float32))
    max: np.ndarray = field(default_factory=lambda: np.full(3, -np.inf, np.float32))

    def __post_init__(self):
        self.min = np.asarray(self.min, dtype=np.float32)
        self.max = np.asarray(self.max, dtype=np.float32)

    @property
    def size(self) -> np.ndarray:
        return self.max - self.min

    @property
    def center(self) -> np.ndarray:
        return self.min + 0.5 * self.size

    def add_margin(self, margin: float) -> "BoundingBox":
        return BoundingBox(self.min - margin, self.max + margin)

    def cubified(self) -> "BoundingBox":
        """Expand to a cube around the center (OctreeSdf.cpp:43-46)."""
        c = self.center
        half = 0.5 * float(np.max(self.size))
        return BoundingBox(c - half, c + half)

    def distance(self, points) -> np.ndarray:
        """Exact box SDF, batched. points: (..., 3)."""
        p = np.asarray(points, dtype=np.float32)
        q = np.abs(p - self.center) - 0.5 * self.size
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return (outside + inside).astype(np.float32)

    def __eq__(self, other):
        return (
            isinstance(other, BoundingBox)
            and np.array_equal(self.min, other.min)
            and np.array_equal(self.max, other.max)
        )


class Mesh:
    """Host-side triangle mesh: vertices (V,3) f32, indices (T,3) u32."""

    def __init__(self, vertices, indices, normals=None):
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self.indices = np.ascontiguousarray(indices, dtype=np.uint32).reshape(-1, 3)
        self._normals = None if normals is None else np.asarray(normals, np.float32)
        self._bbox: BoundingBox | None = None

    @classmethod
    def from_file(cls, path: str) -> "Mesh":
        return load_mesh(path)

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def bounding_box(self) -> BoundingBox:
        if self._bbox is None:
            self._bbox = BoundingBox(self.vertices.min(axis=0), self.vertices.max(axis=0))
        return self._bbox

    def triangle_vertices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(v0, v1, v2) each (T, 3)."""
        v = self.vertices
        i = self.indices
        return v[i[:, 0]], v[i[:, 1]], v[i[:, 2]]

    def face_normals(self, normalized: bool = True) -> np.ndarray:
        a, b, c = self.triangle_vertices()
        n = np.cross(b - a, c - a)
        if normalized:
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            n = np.where(ln > 0, n / np.maximum(ln, 1e-30), n)
        return n.astype(np.float32)

    def compute_normals(self) -> np.ndarray:
        """Angle-weighted per-vertex normals (Mesh.cpp:108-129 semantics)."""
        v = self.vertices.astype(np.float64)
        idx = self.indices.astype(np.int64)
        fn = np.cross(v[idx[:, 1]] - v[idx[:, 0]], v[idx[:, 2]] - v[idx[:, 0]])
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = np.where(ln > 0, fn / np.maximum(ln, 1e-30), fn)
        out = np.zeros_like(v)
        for k in range(3):
            a = idx[:, k]
            b = idx[:, (k + 1) % 3]
            c = idx[:, (k + 2) % 3]
            e1 = v[b] - v[a]
            e2 = v[c] - v[a]
            e1 /= np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-30)
            e2 /= np.maximum(np.linalg.norm(e2, axis=-1, keepdims=True), 1e-30)
            ang = np.arccos(np.clip(np.sum(e1 * e2, axis=-1), -1.0, 1.0))
            np.add.at(out, a, ang[:, None] * fn)
        ln = np.linalg.norm(out, axis=-1, keepdims=True)
        out = np.where(ln > 0, out / np.maximum(ln, 1e-30), out)
        self._normals = out.astype(np.float32)
        return self._normals

    @property
    def normals(self) -> np.ndarray:
        if self._normals is None:
            self.compute_normals()
        return self._normals

    def apply_transform(self, mat4: np.ndarray) -> "Mesh":
        """Return a new mesh with a 4x4 homogeneous transform applied
        (Mesh.cpp:131-139 semantics)."""
        m = np.asarray(mat4, np.float64)
        vh = np.concatenate([self.vertices, np.ones((self.num_vertices, 1), np.float32)], axis=1)
        v = (vh @ m.T)[:, :3]
        return Mesh(v.astype(np.float32), self.indices)

    def normalized(self, margin_ratio: float = 0.0) -> "Mesh":
        """Scale/translate into the unit cube centered at origin."""
        bb = self.bounding_box
        scale = 1.0 / float(np.max(bb.size))
        v = (self.vertices - bb.center) * scale
        return Mesh(v.astype(np.float32), self.indices)


# ---------------------------------------------------------------------------
# Mesh file parsers (assimp replacement)
# ---------------------------------------------------------------------------

def load_mesh(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return _load_ply(path)
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".stl":
        return _load_stl(path)
    if ext == ".off":
        return _load_off(path)
    raise ValueError(f"Unsupported mesh format: {ext!r} ({path})")


_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"Invalid PLY file: {path}")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, type) or ('list', count_t, item_t, name)])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))

    if fmt == "ascii":
        return _parse_ply_ascii(body, elements)
    if fmt in ("binary_little_endian", "binary_big_endian"):
        bo = "<" if fmt == "binary_little_endian" else ">"
        return _parse_ply_binary(body, elements, bo)
    raise ValueError(f"Unsupported PLY format {fmt}")


def _parse_ply_ascii(body: bytes, elements) -> Mesh:
    lines = body.decode("ascii", errors="replace").splitlines()
    pos = 0
    vertices = None
    faces = []
    for name, count, props in elements:
        if name == "vertex":
            xyz_idx = [i for i, p in enumerate(props) if p[0] in ("x", "y", "z")]
            rows = np.array(
                [lines[pos + i].split() for i in range(count)], dtype=np.float64
            )
            vertices = rows[:, xyz_idx].astype(np.float32)
            pos += count
        elif name in ("face", "faces"):
            for i in range(count):
                vals = lines[pos + i].split()
                n = int(vals[0])
                poly = [int(x) for x in vals[1 : 1 + n]]
                for k in range(1, n - 1):  # fan triangulation
                    faces.append((poly[0], poly[k], poly[k + 1]))
            pos += count
        else:
            pos += count
    return Mesh(vertices, np.asarray(faces, np.uint32))


def _parse_ply_binary(body: bytes, elements, bo: str) -> Mesh:
    offset = 0
    vertices = None
    faces = []
    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        if not has_list:
            dtype = np.dtype([(p[0], bo + _PLY_TYPES[p[1]]) for p in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
            offset += dtype.itemsize * count
            if name == "vertex":
                vertices = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float32)
        else:
            # Fast path: a single list property with uniform length-3 faces.
            if name in ("face", "faces") and len(props) == 1:
                _, count_t, item_t, _ = props[0]
                cdt = np.dtype(bo + _PLY_TYPES[count_t])
                idt = np.dtype(bo + _PLY_TYPES[item_t])
                first_n = int(
                    np.frombuffer(body, dtype=cdt, count=1, offset=offset)[0]
                )
                rec = np.dtype(
                    [("n", cdt), ("idx", idt, (first_n,))]
                )
                if offset + rec.itemsize * count <= len(body):
                    arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                    if np.all(arr["n"] == first_n):
                        offset += rec.itemsize * count
                        poly = arr["idx"].astype(np.int64)
                        for k in range(1, first_n - 1):
                            faces.extend(
                                np.stack(
                                    [poly[:, 0], poly[:, k], poly[:, k + 1]], axis=-1
                                )
                            )
                        continue
                # Irregular faces: slow path.
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=cdt, count=1, offset=offset)[0])
                    offset += cdt.itemsize
                    poly = np.frombuffer(body, dtype=idt, count=n, offset=offset)
                    offset += idt.itemsize * n
                    for k in range(1, n - 1):
                        faces.append((poly[0], poly[k], poly[k + 1]))
            else:
                raise ValueError("Unsupported PLY list layout")
    return Mesh(vertices, np.asarray(faces, np.uint32))


def _load_obj(path: str) -> Mesh:
    verts = []
    faces = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = [int(p.split("/")[0]) for p in parts]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return Mesh(np.asarray(verts, np.float32), np.asarray(faces, np.uint32))


def _load_stl(path: str) -> Mesh:
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            text = f.read().decode("ascii", errors="replace")
            if "facet" in text:
                return _load_stl_ascii(text)
            f.seek(0)
        data = f.read()
    n = struct.unpack("<I", data[80:84])[0]
    rec = np.dtype(
        [("n", "<f4", (3,)), ("v", "<f4", (3, 3)), ("attr", "<u2")]
    )
    arr = np.frombuffer(data, dtype=rec, count=n, offset=84)
    tri_verts = arr["v"].reshape(-1, 3)
    verts, inv = np.unique(tri_verts.round(decimals=7), axis=0, return_inverse=True)
    return Mesh(verts.astype(np.float32), inv.astype(np.uint32).reshape(-1, 3))


def _load_stl_ascii(text: str) -> Mesh:
    tri_verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0] == "vertex":
            tri_verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
    tri_verts = np.asarray(tri_verts, np.float64)
    verts, inv = np.unique(tri_verts.round(decimals=7), axis=0, return_inverse=True)
    return Mesh(verts.astype(np.float32), inv.astype(np.uint32).reshape(-1, 3))


def _load_off(path: str) -> Mesh:
    with open(path, "r", errors="replace") as f:
        tokens = f.read().split()
    i = 0
    if tokens[i] == "OFF":
        i += 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3
    verts = np.asarray(tokens[i : i + 3 * nv], np.float64).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        n = int(tokens[i])
        poly = [int(tokens[i + 1 + k]) for k in range(n)]
        i += 1 + n
        for k in range(1, n - 1):
            faces.append((poly[0], poly[k], poly[k + 1]))
    return Mesh(verts.astype(np.float32), np.asarray(faces, np.uint32))
