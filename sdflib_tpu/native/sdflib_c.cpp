// C ABI shim: engine-side SDF evaluation without Python/JAX.
//
// Native equivalent of the reference's SdfLibUnity shared library
// (reference: src/tools/SdfLibUnity/SdfExportFunc.h:16-59 — createOctreeSdf,
// getDistance(AndGradient), saveSdf/loadSdf, getOctreeData/Size/
// getStartGridSize/getBBMinPoint/getBBSize, deleteSdf). Loads the cereal
// PortableBinaryArchive .bin containers written by sdflib_tpu.io (and by
// the reference itself) for ALL THREE formats and evaluates them with the
// identical semantics as the JAX query paths:
//
//   GRID (0)         — trilinear corner interpolation, cells clamped at the
//                      border (sdflib_tpu/sdf/grid.py; UniformGridSdf.cpp:93+).
//   OCTREE (1)       — flat-array descent + tricubic polynomial, roundFloat
//                      >= 0.5 child selection, out-of-box = box SDF +
//                      minBorderValue (sdflib_tpu/sdf/octree.py;
//                      OctreeSdf.cpp:93-152).
//   EXACT_OCTREE (2) — two-tier bit-encoded descent ('>' child rounding),
//                      packed-set decode at the bit-encoding depth, per-level
//                      bitmask filtering, brute force over the surviving
//                      triangle list with region-classified pseudonormal
//                      sign (sdflib_tpu/sdf/exact_octree.py;
//                      ExactOctreeSdf.cpp:38-178). Unlike the reference's
//                      shared mutable mTrianglesCache (ExactOctreeSdf.h:178,
//                      not thread-safe), the scratch here is thread_local so
//                      the OpenMP batch entry point is safe.
//
// BUILDING structures from a mesh requires the Python/JAX side (the
// level-synchronous builders are JAX programs); the shim's role is loading,
// evaluating, and exposing raw arrays for engine-side upload — the
// reference's createOctreeSdf-from-mesh has no native equivalent here by
// design (build on the accelerator, serialize, consume anywhere).
//
// Build: g++ -O2 -shared -fPIC -fopenmp -o _sdflib_c.so sdflib_c.cpp
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint32_t IS_LEAF = 0x80000000u;
constexpr uint32_t MARK = 0x40000000u;
constexpr uint32_t CHILD_MASK = ~(IS_LEAF | MARK);

// ---------------------------------------------------------------------------
// Format-tagged base (SdfFunction role, SdfFunction.h:16-57)
// ---------------------------------------------------------------------------
struct SdfBase {
  int32_t format;  // 0 GRID, 1 OCTREE, 2 EXACT_OCTREE
  float bb_min[3] = {0, 0, 0};
  float bb_max[3] = {0, 0, 0};
  explicit SdfBase(int32_t fmt) : format(fmt) {}
  virtual ~SdfBase() = default;
  virtual float dist(const float p[3]) const = 0;
  virtual float dist_grad(const float p[3], float g[3]) const = 0;
  virtual int save(const char* path) const = 0;
};

// Axis-aligned box SDF (utils/Mesh.h:42-63 semantics).
inline float box_distance(const SdfBase& o, const float p[3]) {
  float q[3], mx = -1e30f;
  for (int a = 0; a < 3; ++a) {
    float cmid = 0.5f * (o.bb_min[a] + o.bb_max[a]);
    float half = 0.5f * (o.bb_max[a] - o.bb_min[a]);
    q[a] = std::fabs(p[a] - cmid) - half;
    mx = std::max(mx, q[a]);
  }
  float ox = std::max(q[0], 0.f), oy = std::max(q[1], 0.f),
        oz = std::max(q[2], 0.f);
  return std::sqrt(ox * ox + oy * oy + oz * oz) + std::min(mx, 0.f);
}

inline bool in_box(const SdfBase& o, const float p[3]) {
  for (int a = 0; a < 3; ++a)
    if (p[a] < o.bb_min[a] || p[a] > o.bb_max[a]) return false;
  return true;
}

// The reference's quirky box gradient: a = |point| - size, NOT
// centered/halved (utils/Mesh.h:48-61; ops/box.py box_distance_gradient) —
// mirrored exactly so out-of-box gradients match the JAX path bit-for-bit.
inline void box_grad(const SdfBase& o, const float p[3], float g[3]) {
  float a[3], sign_p[3];
  for (int i = 0; i < 3; ++i) {
    a[i] = std::fabs(p[i]) - (o.bb_max[i] - o.bb_min[i]);
    sign_p[i] = p[i] >= 0.f ? 1.f : -1.f;
  }
  int k = a[0] > a[1] ? 0 : 1;
  int l = a[2] > a[k] ? 2 : k;
  if (a[l] < 0.f) {
    for (int i = 0; i < 3; ++i) g[i] = (i == l) ? sign_p[i] : 0.f;
    return;
  }
  float b[3], c2 = 0.f;
  for (int i = 0; i < 3; ++i) {
    b[i] = std::max(a[i], 0.f);
    c2 += b[i] * b[i];
  }
  float c = std::max(std::sqrt(c2), 1e-30f);
  for (int i = 0; i < 3; ++i)
    g[i] = a[i] > 0.f ? b[i] / c * sign_p[i] : 0.f;
}

// ---------------------------------------------------------------------------
// OCTREE (approximate, tricubic leaves)
// ---------------------------------------------------------------------------
inline float tricubic_eval(const float* c, float x, float y, float z) {
  float xp[4] = {1.f, x, x * x, x * x * x};
  float yp[4] = {1.f, y, y * y, y * y * y};
  float zp[4] = {1.f, z, z * z, z * z * z};
  float acc = 0.f;
  for (int k = 0; k < 4; ++k)
    for (int j = 0; j < 4; ++j) {
      float w = yp[j] * zp[k];
      const float* row = c + 4 * j + 16 * k;
      acc += w * (row[0] * xp[0] + row[1] * xp[1] + row[2] * xp[2] +
                  row[3] * xp[3]);
    }
  return acc;
}

inline void tricubic_grad(const float* c, float x, float y, float z,
                          float g[3]) {
  float xp[4] = {1.f, x, x * x, x * x * x};
  float yp[4] = {1.f, y, y * y, y * y * y};
  float zp[4] = {1.f, z, z * z, z * z * z};
  float dx[4] = {0.f, 1.f, 2.f * x, 3.f * x * x};
  float dy[4] = {0.f, 1.f, 2.f * y, 3.f * y * y};
  float dz[4] = {0.f, 1.f, 2.f * z, 3.f * z * z};
  g[0] = g[1] = g[2] = 0.f;
  for (int k = 0; k < 4; ++k)
    for (int j = 0; j < 4; ++j)
      for (int i = 0; i < 4; ++i) {
        float cv = c[i + 4 * j + 16 * k];
        g[0] += cv * dx[i] * yp[j] * zp[k];
        g[1] += cv * xp[i] * dy[j] * zp[k];
        g[2] += cv * xp[i] * yp[j] * dz[k];
      }
}

struct OctreeSdf : SdfBase {
  int32_t start_grid_size = 1;
  uint32_t max_depth = 1;
  float value_range = 0.f;
  float min_border_value = 0.f;
  std::vector<uint32_t> data;

  OctreeSdf() : SdfBase(1) {}

  const float* descend(const float p[3], float frac_out[3]) const {
    const int s = start_grid_size;
    const float size = bb_max[0] - bb_min[0];
    const float cell = size / static_cast<float>(s);
    int ic[3];
    float frac[3];
    for (int a = 0; a < 3; ++a) {
      float f = (p[a] - bb_min[a]) / cell;
      float fl = std::floor(f);
      int i = static_cast<int>(fl);
      i = i < 0 ? 0 : (i >= s ? s - 1 : i);
      ic[a] = i;
      frac[a] = f - fl;
    }
    uint32_t node = data[(ic[2] * s + ic[1]) * s + ic[0]];
    while (!(node & IS_LEAF)) {
      // OctreeSdf child rounding uses >= 0.5 (OctreeSdf.cpp:88-91)
      uint32_t child = (frac[2] >= 0.5f ? 4u : 0u) |
                       (frac[1] >= 0.5f ? 2u : 0u) |
                       (frac[0] >= 0.5f ? 1u : 0u);
      node = data[(node & CHILD_MASK) + child];
      for (int a = 0; a < 3; ++a) {
        frac[a] *= 2.f;
        frac[a] -= std::floor(frac[a]);
      }
    }
    std::memcpy(frac_out, frac, sizeof(frac));
    return reinterpret_cast<const float*>(data.data() + (node & CHILD_MASK));
  }

  float dist(const float p[3]) const override {
    if (!in_box(*this, p)) return box_distance(*this, p) + min_border_value;
    float frac[3];
    const float* c = descend(p, frac);
    return tricubic_eval(c, frac[0], frac[1], frac[2]);
  }

  float dist_grad(const float p[3], float g[3]) const override {
    if (!in_box(*this, p)) {
      box_grad(*this, p, g);
      return box_distance(*this, p) + min_border_value;
    }
    float frac[3];
    const float* c = descend(p, frac);
    float raw[3];
    tricubic_grad(c, frac[0], frac[1], frac[2], raw);
    float len = std::sqrt(raw[0] * raw[0] + raw[1] * raw[1] + raw[2] * raw[2]);
    float inv = len > 1e-30f ? 1.f / len : 0.f;
    for (int a = 0; a < 3; ++a) g[a] = raw[a] * inv;
    return tricubic_eval(c, frac[0], frac[1], frac[2]);
  }

  int save(const char* path) const override {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint8_t endian = 1;
    int32_t fmt = 1;
    uint64_t n = data.size();
    std::fwrite(&endian, 1, 1, f);
    std::fwrite(&fmt, 4, 1, f);
    std::fwrite(bb_min, 4, 3, f);
    std::fwrite(bb_max, 4, 3, f);
    std::fwrite(&start_grid_size, 4, 1, f);
    std::fwrite(&max_depth, 4, 1, f);
    std::fwrite(&value_range, 4, 1, f);
    std::fwrite(&min_border_value, 4, 1, f);
    std::fwrite(&n, 8, 1, f);
    std::fwrite(data.data(), 4, n, f);
    std::fclose(f);
    return 0;
  }
};

// ---------------------------------------------------------------------------
// GRID (dense trilinear; UniformGridSdf.h:15-74 / sdflib_tpu/sdf/grid.py)
// ---------------------------------------------------------------------------
struct GridSdf : SdfBase {
  int32_t nx = 0, ny = 0, nz = 0;
  float cell_size = 1.f;
  std::vector<float> grid;  // z-major flat: [iz][iy][ix]

  GridSdf() : SdfBase(0) {}

  inline float at(int ix, int iy, int iz) const {
    return grid[(static_cast<size_t>(iz) * ny + iy) * nx + ix];
  }

  // Corner fetch + local frac, cells clamped at the border (the JAX path
  // clamps where the reference has UB; grid.py:_gather_corners).
  void corners(const float p[3], float c[8], float frac[3]) const {
    int ip[3];
    const int n[3] = {nx, ny, nz};
    for (int a = 0; a < 3; ++a) {
      float f = (p[a] - bb_min[a]) / cell_size;
      float fl = std::floor(f);
      frac[a] = f - fl;
      int i = static_cast<int>(fl);
      ip[a] = i < 0 ? 0 : (i > n[a] - 2 ? n[a] - 2 : i);
    }
    for (int k = 0; k < 8; ++k)
      c[k] = at(ip[0] + (k & 1), ip[1] + ((k >> 1) & 1), ip[2] + (k >> 2));
  }

  float dist(const float p[3]) const override {
    float c[8], f[3];
    corners(p, c, f);
    float c00 = c[0] + (c[1] - c[0]) * f[0];
    float c10 = c[2] + (c[3] - c[2]) * f[0];
    float c01 = c[4] + (c[5] - c[4]) * f[0];
    float c11 = c[6] + (c[7] - c[6]) * f[0];
    float c0 = c00 + (c10 - c00) * f[1];
    float c1 = c01 + (c11 - c01) * f[1];
    return c0 + (c1 - c0) * f[2];
  }

  float dist_grad(const float p[3], float g[3]) const override {
    float c[8], f[3];
    corners(p, c, f);
    const float x = f[0], y = f[1], z = f[2];
    // analytic trilinear gradient / cell_size (grid.py get_distance_and_gradient)
    g[0] = ((c[1] - c[0]) * (1 - y) + (c[3] - c[2]) * y) * (1 - z) +
           ((c[5] - c[4]) * (1 - y) + (c[7] - c[6]) * y) * z;
    g[1] = ((c[2] - c[0]) * (1 - x) + (c[3] - c[1]) * x) * (1 - z) +
           ((c[6] - c[4]) * (1 - x) + (c[7] - c[5]) * x) * z;
    g[2] = ((c[4] - c[0]) * (1 - x) + (c[5] - c[1]) * x) * (1 - y) +
           ((c[6] - c[2]) * (1 - x) + (c[7] - c[3]) * x) * y;
    for (int a = 0; a < 3; ++a) g[a] /= cell_size;
    float c00 = c[0] + (c[1] - c[0]) * x;
    float c10 = c[2] + (c[3] - c[2]) * x;
    float c01 = c[4] + (c[5] - c[4]) * x;
    float c11 = c[6] + (c[7] - c[6]) * x;
    float c0 = c00 + (c10 - c00) * y;
    float c1 = c01 + (c11 - c01) * y;
    return c0 + (c1 - c0) * z;
  }

  int save(const char* path) const override {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint8_t endian = 1;
    int32_t fmt = 0;
    uint64_t n = grid.size();
    std::fwrite(&endian, 1, 1, f);
    std::fwrite(&fmt, 4, 1, f);
    std::fwrite(bb_min, 4, 3, f);
    std::fwrite(bb_max, 4, 3, f);
    std::fwrite(&nx, 4, 1, f);
    std::fwrite(&ny, 4, 1, f);
    std::fwrite(&nz, 4, 1, f);
    std::fwrite(&n, 8, 1, f);
    std::fwrite(grid.data(), 4, n, f);
    std::fclose(f);
    return 0;
  }
};

// ---------------------------------------------------------------------------
// EXACT_OCTREE (bit-encoded; ExactOctreeSdf.h:35-199 / exact_octree.py)
// ---------------------------------------------------------------------------

// Parsed 37-float TriangleData record (TriangleUtils.h:20-72; field order
// io/sdflib_binary.py): world->local transform rows m[3i+j], 2D edge dirs
// b/c, v2/v3 in triangle space, triangle-space edge + vertex pseudonormals.
struct TriRec {
  float origin[3];
  float m[9];
  float b[2], c[2];
  float v2x, v3x, v3y;
  float en[9];
  float vn[9];
};

enum Region { V1 = 0, V2, V3, E1, E2, E3, FACE };

inline void project(const TriRec& t, const float p[3], float pp[3]) {
  float r[3] = {p[0] - t.origin[0], p[1] - t.origin[1], p[2] - t.origin[2]};
  for (int i = 0; i < 3; ++i)
    pp[i] = t.m[3 * i] * r[0] + t.m[3 * i + 1] * r[1] + t.m[3 * i + 2] * r[2];
}

// Region classification + squared distance; tie-breaking mirrors
// TriangleUtils.h:84-134 exactly (ops/point_triangle.py region_code).
inline float sq_dist_region(const TriRec& t, const float pp[3], int* code) {
  const float x = pp[0], y = pp[1], z2 = pp[2] * pp[2];
  const float de1 = -y;
  const float de2 = (x - t.v2x) * t.b[1] - y * t.b[0];
  const float de3 = x * t.c[1] - y * t.c[0];
  int r;
  float sq;
  if (de1 >= 0.f) {
    if (x <= 0.f) {
      r = V1;
      sq = x * x + y * y + z2;
    } else if (x >= t.v2x) {
      r = V2;
      float dx = x - t.v2x;
      sq = dx * dx + y * y + z2;
    } else {
      r = E1;
      sq = de1 * de1 + z2;
    }
  } else if (de2 >= 0.f) {
    float dot_b_v2 = (x - t.v2x) * t.b[0] + y * t.b[1];
    float dot_b_v3 = (x - t.v3x) * t.b[0] + (y - t.v3y) * t.b[1];
    if (dot_b_v2 <= 0.f) {
      r = V2;
      float dx = x - t.v2x;
      sq = dx * dx + y * y + z2;
    } else if (dot_b_v3 >= 0.f) {
      r = V3;
      float dx = x - t.v3x, dy = y - t.v3y;
      sq = dx * dx + dy * dy + z2;
    } else {
      r = E2;
      sq = de2 * de2 + z2;
    }
  } else if (de3 >= 0.f) {
    float dot_c_v1 = x * t.c[0] + y * t.c[1];
    float dot_c_v3 = (x - t.v3x) * t.c[0] + (y - t.v3y) * t.c[1];
    if (dot_c_v1 >= 0.f) {
      r = V1;
      sq = x * x + y * y + z2;
    } else if (dot_c_v3 <= 0.f) {
      r = V3;
      float dx = x - t.v3x, dy = y - t.v3y;
      sq = dx * dx + dy * dy + z2;
    } else {
      r = E3;
      sq = de3 * de3 + z2;
    }
  } else {
    r = FACE;
    sq = z2;
  }
  *code = r;
  return sq;
}

inline float signf(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

// Signed distance of the winning triangle via region pseudonormal
// (TriangleUtils.h:137-196; ops/point_triangle.py signed_dist_pair).
inline float signed_of_winner(const TriRec& t, const float pp[3], int code,
                              float sq) {
  if (code == FACE) return pp[2];
  const float* n;
  float rel[3] = {pp[0], pp[1], pp[2]};
  switch (code) {
    case V1: n = t.vn; break;
    case V2: n = t.vn + 3; rel[0] -= t.v2x; break;
    case V3: n = t.vn + 6; rel[0] -= t.v3x; rel[1] -= t.v3y; break;
    case E1: n = t.en; break;
    case E2: n = t.en + 3; rel[0] -= t.v2x; break;
    default: n = t.en + 6; break;  // E3
  }
  float d = n[0] * rel[0] + n[1] * rel[1] + n[2] * rel[2];
  return signf(d) * std::sqrt(sq);
}

// local -> world via the transpose (frame is orthonormal)
inline void mtv(const TriRec& t, const float v[3], float out[3]) {
  for (int a = 0; a < 3; ++a)
    out[a] = t.m[a] * v[0] + t.m[3 + a] * v[1] + t.m[6 + a] * v[2];
}

inline void safe_normalize(float v[3], const float fb[3]) {
  float n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  if (n2 > 0.f) {
    float inv = 1.f / std::sqrt(n2);
    for (int a = 0; a < 3; ++a) v[a] *= inv;
  } else {
    std::memcpy(v, fb, 12);
  }
}

// Signed distance + world gradient of the winner (TriangleUtils.h:198-290;
// ops/point_triangle.py signed_dist_grad_pair).
inline float signed_grad_of_winner(const TriRec& t, const float p[3],
                                   const float pp[3], int code, float sq,
                                   float g[3]) {
  const float tn[3] = {t.m[6], t.m[7], t.m[8]};  // world unit normal (row 2)
  if (code == FACE) {
    std::memcpy(g, tn, 12);
    return pp[2];
  }
  float d = signed_of_winner(t, pp, code, sq);
  float sgn = signf(d);
  float n[3];
  if (code <= V3) {
    // vertex regions: normalize(point - vertex_world)
    float vw[3] = {t.origin[0], t.origin[1], t.origin[2]};
    if (code == V2) {
      for (int a = 0; a < 3; ++a) vw[a] += t.m[a] * t.v2x;  // row 0 = inv col 0
    } else if (code == V3) {
      for (int a = 0; a < 3; ++a)
        vw[a] += t.m[a] * t.v3x + t.m[3 + a] * t.v3y;
    }
    for (int a = 0; a < 3; ++a) n[a] = p[a] - vw[a];
    safe_normalize(n, tn);
  } else if (code == E1) {
    float loc[3] = {0.f, pp[1], pp[2]};
    mtv(t, loc, n);
    safe_normalize(n, tn);
  } else if (code == E2) {
    float dot_b = (pp[0] - t.v2x) * t.b[0] + pp[1] * t.b[1];
    float loc[3] = {(pp[0] - t.v2x) - dot_b * t.b[0],
                    pp[1] - dot_b * t.b[1], pp[2]};
    mtv(t, loc, n);
    safe_normalize(n, tn);
  } else {  // E3
    float dot_c = pp[0] * t.c[0] + pp[1] * t.c[1];
    float loc[3] = {pp[0] - dot_c * t.c[0], pp[1] - dot_c * t.c[1], pp[2]};
    mtv(t, loc, n);
    safe_normalize(n, tn);
  }
  for (int a = 0; a < 3; ++a) g[a] = sgn * n[a];
  return d;
}

struct ExactSdf : SdfBase {
  int32_t start_grid_size = 1;
  uint32_t start_depth = 1;
  uint32_t min_tris = 0, max_tris = 0, max_encoded = 0;
  uint32_t bit_start_depth = 0;
  uint32_t bpi = 1;
  uint32_t max_depth = 1;
  std::vector<uint32_t> nodes;   // 2 words per node {children, tri_idx}
  std::vector<uint32_t> sets;    // packed index sets (+1 zero pad word)
  uint64_t sets_n = 0;           // original (unpadded) length for save
  std::vector<uint8_t> masks;    // per-parent-triangle bitmasks
  std::vector<TriRec> tris;

  ExactSdf() : SdfBase(2) {}

  // Decode a count-prefixed packed set (ExactOctreeSdf.cpp:70-87).
  void decode_set(uint32_t start, std::vector<uint32_t>& out) const {
    uint32_t count = sets[start];
    out.resize(count);
    uint64_t boff = 0;
    const uint32_t* base = sets.data() + start + 1;
    const uint32_t mask_v = bpi >= 32 ? 0xFFFFFFFFu : ((1u << bpi) - 1u);
    for (uint32_t k = 0; k < count; ++k, boff += bpi) {
      uint64_t word = boff >> 5;
      uint32_t bit = static_cast<uint32_t>(boff & 31);
      uint64_t w = (static_cast<uint64_t>(base[word]) << 32) |
                   base[word + 1];
      out[k] = static_cast<uint32_t>((w >> (64 - bit - bpi)) & mask_v);
    }
  }

  // Filter `cur` by the bitmask at byte offset mask_idx (MSB-first,
  // bit i = position i of the parent list; ExactOctreeSdf.cpp:108-163).
  static void filter_mask(const std::vector<uint8_t>& masks,
                          uint32_t mask_idx, std::vector<uint32_t>& cur,
                          std::vector<uint32_t>& nxt) {
    nxt.clear();
    const uint8_t* mb = masks.data() + mask_idx;
    for (size_t i = 0; i < cur.size(); ++i)
      if (mb[i >> 3] & (0x80u >> (i & 7))) nxt.push_back(cur[i]);
    cur.swap(nxt);
  }

  // Walk to the leaf, materializing the surviving triangle list in `cur`.
  void leaf_list(const float p[3], std::vector<uint32_t>& cur,
                 std::vector<uint32_t>& scratch) const {
    const int s = start_grid_size;
    const float size = bb_max[0] - bb_min[0];
    const float cell = size / static_cast<float>(s);
    int ic[3];
    float frac[3];
    for (int a = 0; a < 3; ++a) {
      float f = (p[a] - bb_min[a]) / cell;
      float fl = std::floor(f);
      int i = static_cast<int>(fl);
      i = i < 0 ? 0 : (i >= s ? s - 1 : i);
      ic[a] = i;
      frac[a] = f - fl;
    }
    uint32_t idx = (ic[2] * s + ic[1]) * s + ic[0];
    uint32_t depth = start_depth;
    for (;;) {
      uint32_t children = nodes[2 * idx];
      uint32_t tri_idx = nodes[2 * idx + 1];
      bool leaf = (children & IS_LEAF) != 0;
      if (!leaf && depth == bit_start_depth) {
        decode_set(tri_idx, cur);
      } else if (depth > bit_start_depth) {
        filter_mask(masks, tri_idx, cur, scratch);
      }
      if (leaf) {
        if (depth <= bit_start_depth) decode_set(tri_idx, cur);
        return;
      }
      // ExactOctreeSdf child rounding uses strict '>' (ExactOctreeSdf.cpp:33-36)
      uint32_t child = (frac[2] > 0.5f ? 4u : 0u) |
                       (frac[1] > 0.5f ? 2u : 0u) |
                       (frac[0] > 0.5f ? 1u : 0u);
      idx = (children & CHILD_MASK) + child;
      for (int a = 0; a < 3; ++a) {
        frac[a] *= 2.f;
        frac[a] -= std::floor(frac[a]);
      }
      ++depth;
    }
  }

  // Brute force survivors; returns winner id with its region + sq distance
  // (ExactOctreeSdf.cpp:166-175).
  uint32_t brute(const float p[3], const std::vector<uint32_t>& list,
                 float pp_out[3], int* code_out, float* sq_out) const {
    float best = 1e30f;
    uint32_t win = 0;
    int win_code = FACE;
    float win_pp[3] = {0, 0, 0};
    for (uint32_t id : list) {
      const TriRec& t = tris[id];
      float pp[3];
      project(t, p, pp);
      int code;
      float sq = sq_dist_region(t, pp, &code);
      if (sq < best) {
        best = sq;
        win = id;
        win_code = code;
        std::memcpy(win_pp, pp, 12);
      }
    }
    std::memcpy(pp_out, win_pp, 12);
    *code_out = win_code;
    *sq_out = best;
    return win;
  }

  float dist(const float p[3]) const override {
    if (!in_box(*this, p))
      return box_distance(*this, p) +
             std::sqrt(3.f) * (bb_max[0] - bb_min[0]);
    thread_local std::vector<uint32_t> cur, scratch;
    leaf_list(p, cur, scratch);
    if (cur.empty()) return box_distance(*this, p);
    float pp[3], sq;
    int code;
    uint32_t win = brute(p, cur, pp, &code, &sq);
    return signed_of_winner(tris[win], pp, code, sq);
  }

  float dist_grad(const float p[3], float g[3]) const override {
    if (!in_box(*this, p)) {
      box_grad(*this, p, g);
      return box_distance(*this, p) +
             std::sqrt(3.f) * (bb_max[0] - bb_min[0]);
    }
    thread_local std::vector<uint32_t> cur, scratch;
    leaf_list(p, cur, scratch);
    if (cur.empty()) {
      box_grad(*this, p, g);
      return box_distance(*this, p);
    }
    float pp[3], sq;
    int code;
    uint32_t win = brute(p, cur, pp, &code, &sq);
    return signed_grad_of_winner(tris[win], p, pp, code, sq, g);
  }

  int save(const char* path) const override {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint8_t endian = 1;
    int32_t fmt = 2;
    std::fwrite(&endian, 1, 1, f);
    std::fwrite(&fmt, 4, 1, f);
    std::fwrite(bb_min, 4, 3, f);
    std::fwrite(bb_max, 4, 3, f);
    std::fwrite(&start_grid_size, 4, 1, f);
    std::fwrite(&start_depth, 4, 1, f);
    std::fwrite(&min_tris, 4, 1, f);
    std::fwrite(&max_tris, 4, 1, f);
    std::fwrite(&max_encoded, 4, 1, f);
    std::fwrite(&bit_start_depth, 4, 1, f);
    std::fwrite(&bpi, 4, 1, f);
    std::fwrite(&max_depth, 4, 1, f);
    uint64_t n_nodes = nodes.size() / 2;
    std::fwrite(&n_nodes, 8, 1, f);
    std::fwrite(nodes.data(), 4, nodes.size(), f);
    std::fwrite(&sets_n, 8, 1, f);
    std::fwrite(sets.data(), 4, sets_n, f);
    uint64_t n_masks = masks.size();
    std::fwrite(&n_masks, 8, 1, f);
    std::fwrite(masks.data(), 1, n_masks, f);
    // TriangleData (37 f32 each, glm mat3 column-major)
    uint64_t n_tris = tris.size();
    std::fwrite(&n_tris, 8, 1, f);
    for (const TriRec& t : tris) {
      float rec[37];
      std::memcpy(rec, t.origin, 12);
      for (int j = 0; j < 3; ++j)
        for (int i = 0; i < 3; ++i) rec[3 + 3 * j + i] = t.m[3 * i + j];
      rec[12] = t.b[0];
      rec[13] = t.b[1];
      rec[14] = t.c[0];
      rec[15] = t.c[1];
      rec[16] = t.v2x;
      rec[17] = t.v3x;
      rec[18] = t.v3y;
      std::memcpy(rec + 19, t.en, 36);
      std::memcpy(rec + 28, t.vn, 36);
      std::fwrite(rec, 4, 37, f);
    }
    std::fclose(f);
    return 0;
  }
};

// ---------------------------------------------------------------------------
// Loaders
// ---------------------------------------------------------------------------
struct Cursor {
  FILE* f;
  bool ok = true;
  template <typename T>
  T get() {
    T v{};
    if (std::fread(&v, sizeof(T), 1, f) != 1) ok = false;
    return v;
  }
  bool read(void* dst, size_t bytes) {
    if (std::fread(dst, 1, bytes, f) != bytes) ok = false;
    return ok;
  }
};

SdfBase* load_grid(Cursor& c) {
  auto* g = new GridSdf();
  c.read(g->bb_min, 12);
  c.read(g->bb_max, 12);
  g->nx = c.get<int32_t>();
  g->ny = c.get<int32_t>();
  g->nz = c.get<int32_t>();
  uint64_t n = c.get<uint64_t>();
  g->grid.resize(n);
  c.read(g->grid.data(), 4 * n);
  if (!c.ok || g->nx < 2 ||
      n != static_cast<uint64_t>(g->nx) * g->ny * g->nz) {
    delete g;
    return nullptr;
  }
  g->cell_size = (g->bb_max[0] - g->bb_min[0]) / (g->nx - 1);
  return g;
}

SdfBase* load_octree(Cursor& c) {
  auto* o = new OctreeSdf();
  c.read(o->bb_min, 12);
  c.read(o->bb_max, 12);
  o->start_grid_size = c.get<int32_t>();
  o->max_depth = c.get<uint32_t>();
  o->value_range = c.get<float>();
  o->min_border_value = c.get<float>();
  uint64_t n = c.get<uint64_t>();
  o->data.resize(n);
  c.read(o->data.data(), 4 * n);
  if (!c.ok) {
    delete o;
    return nullptr;
  }
  return o;
}

SdfBase* load_exact(Cursor& c) {
  auto* e = new ExactSdf();
  c.read(e->bb_min, 12);
  c.read(e->bb_max, 12);
  e->start_grid_size = c.get<int32_t>();
  e->start_depth = c.get<uint32_t>();
  e->min_tris = c.get<uint32_t>();
  e->max_tris = c.get<uint32_t>();
  e->max_encoded = c.get<uint32_t>();
  e->bit_start_depth = c.get<uint32_t>();
  e->bpi = c.get<uint32_t>();
  e->max_depth = c.get<uint32_t>();
  uint64_t n_nodes = c.get<uint64_t>();
  e->nodes.resize(2 * n_nodes);
  c.read(e->nodes.data(), 8 * n_nodes);
  e->sets_n = c.get<uint64_t>();
  e->sets.resize(e->sets_n + 1, 0);  // +1 pad: decode touches word idx+1
  c.read(e->sets.data(), 4 * e->sets_n);
  uint64_t n_masks = c.get<uint64_t>();
  e->masks.resize(n_masks);
  c.read(e->masks.data(), n_masks);
  uint64_t n_tris = c.get<uint64_t>();
  e->tris.resize(n_tris);
  for (uint64_t i = 0; i < n_tris && c.ok; ++i) {
    float rec[37];
    c.read(rec, 4 * 37);
    TriRec& t = e->tris[i];
    std::memcpy(t.origin, rec, 12);
    for (int j = 0; j < 3; ++j)
      for (int a = 0; a < 3; ++a) t.m[3 * a + j] = rec[3 + 3 * j + a];
    t.b[0] = rec[12];
    t.b[1] = rec[13];
    t.c[0] = rec[14];
    t.c[1] = rec[15];
    t.v2x = rec[16];
    t.v3x = rec[17];
    t.v3y = rec[18];
    std::memcpy(t.en, rec + 19, 36);
    std::memcpy(t.vn, rec + 28, 36);
  }
  if (!c.ok) {
    delete e;
    return nullptr;
  }
  return e;
}

}  // namespace

extern "C" {

// loadSdf role (SdfExportFunc.h:49) — format-generic .bin loader.
void* sdflib_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Cursor c{f};
  uint8_t endian = c.get<uint8_t>();
  int32_t fmt = c.get<int32_t>();
  SdfBase* out = nullptr;
  if (c.ok && endian == 1) {
    if (fmt == 0) out = load_grid(c);
    else if (fmt == 1) out = load_octree(c);
    else if (fmt == 2) out = load_exact(c);
  }
  std::fclose(f);
  return out;
}

// SdfFormat of a loaded handle (GRID=0, OCTREE=1, EXACT_OCTREE=2).
int32_t sdflib_format(void* h) { return static_cast<SdfBase*>(h)->format; }

// createOctreeSdf-from-memory role: engine already holds the flat array.
void* sdflib_create_from_data(const uint32_t* data, uint64_t n,
                              const float bb_min[3], float bb_size,
                              int32_t start_grid_size, uint32_t max_depth,
                              float value_range, float min_border_value) {
  auto* o = new OctreeSdf();
  for (int a = 0; a < 3; ++a) {
    o->bb_min[a] = bb_min[a];
    o->bb_max[a] = bb_min[a] + bb_size;
  }
  o->start_grid_size = start_grid_size;
  o->max_depth = max_depth;
  o->value_range = value_range;
  o->min_border_value = min_border_value;
  o->data.assign(data, data + n);
  return o;
}

int sdflib_save(void* h, const char* path) {
  return static_cast<SdfBase*>(h)->save(path);
}

void sdflib_delete(void* h) { delete static_cast<SdfBase*>(h); }

// Format-generic getDistance (SdfExportFunc.h:31-47 role).
float sdflib_get_distance(void* h, float x, float y, float z) {
  const float p[3] = {x, y, z};
  return static_cast<SdfBase*>(h)->dist(p);
}

float sdflib_get_distance_gradient(void* h, float x, float y, float z,
                                   float grad_out[3]) {
  const float p[3] = {x, y, z};
  return static_cast<SdfBase*>(h)->dist_grad(p, grad_out);
}

void sdflib_get_distance_batch(void* h, const float* pts, uint64_t n,
                               float* out) {
  auto* s = static_cast<SdfBase*>(h);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < static_cast<int64_t>(n); ++i) {
    out[i] = s->dist(pts + 3 * i);
  }
}

// ---- OCTREE raw-array accessors (engine SSBO-upload role) ----------------
const uint32_t* sdflib_octree_data(void* h) {
  auto* s = static_cast<SdfBase*>(h);
  if (s->format != 1) return nullptr;
  return static_cast<OctreeSdf*>(s)->data.data();
}

uint64_t sdflib_octree_data_size(void* h) {
  auto* s = static_cast<SdfBase*>(h);
  if (s->format != 1) return 0;
  return static_cast<OctreeSdf*>(s)->data.size();
}

int32_t sdflib_start_grid_size(void* h) {
  auto* s = static_cast<SdfBase*>(h);
  if (s->format == 1) return static_cast<OctreeSdf*>(s)->start_grid_size;
  if (s->format == 2) return static_cast<ExactSdf*>(s)->start_grid_size;
  return 0;
}

void sdflib_bb_min(void* h, float out[3]) {
  std::memcpy(out, static_cast<SdfBase*>(h)->bb_min, 12);
}

float sdflib_bb_size(void* h) {
  auto* s = static_cast<SdfBase*>(h);
  return s->bb_max[0] - s->bb_min[0];
}

}  // extern "C"
