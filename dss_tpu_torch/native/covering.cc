// Native covering fast path for dss_tpu_torch.geo.covering (the port's
// copy of the reference's dss_tpu/native/covering.cc).
//
// Implements EXACTLY the single-face rectangle covering that
// dss_tpu_torch/geo/covering.py::_loop_covering takes for typical entity
// footprints (upstream semantics: pkg/geo/s2.go:16-25,
// coverings at fixed level 13), but in one native call instead of ~80
// small numpy dispatches (~5 ms -> ~20 us per request).  The Python
// path remains the behavioral reference: a differential fuzz test
// (tests/test_torch_native.py) pins this kernel to it cell-for-cell.
//
// Parity notes: every predicate here mirrors the numpy operation order
// (same +,-,*,/ and sqrt sequence in IEEE double), so verdicts are
// bit-identical; the only transcendental (atan2, in the area formula)
// stays in Python and its verdict is passed in via `area_ok`.
//
// Build: dss_tpu_torch/native/_buildlib.py (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int MAX_LEVEL = 30;
constexpr int DAR_LEVEL = 13;
constexpr int LOOKUP_BITS = 4;
constexpr int SWAP_MASK = 1;
constexpr int INVERT_MASK = 2;
constexpr int64_t RECT_MAX_CELLS = 1 << 16;    // covering.py:_RECT_MAX_CELLS
constexpr int64_t MAX_COVERING_CELLS = 100000;  // covering.py:_MAX_COVERING_CELLS

// ---------------------------------------------------------------------------
// Hilbert traversal tables (public S2 scheme; s2cell.py:32-68)
// ---------------------------------------------------------------------------

int64_t lookup_pos[1 << (2 * LOOKUP_BITS + 2)];
int64_t lookup_ij[1 << (2 * LOOKUP_BITS + 2)];
const int pos_to_ij[4][4] = {
    {0, 1, 3, 2}, {0, 2, 3, 1}, {3, 2, 0, 1}, {3, 1, 0, 2}};
const int pos_to_orientation[4] = {SWAP_MASK, 0, 0, INVERT_MASK | SWAP_MASK};

void init_lookup(int level, int i, int j, int orig_orientation, int pos,
                 int orientation) {
  if (level == LOOKUP_BITS) {
    int ij = (i << LOOKUP_BITS) + j;
    lookup_pos[(ij << 2) + orig_orientation] = (pos << 2) + orientation;
    lookup_ij[(pos << 2) + orig_orientation] = (ij << 2) + orientation;
    return;
  }
  level += 1;
  i <<= 1;
  j <<= 1;
  pos <<= 2;
  const int* r = pos_to_ij[orientation];
  for (int idx = 0; idx < 4; ++idx) {
    init_lookup(level, i + (r[idx] >> 1), j + (r[idx] & 1), orig_orientation,
                pos + idx, orientation ^ pos_to_orientation[idx]);
  }
}

struct InitOnce {
  InitOnce() {
    init_lookup(0, 0, 0, 0, 0, 0);
    init_lookup(0, 0, 0, SWAP_MASK, 0, SWAP_MASK);
    init_lookup(0, 0, 0, INVERT_MASK, 0, INVERT_MASK);
    init_lookup(0, 0, 0, SWAP_MASK | INVERT_MASK, 0,
                SWAP_MASK | INVERT_MASK);
  }
} init_once;

// ---------------------------------------------------------------------------
// Projections (s2cell.py:76-166)
// ---------------------------------------------------------------------------

inline double st_to_uv(double s) {
  return s >= 0.5 ? (1.0 / 3.0) * (4.0 * s * s - 1.0)
                  : (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) * (1.0 - s));
}

inline double uv_to_st(double u) {
  return u >= 0.0 ? 0.5 * std::sqrt(std::max(1.0 + 3.0 * u, 0.0))
                  : 1.0 - 0.5 * std::sqrt(std::max(1.0 - 3.0 * u, 0.0));
}

inline void xyz_to_face_uv(const double* p, int* face, double* u, double* v) {
  const double x = p[0], y = p[1], z = p[2];
  const double ax = std::fabs(x), ay = std::fabs(y), az = std::fabs(z);
  const int axis = ax >= ay ? (ax >= az ? 0 : 2) : (ay >= az ? 1 : 2);
  const double comp = axis == 0 ? x : (axis == 1 ? y : z);
  const int f = comp >= 0 ? axis : axis + 3;
  switch (f) {
    case 0: *u = y / x;  *v = z / x;  break;
    case 1: *u = -x / y; *v = z / y;  break;
    case 2: *u = -x / z; *v = -y / z; break;
    case 3: *u = z / x;  *v = y / x;  break;
    case 4: *u = z / y;  *v = -x / y; break;
    default: *u = -y / z; *v = -x / z; break;
  }
  *face = f;
}

inline void face_uv_to_xyz(int face, double u, double v, double* out) {
  double x, y, z;
  switch (face) {
    case 0: x = 1;  y = u;  z = v;  break;
    case 1: x = -u; y = 1;  z = v;  break;
    case 2: x = -u; y = -v; z = 1;  break;
    case 3: x = -1; y = -v; z = -u; break;
    case 4: x = v;  y = -1; z = -u; break;
    default: x = v; y = u;  z = -1; break;
  }
  const double n = std::sqrt(x * x + y * y + z * z);
  out[0] = x / n;
  out[1] = y / n;
  out[2] = z / n;
}

uint64_t from_face_ij(uint64_t face, uint64_t i, uint64_t j) {
  uint64_t n = face << 60;
  int64_t bits = static_cast<int64_t>(face & SWAP_MASK);
  const uint64_t mask = (1 << LOOKUP_BITS) - 1;
  for (int k = 7; k >= 0; --k) {
    const int64_t ki =
        static_cast<int64_t>((i >> (k * LOOKUP_BITS)) & mask);
    const int64_t kj =
        static_cast<int64_t>((j >> (k * LOOKUP_BITS)) & mask);
    bits = lookup_pos[bits + (ki << (LOOKUP_BITS + 2)) + (kj << 2)];
    n |= (static_cast<uint64_t>(bits) >> 2) << (k * 2 * LOOKUP_BITS);
    bits &= (SWAP_MASK | INVERT_MASK);
  }
  return n * 2 + 1;
}

inline uint64_t cell_parent(uint64_t cid, int level) {
  const uint64_t lsb = 1ULL << (2 * (MAX_LEVEL - level));
  return (cid & (~lsb + 1)) | lsb;
}

// Leaf (face, i, j) of a unit point (cell_id_from_point, s2cell.py:246-257).
inline void point_to_face_ij(const double* p, int* face, int64_t* i,
                             int64_t* j) {
  double u, v;
  xyz_to_face_uv(p, face, &u, &v);
  const double s = uv_to_st(u);
  const double t = uv_to_st(v);
  const int64_t lim = (1LL << MAX_LEVEL) - 1;
  int64_t ii = static_cast<int64_t>(
      std::floor(s * static_cast<double>(1LL << MAX_LEVEL)));
  int64_t jj = static_cast<int64_t>(
      std::floor(t * static_cast<double>(1LL << MAX_LEVEL)));
  *i = std::min(std::max(ii, static_cast<int64_t>(0)), lim);
  *j = std::min(std::max(jj, static_cast<int64_t>(0)), lim);
}

// ---------------------------------------------------------------------------
// Spherical predicates (covering.py:66-161) — same operation order
// ---------------------------------------------------------------------------

inline void cross3(const double* a, const double* b, double* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

inline int sign3(const double* a, const double* b, const double* c) {
  double x[3];
  cross3(a, b, x);
  const double d = dot3(x, c);
  if (d > 0) return 1;
  if (d < 0) return -1;
  return 0;
}

inline bool ordered_ccw(const double* a, const double* b, const double* c,
                        const double* o) {
  int k = 0;
  if (sign3(b, o, a) >= 0) k += 1;
  if (sign3(c, o, b) >= 0) k += 1;
  if (sign3(a, o, c) > 0) k += 1;
  return k >= 2;
}

inline bool same3(const double* p, const double* q) {
  return p[0] == q[0] && p[1] == q[1] && p[2] == q[2];
}

bool edges_cross(const double* a, const double* b, const double* c,
                 const double* d) {
  double n1[3], n2[3], x[3];
  cross3(a, b, n1);
  cross3(c, d, n2);
  cross3(n1, n2, x);
  const double norm = std::sqrt(dot3(x, x));
  if (norm < 1e-30) return false;  // coplanar / degenerate
  x[0] /= norm;
  x[1] /= norm;
  x[2] /= norm;
  const double dab = dot3(a, b);
  const double dcd = dot3(c, d);
  for (int si = 0; si < 2; ++si) {
    const double s = si == 0 ? 1.0 : -1.0;
    const double p[3] = {s * x[0], s * x[1], s * x[2]};
    if (dot3(p, a) > dab && dot3(p, b) > dab && dot3(p, c) > dcd &&
        dot3(p, d) > dcd) {
      return true;
    }
  }
  return false;
}

inline void ortho(const double* p, double* out) {
  const double ap[3] = {std::fabs(p[0]), std::fabs(p[1]), std::fabs(p[2])};
  int k = 0;  // np.argmin: first minimum
  if (ap[1] < ap[k]) k = 1;
  if (ap[2] < ap[k]) k = 2;
  double axis[3] = {0.0, 0.0, 0.0};
  axis[k] = 1.0;
  double o[3];
  cross3(p, axis, o);
  const double n = std::sqrt(dot3(o, o));
  out[0] = o[0] / n;
  out[1] = o[1] / n;
  out[2] = o[2] / n;
}

bool vertex_crossing(const double* a, const double* b, const double* c,
                     const double* d) {
  if (same3(a, b) || same3(c, d)) return false;
  double ob[3];
  if (same3(a, d)) {
    ortho(a, ob);
    return ordered_ccw(ob, c, b, a);
  }
  if (same3(b, c)) {
    ortho(b, ob);
    return ordered_ccw(ob, d, a, b);
  }
  if (same3(a, c)) {
    ortho(a, ob);
    return ordered_ccw(ob, d, b, a);
  }
  if (same3(b, d)) {
    ortho(b, ob);
    return ordered_ccw(ob, c, a, b);
  }
  return false;
}

inline bool edge_or_vertex_crossing(const double* a, const double* b,
                                    const double* c, const double* d) {
  if (same3(a, c) || same3(a, d) || same3(b, c) || same3(b, d)) {
    return vertex_crossing(a, b, c, d);
  }
  return edges_cross(a, b, c, d);
}

// Loop containment via crossing parity from the fixed origin
// (covering.py Loop, :164-217).
struct NativeLoop {
  const double* v;  // (n, 3)
  int n;
  double origin[3];
  bool origin_inside;

  NativeLoop(const double* vertices, int count) : v(vertices), n(count) {
    const double raw[3] = {-0.0099994664, 0.0025924542, 0.9999466};
    const double nn = std::sqrt(dot3(raw, raw));
    origin[0] = raw[0] / nn;
    origin[1] = raw[1] / nn;
    origin[2] = raw[2] / nn;
    if (n >= 3) {
      double o1[3];
      ortho(v + 3, o1);
      const bool v1_inside = ordered_ccw(o1, v + 0, v + 6, v + 3);
      const bool contains_v1 = crossing_parity(v + 3) == 1;
      origin_inside = v1_inside != contains_v1;
    } else {
      origin_inside = false;
    }
  }

  int crossing_parity(const double* p) const {
    int crossings = 0;
    for (int k = 0; k < n; ++k) {
      const double* a = v + 3 * k;
      const double* b = v + 3 * ((k + 1) % n);
      if (edge_or_vertex_crossing(origin, p, a, b)) crossings ^= 1;
    }
    return crossings;
  }

  bool contains(const double* p) const {
    return origin_inside != (crossing_parity(p) == 1);
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// Entry point
// ---------------------------------------------------------------------------

extern "C" {

// Level-13 covering of the loop via the single-face rect fast path.
//   v_xyz:    n x 3 unit vertices (float64, row-major)
//   area_ok:  1 if loop_area_km2(loop) <= MAX_AREA_KM2 (computed by the
//             caller in Python — keeps the transcendental area formula
//             out of the parity surface)
//   out:      uint64 buffer with capacity out_cap
// Returns: >= 0 cell count (sorted ascending); -2 covering exceeds
// MAX_COVERING_CELLS (AreaTooLarge); -3 caller must take the Python
// BFS fallback (multi-face / face-edge margin / oversized rect /
// area gate failed).
int64_t dss_loop_covering(const double* v_xyz, int32_t n, int32_t area_ok,
                          uint64_t* out, int64_t out_cap) {
  if (n < 1) return -3;

  // vertex leaf ij + level-13 cells (covering.py:503-533)
  std::vector<int64_t> vi(n), vj(n);
  std::vector<uint64_t> vertex_cells(n);
  int face0 = -1;
  const int64_t step = 1LL << (MAX_LEVEL - DAR_LEVEL);
  for (int k = 0; k < n; ++k) {
    int f;
    point_to_face_ij(v_xyz + 3 * k, &f, &vi[k], &vj[k]);
    if (k == 0) {
      face0 = f;
    } else if (f != face0) {
      return -3;  // multi-face: BFS fallback
    }
    vertex_cells[k] =
        cell_parent(from_face_ij(f, vi[k], vj[k]), DAR_LEVEL);
  }
  if (!area_ok) return -3;

  // ij bounding rect at level-13 granularity, +1-cell margin
  const int64_t lim = 1LL << MAX_LEVEL;
  int64_t imin_c = vi[0] & ~(step - 1), imax_c = imin_c;
  int64_t jmin_c = vj[0] & ~(step - 1), jmax_c = jmin_c;
  for (int k = 1; k < n; ++k) {
    const int64_t il = vi[k] & ~(step - 1);
    const int64_t jl = vj[k] & ~(step - 1);
    imin_c = std::min(imin_c, il);
    imax_c = std::max(imax_c, il);
    jmin_c = std::min(jmin_c, jl);
    jmax_c = std::max(jmax_c, jl);
  }
  const int64_t imin = std::max(imin_c - step, static_cast<int64_t>(0));
  const int64_t imax = std::min(imax_c + step, lim - step);
  const int64_t jmin = std::max(jmin_c - step, static_cast<int64_t>(0));
  const int64_t jmax = std::min(jmax_c + step, lim - step);
  const int64_t ni = (imax - imin) / step + 1;
  const int64_t nj = (jmax - jmin) / step + 1;
  if (!(ni * nj <= RECT_MAX_CELLS && imin > 0 && jmin > 0 &&
        imax < lim - step && jmax < lim - step)) {
    return -3;  // face-edge / oversized rect: BFS fallback
  }

  NativeLoop loop(v_xyz, n);

  // loop-vertex (face, u, v) once (predicate (c), covering.py:383-392)
  std::vector<int> pf(n);
  std::vector<double> pu(n), pv(n);
  for (int k = 0; k < n; ++k) {
    xyz_to_face_uv(v_xyz + 3 * k, &pf[k], &pu[k], &pv[k]);
  }

  const double scale = 1.0 / static_cast<double>(1LL << MAX_LEVEL);
  std::vector<uint64_t> hits;
  for (int64_t ii = imin; ii <= imax; ii += step) {
    const double u_lo = st_to_uv(static_cast<double>(ii) * scale);
    const double u_hi = st_to_uv(static_cast<double>(ii + step) * scale);
    for (int64_t jj = jmin; jj <= jmax; jj += step) {
      const uint64_t cid = cell_parent(
          from_face_ij(face0, ii + step / 2, jj + step / 2), DAR_LEVEL);
      const double v_lo = st_to_uv(static_cast<double>(jj) * scale);
      const double v_hi = st_to_uv(static_cast<double>(jj + step) * scale);

      // corners in CCW order (s2cell.py:290-296)
      double corners[4][3];
      const double us[4] = {u_lo, u_hi, u_hi, u_lo};
      const double vs[4] = {v_lo, v_lo, v_hi, v_hi};
      for (int c = 0; c < 4; ++c) {
        face_uv_to_xyz(face0, us[c], vs[c], corners[c]);
      }

      bool hit = false;
      // (a) any corner inside the loop
      for (int c = 0; c < 4 && !hit; ++c) {
        if (loop.contains(corners[c])) hit = true;
      }
      // (b) cell is a loop-vertex cell
      if (!hit) {
        for (int k = 0; k < n; ++k) {
          if (vertex_cells[k] == cid) {
            hit = true;
            break;
          }
        }
      }
      // (c) a loop vertex projects inside the cell's face-uv rect
      if (!hit) {
        for (int k = 0; k < n; ++k) {
          if (pf[k] == face0 && u_lo <= pu[k] && pu[k] <= u_hi &&
              v_lo <= pv[k] && pv[k] <= v_hi) {
            hit = true;
            break;
          }
        }
      }
      // (d) any loop edge crosses any cell edge
      if (!hit) {
        for (int c = 0; c < 4 && !hit; ++c) {
          const double* ca = corners[c];
          const double* cb = corners[(c + 1) % 4];
          for (int k = 0; k < n; ++k) {
            const double* ea = v_xyz + 3 * k;
            const double* eb = v_xyz + 3 * ((k + 1) % n);
            if (edges_cross(ca, cb, ea, eb)) {
              hit = true;
              break;
            }
          }
        }
      }
      if (hit) hits.push_back(cid);
    }
  }

  std::sort(hits.begin(), hits.end());
  const int64_t count = static_cast<int64_t>(hits.size());
  if (count > MAX_COVERING_CELLS) return -2;
  if (count > out_cap) return -3;  // caller buffer too small (shouldn't happen)
  std::copy(hits.begin(), hits.end(), out);
  return count;
}

// Full covering_from_loop_points fast path (covering.py:596-613):
// signed-area + winding-retry + area-gate + rect covering in one call.
// Vertices arrive as unit xyz (Python computes latlng->xyz so numpy's
// SIMD trig stays the parity reference for vertex positions).
//
//   area_out: loop_area_km2 of the (possibly reversed) loop — the
//             reference's quirk formula (area_sr * 510072000) / 4 * pi
// Returns: >= 0 cell count; -1 degenerate (area <= 0: caller takes the
// polyline path); -2 AreaTooLarge (either the area gate after the
// winding retry, or the covering cell cap); -3 caller must run the
// full Python path (multi-face / face-edge / oversized rect / buffer).
int64_t dss_points_covering(const double* v_xyz_in, int32_t n,
                            double max_area_km2, double* area_out,
                            uint64_t* out, int64_t out_cap) {
  if (n < 1) return -3;
  // signed spherical area via the vertex-0 triangle fan
  // (covering.py Loop.signed_area:219-230; same op order)
  std::vector<double> v(v_xyz_in, v_xyz_in + 3 * n);
  auto signed_area = [&](const double* vv) {
    if (n < 3) return 0.0;
    double total = 0.0;
    const double* v0 = vv;
    for (int k = 1; k < n - 1; ++k) {
      const double* b = vv + 3 * k;
      const double* c = vv + 3 * (k + 1);
      double x[3];
      cross3(v0, b, x);
      const double triple = dot3(x, c);
      const double denom =
          1.0 + dot3(v0, b) + dot3(b, c) + dot3(c, v0);
      total += 2.0 * std::atan2(triple, denom);
    }
    return total;
  };
  constexpr double EARTH_AREA_KM2 = 510072000.0;
  const double MAX_AREA_KM2 = max_area_km2;  // single source: covering.py
  const double PI = 3.14159265358979323846;
  auto area_km2 = [&](const double* vv) {
    double s = signed_area(vv);
    const double interior = s >= 0 ? s : 4.0 * PI + s;
    return (interior * EARTH_AREA_KM2) / 4.0 * PI;
  };
  double a = area_km2(v.data());
  if (a > MAX_AREA_KM2) {
    // winding retry: reverse vertex order (covering.py:602-605)
    std::vector<double> rev(3 * n);
    for (int k = 0; k < n; ++k) {
      rev[3 * k] = v[3 * (n - 1 - k)];
      rev[3 * k + 1] = v[3 * (n - 1 - k) + 1];
      rev[3 * k + 2] = v[3 * (n - 1 - k) + 2];
    }
    v.swap(rev);
    a = area_km2(v.data());
  }
  *area_out = a;
  if (a > MAX_AREA_KM2) return -2;
  if (a <= 0) return -1;  // degenerate: polyline fallback
  return dss_loop_covering(v.data(), n, 1, out, out_cap);
}

}  // extern "C"
