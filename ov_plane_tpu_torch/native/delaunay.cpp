// Incremental 2D Delaunay triangulation (Bowyer-Watson) with a C API and
// EXACT geometric predicates.
//
// Native equivalent of the role the vendored CDT library plays in the
// reference (thirdparty/cdt, used at TrackPlane.cpp:715-726 on ~250 feature
// points per frame and for plane re-meshing, ROS1Visualizer.cpp:1264-1275).
// The reference vendors Shewchuk's robust predicates
// (thirdparty/cdt/predicates.h:907); this file provides the same guarantee
// with a from-scratch design:
//
//   * Stage A: straightforward double evaluation with a forward error bound
//     (the standard static filter, bounds from Shewchuk's analysis:
//     (3+16eps)eps for orient2d, (10+96eps)eps for incircle). When the
//     magnitude clears the bound, the sign is certain.
//   * Exact fallback: every product is split into an exact (hi, lo) pair via
//     fused-multiply-add (fma(a,b,-a*b) is the exact residual), and the
//     resulting scalars are accumulated into a nonoverlapping floating-point
//     expansion by chained two-sums (grow-expansion with zero elimination).
//     The sign of the expansion is the sign of its largest (last) component.
//     No splitter tricks needed; std::fma is correctly rounded by IEEE-754.
//
// The exact path is what makes the degenerate input class of THIS pipeline
// safe: detection grids produce integer-pixel, collinear, and cocircular
// configurations where plain double predicates misclassify and the cavity
// search corrupts the triangulation. Exact duplicates are skipped up front
// (re-inserting an existing vertex would silently shadow it).
//
// API (ctypes-friendly):
//   int delaunay_triangulate(const double* xy, int n,
//                            int* tri_out, int max_tris);
// Returns the number of triangles written (3 ints each, CCW), or -1 on error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kEps = 1.1102230246251565e-16;  // 2^-53
constexpr double kCcwErrA = (3.0 + 16.0 * kEps) * kEps;
constexpr double kIccErrA = (10.0 + 96.0 * kEps) * kEps;

// x + y == a + b exactly, |y| <= ulp(x)/2 (Knuth two-sum; no magnitude order).
inline void two_sum(double a, double b, double& x, double& y) {
  x = a + b;
  const double bv = x - a;
  const double av = x - bv;
  y = (a - av) + (b - bv);
}

// Nonoverlapping expansion accumulator: add() folds one scalar in with a
// chain of two-sums, keeping components in increasing magnitude order and
// dropping zeros. sign() reads the dominant (last) component.
struct Expansion {
  static constexpr int kCap = 512;
  double c[kCap];
  int n = 0;

  void add(double b) {
    double q = b;
    int j = 0;
    for (int i = 0; i < n; i++) {
      double x, y;
      two_sum(q, c[i], x, y);
      if (y != 0.0) c[j++] = y;
      q = x;
    }
    n = j;
    if (q != 0.0 || n == 0) c[n++] = q;
  }

  // Exact product a*b folded in as hi + lo.
  void add_product(double a, double b) {
    const double hi = a * b;
    const double lo = std::fma(a, b, -hi);
    add(lo);
    add(hi);
  }

  double head() const { return n ? c[n - 1] : 0.0; }
};

// Exact sign of (ax*by - ay*bx) + (ay*cx - ax*cy) + (bx*cy - by*cx), the 2D
// orientation determinant on ORIGINAL coordinates (no translation error).
double orient2d_exact(const double* a, const double* b, const double* c) {
  Expansion e;
  e.add_product(a[0], b[1]);
  e.add_product(-a[1], b[0]);
  e.add_product(a[1], c[0]);
  e.add_product(-a[0], c[1]);
  e.add_product(b[0], c[1]);
  e.add_product(-b[1], c[0]);
  return e.head();
}

// > 0 if c is strictly left of directed line a->b (CCW triangle a,b,c).
double orient2d(const double* a, const double* b, const double* c) {
  const double detl = (b[0] - a[0]) * (c[1] - a[1]);
  const double detr = (b[1] - a[1]) * (c[0] - a[0]);
  const double det = detl - detr;
  const double detsum = std::fabs(detl) + std::fabs(detr);
  if (std::fabs(det) >= kCcwErrA * detsum) return det;
  return orient2d_exact(a, b, c);
}

// pair(p, q) = px*qy - qx*py contributed into `e` with overall sign `s`,
// distributed against the exact components (lh, ll) of a lift term. Used by
// incircle_exact: lift * pair = sum over exact-product components.
inline void lift_times_pair(Expansion& e, double s, double lh, double ll,
                            const double* p, const double* q) {
  // (lh + ll) * (px*qy - qx*py), all products exact via fma splitting.
  const double t1h = p[0] * q[1];
  const double t1l = std::fma(p[0], q[1], -t1h);
  const double t2h = q[0] * p[1];
  const double t2l = std::fma(q[0], p[1], -t2h);
  const double comps[4] = {t1h, t1l, -t2h, -t2l};
  const double lifts[2] = {lh, ll};
  for (double lc : lifts) {
    if (lc == 0.0) continue;
    for (double pc : comps) e.add_product(s * lc, pc);
  }
}

// Exact 4x4 incircle determinant on ORIGINAL coordinates:
//   det = -|bcd| + |acd| - |abd| + |abc|,  |qrs| = lq*pair(r,s) -
//   lr*pair(q,s) + ls*pair(q,r),  l = x^2 + y^2 (kept as exact pieces).
double incircle_exact(const double* a, const double* b, const double* c,
                      const double* d) {
  // Exact lift components per point: x*x and y*y each split hi/lo; folding
  // them separately keeps every term a plain product of two doubles.
  double lh[4][4];  // per point: xx_hi, xx_lo, yy_hi, yy_lo
  const double* pts[4] = {a, b, c, d};
  for (int i = 0; i < 4; i++) {
    const double xh = pts[i][0] * pts[i][0];
    const double xl = std::fma(pts[i][0], pts[i][0], -xh);
    const double yh = pts[i][1] * pts[i][1];
    const double yl = std::fma(pts[i][1], pts[i][1], -yh);
    lh[i][0] = xh; lh[i][1] = xl; lh[i][2] = yh; lh[i][3] = yl;
  }
  Expansion e;
  // minor(sign, q, r, s): sign * (lq*pair(r,s) - lr*pair(q,s) + ls*pair(q,r))
  auto minor = [&](double sign, int q, int r, int s) {
    for (int piece = 0; piece < 2; piece++) {
      lift_times_pair(e, sign, lh[q][2 * piece], lh[q][2 * piece + 1], pts[r], pts[s]);
      lift_times_pair(e, -sign, lh[r][2 * piece], lh[r][2 * piece + 1], pts[q], pts[s]);
      lift_times_pair(e, sign, lh[s][2 * piece], lh[s][2 * piece + 1], pts[q], pts[r]);
    }
  };
  minor(-1.0, 1, 2, 3);  // -|bcd|
  minor(+1.0, 0, 2, 3);  // +|acd|
  minor(-1.0, 0, 1, 3);  // -|abd|
  minor(+1.0, 0, 1, 2);  // +|abc|
  return e.head();
}

// > 0 if d strictly inside circumcircle of CCW (a, b, c).
double incircle(const double* a, const double* b, const double* c,
                const double* d) {
  const double adx = a[0] - d[0], ady = a[1] - d[1];
  const double bdx = b[0] - d[0], bdy = b[1] - d[1];
  const double cdx = c[0] - d[0], cdy = c[1] - d[1];
  const double ad2 = adx * adx + ady * ady;
  const double bd2 = bdx * bdx + bdy * bdy;
  const double cd2 = cdx * cdx + cdy * cdy;
  const double bxcy = bdx * cdy, cxby = cdx * bdy;
  const double cxay = cdx * ady, axcy = adx * cdy;
  const double axby = adx * bdy, bxay = bdx * ady;
  const double det =
      ad2 * (bxcy - cxby) + bd2 * (cxay - axcy) + cd2 * (axby - bxay);
  const double permanent = ad2 * (std::fabs(bxcy) + std::fabs(cxby)) +
                           bd2 * (std::fabs(cxay) + std::fabs(axcy)) +
                           cd2 * (std::fabs(axby) + std::fabs(bxay));
  if (std::fabs(det) >= kIccErrA * permanent) return det;
  return incircle_exact(a, b, c, d);
}

struct Tri {
  int v[3];  // vertex indices (super-triangle uses n, n+1, n+2)
  bool alive;
};

}  // namespace

extern "C" int delaunay_triangulate(const double* xy, int n, int* tri_out,
                                    int max_tris) {
  if (n < 3 || xy == nullptr || tri_out == nullptr) return -1;

  // Bounding super-triangle.
  double minx = xy[0], maxx = xy[0], miny = xy[1], maxy = xy[1];
  for (int i = 1; i < n; i++) {
    minx = std::fmin(minx, xy[2 * i]);
    maxx = std::fmax(maxx, xy[2 * i]);
    miny = std::fmin(miny, xy[2 * i + 1]);
    maxy = std::fmax(maxy, xy[2 * i + 1]);
  }
  const double dx = maxx - minx, dy = maxy - miny;
  const double dmax = std::fmax(dx, dy) + 1.0;
  const double cx = 0.5 * (minx + maxx), cy = 0.5 * (miny + maxy);

  std::vector<double> pts(2 * (n + 3));
  std::memcpy(pts.data(), xy, sizeof(double) * 2 * n);
  pts[2 * n + 0] = cx - 20.0 * dmax;
  pts[2 * n + 1] = cy - dmax;
  pts[2 * n + 2] = cx + 20.0 * dmax;
  pts[2 * n + 3] = cy - dmax;
  pts[2 * n + 4] = cx;
  pts[2 * n + 5] = cy + 20.0 * dmax;

  // Exact-duplicate skip map (integer-pixel grids repeat coordinates; a
  // duplicate insertion would shadow the original vertex).
  struct Key {
    uint64_t x, y;
    bool operator==(const Key& o) const { return x == o.x && y == o.y; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return std::hash<uint64_t>()(k.x * 0x9e3779b97f4a7c15ULL ^ k.y);
    }
  };
  std::unordered_map<Key, int, KeyHash> seen;
  seen.reserve(2 * n);
  auto key_of = [&](int i) {
    Key k;
    std::memcpy(&k.x, &pts[2 * i], 8);
    std::memcpy(&k.y, &pts[2 * i + 1], 8);
    return k;
  };

  std::vector<Tri> tris;
  tris.reserve(4 * n);
  tris.push_back({{n, n + 1, n + 2}, true});

  struct Edge {
    int a, b;
  };
  std::vector<Edge> boundary;

  for (int ip = 0; ip < n; ip++) {
    if (!std::isfinite(pts[2 * ip]) || !std::isfinite(pts[2 * ip + 1])) continue;
    if (!seen.emplace(key_of(ip), ip).second) continue;  // exact duplicate
    const double* p = &pts[2 * ip];
    boundary.clear();

    // Find all triangles whose circumcircle strictly contains p; collect the
    // boundary of the cavity (edges that appear exactly once). With exact
    // predicates the cavity is star-shaped around p and every boundary edge
    // is strictly visible, so the fan below is always valid.
    std::vector<int> bad;
    for (size_t t = 0; t < tris.size(); t++) {
      if (!tris[t].alive) continue;
      const double* a = &pts[2 * tris[t].v[0]];
      const double* b = &pts[2 * tris[t].v[1]];
      const double* c = &pts[2 * tris[t].v[2]];
      // Triangles are kept CCW; incircle sign then means "inside".
      if (incircle(a, b, c, p) > 0.0) bad.push_back((int)t);
    }
    if (bad.empty()) {
      // Cannot happen for a non-duplicate point inside the super-triangle
      // under exact predicates; guard anyway.
      continue;
    }
    // Collect cavity edges.
    std::vector<Edge> edges;
    for (int t : bad) {
      for (int e = 0; e < 3; e++) {
        edges.push_back({tris[t].v[e], tris[t].v[(e + 1) % 3]});
      }
      tris[t].alive = false;
    }
    // Boundary = edges appearing once (compare undirected).
    for (size_t i = 0; i < edges.size(); i++) {
      bool shared = false;
      for (size_t j = 0; j < edges.size(); j++) {
        if (i == j) continue;
        if ((edges[i].a == edges[j].b && edges[i].b == edges[j].a) ||
            (edges[i].a == edges[j].a && edges[i].b == edges[j].b)) {
          shared = true;
          break;
        }
      }
      if (!shared) boundary.push_back(edges[i]);
    }
    // Retriangulate the cavity fan (exact CCW enforcement).
    for (const Edge& e : boundary) {
      Tri t{{e.a, e.b, ip}, true};
      if (orient2d(&pts[2 * t.v[0]], &pts[2 * t.v[1]], &pts[2 * t.v[2]]) < 0.0) {
        std::swap(t.v[0], t.v[1]);
      }
      tris.push_back(t);
    }
  }

  // Emit triangles not touching the super-triangle.
  int count = 0;
  for (const Tri& t : tris) {
    if (!t.alive) continue;
    if (t.v[0] >= n || t.v[1] >= n || t.v[2] >= n) continue;
    if (count >= max_tris) return -2;
    tri_out[3 * count + 0] = t.v[0];
    tri_out[3 * count + 1] = t.v[1];
    tri_out[3 * count + 2] = t.v[2];
    count++;
  }
  return count;
}

// Exposed for tests: exact-sign predicates on raw coordinate pairs.
extern "C" double delaunay_orient2d(const double* a, const double* b,
                                    const double* c) {
  return orient2d(a, b, c);
}
extern "C" double delaunay_incircle(const double* a, const double* b,
                                    const double* c, const double* d) {
  return incircle(a, b, c, d);
}
