// Native measurement kernels of deepemia_tpu_torch (C ABI, ctypes-loaded;
// a copy of the JAX package's native/measure.cpp).
//
// Host-side exact morphometrics replacing the OpenCV C++ dependency of the
// reference measurement stack (measurements.py:114-233): outer-border
// tracing (Moore neighborhood, 8-connectivity — cv2.findContours
// RETR_EXTERNAL semantics), polygon area (shoelace = cv2.contourArea),
// closed perimeter (cv2.arcLength), minimum-area rectangle (convex hull +
// rotating calipers = cv2.minAreaRect), and direct least-squares ellipse
// fitting (Fitzgibbon/B2AC, the cv2.fitEllipse family).
//
// Built on first use by deepemia_tpu_torch/native/__init__.py:
// g++ -O2 -shared -fPIC measure.cpp -o build/torch_native/libmeasure-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// Outer contour tracing (Moore neighborhood / radial sweep, 8-connectivity).
// Traces the border of the component containing the first foreground pixel
// in raster order. Writes (x, y) pairs; returns point count (0 if empty,
// capped at max_pts).
// --------------------------------------------------------------------------
int trace_outer_contour(const uint8_t* mask, int h, int w, int32_t* out_xy,
                        int max_pts) {
  auto at = [&](int y, int x) -> int {
    return (y >= 0 && y < h && x >= 0 && x < w) ? mask[y * w + x] != 0 : 0;
  };
  int sy = -1, sx = -1;
  for (int y = 0; y < h && sy < 0; ++y)
    for (int x = 0; x < w; ++x)
      if (mask[y * w + x]) { sy = y; sx = x; break; }
  if (sy < 0) return 0;

  // 8-neighborhood in clockwise order starting from west
  const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  const int dx[8] = {-1, -1, 0, 1, 1, 1, 0, -1};

  int cy = sy, cx = sx;
  int backtrack = 0;  // came from the west (scan direction guarantees empty)
  int n = 0;
  const int limit = 4 * (h * w + 1);
  int steps = 0;
  do {
    if (n < max_pts) { out_xy[2 * n] = cx; out_xy[2 * n + 1] = cy; }
    ++n;
    int found = -1;
    for (int k = 0; k < 8; ++k) {
      int dir = (backtrack + 1 + k) % 8;
      int ny = cy + dy[dir], nx = cx + dx[dir];
      if (at(ny, nx)) { found = dir; break; }
    }
    if (found < 0) break;  // isolated pixel
    cy += dy[found];
    cx += dx[found];
    backtrack = (found + 4) % 8;
    if (++steps > limit) break;  // safety
  } while (!(cy == sy && cx == sx) || n < 2);
  return n < max_pts ? n : max_pts;
}

// --------------------------------------------------------------------------
// Polygon measurements from contour points (float64 x,y pairs).
// out[0]=area  out[1]=perimeter
// --------------------------------------------------------------------------
void polygon_area_perimeter(const double* pts, int n, double* out) {
  double area2 = 0.0, per = 0.0;
  for (int i = 0; i < n; ++i) {
    int j = (i + 1) % n;
    double x0 = pts[2 * i], y0 = pts[2 * i + 1];
    double x1 = pts[2 * j], y1 = pts[2 * j + 1];
    area2 += x0 * y1 - x1 * y0;
    per += std::hypot(x1 - x0, y1 - y0);
  }
  out[0] = std::fabs(area2) * 0.5;
  out[1] = per;
}

// --------------------------------------------------------------------------
// Convex hull (Andrew monotone chain) + rotating calipers min-area rect.
// out[0]=rect_w  out[1]=rect_h  (side lengths; order arbitrary)
// --------------------------------------------------------------------------
static double cross3(const double* o, const double* a, const double* b) {
  return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]);
}

void min_area_rect(const double* pts_in, int n, double* out) {
  out[0] = out[1] = 0.0;
  if (n < 1) return;
  if (n == 1) return;
  std::vector<std::pair<double, double>> p(n);
  for (int i = 0; i < n; ++i) p[i] = {pts_in[2 * i], pts_in[2 * i + 1]};
  std::sort(p.begin(), p.end());
  p.erase(std::unique(p.begin(), p.end()), p.end());
  int m = (int)p.size();
  std::vector<double> flat(2 * m);
  for (int i = 0; i < m; ++i) { flat[2 * i] = p[i].first; flat[2 * i + 1] = p[i].second; }
  if (m <= 2) {
    out[0] = m == 2 ? std::hypot(flat[2] - flat[0], flat[3] - flat[1]) : 0.0;
    out[1] = 0.0;
    return;
  }
  // build hull
  std::vector<int> hull;
  {
    std::vector<int> lower, upper;
    for (int i = 0; i < m; ++i) {
      while (lower.size() >= 2 &&
             cross3(&flat[2 * lower[lower.size() - 2]],
                    &flat[2 * lower.back()], &flat[2 * i]) <= 0)
        lower.pop_back();
      lower.push_back(i);
    }
    for (int i = m - 1; i >= 0; --i) {
      while (upper.size() >= 2 &&
             cross3(&flat[2 * upper[upper.size() - 2]],
                    &flat[2 * upper.back()], &flat[2 * i]) <= 0)
        upper.pop_back();
      upper.push_back(i);
    }
    lower.pop_back();
    upper.pop_back();
    hull = lower;
    hull.insert(hull.end(), upper.begin(), upper.end());
  }
  int hn = (int)hull.size();
  if (hn < 3) {
    // collinear: extent along the line
    double maxd = 0.0;
    for (int i = 0; i < m; ++i)
      for (int j = i + 1; j < m; ++j)
        maxd = std::max(maxd, std::hypot(flat[2 * i] - flat[2 * j],
                                         flat[2 * i + 1] - flat[2 * j + 1]));
    out[0] = maxd; out[1] = 0.0;
    return;
  }
  double best_area = 1e300, best_w = 0, best_h = 0;
  for (int e = 0; e < hn; ++e) {
    int e2 = (e + 1) % hn;
    double ex = flat[2 * hull[e2]] - flat[2 * hull[e]];
    double ey = flat[2 * hull[e2] + 1] - flat[2 * hull[e] + 1];
    double len = std::hypot(ex, ey);
    if (len < 1e-12) continue;
    double ux = ex / len, uy = ey / len;   // edge direction
    double vx = -uy, vy = ux;              // normal
    double min_u = 1e300, max_u = -1e300, min_v = 1e300, max_v = -1e300;
    for (int k = 0; k < hn; ++k) {
      double px = flat[2 * hull[k]], py = flat[2 * hull[k] + 1];
      double pu = px * ux + py * uy;
      double pv = px * vx + py * vy;
      min_u = std::min(min_u, pu); max_u = std::max(max_u, pu);
      min_v = std::min(min_v, pv); max_v = std::max(max_v, pv);
    }
    double cw = max_u - min_u, ch = max_v - min_v;
    double area = cw * ch;
    if (area < best_area) { best_area = area; best_w = cw; best_h = ch; }
  }
  out[0] = best_w;
  out[1] = best_h;
}

// --------------------------------------------------------------------------
// Direct least-squares ellipse fit (Fitzgibbon/Halir-Flusser numerically
// stable variant). out[0]=major_axis (full length) out[1]=minor_axis
// out[2]=eccentricity out[3]=center_x out[4]=center_y out[5]=angle_deg
// Returns 0 on success, nonzero on degenerate input.
// --------------------------------------------------------------------------
int fit_ellipse(const double* pts, int n, double* out) {
  std::memset(out, 0, 6 * sizeof(double));
  if (n < 5) return 1;
  // center the data for conditioning
  double mx = 0, my = 0;
  for (int i = 0; i < n; ++i) { mx += pts[2 * i]; my += pts[2 * i + 1]; }
  mx /= n; my /= n;

  // scatter matrices: D1 = [x^2, xy, y^2], D2 = [x, y, 1]
  double S1[3][3] = {{0}}, S2[3][3] = {{0}}, S3[3][3] = {{0}};
  for (int i = 0; i < n; ++i) {
    double x = pts[2 * i] - mx, y = pts[2 * i + 1] - my;
    double d1[3] = {x * x, x * y, y * y};
    double d2[3] = {x, y, 1.0};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        S1[r][c] += d1[r] * d1[c];
        S2[r][c] += d1[r] * d2[c];
        S3[r][c] += d2[r] * d2[c];
      }
  }
  // T = -S3^-1 * S2^T ; M = C1^-1 (S1 + S2 T)
  // invert S3 (3x3)
  double det3 =
      S3[0][0] * (S3[1][1] * S3[2][2] - S3[1][2] * S3[2][1]) -
      S3[0][1] * (S3[1][0] * S3[2][2] - S3[1][2] * S3[2][0]) +
      S3[0][2] * (S3[1][0] * S3[2][1] - S3[1][1] * S3[2][0]);
  if (std::fabs(det3) < 1e-12) return 2;
  double inv3[3][3];
  inv3[0][0] = (S3[1][1] * S3[2][2] - S3[1][2] * S3[2][1]) / det3;
  inv3[0][1] = (S3[0][2] * S3[2][1] - S3[0][1] * S3[2][2]) / det3;
  inv3[0][2] = (S3[0][1] * S3[1][2] - S3[0][2] * S3[1][1]) / det3;
  inv3[1][0] = (S3[1][2] * S3[2][0] - S3[1][0] * S3[2][2]) / det3;
  inv3[1][1] = (S3[0][0] * S3[2][2] - S3[0][2] * S3[2][0]) / det3;
  inv3[1][2] = (S3[0][2] * S3[1][0] - S3[0][0] * S3[1][2]) / det3;
  inv3[2][0] = (S3[1][0] * S3[2][1] - S3[1][1] * S3[2][0]) / det3;
  inv3[2][1] = (S3[0][1] * S3[2][0] - S3[0][0] * S3[2][1]) / det3;
  inv3[2][2] = (S3[0][0] * S3[1][1] - S3[0][1] * S3[1][0]) / det3;

  double T[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      T[r][c] = 0;
      for (int k = 0; k < 3; ++k) T[r][c] -= inv3[r][k] * S2[c][k];
    }
  double M0[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      M0[r][c] = S1[r][c];
      for (int k = 0; k < 3; ++k) M0[r][c] += S2[r][k] * T[k][c];
    }
  // M = C1^-1 * M0 with C1 = [[0,0,2],[0,-1,0],[2,0,0]]
  double M[3][3];
  for (int c = 0; c < 3; ++c) {
    M[0][c] = M0[2][c] / 2.0;
    M[1][c] = -M0[1][c];
    M[2][c] = M0[0][c] / 2.0;
  }
  // eigenvectors of 3x3 M: solve characteristic cubic via iteration-free
  // approach — power iteration with deflation is overkill; use the cubic.
  // char poly: det(M - l I) = -l^3 + tr l^2 - ... ; find real roots.
  double tr = M[0][0] + M[1][1] + M[2][2];
  double m00 = M[1][1] * M[2][2] - M[1][2] * M[2][1];
  double m11 = M[0][0] * M[2][2] - M[0][2] * M[2][0];
  double m22 = M[0][0] * M[1][1] - M[0][1] * M[1][0];
  double c1 = m00 + m11 + m22;
  double detM =
      M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1]) -
      M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0]) +
      M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
  // l^3 - tr l^2 + c1 l - detM = 0 ; Newton from several starts
  double roots[3];
  int nroots = 0;
  for (int s = 0; s < 7 && nroots < 3; ++s) {
    double l = (s - 3) * std::max(1.0, std::fabs(tr));
    for (int it = 0; it < 100; ++it) {
      double f = ((l - tr) * l + c1) * l - detM;
      double fp = (3 * l - 2 * tr) * l + c1;
      if (std::fabs(fp) < 1e-14) break;
      double step = f / fp;
      l -= step;
      if (std::fabs(step) < 1e-12 * std::max(1.0, std::fabs(l))) break;
    }
    bool dup = false;
    for (int k = 0; k < nroots; ++k)
      if (std::fabs(roots[k] - l) < 1e-6 * std::max(1.0, std::fabs(l))) dup = true;
    double f = ((l - tr) * l + c1) * l - detM;
    if (!dup && std::fabs(f) < 1e-4 * std::max(1.0, std::fabs(detM)))
      roots[nroots++] = l;
  }
  if (nroots == 0) return 3;
  // pick the eigenvector with a1 = [a,b,c] satisfying 4ac - b^2 > 0
  double best[3] = {0, 0, 0};
  bool ok = false;
  for (int k = 0; k < nroots && !ok; ++k) {
    // solve (M - l I) v = 0 via cross products of two rows
    double A[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) A[r][c] = M[r][c] - (r == c ? roots[k] : 0.0);
    double v[3][3] = {
        {A[0][1] * A[1][2] - A[0][2] * A[1][1],
         A[0][2] * A[1][0] - A[0][0] * A[1][2],
         A[0][0] * A[1][1] - A[0][1] * A[1][0]},
        {A[0][1] * A[2][2] - A[0][2] * A[2][1],
         A[0][2] * A[2][0] - A[0][0] * A[2][2],
         A[0][0] * A[2][1] - A[0][1] * A[2][0]},
        {A[1][1] * A[2][2] - A[1][2] * A[2][1],
         A[1][2] * A[2][0] - A[1][0] * A[2][2],
         A[1][0] * A[2][1] - A[1][1] * A[2][0]}};
    // choose the largest-norm candidate
    int bi = 0;
    double bn = -1;
    for (int r = 0; r < 3; ++r) {
      double nn = v[r][0] * v[r][0] + v[r][1] * v[r][1] + v[r][2] * v[r][2];
      if (nn > bn) { bn = nn; bi = r; }
    }
    if (bn < 1e-20) continue;
    double a = v[bi][0], b = v[bi][1], c = v[bi][2];
    if (4 * a * c - b * b > 0) {
      best[0] = a; best[1] = b; best[2] = c;
      ok = true;
    }
  }
  if (!ok) return 4;
  double a = best[0], b = best[1], c = best[2];
  // a2 = T * a1
  double d = T[0][0] * a + T[0][1] * b + T[0][2] * c;
  double e = T[1][0] * a + T[1][1] * b + T[1][2] * c;
  double f = T[2][0] * a + T[2][1] * b + T[2][2] * c;
  // conic: a x^2 + b xy + c y^2 + d x + e y + f = 0 (centered coords)
  double den = 4 * a * c - b * b;
  double cx = (b * e - 2 * c * d) / den;
  double cy = (b * d - 2 * a * e) / den;
  double num = 2 * (a * e * e + c * d * d + f * b * b - b * d * e - 4 * a * c * f) / 2.0;
  // axis lengths from eigenvalues of [[a, b/2],[b/2, c]]
  double tr2 = a + c;
  double det2 = a * c - b * b / 4.0;
  double disc = std::sqrt(std::max(tr2 * tr2 / 4.0 - det2, 0.0));
  double l1 = tr2 / 2.0 + disc;  // larger eigenvalue -> minor axis
  double l2 = tr2 / 2.0 - disc;
  double fc = a * cx * cx + b * cx * cy + c * cy * cy - f * 0 +
              d * cx + e * cy + f;
  // value of conic at center gives the scaling: axis_i = sqrt(-fc / l_i)
  if (l1 <= 0 || l2 <= 0) {
    // sign convention flip
    l1 = -l1; l2 = -l2; fc = -fc;
  }
  if (l1 <= 0 || l2 <= 0 || fc >= 0) return 5;
  double semi1 = std::sqrt(-fc / l1);
  double semi2 = std::sqrt(-fc / l2);
  double semi_major = std::max(semi1, semi2);
  double semi_minor = std::min(semi1, semi2);
  out[0] = 2 * semi_major;
  out[1] = 2 * semi_minor;
  out[2] = std::sqrt(1.0 - (semi_minor * semi_minor) /
                               (semi_major * semi_major));
  out[3] = cx + mx;
  out[4] = cy + my;
  double angle = 0.5 * std::atan2(b, a - c);
  out[5] = angle * 180.0 / M_PI;
  return 0;
}

}  // extern "C"
