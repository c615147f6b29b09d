// Native deformation-transfer runtime (C++17, no external deps).
//
// The float64 host runtime of the reference Eigen module
// (deformation/cpp/src/deform_triangle_impl.hpp of the reference framework):
//   - set_target: per-triangle Gram-Schmidt local frames, normal equations
//     over free vertices with diagonal regularization, dense Cholesky
//     prefactorization (the FLAME free system is ~1.3k unknowns — dense LLT
//     beats a sparse LU here and vectorizes cleanly)
//   - get_deform_grad: edge frames (|cross|^1/2 third edge, degeneracy
//     guard), affine T = Mb·Ma^-1, polar decomposition via symmetric Jacobi
//     eigensolve of T^T·T, 6 scale + 3 rotation-log floats per triangle
//   - get_mesh_from_dgrad: exp(skew)·S per triangle, constrained-vertex
//     subtraction, Cholesky solve; batched over frames with OpenMP.
//
// Exposed as a C ABI for ctypes (pybind11 is not in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct V3 {
  double x, y, z;
};
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

using M3 = double[3][3];

static inline void mat_mul(const M3 a, const M3 b, M3 out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

static inline double det3(const M3 m) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
         m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

static inline bool inv3(const M3 m, M3 out) {
  double d = det3(m);
  if (std::fabs(d) < 1e-300) return false;
  double id = 1.0 / d;
  out[0][0] = (m[1][1] * m[2][2] - m[1][2] * m[2][1]) * id;
  out[0][1] = (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * id;
  out[0][2] = (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * id;
  out[1][0] = (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * id;
  out[1][1] = (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * id;
  out[1][2] = (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * id;
  out[2][0] = (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * id;
  out[2][1] = (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * id;
  out[2][2] = (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * id;
  return true;
}

// Jacobi eigendecomposition of a symmetric 3x3: A = Q diag(w) Q^T.
static void sym_eigen3(const M3 a_in, double w[3], M3 q) {
  M3 a;
  std::memcpy(a, a_in, sizeof(M3));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) q[i][j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; ++p) {
      for (int qi = p + 1; qi < 3; ++qi) {
        if (std::fabs(a[p][qi]) < 1e-300) continue;
        double theta = (a[qi][qi] - a[p][p]) / (2.0 * a[p][qi]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0);
        double s = t * c;
        // rotate A
        for (int k = 0; k < 3; ++k) {
          double akp = a[k][p], akq = a[k][qi];
          a[k][p] = c * akp - s * akq;
          a[k][qi] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          double apk = a[p][k], aqk = a[qi][k];
          a[p][k] = c * apk - s * aqk;
          a[qi][k] = s * apk + c * aqk;
        }
        // rotate Q
        for (int k = 0; k < 3; ++k) {
          double qkp = q[k][p], qkq = q[k][qi];
          q[k][p] = c * qkp - s * qkq;
          q[k][qi] = s * qkp + c * qkq;
        }
      }
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = a[i][i];
}

// Polar decomposition T = R * S with S symmetric PSD-ish and the
// reference's reflection handling (det correction on the smallest mode).
static void polar_decompose(const M3 t, M3 r, M3 s) {
  // T^T T = V diag(w) V^T ;  singular values = sqrt(w)
  M3 tt = {};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      tt[i][j] = t[0][i] * t[0][j] + t[1][i] * t[1][j] + t[2][i] * t[2][j];
  double w[3];
  M3 v;
  sym_eigen3(tt, w, v);
  // sort descending so the det fix lands on the smallest singular value
  int idx[3] = {0, 1, 2};
  for (int i = 0; i < 2; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (w[idx[j]] > w[idx[i]]) std::swap(idx[i], idx[j]);
  double sv[3];
  M3 vs;  // V sorted (columns)
  for (int c = 0; c < 3; ++c) {
    sv[c] = std::sqrt(std::fmax(w[idx[c]], 0.0));
    for (int rr = 0; rr < 3; ++rr) vs[rr][c] = v[rr][idx[c]];
  }
  // U = T V diag(1/s)
  M3 u;
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 3; ++c) {
      double acc = 0;
      for (int k = 0; k < 3; ++k) acc += t[i][k] * vs[k][c];
      u[i][c] = (sv[c] > 1e-12) ? acc / sv[c] : 0.0;
    }
  // fix a rank-deficient/zero column of U via cross product
  if (sv[2] <= 1e-12) {
    double ux = u[1][0] * u[2][1] - u[2][0] * u[1][1];
    double uy = u[2][0] * u[0][1] - u[0][0] * u[2][1];
    double uz = u[0][0] * u[1][1] - u[1][0] * u[0][1];
    u[0][2] = ux; u[1][2] = uy; u[2][2] = uz;
  }
  // det(U V^T) correction
  M3 vt, uvt;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) vt[i][j] = vs[j][i];
  mat_mul(u, vt, uvt);
  double dfix = det3(uvt) < 0 ? -1.0 : 1.0;
  // R = U diag(1,1,d) V^T ;  S = V diag(1,1,d) diag(sv) V^T
  M3 ud;
  std::memcpy(ud, u, sizeof(M3));
  for (int i = 0; i < 3; ++i) ud[i][2] *= dfix;
  mat_mul(ud, vt, r);
  M3 ds = {};
  ds[0][0] = sv[0];
  ds[1][1] = sv[1];
  ds[2][2] = sv[2] * dfix;
  M3 tmp;
  mat_mul(vs, ds, tmp);
  mat_mul(tmp, vt, s);
}

static void rotation_log(const M3 r, double out[3]) {
  double tr = r[0][0] + r[1][1] + r[2][2];
  double csin = (tr - 1.0) / 2.0;
  csin = std::fmax(-1.0, std::fmin(1.0, csin));
  double angle = std::acos(csin);
  const double tol = 1e-6;
  if (std::fabs(angle) < tol) {
    out[0] = out[1] = out[2] = 0.0;
    return;
  }
  if (std::fabs(angle - M_PI) < tol) {
    double b00 = (r[0][0] + 1.0) / 2.0, b11 = (r[1][1] + 1.0) / 2.0,
           b22 = (r[2][2] + 1.0) / 2.0;
    double k1 = std::sqrt(std::fmax(b00, 0.0));
    double b01 = (r[0][1] + 0.0) / 2.0, b02 = (r[0][2] + 0.0) / 2.0;
    double k2 = ((k1 * b01 > 0) ? 1.0 : -1.0) * std::sqrt(std::fmax(b11, 0.0));
    double k3 = ((k1 * b02 > 0) ? 1.0 : -1.0) * std::sqrt(std::fmax(b22, 0.0));
    out[0] = k1 * M_PI; out[1] = k2 * M_PI; out[2] = k3 * M_PI;
    return;
  }
  double s2 = 2.0 * std::sin(angle);
  out[0] = (r[2][1] - r[1][2]) / s2 * angle;
  out[1] = (r[0][2] - r[2][0]) / s2 * angle;
  out[2] = (r[1][0] - r[0][1]) / s2 * angle;
}

static void rotation_exp(const double wv[3], M3 out) {
  double angle = std::sqrt(wv[0] * wv[0] + wv[1] * wv[1] + wv[2] * wv[2]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] = (i == j) ? 1.0 : 0.0;
  if (angle < 1e-6) return;
  double ax = wv[0] / angle, ay = wv[1] / angle, az = wv[2] / angle;
  M3 k = {{0, -az, ay}, {az, 0, -ax}, {-ay, ax, 0}};
  M3 kk;
  mat_mul(k, k, kk);
  double sa = std::sin(angle), ca = 1.0 - std::cos(angle);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] += sa * k[i][j] + ca * kk[i][j];
}

static bool edge3(V3 e1, V3 e2, V3 &e3, double eps) {
  e3 = cross(e1, e2);
  double l1 = std::sqrt(dot(e1, e1)), l2 = std::sqrt(dot(e2, e2));
  double denom = (l1 * l2 == 0) ? 1.0 : l1 * l2;
  if (std::fabs(dot(e1, e2) / denom) > 1.0 - eps) return false;
  double n = std::pow(dot(e3, e3), 0.25);
  n = std::fmax(n, eps);
  e3 = {e3.x / n, e3.y / n, e3.z / n};
  return true;
}

// ---------------------------------------------------------------------------
// global target state (mirrors the reference's single global manager,
// pybind.cpp:10)
// ---------------------------------------------------------------------------
struct Target {
  int n_verts = 0, n_tris = 0, n_cnsts = 0, n_free = 0;
  std::vector<int64_t> faces;         // (n_tris*3)
  std::vector<double> w;              // (n_tris*3*3) slot-major weights
  std::vector<int32_t> vi_to_col;     // free col or -1
  std::vector<int32_t> vi_to_col_r;   // cnst col or -1
  std::vector<int32_t> free_ids, cnst_ids;
  std::vector<double> chol;           // (n_free*n_free) lower Cholesky factor
  std::vector<double> template_cnst;  // (n_cnsts*3)
  bool valid = false;
};

static Target g_target;

static bool cholesky_factor(std::vector<double> &a, int n) {
  // in-place lower-triangular LLT
  for (int j = 0; j < n; ++j) {
    double d = a[j * (int64_t)n + j];
    for (int k = 0; k < j; ++k) d -= a[j * (int64_t)n + k] * a[j * (int64_t)n + k];
    if (d <= 0) return false;
    double dj = std::sqrt(d);
    a[j * (int64_t)n + j] = dj;
    for (int i = j + 1; i < n; ++i) {
      double s = a[i * (int64_t)n + j];
      for (int k = 0; k < j; ++k) s -= a[i * (int64_t)n + k] * a[j * (int64_t)n + k];
      a[i * (int64_t)n + j] = s / dj;
    }
  }
  // zero upper triangle
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) a[i * (int64_t)n + j] = 0.0;
  return true;
}

static void cholesky_solve(const std::vector<double> &l, int n, double *b, int nrhs) {
  // forward: L y = b, then backward: L^T x = y  (b is (n, nrhs) row-major)
  for (int i = 0; i < n; ++i) {
    for (int k = 0; k < i; ++k) {
      double lik = l[i * (int64_t)n + k];
      if (lik == 0.0) continue;
      for (int r = 0; r < nrhs; ++r) b[i * nrhs + r] -= lik * b[k * nrhs + r];
    }
    double d = l[i * (int64_t)n + i];
    for (int r = 0; r < nrhs; ++r) b[i * nrhs + r] /= d;
  }
  for (int i = n - 1; i >= 0; --i) {
    for (int k = i + 1; k < n; ++k) {
      double lki = l[k * (int64_t)n + i];
      if (lki == 0.0) continue;
      for (int r = 0; r < nrhs; ++r) b[i * nrhs + r] -= lki * b[k * nrhs + r];
    }
    double d = l[i * (int64_t)n + i];
    for (int r = 0; r < nrhs; ++r) b[i * nrhs + r] /= d;
  }
}

}  // namespace

extern "C" {

int sdfa_set_target(const double *verts, int n_verts, const int64_t *tris,
                    int n_tris, const int64_t *cnsts, int n_cnsts, double reg) {
  Target t;
  t.n_verts = n_verts;
  t.n_tris = n_tris;
  t.n_cnsts = n_cnsts;
  t.faces.assign(tris, tris + (int64_t)n_tris * 3);

  // column maps: free verts keep ascending order (impl.hpp:44-75 net effect)
  std::vector<char> is_cnst(n_verts, 0);
  for (int i = 0; i < n_cnsts; ++i) is_cnst[cnsts[i]] = 1;
  t.vi_to_col.assign(n_verts, -1);
  t.vi_to_col_r.assign(n_verts, -1);
  for (int i = 0; i < n_cnsts; ++i) t.vi_to_col_r[cnsts[i]] = i;
  for (int v = 0; v < n_verts; ++v)
    if (!is_cnst[v]) {
      t.vi_to_col[v] = (int)t.free_ids.size();
      t.free_ids.push_back(v);
    }
  for (int i = 0; i < n_cnsts; ++i) t.cnst_ids.push_back((int)cnsts[i]);
  t.n_free = (int)t.free_ids.size();

  // per-triangle weights from the Gram-Schmidt QR local frame
  t.w.assign((int64_t)n_tris * 9, 0.0);
  for (int j = 0; j < n_tris; ++j) {
    const int64_t *f = &t.faces[(int64_t)j * 3];
    V3 v1 = {verts[f[0] * 3], verts[f[0] * 3 + 1], verts[f[0] * 3 + 2]};
    V3 v2 = {verts[f[1] * 3], verts[f[1] * 3 + 1], verts[f[1] * 3 + 2]};
    V3 v3 = {verts[f[2] * 3], verts[f[2] * 3 + 1], verts[f[2] * 3 + 2]};
    V3 a = sub(v2, v1), b = sub(v3, v1);
    // Gram-Schmidt on [a b] with the reference degenerate branch (eps 1e-6)
    double r00 = std::sqrt(dot(a, a));
    V3 q0 = {0, 0, 0};
    if (r00 < 1e-6) { r00 = 1.0; }
    else { q0 = {a.x / r00, a.y / r00, a.z / r00}; }
    double r01 = dot(q0, b);
    V3 w1 = {b.x - r01 * q0.x, b.y - r01 * q0.y, b.z - r01 * q0.z};
    double r11 = std::sqrt(dot(w1, w1));
    V3 q1 = {0, 0, 0};
    if (r11 < 1e-6) { r11 = 1.0; }
    else { q1 = {w1.x / r11, w1.y / r11, w1.z / r11}; }
    // Uj = R^-1 Q^T  (2x3) with R = [[r00, r01], [0, r11]]
    double u0[3] = {q0.x / r00 - (r01 / (r00 * r11)) * q1.x,
                    q0.y / r00 - (r01 / (r00 * r11)) * q1.y,
                    q0.z / r00 - (r01 / (r00 * r11)) * q1.z};
    double u1[3] = {q1.x / r11, q1.y / r11, q1.z / r11};
    double *wj = &t.w[(int64_t)j * 9];
    for (int c = 0; c < 3; ++c) {
      wj[0 * 3 + c] = -u0[c] - u1[c];  // slot v1
      wj[1 * 3 + c] = u0[c];           // slot v2
      wj[2 * 3 + c] = u1[c];           // slot v3
    }
  }

  // AtA (dense, free system) + regularization, then Cholesky
  int n = t.n_free;
  std::vector<double> ata((int64_t)n * n, 0.0);
  for (int j = 0; j < n_tris; ++j) {
    const int64_t *f = &t.faces[(int64_t)j * 3];
    const double *wj = &t.w[(int64_t)j * 9];
    for (int c = 0; c < 3; ++c) {
      int cols[3];
      double vals[3];
      int cnt = 0;
      for (int s = 0; s < 3; ++s) {
        int col = t.vi_to_col[f[s]];
        if (col >= 0) { cols[cnt] = col; vals[cnt] = wj[s * 3 + c]; ++cnt; }
      }
      for (int aI = 0; aI < cnt; ++aI)
        for (int bI = 0; bI < cnt; ++bI)
          ata[(int64_t)cols[aI] * n + cols[bI]] += vals[aI] * vals[bI];
    }
  }
  for (int i = 0; i < n; ++i) ata[(int64_t)i * n + i] += reg;
  if (!cholesky_factor(ata, n)) return 0;
  t.chol = std::move(ata);

  t.template_cnst.resize((int64_t)n_cnsts * 3);
  for (int i = 0; i < n_cnsts; ++i)
    for (int d = 0; d < 3; ++d)
      t.template_cnst[(int64_t)i * 3 + d] = verts[cnsts[i] * 3 + d];

  t.valid = true;
  g_target = std::move(t);
  return 1;
}

int sdfa_is_same(int n_verts, int n_tris, int n_cnsts) {
  return g_target.valid && g_target.n_verts == n_verts &&
         g_target.n_tris == n_tris && g_target.n_cnsts == n_cnsts;
}

int sdfa_get_deform_grad(const double *src, const double *dst, int /*n_verts*/,
                         const int64_t *tris, int n_tris, double eps,
                         float *out) {
#pragma omp parallel for schedule(static)
  for (int j = 0; j < n_tris; ++j) {
    const int64_t *f = &tris[(int64_t)j * 3];
    V3 pa1 = {src[f[0] * 3], src[f[0] * 3 + 1], src[f[0] * 3 + 2]};
    V3 pa2 = {src[f[1] * 3], src[f[1] * 3 + 1], src[f[1] * 3 + 2]};
    V3 pa3 = {src[f[2] * 3], src[f[2] * 3 + 1], src[f[2] * 3 + 2]};
    V3 pb1 = {dst[f[0] * 3], dst[f[0] * 3 + 1], dst[f[0] * 3 + 2]};
    V3 pb2 = {dst[f[1] * 3], dst[f[1] * 3 + 1], dst[f[1] * 3 + 2]};
    V3 pb3 = {dst[f[2] * 3], dst[f[2] * 3 + 1], dst[f[2] * 3 + 2]};
    V3 ea1 = sub(pa2, pa1), ea2 = sub(pa3, pa1);
    V3 eb1 = sub(pb2, pb1), eb2 = sub(pb3, pb1);
    V3 ea3, eb3;
    bool ok = edge3(ea1, ea2, ea3, eps) && edge3(eb1, eb2, eb3, eps);
    float *g = out + (int64_t)j * 9;
    if (!ok) {
      for (int k = 0; k < 9; ++k) g[k] = 0.0f;
      continue;
    }
    M3 ma = {{ea1.x, ea2.x, ea3.x}, {ea1.y, ea2.y, ea3.y}, {ea1.z, ea2.z, ea3.z}};
    M3 mb = {{eb1.x, eb2.x, eb3.x}, {eb1.y, eb2.y, eb3.y}, {eb1.z, eb2.z, eb3.z}};
    M3 mai, t;
    if (!inv3(ma, mai)) {
      for (int k = 0; k < 9; ++k) g[k] = 0.0f;
      continue;
    }
    mat_mul(mb, mai, t);
    M3 r, s;
    polar_decompose(t, r, s);
    double wlog[3];
    rotation_log(r, wlog);
    g[0] = (float)(s[0][0] - 1.0);
    g[1] = (float)s[0][1];
    g[2] = (float)s[0][2];
    g[3] = (float)(s[1][1] - 1.0);
    g[4] = (float)s[1][2];
    g[5] = (float)(s[2][2] - 1.0);
    // dgrad packing: (logR[0,1], logR[0,2], logR[1,2]) = (−w2, w1, −w0)
    g[6] = (float)(-wlog[2]);
    g[7] = (float)(wlog[1]);
    g[8] = (float)(-wlog[0]);
  }
  return 1;
}

// dgrad (n_frames, n_tris*9) float32 → verts (n_frames, n_verts*3) float64
int sdfa_get_mesh_from_dgrad(const float *dgrad, int n_frames,
                             const double *cnst_verts, double *out_verts) {
  if (!g_target.valid) return 0;
  const Target &t = g_target;
  const double *cv = cnst_verts ? cnst_verts : t.template_cnst.data();

#pragma omp parallel for schedule(static)
  for (int fi = 0; fi < n_frames; ++fi) {
    const float *dg = dgrad + (int64_t)fi * t.n_tris * 9;
    std::vector<double> rhs((int64_t)t.n_free * 3, 0.0);
    for (int j = 0; j < t.n_tris; ++j) {
      const float *g = dg + (int64_t)j * 9;
      // T^T = (exp(skew)·S)^T
      double wv[3] = {-(double)g[8], (double)g[7], -(double)g[6]};
      M3 s = {{g[0] + 1.0, g[1], g[2]},
                 {g[1], g[3] + 1.0, g[4]},
                 {g[2], g[4], g[5] + 1.0}};
      M3 rot, tmat, tt;
      rotation_exp(wv, rot);
      mat_mul(rot, s, tmat);
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k) tt[i][k] = tmat[k][i];
      const int64_t *f = &t.faces[(int64_t)j * 3];
      const double *wj = &t.w[(int64_t)j * 9];
      for (int slot = 0; slot < 3; ++slot) {
        int col = t.vi_to_col[f[slot]];
        if (col < 0) continue;
        // RHS[col] += Σ_c w[slot][c] · Tt[c][:]
        for (int c = 0; c < 3; ++c) {
          double wv2 = wj[slot * 3 + c];
          if (wv2 == 0.0) continue;
          rhs[(int64_t)col * 3 + 0] += wv2 * tt[c][0];
          rhs[(int64_t)col * 3 + 1] += wv2 * tt[c][1];
          rhs[(int64_t)col * 3 + 2] += wv2 * tt[c][2];
        }
      }
      // constrained-vertex subtraction: RHS -= At·Ar·C contribution
      for (int slot = 0; slot < 3; ++slot) {
        int rcol = t.vi_to_col_r[f[slot]];
        if (rcol < 0) continue;
        const double *c0 = cv + (int64_t)rcol * 3;
        for (int c = 0; c < 3; ++c) {
          double w_r = wj[slot * 3 + c];
          if (w_r == 0.0) continue;
          for (int slot2 = 0; slot2 < 3; ++slot2) {
            int col = t.vi_to_col[f[slot2]];
            if (col < 0) continue;
            double w_a = wj[slot2 * 3 + c];
            rhs[(int64_t)col * 3 + 0] -= w_a * w_r * c0[0];
            rhs[(int64_t)col * 3 + 1] -= w_a * w_r * c0[1];
            rhs[(int64_t)col * 3 + 2] -= w_a * w_r * c0[2];
          }
        }
      }
    }
    cholesky_solve(t.chol, t.n_free, rhs.data(), 3);
    double *ov = out_verts + (int64_t)fi * t.n_verts * 3;
    for (int i = 0; i < t.n_free; ++i) {
      int vi = t.free_ids[i];
      ov[vi * 3 + 0] = rhs[(int64_t)i * 3 + 0];
      ov[vi * 3 + 1] = rhs[(int64_t)i * 3 + 1];
      ov[vi * 3 + 2] = rhs[(int64_t)i * 3 + 2];
    }
    for (int i = 0; i < t.n_cnsts; ++i) {
      int vi = t.cnst_ids[i];
      ov[vi * 3 + 0] = cv[(int64_t)i * 3 + 0];
      ov[vi * 3 + 1] = cv[(int64_t)i * 3 + 1];
      ov[vi * 3 + 2] = cv[(int64_t)i * 3 + 2];
    }
  }
  return 1;
}

// raw per-triangle affine transforms, row-major 9 floats/triangle
// (reference getDeformationMatrix, deform_triangle_impl.hpp:313-383;
// degenerate triangles emit identity, not zeros)
int sdfa_get_deform_mat(const double *src, const double *dst, int /*n_verts*/,
                        const int64_t *tris, int n_tris, double eps,
                        float *out) {
#pragma omp parallel for schedule(static)
  for (int j = 0; j < n_tris; ++j) {
    const int64_t *f = &tris[(int64_t)j * 3];
    V3 pa1 = {src[f[0] * 3], src[f[0] * 3 + 1], src[f[0] * 3 + 2]};
    V3 pa2 = {src[f[1] * 3], src[f[1] * 3 + 1], src[f[1] * 3 + 2]};
    V3 pa3 = {src[f[2] * 3], src[f[2] * 3 + 1], src[f[2] * 3 + 2]};
    V3 pb1 = {dst[f[0] * 3], dst[f[0] * 3 + 1], dst[f[0] * 3 + 2]};
    V3 pb2 = {dst[f[1] * 3], dst[f[1] * 3 + 1], dst[f[1] * 3 + 2]};
    V3 pb3 = {dst[f[2] * 3], dst[f[2] * 3 + 1], dst[f[2] * 3 + 2]};
    V3 ea1 = sub(pa2, pa1), ea2 = sub(pa3, pa1);
    V3 eb1 = sub(pb2, pb1), eb2 = sub(pb3, pb1);
    V3 ea3, eb3;
    bool ok = edge3(ea1, ea2, ea3, eps) && edge3(eb1, eb2, eb3, eps);
    float *m = out + (int64_t)j * 9;
    M3 t = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
    if (ok) {
      M3 ma = {{ea1.x, ea2.x, ea3.x}, {ea1.y, ea2.y, ea3.y}, {ea1.z, ea2.z, ea3.z}};
      M3 mb = {{eb1.x, eb2.x, eb3.x}, {eb1.y, eb2.y, eb3.y}, {eb1.z, eb2.z, eb3.z}};
      M3 mai;
      if (inv3(ma, mai)) mat_mul(mb, mai, t);
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) m[r * 3 + c] = (float)t[r][c];
  }
  return 1;
}

// mesh from RAW matrices (reference getMeshFromDeformationMatrix,
// deform_triangle_impl.hpp:383-440): the row-major buffer is consumed as
// its transpose (the reference's col-major Eigen read of row-major data)
int sdfa_get_mesh_from_dm(const float *dmat, int n_frames,
                          const double *cnst_verts, double *out_verts) {
  if (!g_target.valid) return 0;
  const Target &t = g_target;
  const double *cv = cnst_verts ? cnst_verts : t.template_cnst.data();

#pragma omp parallel for schedule(static)
  for (int fi = 0; fi < n_frames; ++fi) {
    const float *dm = dmat + (int64_t)fi * t.n_tris * 9;
    std::vector<double> rhs((int64_t)t.n_free * 3, 0.0);
    for (int j = 0; j < t.n_tris; ++j) {
      const float *m = dm + (int64_t)j * 9;
      M3 tt;  // tt[c][d] = T[d][c]
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 3; ++k) tt[i][k] = (double)m[k * 3 + i];
      const int64_t *f = &t.faces[(int64_t)j * 3];
      const double *wj = &t.w[(int64_t)j * 9];
      for (int slot = 0; slot < 3; ++slot) {
        int col = t.vi_to_col[f[slot]];
        if (col < 0) continue;
        for (int c = 0; c < 3; ++c) {
          double wv2 = wj[slot * 3 + c];
          if (wv2 == 0.0) continue;
          rhs[(int64_t)col * 3 + 0] += wv2 * tt[c][0];
          rhs[(int64_t)col * 3 + 1] += wv2 * tt[c][1];
          rhs[(int64_t)col * 3 + 2] += wv2 * tt[c][2];
        }
      }
      for (int slot = 0; slot < 3; ++slot) {
        int rcol = t.vi_to_col_r[f[slot]];
        if (rcol < 0) continue;
        const double *c0 = cv + (int64_t)rcol * 3;
        for (int c = 0; c < 3; ++c) {
          double w_r = wj[slot * 3 + c];
          if (w_r == 0.0) continue;
          for (int slot2 = 0; slot2 < 3; ++slot2) {
            int col = t.vi_to_col[f[slot2]];
            if (col < 0) continue;
            double w_a = wj[slot2 * 3 + c];
            rhs[(int64_t)col * 3 + 0] -= w_a * w_r * c0[0];
            rhs[(int64_t)col * 3 + 1] -= w_a * w_r * c0[1];
            rhs[(int64_t)col * 3 + 2] -= w_a * w_r * c0[2];
          }
        }
      }
    }
    cholesky_solve(t.chol, t.n_free, rhs.data(), 3);
    double *ov = out_verts + (int64_t)fi * t.n_verts * 3;
    for (int i = 0; i < t.n_free; ++i) {
      int vi = t.free_ids[i];
      ov[vi * 3 + 0] = rhs[(int64_t)i * 3 + 0];
      ov[vi * 3 + 1] = rhs[(int64_t)i * 3 + 1];
      ov[vi * 3 + 2] = rhs[(int64_t)i * 3 + 2];
    }
    for (int i = 0; i < t.n_cnsts; ++i) {
      int vi = t.cnst_ids[i];
      ov[vi * 3 + 0] = cv[(int64_t)i * 3 + 0];
      ov[vi * 3 + 1] = cv[(int64_t)i * 3 + 1];
      ov[vi * 3 + 2] = cv[(int64_t)i * 3 + 2];
    }
  }
  return 1;
}

int sdfa_n_free() { return g_target.valid ? g_target.n_free : -1; }

int sdfa_n_tris() { return g_target.valid ? g_target.n_tris : -1; }

}  // extern "C"
