// petal_native: host-side factorization core.
//
// The reference's L1 is a native LAPACK FFI layer behind a trait
// (src/linalg/lapack.rs: gesvd/gesdd/heev/gelqf+unglq via macro-generated
// Fortran bindings).  This library is its standalone equivalent for the
// JAX rebuild: the same four factorization capabilities implemented
// directly (no LAPACK dependency), exposed over a C ABI for ctypes.
// It serves as
//   * an alternate `linalg_backend="native"` for host execution,
//   * a cross-validation oracle for the JAX Jacobi solvers,
//   * a dispatch-overhead-free path for tiny problems.
//
// Algorithms: cyclic one-sided Jacobi SVD (full working precision, the
// same family as the on-device kernels), cyclic two-sided Jacobi
// eigendecomposition, blocked-free Householder QR (economy Q), and
// partial-pivot LU returning the P·L factor.
//
// All matrices are row-major, f64.  Return code 0 = success,
// 1 = failed to converge within the sweep budget (the LAPACK
// `info != 0` analogue surfaced as LinalgError in Python).

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr int kDefaultMaxSweeps = 60;

// <= 0 selects the default budget; the Python layer passes
// config.jacobi_max_sweeps so forced-non-convergence tests (and user
// budget tuning) reach this core exactly like the jitted kernels.
inline int sweep_budget(int max_sweeps) {
  return max_sweeps > 0 ? max_sweeps : kDefaultMaxSweeps;
}

// Column dot products for a row-major m x n matrix.
inline double col_dot(const double* a, int m, int n, int p, int q) {
  double s = 0.0;
  for (int i = 0; i < m; ++i) s += a[i * n + p] * a[i * n + q];
  return s;
}

inline void rotate_cols(double* a, int m, int n, int p, int q, double c,
                        double s) {
  for (int i = 0; i < m; ++i) {
    const double ap = a[i * n + p];
    const double aq = a[i * n + q];
    a[i * n + p] = c * ap - s * aq;
    a[i * n + q] = s * ap + c * aq;
  }
}

}  // namespace

extern "C" {

// One-sided Jacobi SVD of a (m x n) with m >= n (caller transposes
// otherwise).  Outputs: u (m x n), s (n), vt (n x n).
//
// Works on a column-major copy so every column dot/rotation touches
// contiguous memory (the inner loops auto-vectorize); the row-major
// interface layout is restored on output.
int petal_jacobi_svd(const double* a_in, int m, int n, int max_sweeps,
                     double* u, double* s, double* vt) {
  const int kMaxSweeps = sweep_budget(max_sweeps);
  // ac: n columns of length m, contiguous per column.
  std::vector<double> ac(static_cast<size_t>(m) * n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j)
      ac[static_cast<size_t>(j) * m + i] = a_in[static_cast<size_t>(i) * n + j];
  std::vector<double> vc(static_cast<size_t>(n) * n, 0.0);
  for (int j = 0; j < n; ++j) vc[static_cast<size_t>(j) * n + j] = 1.0;

  const double eps = 2.22044604925031308e-16;
  const double tol = eps * std::sqrt(static_cast<double>(m));
  bool converged = false;
  for (int sweep = 0; sweep < kMaxSweeps && !converged; ++sweep) {
    converged = true;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        double* cp = &ac[static_cast<size_t>(p) * m];
        double* cq = &ac[static_cast<size_t>(q) * m];
        double app = 0.0, aqq = 0.0, apq = 0.0;
        for (int i = 0; i < m; ++i) {
          app += cp[i] * cp[i];
          aqq += cq[i] * cq[i];
          apq += cp[i] * cq[i];
        }
        const double scale = std::sqrt(app * aqq);
        if (scale <= 0.0 || std::fabs(apq) <= eps * scale) continue;
        if (std::fabs(apq) > tol * scale) converged = false;
        const double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t);
        const double sn = c * t;
        for (int i = 0; i < m; ++i) {
          const double xp = cp[i];
          const double xq = cq[i];
          cp[i] = c * xp - sn * xq;
          cq[i] = sn * xp + c * xq;
        }
        double* wp = &vc[static_cast<size_t>(p) * n];
        double* wq = &vc[static_cast<size_t>(q) * n];
        for (int i = 0; i < n; ++i) {
          const double xp = wp[i];
          const double xq = wq[i];
          wp[i] = c * xp - sn * xq;
          wq[i] = sn * xp + c * xq;
        }
      }
    }
  }

  // Singular values = column norms; sort descending.
  std::vector<int> order(n);
  std::vector<double> norms(n);
  for (int j = 0; j < n; ++j) {
    const double* cj = &ac[static_cast<size_t>(j) * m];
    double nn = 0.0;
    for (int i = 0; i < m; ++i) nn += cj[i] * cj[i];
    norms[j] = std::sqrt(nn);
    order[j] = j;
  }
  std::sort(order.begin(), order.end(),
            [&](int x, int y) { return norms[x] > norms[y]; });
  for (int j = 0; j < n; ++j) {
    const int src = order[j];
    s[j] = norms[src];
    const double inv = s[j] > 0 ? 1.0 / s[j] : 0.0;
    const double* cs = &ac[static_cast<size_t>(src) * m];
    for (int i = 0; i < m; ++i) u[static_cast<size_t>(i) * n + j] = cs[i] * inv;
    const double* ws = &vc[static_cast<size_t>(src) * n];
    for (int i = 0; i < n; ++i) vt[static_cast<size_t>(j) * n + i] = ws[i];
  }
  return converged ? 0 : 1;
}

// Two-sided Jacobi eigendecomposition of symmetric a (n x n).
// Outputs: w (n, ascending), v (n x n, eigenvectors in columns).
int petal_jacobi_eigh(const double* a_in, int n, int max_sweeps,
                      double* w, double* v) {
  const int kMaxSweeps = sweep_budget(max_sweeps);
  std::vector<double> a(a_in, a_in + static_cast<size_t>(n) * n);
  std::memset(v, 0, sizeof(double) * n * n);
  for (int i = 0; i < n; ++i) v[i * n + i] = 1.0;

  double anorm = 0.0;
  for (int i = 0; i < n * n; ++i) anorm = std::max(anorm, std::fabs(a[i]));
  if (anorm == 0.0) {
    std::memset(w, 0, sizeof(double) * n);
    return 0;
  }
  const double eps = 2.22044604925031308e-16;
  const double thresh = eps * anorm;

  bool converged = false;
  for (int sweep = 0; sweep < kMaxSweeps && !converged; ++sweep) {
    converged = true;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p * n + q];
        if (std::fabs(apq) <= thresh) continue;
        converged = false;
        const double app = a[p * n + p];
        const double aqq = a[q * n + q];
        const double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t);
        const double sn = c * t;
        // A <- J^T A J on rows/cols p and q.
        for (int i = 0; i < n; ++i) {
          const double aip = a[i * n + p];
          const double aiq = a[i * n + q];
          a[i * n + p] = c * aip - sn * aiq;
          a[i * n + q] = sn * aip + c * aiq;
        }
        for (int i = 0; i < n; ++i) {
          const double api = a[p * n + i];
          const double aqi = a[q * n + i];
          a[p * n + i] = c * api - sn * aqi;
          a[q * n + i] = sn * api + c * aqi;
        }
        for (int i = 0; i < n; ++i) {
          const double vip = v[i * n + p];
          const double viq = v[i * n + q];
          v[i * n + p] = c * vip - sn * viq;
          v[i * n + q] = sn * vip + c * viq;
        }
      }
    }
  }

  // Ascending eigenvalue order (LAPACK ?syev convention).
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int x, int y) {
    return a[x * n + x] < a[y * n + y];
  });
  std::vector<double> vs(v, v + static_cast<size_t>(n) * n);
  for (int j = 0; j < n; ++j) {
    w[j] = a[order[j] * n + order[j]];
    for (int i = 0; i < n; ++i) v[i * n + j] = vs[i * n + order[j]];
  }
  return converged ? 0 : 1;
}

// Householder QR, economy Q (m x k, k = min(m, n)) of a (m x n).
int petal_qr(const double* a_in, int m, int n, double* q) {
  const int k = std::min(m, n);
  std::vector<double> a(a_in, a_in + static_cast<size_t>(m) * n);
  std::vector<double> taus(k, 0.0);
  std::vector<double> hh(static_cast<size_t>(m) * k, 0.0);  // reflectors

  for (int j = 0; j < k; ++j) {
    // Build reflector for column j, rows j..m-1.
    double normx = 0.0;
    for (int i = j; i < m; ++i) normx += a[i * n + j] * a[i * n + j];
    normx = std::sqrt(normx);
    if (normx == 0.0) continue;
    const double alpha = a[j * n + j];
    const double beta = alpha >= 0 ? -normx : normx;
    double* vcol = &hh[static_cast<size_t>(j) * m];
    vcol[j] = alpha - beta;
    for (int i = j + 1; i < m; ++i) vcol[i] = a[i * n + j];
    double vnorm2 = 0.0;
    for (int i = j; i < m; ++i) vnorm2 += vcol[i] * vcol[i];
    if (vnorm2 == 0.0) continue;
    taus[j] = 2.0 / vnorm2;
    // Apply reflector to trailing columns.
    for (int c = j; c < n; ++c) {
      double dot = 0.0;
      for (int i = j; i < m; ++i) dot += vcol[i] * a[i * n + c];
      const double f = taus[j] * dot;
      for (int i = j; i < m; ++i) a[i * n + c] -= f * vcol[i];
    }
  }

  // Materialize economy Q by applying reflectors to the identity.
  std::memset(q, 0, sizeof(double) * m * k);
  for (int j = 0; j < k; ++j) q[j * k + j] = 1.0;
  for (int j = k - 1; j >= 0; --j) {
    if (taus[j] == 0.0) continue;
    const double* vcol = &hh[static_cast<size_t>(j) * m];
    for (int c = 0; c < k; ++c) {
      double dot = 0.0;
      for (int i = j; i < m; ++i) dot += vcol[i] * q[i * k + c];
      const double f = taus[j] * dot;
      for (int i = j; i < m; ++i) q[i * k + c] -= f * vcol[i];
    }
  }
  return 0;
}

// Partial-pivot LU of a (m x n); writes the P·L factor (m x k).
int petal_lu_pl(const double* a_in, int m, int n, double* pl) {
  const int k = std::min(m, n);
  std::vector<double> a(a_in, a_in + static_cast<size_t>(m) * n);
  std::vector<int> perm(m);
  for (int i = 0; i < m; ++i) perm[i] = i;

  for (int j = 0; j < k; ++j) {
    int piv = j;
    double best = std::fabs(a[j * n + j]);
    for (int i = j + 1; i < m; ++i) {
      const double mag = std::fabs(a[i * n + j]);
      if (mag > best) {
        best = mag;
        piv = i;
      }
    }
    if (piv != j) {
      for (int c = 0; c < n; ++c) std::swap(a[j * n + c], a[piv * n + c]);
      std::swap(perm[j], perm[piv]);
    }
    const double pivot = a[j * n + j];
    if (pivot == 0.0) continue;
    for (int i = j + 1; i < m; ++i) {
      const double f = a[i * n + j] / pivot;
      a[i * n + j] = f;
      for (int c = j + 1; c < n; ++c) a[i * n + c] -= f * a[j * n + c];
    }
  }

  // P·L: row perm[i] of the product is row i of unit-lower L.
  std::memset(pl, 0, sizeof(double) * m * k);
  for (int i = 0; i < m; ++i) {
    double* dst = &pl[static_cast<size_t>(perm[i]) * k];
    for (int j = 0; j < std::min(i, k); ++j) dst[j] = a[i * n + j];
    if (i < k) dst[i] = 1.0;
  }
  return 0;
}

}  // extern "C"
