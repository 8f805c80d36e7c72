// Per-vertex deformation gradients on the host: the reference's pyACAP
// `GetRS` contract (edittool/__init__.py:102,109-113), the port's copy of
// the JAX package's native extractor.
//
// For each vertex i with one-ring edges e_j = v_j - v_i (reference) and
// e'_j (deformed): T = A B^-1, A = sum e'_j e_j^T, B = sum e_j e_j^T + eps I,
// factored T = R S by Higham's scaled Newton iteration. OpenMP over
// vertices, float64 throughout; R and S come back as float32.
//
// The arithmetic is `gaussianmesh_tpu_torch/edit/deform.py`'s, with its ring
// normalisation (the repair of the JAX package's fault B4): both rings are
// divided by the RMS length of the reference ring's edges, so B is O(1) on
// every mesh and the determinant guards below (the JAX package's: adjugate
// at |det B| <= 1e-12, R = S = I at |det T| <= 1e-9) trip only on
// degenerate rings, not on the nearly flat rings of a fine mesh. The same
// eps (1e-8 on the normalised ring), the same guards, the same 7 Newton
// steps with the determinant scaling clipped to [0.1, 10]: run in float64,
// `deformation_gradients` gives these results to rounding.
//
// Host code, not a TPU kernel: built by `ops/_cuda.py::host_library` with
// g++ -O3 -std=c++17 -fopenmp -shared -fPIC, loaded with ctypes.

#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kRingEps = 1e-8;    // deform.RING_EPS
constexpr double kInvEps = 1e-12;    // maths.INV_EPS
constexpr double kPolarEps = 1e-9;   // maths.POLAR_EPS
constexpr int kNewtonSteps = 7;      // maths.NEWTON_STEPS

// Cofactor matrix (row i = cross of the other two rows, cyclic) and
// determinant of a row-major 3x3, in maths._cofactors' products.
inline double cofactors(const double* a, double* c) {
  c[0] = a[4] * a[8] - a[5] * a[7];
  c[1] = a[5] * a[6] - a[3] * a[8];
  c[2] = a[3] * a[7] - a[4] * a[6];
  c[3] = a[7] * a[2] - a[8] * a[1];
  c[4] = a[8] * a[0] - a[6] * a[2];
  c[5] = a[6] * a[1] - a[7] * a[0];
  c[6] = a[1] * a[5] - a[2] * a[4];
  c[7] = a[2] * a[3] - a[0] * a[5];
  c[8] = a[0] * a[4] - a[1] * a[3];
  return a[0] * c[0] + a[1] * c[1] + a[2] * c[2];
}

// maths.polar_decompose_rs: R a proper rotation, S symmetric.
inline void polar_rs(const double* a, double* r, double* s) {
  double c[9];
  const double det_a = cofactors(a, c);
  const bool ok = std::fabs(det_a) > kPolarEps;
  double safe[9];
  for (int i = 0; i < 9; ++i) safe[i] = ok ? a[i] : (i % 4 == 0 ? 1.0 : 0.0);
  const double sign = det_a < 0 ? -1.0 : 1.0;
  double x[9];
  for (int i = 0; i < 9; ++i) x[i] = safe[i] * sign;
  for (int it = 0; it < kNewtonSteps; ++it) {
    const double det = cofactors(x, c);
    const double inv_det = 1.0 / (std::fabs(det) > kInvEps ? det : 1.0);
    double sc = std::pow(std::fabs(det), -1.0 / 3.0);
    sc = sc < 0.1 ? 0.1 : (sc > 10.0 ? 10.0 : sc);
    // X^-T is the cofactor matrix over det
    for (int i = 0; i < 9; ++i) x[i] = 0.5 * (x[i] * sc + c[i] * inv_det / sc);
  }
  double st[9];   // X^T safe
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      st[i * 3 + j] = x[0 * 3 + i] * safe[0 * 3 + j] + x[1 * 3 + i] * safe[1 * 3 + j] +
                      x[2 * 3 + i] * safe[2 * 3 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      r[i * 3 + j] = x[i * 3 + j];
      s[i * 3 + j] = 0.5 * (st[i * 3 + j] + st[j * 3 + i]);
    }
}

}  // namespace

extern "C" {

// v_ref, v_def: (n, 3) float64; neighbors: (n, max_degree) int32 and
// mask: (n, max_degree) uint8 (deform.build_one_ring); r_out, s_out: (n, 9)
// float32 row-major. n_threads <= 0: OpenMP's default (every core).
// Returns 0 (the status every host entry point returns).
int gm_acap_get_rs(const double* v_ref, const double* v_def, int n_vertices,
                   const int* neighbors, const unsigned char* mask,
                   int max_degree, float* r_out, float* s_out, int n_threads) {
#ifdef _OPENMP
  const int threads = n_threads > 0 ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(static) num_threads(threads)
#endif
  for (int v = 0; v < n_vertices; ++v) {
    const double* pr = v_ref + 3 * v;
    const double* pd = v_def + 3 * v;
    const int* nb = neighbors + static_cast<long>(v) * max_degree;
    const unsigned char* mk = mask + static_cast<long>(v) * max_degree;
    // the RMS length of the reference ring's edges
    double sq = 0.0;
    int count = 0;
    for (int k = 0; k < max_degree; ++k) {
      if (!mk[k]) continue;
      const double* q = v_ref + 3 * nb[k];
      for (int i = 0; i < 3; ++i) sq += (q[i] - pr[i]) * (q[i] - pr[i]);
      ++count;
    }
    const double rms = std::sqrt(sq / (count > 0 ? count : 1));
    const double inv_scale = rms > 0 ? 1.0 / rms : 0.0;
    double b[9] = {0}, a[9] = {0};
    for (int k = 0; k < max_degree; ++k) {
      if (!mk[k]) continue;
      const double* q = v_ref + 3 * nb[k];
      const double* qd = v_def + 3 * nb[k];
      double e[3], ed[3];
      for (int i = 0; i < 3; ++i) {
        e[i] = (q[i] - pr[i]) * inv_scale;
        ed[i] = (qd[i] - pd[i]) * inv_scale;
      }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          b[i * 3 + j] += e[i] * e[j];
          a[i * 3 + j] += ed[i] * e[j];
        }
    }
    double t[9];
    if (b[0] + b[4] + b[8] > 1e-12) {   // a ring (deform.ReferenceRing.has_ring)
      for (int i = 0; i < 3; ++i) b[i * 4] += kRingEps;
      double c[9];
      const double det = cofactors(b, c);
      const double inv_det = 1.0 / (std::fabs(det) > kInvEps ? det : 1.0);
      // B^-1 = cof^T / det; T = A B^-1
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          t[i * 3 + j] = (a[i * 3 + 0] * c[j * 3 + 0] + a[i * 3 + 1] * c[j * 3 + 1] +
                          a[i * 3 + 2] * c[j * 3 + 2]) * inv_det;
    } else {
      for (int i = 0; i < 9; ++i) t[i] = i % 4 == 0 ? 1.0 : 0.0;
    }
    double r[9], s[9];
    polar_rs(t, r, s);
    for (int i = 0; i < 9; ++i) {
      r_out[static_cast<long>(v) * 9 + i] = static_cast<float>(r[i]);
      s_out[static_cast<long>(v) * 9 + i] = static_cast<float>(s[i]);
    }
  }
  return 0;
}

}  // extern "C"
