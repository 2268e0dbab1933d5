// Host-side banded complex-symmetric LDL^T direct solver.
//
// Native equivalent of the reference's L0 layer — the MUMPS shared library
// driven through factor/apply/destroy handles (reference:
// MUMPS/src/MUMPSfuncs.jl:24-176, entry points factor_mumps_cmplx_,
// solve_mumps_cmplx_, destroy_mumps_).  The 2-D MT interior operator on a
// tensor mesh is a 5-point stencil; with y-fastest node ordering it is a
// banded complex *symmetric* matrix with half-bandwidth = nyi (the number of
// interior nodes per z-line), so a dense-band LDL^T (no pivoting — the
// equilibrated operator is strongly diagonally dominated by |diag| = 1) does
// exactly what MUMPS's multifrontal LDL^T does for this matrix class, at
// O(n b^2) flops.
//
// On the GPU the production path is the batched block-Thomas factorisation in
// hmcmt2d/ops/solver.py; this native solver is the host-side oracle the
// tests validate it against, and the self-contained CPU baseline for
// bench.py.  API is C (called from Python via ctypes), handles are opaque
// int64 ids like the reference's MUMPSfactorization pointers.

#include <complex>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

using cplx = std::complex<double>;

namespace {

struct BandFactor {
  int64_t n = 0;     // matrix order
  int64_t b = 0;     // half bandwidth
  // packed lower band of the LDL^T factors, column-major bands:
  // entry (i, j) with 0 <= i - j <= b lives at band[j * (b + 1) + (i - j)].
  // After factorisation: row 0 of each column holds D(j), rows 1..b hold
  // the unit-lower-triangular L(i, j).
  std::vector<cplx> band;
};

std::mutex g_mu;
std::map<int64_t, BandFactor> g_factors;
int64_t g_next_id = 1;

}  // namespace

extern "C" {

// Factorise the packed band (see layout above).  Returns a handle id > 0 on
// success, or a negative error code (-10: zero pivot, mirroring the
// reference's MUMPS error mapping, MUMPSfuncs.jl:59-73).
int64_t band_ldlt_factor(const double* ab_interleaved, int64_t n, int64_t b) {
  BandFactor f;
  f.n = n;
  f.b = b;
  const cplx* src = reinterpret_cast<const cplx*>(ab_interleaved);
  f.band.assign(src, src + static_cast<size_t>(n) * (b + 1));

  cplx* a = f.band.data();
  const int64_t w = b + 1;
  // Column-wise right-looking LDL^T restricted to the band.
  for (int64_t j = 0; j < n; ++j) {
    cplx d = a[j * w];
    if (d == cplx(0.0, 0.0)) return -10;
    const int64_t m = std::min(b, n - 1 - j);  // sub-diagonal entries
    // scale column j: L(i,j) = A(i,j) / d
    for (int64_t r = 1; r <= m; ++r) a[j * w + r] /= d;
    // trailing update: A(i,k) -= L(i,j) * d * L(k,j) for j < k <= i <= j+m
    for (int64_t k = j + 1; k <= j + m; ++k) {
      const cplx ldk = a[j * w + (k - j)] * d;  // d * L(k,j)
      cplx* colk = a + k * w;
      const cplx* colj = a + j * w;
      for (int64_t i = k; i <= j + m; ++i) {
        colk[i - k] -= colj[i - j] * ldk;
      }
    }
  }

  std::lock_guard<std::mutex> lock(g_mu);
  const int64_t id = g_next_id++;
  g_factors[id] = std::move(f);
  return id;
}

// Solve A X = B for nrhs right-hand sides (B column-major n x nrhs,
// interleaved re/im, overwritten with X).  The matrix is symmetric, so the
// transpose solve is identical (the reference's applyMUMPS `tr` flag is a
// no-op for sym=1 complex-symmetric factors).
int64_t band_ldlt_solve(int64_t id, double* b_interleaved, int64_t nrhs) {
  BandFactor* f;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_factors.find(id);
    if (it == g_factors.end()) return -1;
    f = &it->second;
  }
  const int64_t n = f->n, b = f->b, w = b + 1;
  const cplx* a = f->band.data();
  cplx* x = reinterpret_cast<cplx*>(b_interleaved);

  for (int64_t r = 0; r < nrhs; ++r) {
    cplx* v = x + r * n;
    // forward: L y = b
    for (int64_t j = 0; j < n; ++j) {
      const cplx vj = v[j];
      const int64_t m = std::min(b, n - 1 - j);
      const cplx* colj = a + j * w;
      for (int64_t i = 1; i <= m; ++i) v[j + i] -= colj[i] * vj;
    }
    // diagonal: D z = y
    for (int64_t j = 0; j < n; ++j) v[j] /= a[j * w];
    // backward: L^T x = z
    for (int64_t j = n - 1; j >= 0; --j) {
      const int64_t m = std::min(b, n - 1 - j);
      const cplx* colj = a + j * w;
      cplx s = v[j];
      for (int64_t i = 1; i <= m; ++i) s -= colj[i] * v[j + i];
      v[j] = s;
    }
  }
  return 0;
}

// Free the native factorisation (destroyMUMPS, MUMPSfuncs.jl:148-176).
int64_t band_ldlt_destroy(int64_t id) {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_factors.erase(id) ? 0 : -1;
}

// Number of live factorisations (leak checking in tests).
int64_t band_ldlt_live() {
  std::lock_guard<std::mutex> lock(g_mu);
  return static_cast<int64_t>(g_factors.size());
}

}  // extern "C"
