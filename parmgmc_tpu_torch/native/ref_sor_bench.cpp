// Faithful single-core re-timing of the reference's hot loop, the CPU
// anchor of the port's baseline (examples/baseline_cpu_reference.py and
// examples/benchmark_matern.py --anchor-ranks in parmgmc_tpu_torch; the
// reference publishes no numbers).
//
// Reproduces the data movement and arithmetic of the reference's
// sequential multicolor SOR kernel (the reference's src/mc_sor.c:241-296):
// CSR rows swept color by color through index lists, off-diagonal dot per
// row, idiag = omega/diag cached, x updated in place.  Written from
// scratch against that description — structure is the standard CSR SOR
// loop, not copied code.  Also times the std-normal vector fill that
// precedes every Gibbs sweep (the reference's src/parmgmc.c:70-116,
// Box-Muller fallback path).
//
// Build: the host's g++ -O3 -shared -fPIC at first use (native/__init__.py).

#include <chrono>
#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

namespace {

double now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

// Time red/black SOR sweeps of the 7-point shifted-Laplace (kappa^2 - Lap)
// on an n^3 grid in CSR double precision, one core.
//   sec_sweep: seconds per full (two-color) SOR sweep
//   sec_fill : seconds per N(0,1) fill of one grid vector (Box-Muller)
// Returns the DOF count.
int64_t pmg_ref_sor_bench(int64_t n, int64_t nsweeps, double kappa2,
                          double hinv2, double omega, double* sec_sweep,
                          double* sec_fill) {
  const int64_t N = n * n * n;

  // --- CSR assembly (off-diagonals; diagonal kept separate like the
  //     reference's diagptr split) --------------------------------------
  std::vector<int64_t> rowptr(N + 1, 0);
  std::vector<int32_t> col(N * 6);
  std::vector<double> val(N * 6);
  std::vector<double> idiag(N);

  int64_t nnz = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      for (int64_t k = 0; k < n; ++k) {
        const int64_t r = (i * n + j) * n + k;
        int links = 0;
        const int64_t nbr[6] = {r - n * n, r + n * n, r - n,
                                r + n,     r - 1,     r + 1};
        const bool ok[6] = {i > 0, i < n - 1, j > 0,
                            j < n - 1, k > 0, k < n - 1};
        for (int m = 0; m < 6; ++m) {
          if (ok[m]) {
            col[nnz] = (int32_t)nbr[m];
            val[nnz] = -hinv2;
            ++nnz;
            ++links;
          }
        }
        rowptr[r + 1] = nnz;
        idiag[r] = omega / (kappa2 + hinv2 * links);
      }
    }
  }

  // --- red/black color index lists (JP coloring of a star stencil
  //     reduces to parity; mc_sor.c:383-395) ---------------------------
  std::vector<int32_t> colors[2];
  colors[0].reserve(N / 2 + 1);
  colors[1].reserve(N / 2 + 1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      for (int64_t k = 0; k < n; ++k)
        colors[(i + j + k) & 1].push_back((int32_t)((i * n + j) * n + k));

  std::vector<double> x(N, 0.0), b(N, 1.0);

  // --- std-normal fill timing (Box-Muller over a 64-bit PRNG, the
  //     reference's no-MKL fallback) -----------------------------------
  std::mt19937_64 rng(12345);
  const double t0f = now();
  double sink = 0.0;
  for (int64_t s = 0; s < nsweeps; ++s) {
    const double inv = 1.0 / 18446744073709551616.0;  // 2^-64
    for (int64_t r = 0; r + 1 < N; r += 2) {
      const double u1 = (rng() * inv) + 1e-18;
      const double u2 = rng() * inv;
      const double rad = std::sqrt(-2.0 * std::log(u1));
      b[r] = rad * std::cos(6.283185307179586 * u2);
      b[r + 1] = rad * std::sin(6.283185307179586 * u2);
    }
  }
  *sec_fill = (now() - t0f) / (double)nsweeps;
  sink += b[N / 2];

  // --- SOR sweep timing ------------------------------------------------
  const double t0 = now();
  for (int64_t s = 0; s < nsweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      const int32_t* rows = colors[c].data();
      const int64_t nc = (int64_t)colors[c].size();
      for (int64_t m = 0; m < nc; ++m) {
        const int32_t r = rows[m];
        double acc = b[r];
        for (int64_t jj = rowptr[r]; jj < rowptr[r + 1]; ++jj)
          acc -= val[jj] * x[col[jj]];
        x[r] = (1.0 - omega) * x[r] + idiag[r] * acc;
      }
    }
  }
  *sec_sweep = (now() - t0) / (double)nsweeps;

  // keep the optimizer honest
  if (x[N / 2] + sink == -1.0e301) *sec_sweep = -1.0;
  return N;
}

// Same hot loop on a CALLER-PROVIDED CSR matrix in colour-blocked row
// order (rows of one colour contiguous — the ordering GraphOperator
// establishes at setup), anchoring the UNSTRUCTURED (mesh) benchmark in
// a measurement.  Sweeping rows 0..N-1 in order IS the reference's
// colour-by-colour multicolor SOR (mc_sor.c:251-295) in that ordering.
//   rowptr/col/val: off-diagonal CSR (any nnz); diag: separate diagonal
//   (the reference's diagptr split).
int64_t pmg_ref_sor_bench_csr(int64_t N, const int64_t* rowptr,
                              const int32_t* col, const double* val,
                              const double* diag, int64_t nsweeps,
                              double omega, double* sec_sweep,
                              double* sec_fill) {
  std::vector<double> idiag(N);
  for (int64_t r = 0; r < N; ++r) idiag[r] = omega / diag[r];
  std::vector<double> x(N, 0.0), b(N, 1.0);

  std::mt19937_64 rng(12345);
  const double t0f = now();
  double sink = 0.0;
  for (int64_t s = 0; s < nsweeps; ++s) {
    const double inv = 1.0 / 18446744073709551616.0;  // 2^-64
    for (int64_t r = 0; r + 1 < N; r += 2) {
      const double u1 = (rng() * inv) + 1e-18;
      const double u2 = rng() * inv;
      const double rad = std::sqrt(-2.0 * std::log(u1));
      b[r] = rad * std::cos(6.283185307179586 * u2);
      b[r + 1] = rad * std::sin(6.283185307179586 * u2);
    }
  }
  *sec_fill = (now() - t0f) / (double)nsweeps;
  sink += b[N / 2];

  const double t0 = now();
  for (int64_t s = 0; s < nsweeps; ++s) {
    for (int64_t r = 0; r < N; ++r) {
      double acc = b[r];
      for (int64_t jj = rowptr[r]; jj < rowptr[r + 1]; ++jj)
        acc -= val[jj] * x[col[jj]];
      x[r] = (1.0 - omega) * x[r] + idiag[r] * acc;
    }
  }
  *sec_sweep = (now() - t0) / (double)nsweeps;

  if (x[N / 2] + sink == -1.0e301) *sec_sweep = -1.0;
  return N;
}

}  // extern "C"
