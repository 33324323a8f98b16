// The cell update of a stochastic red/black SOR (Gibbs) sweep, shared by
// the four full-sweep entry points of csrc/sweep_march.cu (#9, #8, #7,
// #6).  The kernel gathers a cell's value and its six neighbours from its
// shared-memory rings and calls sor_cell (D streamed) or sor_cell_pre (FD,
// the same roundings): one expression keeps the float operations, and the
// compiler's FMA contractions, the same on every launch plan and entry,
// so the entries agree bit for bit.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "noise.cuh"

namespace pmg {

// the six scalar off-diagonals, ordered (-e0, +e0, -e1, +e1, -e2, +e2)
struct StarCoeffs {
  float c0lo, c0hi, c1lo, c1hi, c2lo, c2hi;
};

// the diagonal at cell (i, j, k): read from d (kStreamD) or rebuilt as
// kappa2 + hinv2 * (in-grid link count)
template <bool kStreamD>
__device__ __forceinline__ float sweep_diag(const float* __restrict__ d,
                                            size_t id, int i, int j, int k,
                                            int n0, int n1, int n2,
                                            float kappa2, float hinv2) {
  if (kStreamD) return d[id];
  const float links = (float)((i >= 1) + (i <= n0 - 2) + (j >= 1) +
                              (j <= n1 - 2) + (k >= 1) + (k <= n2 - 2));
  return kappa2 + hinv2 * links;
}

// (1 - omega) xc + (omega / dv) (b~ - sum_nbr c x_nbr) with
// b~ = bv + nscale sqrt(dv) eta(prefix, id); lo0 .. hi2 are the neighbours
// along axes 0, 1, 2 (0 outside the grid)
__device__ __forceinline__ float sor_cell(float xc, float lo0, float hi0,
                                          float lo1, float hi1, float lo2,
                                          float hi2, const StarCoeffs& q,
                                          float dv, float bv, float omega,
                                          float nscale, uint32_t prefix,
                                          uint32_t id, int with_noise) {
  if (with_noise) bv = bv + nscale * sqrtf(dv) * eta(prefix, id);
  const float nb = q.c0lo * lo0 + q.c0hi * hi0 + q.c1lo * lo1 + q.c1hi * hi1 +
                   q.c2lo * lo2 + q.c2hi * hi2;
  return (1.f - omega) * xc + (omega / dv) * (bv - nb);
}

// sor_cell with the diagonal's two derived factors given: ns = nscale *
// sqrtf(dv) and wd = omega / dv, each rounded as sor_cell rounds it, so
// the result is sor_cell's bit for bit (the expression trees, and so the
// FMA contractions, are the same).  For the link-count FD diagonal, which
// takes 7 values, a kernel tabulates them once
__device__ __forceinline__ float sor_cell_pre(float xc, float lo0, float hi0, float lo1,
                                              float hi1, float lo2, float hi2,
                                              const StarCoeffs& q, float ns, float wd,
                                              float bv, float omega, uint32_t prefix,
                                              uint32_t id, int with_noise) {
  if (with_noise) bv = bv + ns * eta<true>(prefix, id);
  const float nb = q.c0lo * lo0 + q.c0hi * hi0 + q.c1lo * lo1 + q.c1hi * hi1 +
                   q.c2lo * lo2 + q.c2hi * hi2;
  return (1.f - omega) * xc + wd * (bv - nb);
}

}  // namespace pmg
