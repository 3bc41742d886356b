// Unpivoted Householder QR solve of one small dense system, per thread.
//
// The device function shared by the batched solve (K2) and the fused
// interior-point solve (K1). It computes what the reference's
// ``_qr_solve_block`` computes (optimization_dynamics_tpu/ops/pallas/
// batched_solve.py:34), in the same order: for each column i, the
// Householder vector v of the sub-column, ``inv = 2 / |v|^2`` (0 for a
// zero column), ``R <- R - (inv v) w^T`` on the columns >= i with
// ``w = v^T R``, the same reflection on the right-hand sides; then back
// substitution with a guarded diagonal (|d| <= 1e-30 divides by 1).
//
// N and K are template parameters and every loop is unrolled, so R, y and
// x are register arrays (they spill to local memory at N=10 in double).
#pragma once

#include "odt_common.cuh"

namespace odt {

template <typename T, int N, int K>
__device__ __forceinline__ void qr_solve(T (&R)[N][N], T (&y)[N][K],
                                         T (&x)[N][K]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T normsq = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) normsq += R[r][i] * R[r][i];
    const T normx = sqrt(normsq);
    const T x0 = R[i][i];
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * normx;
    T v[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
      v[r] = r < i ? T(0) : (r == i ? x0 - alpha : R[r][i]);
    T vnorm2 = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) vnorm2 += v[r] * v[r];
    const T inv = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);

#pragma unroll
    for (int c = i; c < N; ++c) {
      T w = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) w += v[r] * R[r][c];
#pragma unroll
      for (int r = i; r < N; ++r) R[r][c] = R[r][c] - (inv * v[r]) * w;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T wy = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) wy += v[r] * y[r][k];
#pragma unroll
      for (int r = i; r < N; ++r) y[r][k] = y[r][k] - (inv * v[r]) * wy;
    }
  }

#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const T diag = R[i][i];
    const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T s = T(0);
#pragma unroll
      for (int j = i + 1; j < N; ++j) s += R[i][j] * x[j][k];
      x[i][k] = (y[i][k] - s) / safe;
    }
  }
}

}  // namespace odt
