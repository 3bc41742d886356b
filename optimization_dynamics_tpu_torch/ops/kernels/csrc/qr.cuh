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
// N and K are template parameters. Up to N = UNROLL_MAX_N every loop is
// unrolled, so R, y and x are register arrays (they spill to local memory
// at N=10 in double); above (planar push's 35x35 systems) the loops stay
// rolled and the arrays live in local memory. The body is qr_body.cuh,
// instantiated for both.
#pragma once

#include "odt_common.cuh"

namespace odt {

#define ODT_QR_NAME qr_solve_unrolled
#define ODT_QR_UNROLL _Pragma("unroll")
#include "qr_body.cuh"
#undef ODT_QR_NAME
#undef ODT_QR_UNROLL

#define ODT_QR_NAME qr_solve_rolled
#define ODT_QR_UNROLL _Pragma("unroll 1")
#include "qr_body.cuh"
#undef ODT_QR_NAME
#undef ODT_QR_UNROLL

template <typename T, int N, int K>
__device__ __forceinline__ void qr_solve(T (&R)[N][N], T (&y)[N][K],
                                         T (&x)[N][K]) {
  if constexpr (N <= UNROLL_MAX_N)
    qr_solve_unrolled<T, N, K>(R, y, x);
  else
    qr_solve_rolled<T, N, K>(R, y, x);
}

}  // namespace odt
