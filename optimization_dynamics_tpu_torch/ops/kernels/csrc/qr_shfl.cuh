// Unpivoted Householder QR solve of one small dense system with one
// right-hand side, held in registers by W lanes of a warp and
// synchronised by register shuffles alone: no shared memory, no barrier.
//
// The shuffle counterpart of qr_group.cuh at K = 1, shared by K1's warp
// kernel on the rocket's thrust projection (ip_warp.cuh, N = 10, W = 32)
// and K2's shuffle kernel at the rocket's (12, 1) (batched_solve.cu, N =
// 12, W = 16, two systems a warp). Lane c = lane % W < N owns column c of
// A, lane N owns b, each in ``col``; lanes above N hold anything and only
// take part in the shuffles. Every lane of the warp calls it together
// (the shuffles name the full warp), W a power of two <= 32.
//
// Each step and the back substitution run qr_body.cuh's arithmetic in
// its order; only where the operands come from differs:
//   * step i: every lane holds the pivot column i (``piv``, updated
//     through step i - 1) and computes normsq, alpha, v, vnorm2 and inv
//     from it itself, with qr_body.cuh's serial sums, so every lane holds
//     the same bits; every owner of a column c >= i (A's and b's alike)
//     computes w = sum_{r>=i} v[r] col[r] in row order and updates col[r]
//     -= (inv v[r]) w, as qr_group.cuh does after its barrier (every lane
//     computes it, the owners keep it: no divergent branch);
//   * the next pivot: at the start of step i every lane takes column i + 1
//     from its owner by shuffles, before the owner's own step-i update,
//     and applies step i's update to that copy with the owner's
//     expressions, so it has the owner's bits when step i + 1 starts
//     without waiting for a shuffle of the updated column;
//   * back substitution: every lane takes R's row i from its owners
//     (R[i][j] is col[i] of lane j), one row ahead of the chain, and the
//     reflected b from lane N, and runs the serial back substitution
//     itself (sum in j order, guarded diagonal).
// On return every lane holds x in ``x``.
//
// What bounds it: the chain of a step (the pivot's sums, a square root
// and a division, 4, 47 and 48 cycles of latency a link in float32 on
// the H100, PERF.md section 6) and the back substitution's chain of N
// divisions; one warp a solve has nothing to hide them behind, so the
// design keeps every other cycle off that chain.
#pragma once

#include "odt_common.cuh"

namespace odt {

constexpr unsigned FULL_WARP = 0xffffffffu;

template <int N, int W, typename T>
__device__ __forceinline__ void qr_solve_shfl(int c, T (&col)[N],
                                              T (&x)[N]) {
  static_assert(N + 1 <= W && W <= 32 && (W & (W - 1)) == 0,
                "W lanes hold the N columns of A and b");
  T piv[N];
#pragma unroll
  for (int r = 0; r < N; ++r) piv[r] = __shfl_sync(FULL_WARP, col[r], 0, W);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // column i + 1 as its owner holds it before step i
    T nxt[N];
    if (i + 1 < N) {
#pragma unroll
      for (int r = i; r < N; ++r)
        nxt[r] = __shfl_sync(FULL_WARP, col[r], i + 1, W);
    }
    T normsq = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) normsq += piv[r] * piv[r];
    const T normx = sqrt(normsq);
    const T x0 = piv[i];
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * normx;
    T v[N];
    T vnorm2 = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) {
      v[r] = r == i ? x0 - alpha : piv[r];
      vnorm2 += v[r] * v[r];
    }
    const T inv = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);
    const bool owner = c >= i && c <= N;
    T w = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) w += v[r] * col[r];
#pragma unroll
    for (int r = i; r < N; ++r) {
      const T u = col[r] - (inv * v[r]) * w;
      col[r] = owner ? u : col[r];
    }
    if (i + 1 < N) {
      T wn = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) wn += v[r] * nxt[r];
#pragma unroll
      for (int r = i; r < N; ++r) piv[r] = nxt[r] - (inv * v[r]) * wn;
    }
  }

  T y[N], Ri[N];
#pragma unroll
  for (int r = 0; r < N; ++r) y[r] = __shfl_sync(FULL_WARP, col[r], N, W);
#pragma unroll
  for (int j = N - 1; j < N; ++j)
    Ri[j] = __shfl_sync(FULL_WARP, col[N - 1], j, W);
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    // row i - 1 of R, fetched while row i's chain runs
    T Rn[N];
    if (i > 0) {
#pragma unroll
      for (int j = i - 1; j < N; ++j)
        Rn[j] = __shfl_sync(FULL_WARP, col[i - 1], j, W);
    }
    const T diag = Ri[i];
    const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
    T s = T(0);
#pragma unroll
    for (int j = i + 1; j < N; ++j) s += Ri[j] * x[j];
    x[i] = (y[i] - s) / safe;
    if (i > 0) {
#pragma unroll
      for (int j = i - 1; j < N; ++j) Ri[j] = Rn[j];
    }
  }
}

}  // namespace odt
