// Unpivoted Householder QR solve of one small dense system, a column a
// thread.
//
// The group-cooperative counterpart of qr.cuh's per-thread qr_solve,
// shared by K2 above UNROLL_MAX_N (batched_solve.cu: a 64-thread block a
// system) and K1 for cartpole (ip_tile.cuh: a 16-thread tile a scenario).
// G is a cooperative-groups group (thread_block or thread_block_tile<W>).
// Thread c = g.thread_rank() < N + K owns column c of the augmented
// system [A | b] and keeps it in registers (``col``); the other threads
// of the group only take part in the syncs.
//
// Each column's arithmetic is qr_body.cuh's, in the same order, so float64
// results match the per-thread solve to rounding. Step i:
//   * the owner of column i computes normsq, alpha, v, vnorm2 and inv as
//     qr_body.cuh does and writes v (rows >= i) and inv to shared memory;
//   * g.sync();
//   * every owner of a column c >= i (A's columns and the K right-hand
//     sides alike) computes w = sum_{r>=i} v[r] col[r] in row order and
//     updates col[r] = col[r] - (inv * v[r]) * w.
// v is double-buffered (step i writes buffer i % 2), so one sync a step
// suffices: the owner of step i + 2 passed step i + 1's sync, which every
// reader of step i's buffer reached only after its update.
// Back substitution: the owners of A's columns publish R's upper triangle
// to S (row-major, row stride ld, N x ld values), g.sync(), and the owner
// of right-hand side k runs qr_body.cuh's back substitution for its k on
// its own column (the K right-hand sides run in parallel). On return,
// thread N + k holds x[:, k] in ``col``.
//
// Shared memory: S (N * ld values, ld >= N) and vb (2 * (N + 1) values).
// Every loop index is a compile-time constant, so ``col`` stays in
// registers; the loops unroll fully (about N^2 statements a thread, not
// the N^3 of the per-thread solve), at N = 35 too.
#pragma once

#include "odt_common.cuh"

namespace odt {

template <int N, int K, typename G, typename T>
__device__ __forceinline__ void qr_solve_group(const G& g, T (&col)[N], T* S,
                                               int ld, T* vb) {
  const int c = static_cast<int>(g.thread_rank());
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T* v = vb + (i & 1) * (N + 1);  // v[r] for r >= i, then inv at v[N]
    if (c == i) {
      T normsq = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) normsq += col[r] * col[r];
      const T normx = sqrt(normsq);
      const T x0 = col[i];
      const T sign = x0 >= T(0) ? T(1) : T(-1);
      const T alpha = -sign * normx;
      T vnorm2 = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) {
        const T vr = r == i ? x0 - alpha : col[r];
        v[r] = vr;
        vnorm2 += vr * vr;
      }
      v[N] = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);
    }
    g.sync();
    if (c >= i && c < N + K) {
      const T inv = v[N];
      T w = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) w += v[r] * col[r];
#pragma unroll
      for (int r = i; r < N; ++r) col[r] = col[r] - (inv * v[r]) * w;
    }
  }

  if (c < N) {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r <= c) S[r * ld + c] = col[r];
  }
  g.sync();
  if (c >= N && c < N + K) {
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      const T diag = S[i * ld + i];
      const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
      T s = T(0);
#pragma unroll
      for (int j = i + 1; j < N; ++j) s += S[i * ld + j] * col[j];
      col[i] = (col[i] - s) / safe;
    }
  }
}

}  // namespace odt
