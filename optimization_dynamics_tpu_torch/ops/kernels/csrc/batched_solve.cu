// K2: A x = b for a batch of small dense systems with K right-hand sides.
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/pallas/
// batched_solve.py (batched_solve). See ops/kernels/batched_solve.py for
// the design note.
//
// Layout: A (B, N, N), b and x (B, N, K), row-major and contiguous.
// Shapes: (10, 8) and (10, 1) for cartpole's IFT and Newton solves, (35,
// 13) for planar push's IFT solve, (6, 6) for the acrobot's IFT solve and
// (2, 1), (2, 6) for the Newton and IFT solves of the acrobot without
// joint limits (no fused-IP functor).
//
// Two kernels, chosen by N at compile time:
// * N <= UNROLL_MAX_N: one thread a system, the per-thread QR of qr.cuh
//   with every loop unrolled (the system lives in registers);
// * N > UNROLL_MAX_N: one 64-thread block a system, the column-per-thread
//   QR of qr_group.cuh. The block stages A and b through shared memory
//   with loads over all its threads (neighbouring threads read
//   neighbouring words, so they coalesce), each thread takes its column
//   into registers, and x goes back the same way.
#include <cooperative_groups.h>

#include <cstdint>

#include "odt_common.cuh"
#include "qr.cuh"
#include "qr_group.cuh"

namespace odt {

template <typename T, int N, int K>
__global__ void __launch_bounds__(128)
batched_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                     T* __restrict__ x, int B) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const T* As = A + (int64_t)s * N * N;
  const T* bs = b + (int64_t)s * N * K;
  T R[N][N], y[N][K], xs[N][K];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) R[r][c] = As[r * N + c];
#pragma unroll
    for (int k = 0; k < K; ++k) y[r][k] = bs[r * K + k];
  }
  qr_solve<T, N, K>(R, y, xs);
  T* out = x + (int64_t)s * N * K;
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[r * K + k] = xs[r][k];
  }
}

// one system a block; 64 threads cover the N + K columns of (35, 13)
constexpr int GROUP_SOLVE_THREADS = 64;

template <typename T, int N, int K>
__global__ void __launch_bounds__(GROUP_SOLVE_THREADS)
batched_solve_group_kernel(const T* __restrict__ A, const T* __restrict__ b,
                           T* __restrict__ x) {
  namespace cg = cooperative_groups;
  static_assert(N + K <= GROUP_SOLVE_THREADS, "a column a thread");
  constexpr int LD = N + K;
  __shared__ T S[N * LD];
  __shared__ T vb[2 * (N + 1)];
  const cg::thread_block g = cg::this_thread_block();
  const int c = static_cast<int>(g.thread_rank());
  const T* As = A + (int64_t)blockIdx.x * N * N;
  const T* bs = b + (int64_t)blockIdx.x * N * K;
  for (int e = c; e < N * N; e += GROUP_SOLVE_THREADS)
    S[(e / N) * LD + e % N] = As[e];
  for (int e = c; e < N * K; e += GROUP_SOLVE_THREADS)
    S[(e / K) * LD + N + e % K] = bs[e];
  g.sync();
  T col[N];
  if (c < LD) {
#pragma unroll
    for (int r = 0; r < N; ++r) col[r] = S[r * LD + c];
  }
  qr_solve_group<N, K>(g, col, S, LD, vb);
  if (c >= N && c < LD) {
#pragma unroll
    for (int r = 0; r < N; ++r) S[r * LD + c] = col[r];
  }
  g.sync();
  T* xs = x + (int64_t)blockIdx.x * N * K;
  for (int e = c; e < N * K; e += GROUP_SOLVE_THREADS)
    xs[e] = S[(e / K) * LD + N + e % K];
}

template <typename T, int N, int K>
int launch_batched_solve(const void* A, const void* b, void* x, int B,
                         void* stream) {
  if (B <= 0) return 0;
  if constexpr (N > UNROLL_MAX_N) {
    batched_solve_group_kernel<T, N, K>
        <<<B, GROUP_SOLVE_THREADS, 0, (cudaStream_t)stream>>>(
            static_cast<const T*>(A), static_cast<const T*>(b),
            static_cast<T*>(x));
  } else {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    batched_solve_kernel<T, N, K>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            static_cast<const T*>(A), static_cast<const T*>(b),
            static_cast<T*>(x), B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

#define ODT_BATCHED_SOLVE(N, K, SUFFIX, T)                                  \
  int odt_batched_solve_n##N##_k##K##_##SUFFIX(const void* A, const void* b, \
                                               void* x, int B,              \
                                               void* stream) {              \
    return odt::launch_batched_solve<T, N, K>(A, b, x, B, stream);          \
  }

extern "C" {
ODT_BATCHED_SOLVE(10, 8, f32, float)
ODT_BATCHED_SOLVE(10, 8, f64, double)
ODT_BATCHED_SOLVE(10, 1, f32, float)
ODT_BATCHED_SOLVE(10, 1, f64, double)
ODT_BATCHED_SOLVE(35, 13, f32, float)
ODT_BATCHED_SOLVE(35, 13, f64, double)
ODT_BATCHED_SOLVE(6, 6, f32, float)
ODT_BATCHED_SOLVE(6, 6, f64, double)
ODT_BATCHED_SOLVE(2, 1, f32, float)
ODT_BATCHED_SOLVE(2, 1, f64, double)
ODT_BATCHED_SOLVE(2, 6, f32, float)
ODT_BATCHED_SOLVE(2, 6, f64, double)
}  // extern "C"
