// K2: A x = b for a batch of small dense systems with K right-hand sides,
// one thread per system, through the QR device function that K1 uses.
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/pallas/
// batched_solve.py (batched_solve). See ops/kernels/batched_solve.py for
// the design note.
//
// Layout: A (B, N, N), b and x (B, N, K), row-major and contiguous.
// Shapes: (10, 8) and (10, 1) for cartpole's IFT and Newton solves, (35,
// 13) for planar push's IFT solve, (6, 6) for the acrobot's IFT solve and
// (2, 1), (2, 6) for the Newton and IFT solves of the acrobot without
// joint limits (no fused-IP functor); above UNROLL_MAX_N (odt_common.cuh)
// the QR's loops stay rolled and the system lives in local memory.
#include <cstdint>

#include "odt_common.cuh"
#include "qr.cuh"

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

template <typename T, int N, int K>
int launch_batched_solve(const void* A, const void* b, void* x, int B,
                         void* stream) {
  if (B <= 0) return 0;
  // 32 threads a block for the local-memory systems, as K1n
  const int threads = N <= UNROLL_MAX_N ? 128 : 32;
  const int blocks = (B + threads - 1) / threads;
  batched_solve_kernel<T, N, K><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x),
      B);
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
