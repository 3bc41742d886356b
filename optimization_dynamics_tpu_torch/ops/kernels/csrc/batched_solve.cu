// K2: A x = b for a batch of small dense systems with K right-hand sides.
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/pallas/
// batched_solve.py (batched_solve). See ops/kernels/batched_solve.py for
// the design note.
//
// Layout: A (B, N, N) and b (B, N, K) at any element strides between
// systems and between rows (SolveStrides), a row's entries adjacent: the
// IFT Jacobians of batched_jacobian come interleaved, row r of every
// system before row r + 1 (strides (N, B N, 1)), and are read as they
// are; x (B, N, K) is contiguous.
// Shapes: (10, 8) and (10, 1) for cartpole's IFT and Newton solves, (35,
// 13) for planar push's IFT solve, (6, 6) for the acrobot's IFT solve and
// (2, 1), (2, 6) for the Newton and IFT solves of the acrobot without
// joint limits, (20, 1), (20, 13) for the hopper model's and (12, 1),
// (12, 16), (10, 1), (10, 4) for the rocket's midpoint and
// thrust-projection solves (the Newton solves at (20, 1) and (10, 1) run
// inside K1 on a deploy; the shapes stay compiled and tested).
//
// Four kernels:
// * N <= UNROLL_MAX_N, narrow launches (the wrapper's cut,
//   BATCHED_SOLVE_TILE_MAX_B), every shape but (12, 1): the tile kernel, a
//   tile of W = solve_tile_width<N, K>()
//   threads a system (the smallest power of two >= N + K), the
//   column-per-thread QR of qr_group.cuh on a thread_block_tile<W>,
//   SOLVE_TILE_BLOCK / W systems a block. The block stages its systems'
//   A and b through shared memory with loads over all its threads
//   (neighbouring threads read neighbouring words), each thread takes its
//   column into registers, and x goes back the same way;
// * (12, 1), narrow launches: the shuffle kernel, a 16-lane tile a system
//   that loads its columns straight into registers and solves with
//   qr_solve_shfl (qr_shfl.cuh), no shared memory and no barrier. The
//   rocket's midpoint Newton steps are launched 32-1,024 systems wide
//   (PERF.md section 6): there a thread a system fills a few SMs with
//   one long serial chain each, and the tile kernel's staging through
//   shared memory and its barrier a reflector step lost to it at every
//   width;
// * N <= UNROLL_MAX_N, wide launches: one thread a system, the per-thread
//   QR of qr.cuh with every loop unrolled (the system lives in
//   registers);
// * N > UNROLL_MAX_N: one 64-thread block a system, the column-per-thread
//   QR of qr_group.cuh, staged through shared memory as the tile kernel.
// All four run qr_body.cuh's steps in its order. The tile and group
// kernels agree with the rolled per-thread QR bit for bit (the shuffle
// kernel runs their expressions, from registers); the unrolled
// one (N <= UNROLL_MAX_N) rounds some squares apart from their sums where
// qr_group.cuh fuses them (nvcc shares v[r] * v[r] = R[r][i]^2 between
// the norms and the pivot column's product), so there the tile and
// per-thread kernels agree to rounding.
#include <cooperative_groups.h>

#include <cstdint>

#include "odt_common.cuh"
#include "qr.cuh"
#include "qr_group.cuh"
#include "qr_shfl.cuh"

namespace odt {

// element strides of A and b between systems and between rows
struct SolveStrides {
  int64_t a_sys, a_row, b_sys, b_row;
};

template <typename T, int N, int K>
__global__ void __launch_bounds__(128)
batched_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                     T* __restrict__ x, int B, SolveStrides st) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const T* As = A + s * st.a_sys;
  const T* bs = b + s * st.b_sys;
  T R[N][N], y[N][K], xs[N][K];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) R[r][c] = As[r * st.a_row + c];
#pragma unroll
    for (int k = 0; k < K; ++k) y[r][k] = bs[r * st.b_row + k];
  }
  qr_solve<T, N, K>(R, y, xs);
  T* out = x + (int64_t)s * N * K;
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[r * K + k] = xs[r][k];
  }
}

// one system a block; 64 threads cover the N + K columns of (35, 13),
// and of the hopper's (20, 1) and (20, 13)
constexpr int GROUP_SOLVE_THREADS = 64;

template <typename T, int N, int K>
__global__ void __launch_bounds__(GROUP_SOLVE_THREADS)
batched_solve_group_kernel(const T* __restrict__ A, const T* __restrict__ b,
                           T* __restrict__ x, SolveStrides st) {
  namespace cg = cooperative_groups;
  static_assert(N + K <= GROUP_SOLVE_THREADS, "a column a thread");
  constexpr int LD = N + K;
  __shared__ T S[N * LD];
  __shared__ T vb[2 * (N + 1)];
  const cg::thread_block g = cg::this_thread_block();
  const int c = static_cast<int>(g.thread_rank());
  const T* As = A + blockIdx.x * st.a_sys;
  const T* bs = b + blockIdx.x * st.b_sys;
  for (int e = c; e < N * N; e += GROUP_SOLVE_THREADS)
    S[(e / N) * LD + e % N] = As[(e / N) * st.a_row + e % N];
  for (int e = c; e < N * K; e += GROUP_SOLVE_THREADS)
    S[(e / K) * LD + N + e % K] = bs[(e / K) * st.b_row + e % K];
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
                         SolveStrides st, void* stream) {
  if (B <= 0) return 0;
  if constexpr (N > UNROLL_MAX_N) {
    batched_solve_group_kernel<T, N, K>
        <<<B, GROUP_SOLVE_THREADS, 0, (cudaStream_t)stream>>>(
            static_cast<const T*>(A), static_cast<const T*>(b),
            static_cast<T*>(x), st);
  } else {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    batched_solve_kernel<T, N, K>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            static_cast<const T*>(A), static_cast<const T*>(b),
            static_cast<T*>(x), B, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// threads a system of the tile kernel: the smallest power of two that
// holds the N + K columns of [A | b], so a warp holds whole tiles
template <int N, int K>
__host__ __device__ constexpr int solve_tile_width() {
  int w = 1;
  while (w < N + K) w *= 2;
  return w;
}

// threads a block of the tile kernel
constexpr int SOLVE_TILE_BLOCK = 128;

// The tile kernel's staging: TILES systems' R x C blocks, system s's from
// src + s * sys + r * row + c, into S[s][r * LD + OFF + c], for the first
// `systems` of them. Consecutive threads take consecutive entries of a
// row, then the next system's row where systems are interleaved row by
// row (row > sys), else the system's next row: so the block reads
// runs of adjacent words either way.
template <int R, int C, int TILES, int LD, int OFF, typename T, int SLAB>
__device__ __forceinline__ void stage_systems(T (*S)[SLAB],
                                              const T* __restrict__ src,
                                              int64_t sys, int64_t row,
                                              int systems, int tid) {
  const bool interleaved = row > sys;
  for (int e = tid; e < TILES * R * C; e += SOLVE_TILE_BLOCK) {
    const int c = e % C;
    const int s = interleaved ? (e / C) % TILES : e / (R * C);
    const int r = interleaved ? e / (C * TILES) : (e / C) % R;
    if (s < systems) S[s][r * LD + OFF + c] = src[s * sys + r * row + c];
  }
}

template <typename T, int N, int K>
__global__ void __launch_bounds__(SOLVE_TILE_BLOCK)
batched_solve_tile_kernel(const T* __restrict__ A, const T* __restrict__ b,
                          T* __restrict__ x, int B, SolveStrides st) {
  namespace cg = cooperative_groups;
  constexpr int W = solve_tile_width<N, K>();
  static_assert(N <= UNROLL_MAX_N && W <= 32 && SOLVE_TILE_BLOCK % W == 0,
                "a warp and a block hold whole tiles");
  constexpr int TILES = SOLVE_TILE_BLOCK / W;
  constexpr int LD = N + K;
  __shared__ T S[TILES][N * LD];
  __shared__ T vb[TILES][2 * (N + 1)];
  const int first = blockIdx.x * TILES;
  const int systems = min(TILES, B - first);
  const int tid = static_cast<int>(threadIdx.x);
  stage_systems<N, N, TILES, LD, 0>(S, A + first * st.a_sys, st.a_sys,
                                    st.a_row, systems, tid);
  stage_systems<N, K, TILES, LD, N>(S, b + first * st.b_sys, st.b_sys,
                                    st.b_row, systems, tid);
  __syncthreads();
  const cg::thread_block_tile<W> tile =
      cg::tiled_partition<W>(cg::this_thread_block());
  const int sys = tid / W;
  if (sys < systems) {  // a tile past B skips the solve, not the syncs
    const int c = static_cast<int>(tile.thread_rank());
    T col[N];
    if (c < LD) {
#pragma unroll
      for (int r = 0; r < N; ++r) col[r] = S[sys][r * LD + c];
    }
    qr_solve_group<N, K>(tile, col, S[sys], LD, vb[sys]);
    if (c >= N && c < LD) {
#pragma unroll
      for (int r = 0; r < N; ++r) S[sys][r * LD + c] = col[r];
    }
  }
  __syncthreads();
  T* xs = x + (int64_t)first * N * K;
  for (int e = tid; e < systems * N * K; e += SOLVE_TILE_BLOCK) {
    const int r = e % (N * K);
    xs[e] = S[e / (N * K)][(r / K) * LD + N + r % K];
  }
}

template <typename T, int N, int K>
int launch_batched_solve_tile(const void* A, const void* b, void* x, int B,
                              SolveStrides st, void* stream) {
  if (B <= 0) return 0;
  constexpr int tiles = SOLVE_TILE_BLOCK / solve_tile_width<N, K>();
  batched_solve_tile_kernel<T, N, K>
      <<<(B + tiles - 1) / tiles, SOLVE_TILE_BLOCK, 0,
         (cudaStream_t)stream>>>(static_cast<const T*>(A),
                                 static_cast<const T*>(b),
                                 static_cast<T*>(x), B, st);
  return static_cast<int>(cudaGetLastError());
}

// The shuffle kernel, at (12, 1) (the rocket's midpoint Newton steps):
// a tile of W = solve_tile_width<N, 1>() lanes a system (16 at (12, 1),
// two systems a warp), SOLVE_SHFL_BLOCK / W systems a block. Lane c < N
// loads column c of A and lane N the right-hand side straight from their
// strides into registers (row r of the warp's two systems is one run of
// adjacent words in the row-interleaved layout the solver passes), the
// solve is qr_solve_shfl (qr_shfl.cuh: shuffles, no shared memory, no
// barrier), and lane r writes x[r]. Lanes of a system past B load zeros
// and take part in the shuffles (which name the whole warp), writing
// nothing.
constexpr int SOLVE_SHFL_BLOCK = 64;

template <typename T, int N, int K>
__global__ void __launch_bounds__(SOLVE_SHFL_BLOCK)
batched_solve_shfl_kernel(const T* __restrict__ A, const T* __restrict__ b,
                          T* __restrict__ x, int B, SolveStrides st) {
  static_assert(K == 1 && N <= UNROLL_MAX_N, "one right-hand side");
  constexpr int W = solve_tile_width<N, K>();
  static_assert(SOLVE_SHFL_BLOCK % 32 == 0 && 32 % W == 0,
                "a warp holds whole tiles");
  const int64_t s =
      ((int64_t)blockIdx.x * SOLVE_SHFL_BLOCK + threadIdx.x) / W;
  const int c = static_cast<int>(threadIdx.x) % W;
  const bool live = s < B && c <= N;
  const T* src = c < N ? A + s * st.a_sys + c : b + s * st.b_sys;
  const int64_t stride = c < N ? st.a_row : st.b_row;
  T col[N];
#pragma unroll
  for (int r = 0; r < N; ++r) col[r] = live ? src[r * stride] : T(0);
  T xs[N];
  qr_solve_shfl<N, W>(c, col, xs);
  if (s < B) {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r == c) x[s * N + r] = xs[r];
  }
}

template <typename T, int N, int K>
int launch_batched_solve_shfl(const void* A, const void* b, void* x, int B,
                              SolveStrides st, void* stream) {
  if (B <= 0) return 0;
  constexpr int per_block = SOLVE_SHFL_BLOCK / solve_tile_width<N, K>();
  batched_solve_shfl_kernel<T, N, K>
      <<<(B + per_block - 1) / per_block, SOLVE_SHFL_BLOCK, 0,
         (cudaStream_t)stream>>>(static_cast<const T*>(A),
                                 static_cast<const T*>(b),
                                 static_cast<T*>(x), B, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

// entry points: A, b, x, B, A's and b's strides between systems and
// between rows (elements), stream
#define ODT_BATCHED_SOLVE(N, K, SUFFIX, T)                                  \
  int odt_batched_solve_n##N##_k##K##_##SUFFIX(                             \
      const void* A, const void* b, void* x, int B, int64_t a_sys,          \
      int64_t a_row, int64_t b_sys, int64_t b_row, void* stream) {          \
    return odt::launch_batched_solve<T, N, K>(                              \
        A, b, x, B, odt::SolveStrides{a_sys, a_row, b_sys, b_row}, stream); \
  }

#define ODT_BATCHED_SOLVE_TILE(N, K, SUFFIX, T)                             \
  int odt_batched_solve_tile_n##N##_k##K##_##SUFFIX(                        \
      const void* A, const void* b, void* x, int B, int64_t a_sys,          \
      int64_t a_row, int64_t b_sys, int64_t b_row, void* stream) {          \
    return odt::launch_batched_solve_tile<T, N, K>(                         \
        A, b, x, B, odt::SolveStrides{a_sys, a_row, b_sys, b_row}, stream); \
  }

#define ODT_BATCHED_SOLVE_SHFL(N, K, SUFFIX, T)                             \
  int odt_batched_solve_shfl_n##N##_k##K##_##SUFFIX(                        \
      const void* A, const void* b, void* x, int B, int64_t a_sys,          \
      int64_t a_row, int64_t b_sys, int64_t b_row, void* stream) {          \
    return odt::launch_batched_solve_shfl<T, N, K>(                         \
        A, b, x, B, odt::SolveStrides{a_sys, a_row, b_sys, b_row}, stream); \
  }

// one line per (n, k) of BATCHED_SOLVE_SHAPES in ops/kernels/_build.py; the
// narrow kernel for n <= UNROLL_MAX_N (the shuffle kernel at
// BATCHED_SOLVE_SHFL_SHAPES, the tile kernel at the others)
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
ODT_BATCHED_SOLVE(20, 1, f32, float)
ODT_BATCHED_SOLVE(20, 1, f64, double)
ODT_BATCHED_SOLVE(20, 13, f32, float)
ODT_BATCHED_SOLVE(20, 13, f64, double)
ODT_BATCHED_SOLVE(12, 1, f32, float)
ODT_BATCHED_SOLVE(12, 1, f64, double)
ODT_BATCHED_SOLVE(12, 16, f32, float)
ODT_BATCHED_SOLVE(12, 16, f64, double)
ODT_BATCHED_SOLVE(10, 4, f32, float)
ODT_BATCHED_SOLVE(10, 4, f64, double)
ODT_BATCHED_SOLVE_TILE(10, 8, f32, float)
ODT_BATCHED_SOLVE_TILE(10, 8, f64, double)
ODT_BATCHED_SOLVE_TILE(10, 1, f32, float)
ODT_BATCHED_SOLVE_TILE(10, 1, f64, double)
ODT_BATCHED_SOLVE_TILE(6, 6, f32, float)
ODT_BATCHED_SOLVE_TILE(6, 6, f64, double)
ODT_BATCHED_SOLVE_TILE(2, 1, f32, float)
ODT_BATCHED_SOLVE_TILE(2, 1, f64, double)
ODT_BATCHED_SOLVE_TILE(2, 6, f32, float)
ODT_BATCHED_SOLVE_TILE(2, 6, f64, double)
ODT_BATCHED_SOLVE_TILE(12, 16, f32, float)
ODT_BATCHED_SOLVE_TILE(12, 16, f64, double)
ODT_BATCHED_SOLVE_TILE(10, 4, f32, float)
ODT_BATCHED_SOLVE_TILE(10, 4, f64, double)
ODT_BATCHED_SOLVE_SHFL(12, 1, f32, float)
ODT_BATCHED_SOLVE_SHFL(12, 1, f64, double)
}  // extern "C"
