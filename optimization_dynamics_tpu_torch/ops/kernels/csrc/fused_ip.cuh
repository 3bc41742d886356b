// The fused IP kernels and their launchers, instantiated per device
// functor in a source file of its own (fused_ip.cu: K1, cartpole;
// fused_ip_push.cu: K1n, planar push; fused_ip_acrobot.cu: K1a, acrobot),
// so nvcc builds them in parallel. See ops/kernels/fused_ip.py for the
// design note. Two kernels:
// * fused_ip_kernel (ODT_FUSED_IP): one thread a scenario; the per-lane
//   solve is ip_solve_lane (ip_body.cuh), which K4 shares;
// * fused_ip_tile_kernel (ODT_FUSED_IP_TILE): one tile of
//   ip_tile_width<M>() threads a scenario (16 for cartpole, 8 for the
//   acrobot), 64-thread blocks; the solve is ip_solve_tile (ip_tile.cuh),
//   which K4's tile kernel shares. It takes any functor with NZ + 1 <= 32;
// * fused_ip_group_kernel (ODT_FUSED_IP_GROUP): one group of
//   IP_GROUP_THREADS = 64 threads a scenario, for functors whose NZ + 1
//   columns do not fit a warp (K1n, planar push); the solve is
//   ip_solve_group (ip_group.cuh).
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "ip_body.cuh"
#include "ip_group.cuh"
#include "ip_tile.cuh"

namespace odt {

template <typename T, typename M>
__global__ void __launch_bounds__(128)
fused_ip_kernel(const T* __restrict__ z0s, const T* __restrict__ ths,
                T* __restrict__ zs_out, T* __restrict__ stats, int B,
                M model, IPParams<T> p) {
  constexpr int NZ = M::NZ;
  constexpr int NTH = M::NTH;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  T z[NZ], th[NTH], st[4];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = z0s[(int64_t)lane * NZ + i];
#pragma unroll
  for (int i = 0; i < NTH; ++i) th[i] = ths[(int64_t)lane * NTH + i];

  ip_solve_lane<T, M>(z, th, model, p, st);

#pragma unroll
  for (int i = 0; i < NZ; ++i) zs_out[(int64_t)lane * NZ + i] = z[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) stats[(int64_t)lane * 4 + i] = st[i];
}

template <typename T, typename M>
int launch_fused_ip(const void* z0s, const void* ths, void* zs, void* stats,
                    int B, const double* model_params, const double* ip,
                    void* stream) {
  if (B <= 0) return 0;
  const IPParams<T> p = make_ip_params<T>(ip);
  const M model(model_params);
  // 128 threads a block for the register-resident systems; 32 for the
  // local-memory ones, as the reference's 32-lane blocks, so a sweep's
  // few thousand lanes still spread over the SMs
  const int threads = M::NZ <= UNROLL_MAX_N ? 128 : 32;
  const int blocks = (B + threads - 1) / threads;
  fused_ip_kernel<T, M><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(z0s), static_cast<const T*>(ths),
      static_cast<T*>(zs), static_cast<T*>(stats), B, model, p);
  return static_cast<int>(cudaGetLastError());
}

// One tile a scenario. A tile whose scenario is past B returns as a
// whole, before any sync; after the loads there is no block-level
// barrier, so the tiles of a block stop at their own iterations.
template <typename T, typename M>
__global__ void __launch_bounds__(IP_TILE_BLOCK, IP_TILE_MIN_BLOCKS)
fused_ip_tile_kernel(const T* __restrict__ z0s, const T* __restrict__ ths,
                     T* __restrict__ zs_out, T* __restrict__ stats, int B,
                     M model, IPParams<T> p) {
  namespace cg = cooperative_groups;
  constexpr int NZ = M::NZ;
  constexpr int NTH = M::NTH;
  constexpr int W = ip_tile_width<M>();
  constexpr int TILES = ip_tiles_per_block<M>();
  __shared__ T S[TILES][NZ * (NZ + 1)];
  __shared__ T vb[TILES][2 * (NZ + 1)];
  const cg::thread_block_tile<W> tile =
      cg::tiled_partition<W>(cg::this_thread_block());
  const int t = threadIdx.x / W;
  const int64_t lane = (int64_t)blockIdx.x * TILES + t;
  if (lane >= B) return;

  T z[NZ], th[NTH], st[4];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = z0s[lane * NZ + i];
#pragma unroll
  for (int i = 0; i < NTH; ++i) th[i] = ths[lane * NTH + i];

  ip_solve_tile<T, M, W>(tile, z, th, model, p, st, S[t], vb[t]);

  const int rank = static_cast<int>(tile.thread_rank());
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    if (i % W == rank) zs_out[lane * NZ + i] = z[i];
  if (rank == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) stats[lane * 4 + i] = st[i];
  }
}

template <typename T, typename M>
int launch_fused_ip_tile(const void* z0s, const void* ths, void* zs,
                         void* stats, int B, const double* model_params,
                         const double* ip, void* stream) {
  if (B <= 0) return 0;
  const IPParams<T> p = make_ip_params<T>(ip);
  const M model(model_params);
  constexpr int tiles = ip_tiles_per_block<M>();
  const int blocks = (B + tiles - 1) / tiles;
  fused_ip_tile_kernel<T, M>
      <<<blocks, IP_TILE_BLOCK, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(z0s), static_cast<const T*>(ths),
          static_cast<T*>(zs), static_cast<T*>(stats), B, model, p);
  return static_cast<int>(cudaGetLastError());
}

// One group of IP_GROUP_THREADS threads a scenario, IP_GROUP_BLOCK /
// IP_GROUP_THREADS groups a block, each syncing on its own named barrier.
// A group whose scenario is past B returns as a whole, before any sync.
template <typename T, typename M>
__global__ void __launch_bounds__(IP_GROUP_BLOCK, IP_GROUP_MIN_BLOCKS)
fused_ip_group_kernel(const T* __restrict__ z0s, const T* __restrict__ ths,
                      T* __restrict__ zs_out, T* __restrict__ stats, int B,
                      M model, IPParams<T> p) {
  constexpr int NZ = M::NZ;
  constexpr int NTH = M::NTH;
  constexpr int GROUPS = ip_groups_per_block();
  __shared__ IPGroupState<T, M> sh[GROUPS];
  const int gi = threadIdx.x / IP_GROUP_THREADS;
  const int64_t lane = (int64_t)blockIdx.x * GROUPS + gi;
  if (lane >= B) return;

  const IPGroup g(gi);
  IPGroupState<T, M>& s = sh[gi];
  const int rank = static_cast<int>(g.thread_rank());
  for (int i = rank; i < NZ; i += IP_GROUP_THREADS)
    s.z[i] = z0s[lane * NZ + i];
  for (int i = rank; i < NTH; i += IP_GROUP_THREADS)
    s.th[i] = ths[lane * NTH + i];
  g.sync();

  T st[4];
  ip_solve_group<T, M>(g, model, p, s, st);

  for (int i = rank; i < NZ; i += IP_GROUP_THREADS)
    zs_out[lane * NZ + i] = s.z[i];
  if (rank == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) stats[lane * 4 + i] = st[i];
  }
}

template <typename T, typename M>
int launch_fused_ip_group(const void* z0s, const void* ths, void* zs,
                          void* stats, int B, const double* model_params,
                          const double* ip, void* stream) {
  if (B <= 0) return 0;
  const IPParams<T> p = make_ip_params<T>(ip);
  const M model(model_params);
  constexpr int groups = ip_groups_per_block();
  const int blocks = (B + groups - 1) / groups;
  fused_ip_group_kernel<T, M>
      <<<blocks, IP_GROUP_BLOCK, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(z0s), static_cast<const T*>(ths),
          static_cast<T*>(zs), static_cast<T*>(stats), B, model, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

#define ODT_FUSED_IP(NAME, FUNCTOR, SUFFIX, T)                               \
  int odt_fused_ip_##NAME##_##SUFFIX(const void* z0s, const void* ths,        \
                                     void* zs, void* stats, int B,            \
                                     const double* model_params,              \
                                     const double* ip, void* stream) {        \
    return odt::launch_fused_ip<T, odt::FUNCTOR<T>>(                          \
        z0s, ths, zs, stats, B, model_params, ip, stream);                    \
  }

#define ODT_FUSED_IP_TILE(NAME, FUNCTOR, SUFFIX, T)                          \
  int odt_fused_ip_tile_##NAME##_##SUFFIX(                                    \
      const void* z0s, const void* ths, void* zs, void* stats, int B,         \
      const double* model_params, const double* ip, void* stream) {           \
    return odt::launch_fused_ip_tile<T, odt::FUNCTOR<T>>(                     \
        z0s, ths, zs, stats, B, model_params, ip, stream);                    \
  }

#define ODT_FUSED_IP_GROUP(NAME, FUNCTOR, SUFFIX, T)                         \
  int odt_fused_ip_group_##NAME##_##SUFFIX(                                   \
      const void* z0s, const void* ths, void* zs, void* stats, int B,         \
      const double* model_params, const double* ip, void* stream) {           \
    return odt::launch_fused_ip_group<T, odt::FUNCTOR<T>>(                    \
        z0s, ths, zs, stats, B, model_params, ip, stream);                    \
  }
