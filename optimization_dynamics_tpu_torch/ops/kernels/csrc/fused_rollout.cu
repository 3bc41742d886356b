// K4: a whole closed-loop rollout of a scenario in one kernel.
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/pallas/
// fused_rollout.py (make_fused_rollout, step step_bl). See
// ops/kernels/fused_rollout.py for the design note.
//
// Per scenario, t = 0 .. T-2, with the state x = [q0; q1] in registers:
//   u  = u_ref + alpha k + K (x - x_ref)  where u_mask[t] is set, else
//        u_ref (the same value as folding the mask into K and k);
//   th = M::pack_theta(q0, q1, u, aux);  z = M::init_z(q1) (cold start);
//   z  = the IP solve of K1 from z       (ip_solve_lane or ip_solve_tile);
//   x  = [q1; z[q_sel]].
// The gains are read from device memory one step at a time. Two kernels,
// which the wrapper picks by width as K1's (FUSED_IP_TILE_MAX_B):
// * fused_rollout_tile_kernel (ODT_FUSED_ROLLOUT_TILE): one tile of
//   ip_tile_width<M>() threads a scenario, 64-thread blocks. Every thread
//   of the tile holds x, alpha, aux and the step's u, computed in the
//   same order, so the tile branches together; each step's solve is
//   ip_solve_tile, K1's tile solve; element i of each store goes to
//   thread i % W.
// * fused_rollout_kernel (ODT_FUSED_ROLLOUT): one thread a scenario in
//   32-thread blocks, each step's solve ip_solve_lane, K1's per-thread
//   solve.
//
// Layout, batch first and contiguous: x0s (B, NX), xss_ref (B, T, NX),
// uss_ref (B, T-1, NU), Kss (B, T-1, NU, NX), kss (B, T-1, NU), alphas
// (B,), u_mask (T-1, NU); out xss (B, T, NX), uss (B, T-1, NU), wss (B,
// T-1, NZ) and, when not null, stats (B, T-1, 4) of each step's solve.
#include <cooperative_groups.h>

#include <cstdint>

#include "cartpole_friction.cuh"
#include "ip_body.cuh"
#include "ip_tile.cuh"

namespace odt {

constexpr int ROLLOUT_THREADS = 32;

template <typename T, int N>
struct Vec {
  T v[N];
};

// The step's control: acc = alpha k, then + K[i, j] dx[j] over j; u_ref
// + acc where the mask is set, else u_ref
template <typename T, int NX, int NU>
__device__ __forceinline__ void feedback(const T (&x)[NX],
                                         const T* __restrict__ xr,
                                         const T* __restrict__ ur,
                                         const T* __restrict__ Kt,
                                         const T* __restrict__ kt,
                                         const T* __restrict__ mask, T alpha,
                                         T (&u)[NU]) {
  T dx[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) dx[j] = x[j] - xr[j];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = alpha * kt[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) acc = acc + Kt[i * NX + j] * dx[j];
    u[i] = mask[i] != T(0) ? ur[i] + acc : ur[i];
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(ROLLOUT_THREADS)
fused_rollout_kernel(const T* __restrict__ x0s, const T* __restrict__ xss_ref,
                     const T* __restrict__ uss_ref, const T* __restrict__ Kss,
                     const T* __restrict__ kss, const T* __restrict__ alphas,
                     const T* __restrict__ u_mask, T* __restrict__ xss,
                     T* __restrict__ uss, T* __restrict__ wss,
                     T* __restrict__ stats, int B, int Tm1, M model,
                     IPParams<T> p, Vec<T, M::NAUX> aux_in) {
  constexpr int NQ = M::NQ, NX = 2 * M::NQ, NU = M::NU, NZ = M::NZ;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const T alpha = alphas[lane];
  T aux[M::NAUX];
#pragma unroll
  for (int i = 0; i < M::NAUX; ++i) aux[i] = aux_in.v[i];

  T x[NX];
  T* xo = xss + (int64_t)lane * (Tm1 + 1) * NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = x0s[(int64_t)lane * NX + i];
    xo[i] = x[i];
  }

  for (int t = 0; t < Tm1; ++t) {
    const int64_t s = (int64_t)lane * Tm1 + t;
    T u[NU];
    feedback<T, NX, NU>(x, xss_ref + ((int64_t)lane * (Tm1 + 1) + t) * NX,
                        uss_ref + s * NU, Kss + s * NU * NX, kss + s * NU,
                        u_mask + t * NU, alpha, u);

    T q0[NQ], q1[NQ], th[M::NTH], z[NZ], st[4];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      q0[i] = x[i];
      q1[i] = x[NQ + i];
    }
    M::pack_theta(q0, q1, u, aux, th);
    M::init_z(q1, z);
    ip_solve_lane<T, M>(z, th, model, p, st);

#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      x[i] = q1[i];
      x[NQ + i] = z[M::q_sel(i)];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) xo[(t + 1) * NX + i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) uss[s * NU + i] = u[i];
#pragma unroll
    for (int i = 0; i < NZ; ++i) wss[s * NZ + i] = z[i];
    if (stats != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) stats[s * 4 + i] = st[i];
    }
  }
}

// One tile a scenario. A tile whose scenario is past B returns as a
// whole, before any sync; there is no block-level barrier, so the tiles
// of a block run their own iterations and steps.
template <typename T, typename M>
__global__ void __launch_bounds__(IP_TILE_BLOCK, IP_TILE_MIN_BLOCKS)
fused_rollout_tile_kernel(
    const T* __restrict__ x0s, const T* __restrict__ xss_ref,
    const T* __restrict__ uss_ref, const T* __restrict__ Kss,
    const T* __restrict__ kss, const T* __restrict__ alphas,
    const T* __restrict__ u_mask, T* __restrict__ xss, T* __restrict__ uss,
    T* __restrict__ wss, T* __restrict__ stats, int B, int Tm1, M model,
    IPParams<T> p, Vec<T, M::NAUX> aux_in) {
  namespace cg = cooperative_groups;
  constexpr int NQ = M::NQ, NX = 2 * M::NQ, NU = M::NU, NZ = M::NZ;
  constexpr int W = ip_tile_width<M>();
  constexpr int TILES = ip_tiles_per_block<M>();
  __shared__ T S[TILES][NZ * (NZ + 1)];
  __shared__ T vb[TILES][2 * (NZ + 1)];
  const cg::thread_block_tile<W> tile =
      cg::tiled_partition<W>(cg::this_thread_block());
  const int ti = threadIdx.x / W;
  const int64_t lane = (int64_t)blockIdx.x * TILES + ti;
  if (lane >= B) return;
  const int rank = static_cast<int>(tile.thread_rank());
  const T alpha = alphas[lane];
  T aux[M::NAUX];
#pragma unroll
  for (int i = 0; i < M::NAUX; ++i) aux[i] = aux_in.v[i];

  T x[NX];
  T* xo = xss + lane * (Tm1 + 1) * NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = x0s[lane * NX + i];
    if (i % W == rank) xo[i] = x[i];
  }

  for (int t = 0; t < Tm1; ++t) {
    const int64_t s = lane * Tm1 + t;
    T u[NU];
    feedback<T, NX, NU>(x, xss_ref + (lane * (Tm1 + 1) + t) * NX,
                        uss_ref + s * NU, Kss + s * NU * NX, kss + s * NU,
                        u_mask + t * NU, alpha, u);

    T q0[NQ], q1[NQ], th[M::NTH], z[NZ], st[4];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      q0[i] = x[i];
      q1[i] = x[NQ + i];
    }
    M::pack_theta(q0, q1, u, aux, th);
    M::init_z(q1, z);
    ip_solve_tile<T, M, W>(tile, z, th, model, p, st, S[ti], vb[ti]);

#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      x[i] = q1[i];
      x[NQ + i] = z[M::q_sel(i)];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (i % W == rank) xo[(t + 1) * NX + i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (i % W == rank) uss[s * NU + i] = u[i];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      if (i % W == rank) wss[s * NZ + i] = z[i];
    if (stats != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i % W == rank) stats[s * 4 + i] = st[i];
    }
  }
}

template <typename T, typename M, bool TILE>
int launch_fused_rollout(const void* x0s, const void* xss_ref,
                         const void* uss_ref, const void* Kss,
                         const void* kss, const void* alphas,
                         const void* u_mask, void* xss, void* uss, void* wss,
                         void* stats, int B, int Tm1,
                         const double* model_params, const double* ip,
                         const double* aux, void* stream) {
  if (B <= 0) return 0;
  const IPParams<T> p = make_ip_params<T>(ip);
  const M model(model_params);
  Vec<T, M::NAUX> a;
  for (int i = 0; i < M::NAUX; ++i) a.v[i] = T(aux[i]);
  const int per_block = TILE ? ip_tiles_per_block<M>() : ROLLOUT_THREADS;
  const int blocks = (B + per_block - 1) / per_block;
  auto kernel = TILE ? fused_rollout_tile_kernel<T, M>
                     : fused_rollout_kernel<T, M>;
  kernel<<<blocks, TILE ? IP_TILE_BLOCK : ROLLOUT_THREADS, 0,
           (cudaStream_t)stream>>>(
      static_cast<const T*>(x0s), static_cast<const T*>(xss_ref),
      static_cast<const T*>(uss_ref), static_cast<const T*>(Kss),
      static_cast<const T*>(kss), static_cast<const T*>(alphas),
      static_cast<const T*>(u_mask), static_cast<T*>(xss),
      static_cast<T*>(uss), static_cast<T*>(wss), static_cast<T*>(stats), B,
      Tm1, model, p, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

#define ODT_FUSED_ROLLOUT_ENTRY(SYMBOL, FUNCTOR, T, TILE)                    \
  int SYMBOL(const void* x0s, const void* xss_ref, const void* uss_ref,      \
             const void* Kss, const void* kss, const void* alphas,           \
             const void* u_mask, void* xss, void* uss, void* wss,            \
             void* stats, int B, int Tm1, const double* model_params,        \
             const double* ip, const double* aux, void* stream) {            \
    return odt::launch_fused_rollout<T, odt::FUNCTOR<T>, TILE>(              \
        x0s, xss_ref, uss_ref, Kss, kss, alphas, u_mask, xss, uss, wss,      \
        stats, B, Tm1, model_params, ip, aux, stream);                       \
  }
#define ODT_FUSED_ROLLOUT(NAME, FUNCTOR, SUFFIX, T)                          \
  ODT_FUSED_ROLLOUT_ENTRY(odt_fused_rollout_##NAME##_##SUFFIX, FUNCTOR, T,   \
                          false)
#define ODT_FUSED_ROLLOUT_TILE(NAME, FUNCTOR, SUFFIX, T)                     \
  ODT_FUSED_ROLLOUT_ENTRY(odt_fused_rollout_tile_##NAME##_##SUFFIX, FUNCTOR, \
                          T, true)

// one line per functor of FUSED_ROLLOUT_FUNCTORS in ops/kernels/_build.py
extern "C" {
ODT_FUSED_ROLLOUT(cartpole_friction, CartpoleFriction, f32, float)
ODT_FUSED_ROLLOUT(cartpole_friction, CartpoleFriction, f64, double)
ODT_FUSED_ROLLOUT_TILE(cartpole_friction, CartpoleFriction, f32, float)
ODT_FUSED_ROLLOUT_TILE(cartpole_friction, CartpoleFriction, f64, double)
}  // extern "C"
