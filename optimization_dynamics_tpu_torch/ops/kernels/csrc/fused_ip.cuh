// The fused IP kernel and its launcher, instantiated per device functor
// in a source file of its own (fused_ip.cu: K1, cartpole; fused_ip_push.cu:
// K1n, planar push), so nvcc builds them in parallel. One thread per
// scenario; the per-lane solve is ip_solve_lane (ip_body.cuh), which K4
// shares. See ops/kernels/fused_ip.py for the design note.
#pragma once

#include <cstdint>

#include "ip_body.cuh"

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

}  // namespace odt

#define ODT_FUSED_IP(NAME, FUNCTOR, SUFFIX, T)                               \
  int odt_fused_ip_##NAME##_##SUFFIX(const void* z0s, const void* ths,        \
                                     void* zs, void* stats, int B,            \
                                     const double* model_params,              \
                                     const double* ip, void* stream) {        \
    return odt::launch_fused_ip<T, odt::FUNCTOR<T>>(                          \
        z0s, ths, zs, stats, B, model_params, ip, stream);                    \
  }
