// K4: a whole closed-loop rollout, one thread per scenario.
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/pallas/
// fused_rollout.py (make_fused_rollout, step step_bl). See
// ops/kernels/fused_rollout.py for the design note.
//
// Per lane, t = 0 .. T-2, with the state x = [q0; q1] in registers:
//   u  = u_ref + alpha k + K (x - x_ref)  where u_mask[t] is set, else
//        u_ref (the same value as folding the mask into K and k);
//   th = M::pack_theta(q0, q1, u, aux);  z = M::init_z(q1) (cold start);
//   z  = ip_solve_lane(z, th)            (K1's per-lane solve);
//   x  = [q1; z[q_sel]].
// The gains are read from device memory one step at a time.
//
// Layout, batch first and contiguous: x0s (B, NX), xss_ref (B, T, NX),
// uss_ref (B, T-1, NU), Kss (B, T-1, NU, NX), kss (B, T-1, NU), alphas
// (B,), u_mask (T-1, NU); out xss (B, T, NX), uss (B, T-1, NU), wss (B,
// T-1, NZ) and, when not null, stats (B, T-1, 4) of each step's solve.
#include <cstdint>

#include "cartpole_friction.cuh"
#include "ip_body.cuh"

namespace odt {

constexpr int ROLLOUT_THREADS = 32;

template <typename T, int N>
struct Vec {
  T v[N];
};

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
    const T* xr = xss_ref + ((int64_t)lane * (Tm1 + 1) + t) * NX;
    const T* ur = uss_ref + s * NU;
    const T* Kt = Kss + s * NU * NX;
    const T* kt = kss + s * NU;

    T dx[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dx[j] = x[j] - xr[j];
    T u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T acc = alpha * kt[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + Kt[i * NX + j] * dx[j];
      u[i] = u_mask[t * NU + i] != T(0) ? ur[i] + acc : ur[i];
    }

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

template <typename T, typename M>
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
  const int blocks = (B + ROLLOUT_THREADS - 1) / ROLLOUT_THREADS;
  fused_rollout_kernel<T, M>
      <<<blocks, ROLLOUT_THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(x0s), static_cast<const T*>(xss_ref),
          static_cast<const T*>(uss_ref), static_cast<const T*>(Kss),
          static_cast<const T*>(kss), static_cast<const T*>(alphas),
          static_cast<const T*>(u_mask), static_cast<T*>(xss),
          static_cast<T*>(uss), static_cast<T*>(wss), static_cast<T*>(stats),
          B, Tm1, model, p, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

#define ODT_FUSED_ROLLOUT(NAME, FUNCTOR, SUFFIX, T)                          \
  int odt_fused_rollout_##NAME##_##SUFFIX(                                   \
      const void* x0s, const void* xss_ref, const void* uss_ref,             \
      const void* Kss, const void* kss, const void* alphas,                  \
      const void* u_mask, void* xss, void* uss, void* wss, void* stats,      \
      int B, int Tm1, const double* model_params, const double* ip,          \
      const double* aux, void* stream) {                                     \
    return odt::launch_fused_rollout<T, odt::FUNCTOR<T>>(                    \
        x0s, xss_ref, uss_ref, Kss, kss, alphas, u_mask, xss, uss, wss,      \
        stats, B, Tm1, model_params, ip, aux, stream);                       \
  }

// one line per functor of FUSED_ROLLOUT_FUNCTORS in ops/kernels/_build.py
extern "C" {
ODT_FUSED_ROLLOUT(cartpole_friction, CartpoleFriction, f32, float)
ODT_FUSED_ROLLOUT(cartpole_friction, CartpoleFriction, f64, double)
}  // extern "C"
