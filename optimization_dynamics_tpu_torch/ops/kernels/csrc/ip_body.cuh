// The per-lane path-following interior-point solve, as one device function.
//
// Shared by K1 (fused_ip.cu: one IP solve per thread) and K4
// (fused_rollout.cu: T-1 IP solves per thread, one per rollout step), so
// the two kernels run the same arithmetic and cannot drift apart.
//
// Per lane, exactly what make_ip_body (optimization_dynamics_tpu/ops/
// pallas/fused_ip.py) computes, in the same order:
// kappa0 = clip(kappa_vio(r0), kappa_lo, kappa_init_max); then until the
// lane is converged, stalled or at max_iter: Jacobian (dual numbers),
// QR Newton step on r0 - kappa*head, tau = clip(1 - merit, tau_min,
// tau_max), alpha0 = min(boundary_alpha * tau, 1), max_ls halving
// candidates with first-improvement pick and first-minimum fallback,
// centring test, one-shot cone reinit with kappa re-clipped from kappa_lo.
// A lane's iteration count counts its active iterations only.
#pragma once

#include "odt_common.cuh"
#include "qr.cuh"

namespace odt {

template <typename T>
struct IPParams {
  T r_tol, kappa_final, kappa_lo, kappa_init_max, kappa_scale, center_frac,
      tau_min, tau_max, gamma_reg;
  int max_iter, max_ls;
};

// ip: r_tol, kappa_final, kappa_lo, kappa_init_max, kappa_scale,
//     center_frac, tau_min, tau_max, gamma_reg, max_iter, max_ls
template <typename T>
IPParams<T> make_ip_params(const double* ip) {
  IPParams<T> p;
  p.r_tol = T(ip[0]);
  p.kappa_final = T(ip[1]);
  p.kappa_lo = T(ip[2]);
  p.kappa_init_max = T(ip[3]);
  p.kappa_scale = T(ip[4]);
  p.center_frac = T(ip[5]);
  p.tau_min = T(ip[6]);
  p.tau_max = T(ip[7]);
  p.gamma_reg = T(ip[8]);
  p.max_iter = static_cast<int>(ip[9]);
  p.max_ls = static_cast<int>(ip[10]);
  return p;
}

template <typename T>
__device__ __forceinline__ T soc_alpha(const T* zg, const T* dg, int dim) {
  const T BIG = T(1e12);
  const T z0 = zg[0], d0 = dg[0];
  T dd = T(0), zd = T(0), zz = T(0);
  for (int j = 1; j < dim; ++j) {
    dd += dg[j] * dg[j];
    zd += zg[j] * dg[j];
    zz += zg[j] * zg[j];
  }
  const T A = d0 * d0 - dd;
  const T Bq = T(-2) * (z0 * d0 - zd);
  const T C = z0 * z0 - zz;
  const T a_axis = d0 > T(0) ? z0 / d0 : BIG;
  const T disc = Bq * Bq - T(4) * A * C;
  const T sq = sqrt(jmax(disc, T(0)));
  const T safe_A = jabs(A) > T(1e-30) ? A : T(1);
  const T r1 = (-Bq - sq) / (T(2) * safe_A);
  const T r2 = (-Bq + sq) / (T(2) * safe_A);
  const T lo = jmin(r1, r2);
  const T hi = jmax(r1, r2);
  const T quad = lo > T(0) ? lo : (hi > T(0) ? hi : BIG);
  T lin = jabs(Bq) > T(1e-30) ? -C / Bq : BIG;
  lin = lin > T(0) ? lin : BIG;
  T root = jabs(A) > T(1e-30) ? quad : lin;
  root = disc >= T(0) ? root : BIG;
  return jmin(root, a_axis);
}

template <typename T, typename M>
__device__ __forceinline__ T boundary_alpha(const T (&z)[M::NZ],
                                            const T (&d)[M::NZ]) {
  const T BIG = T(1e12);
  T a = BIG;
#pragma unroll
  for (int i = 0; i < M::N_ORT; ++i) {
    const int k = M::ort_idx(i);
    a = jmin(a, d[k] > T(0) ? z[k] / d[k] : BIG);
  }
#pragma unroll
  for (int g = 0; g < M::N_SOC; ++g) {
    T zg[M::SOC_DIM], dg[M::SOC_DIM];
#pragma unroll
    for (int j = 0; j < M::SOC_DIM; ++j) {
      zg[j] = z[M::soc_idx(g, j)];
      dg[j] = d[M::soc_idx(g, j)];
    }
    a = jmin(a, soc_alpha(zg, dg, M::SOC_DIM));
  }
  return jmin(a, T(1));
}

// |r0 - kappa * head|_inf
template <typename T, typename M>
__device__ __forceinline__ T merit_of(const T (&r0)[M::NZ], T kappa) {
  T m = jabs(r0[0] - kappa * T(M::head_mask(0)));
#pragma unroll
  for (int i = 1; i < M::NZ; ++i)
    m = jmax(m, jabs(r0[i] - kappa * T(M::head_mask(i))));
  return m;
}

// max_i |r0_i| * mask_i for the equality (bil=false) or bilinear rows
template <typename T, typename M>
__device__ __forceinline__ T row_vio(const T (&r0)[M::NZ], bool bil) {
  T m = T(0);
#pragma unroll
  for (int i = 0; i < M::NZ; ++i) {
    const T w = T(bil ? M::bil_mask(i) : M::eq_mask(i));
    m = i == 0 ? jabs(r0[i]) * w : jmax(m, jabs(r0[i]) * w);
  }
  return m;
}

// Solve the lane's IP problem from z (in: the start, out: the solution).
// stats: iterations, converged (1/0), equality-row violation,
// bilinear-row violation.
template <typename T, typename M>
__device__ __forceinline__ void ip_solve_lane(T (&z)[M::NZ],
                                              const T (&th)[M::NTH],
                                              const M& model,
                                              const IPParams<T>& p,
                                              T (&stats)[4]) {
  constexpr int NZ = M::NZ;
  const T BIG = T(1e12);
  T r0[NZ];

  model.template residual<T>(z, th, r0);
  T kappa = M::HAS_CONES
                ? jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max)
                : p.kappa_final;
  int it = 0;
  bool stalled = false, reinit = false;

  while (it < p.max_iter) {
    if (merit_of<T, M>(r0, p.kappa_final) < p.r_tol || stalled) break;

    // Jacobian, one dual-number residual per column
    T J[NZ][NZ];
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      Dual<T> zd[NZ], rd[NZ];
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        zd[i] = Dual<T>(z[i], i == j ? T(1) : T(0));
      model.template residual<Dual<T>>(zd, th, rd);
#pragma unroll
      for (int i = 0; i < NZ; ++i) J[i][j] = rd[i].d;
    }
    if (p.gamma_reg > T(0)) {
#pragma unroll
      for (int i = 0; i < NZ; ++i) J[i][i] = J[i][i] + p.gamma_reg * kappa;
    }

    T rk[NZ][1], delta_m[NZ][1];
    T merit_cur = T(0);
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      rk[i][0] = r0[i] - kappa * T(M::head_mask(i));
      merit_cur = i == 0 ? jabs(rk[i][0]) : jmax(merit_cur, jabs(rk[i][0]));
    }
    qr_solve<T, NZ, 1>(J, rk, delta_m);
    T delta[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) delta[i] = delta_m[i][0];

    const T tau = jclip(T(1) - merit_cur, p.tau_min, p.tau_max);
    const T alpha0 = jmin(boundary_alpha<T, M>(z, delta) * tau, T(1));

    // candidate sweep: first improving alpha, else the first minimum
    bool found = false;
    T best_a = T(0), best_m = BIG, min_a = alpha0, min_m = BIG;
    T pw = T(1);
    for (int j = 0; j < p.max_ls; ++j) {
      const T a_j = alpha0 * pw;
      pw = pw * T(0.5);
      T zc[NZ], rc[NZ];
#pragma unroll
      for (int i = 0; i < NZ; ++i) zc[i] = z[i] - a_j * delta[i];
      model.template residual<T>(zc, th, rc);
      const T m_j = merit_of<T, M>(rc, kappa);
      if (m_j < merit_cur && !found) {
        best_a = a_j;
        best_m = m_j;
        found = true;
      }
      if (m_j < min_m) {
        min_a = a_j;
        min_m = m_j;
      }
    }
    const T alpha = found ? best_a : min_a;
    const T new_merit = found ? best_m : min_m;
    bool stalled_new = !found;

#pragma unroll
    for (int i = 0; i < NZ; ++i) z[i] = z[i] - alpha * delta[i];
    const bool centered = new_merit < jmax(p.center_frac * kappa, p.r_tol);
    if (centered) kappa = jmax(kappa * p.kappa_scale, p.kappa_final);

    bool do_reinit = false;
    if (M::HAS_CONES) {
      do_reinit = stalled_new && !reinit;
      if (do_reinit) {
#pragma unroll
        for (int i = 0; i < NZ; ++i)
          if (M::reset_mask(i) != 0.0) z[i] = T(M::reset_tmpl(i));
      }
      stalled_new = stalled_new && reinit;
      reinit = reinit || do_reinit;
    }
    stalled = stalled_new;

    model.template residual<T>(z, th, r0);
    if (do_reinit)
      kappa = jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max);
    ++it;
  }

  const bool conv = merit_of<T, M>(r0, p.kappa_final) < p.r_tol;
  stats[0] = T(it);
  stats[1] = conv ? T(1) : T(0);
  stats[2] = row_vio<T, M>(r0, false);
  stats[3] = row_vio<T, M>(r0, true);
}

}  // namespace odt
