// Acrobot with hard elbow joint limits as a device functor for the fused
// IP solve (K1a).
//
// The residual of optimization_dynamics_tpu_torch/models/acrobot.py
// (``residual_impact`` at kappa = 0), written once as a template on the
// number type S: S = T evaluates it, S = Dual<T> gives one Jacobian column
// per evaluation (dsin/dcos carry the tangent through sin(q0 + q1),
// cos(q1) and sin(q1)). The arithmetic follows the Python residual
// operation by operation; products of parameters are folded in double,
// in the order the Python residual folds them, then rounded to T.
//
// The cone tables below are ``cone_spec_impact()`` turned into constexpr
// lookups: the row masks of ``_row_masks``, the reset mask and template
// of ``_cone_reset``, and the orthant variables (the pairs (lambda_i,
// s_i), primal then dual). The model has no SOC group: N_SOC = 0, and
// soc_dim / soc_idx are one-entry sentinels (SOC_MAX = 1) that the
// kernel's SOC loop never reads, so no table has zero length.
// ``init_tail`` is the cold start of ``init_z_impact``. A CPU test parses
// these tables and checks them against the Python ConeSpec and init_z.
#pragma once

#include "odt_common.cuh"

namespace odt {

template <typename T>
struct AcrobotImpact {
  static constexpr int NZ = 6;
  static constexpr int NTH = 6;
  static constexpr int NQ = 2;          // configuration; x = [q0; q1]
  static constexpr int NU = 1;
  static constexpr int NAUX = 1;        // theta tail: h
  static constexpr bool HAS_CONES = true;
  static constexpr int N_ORT = 4;       // orthant variables (prim + dual)
  static constexpr int N_SOC = 0;       // no SOC group
  static constexpr int SOC_MAX = 1;     // sentinel: no zero-length arrays

  __host__ __device__ static constexpr double eq_mask(int i) {
    constexpr double t[NZ] = {1, 1, 1, 1, 0, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double bil_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double head_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_mask(int i) {
    constexpr double t[NZ] = {0, 0, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_tmpl(int i) {
    constexpr double t[NZ] = {0, 0, 1, 1, 1, 1};
    return t[i];
  }
  // init_z_impact's tail after q: lambda = 1, s = 1
  __host__ __device__ static constexpr double init_tail(int i) {
    constexpr double t[NZ - NQ] = {1, 1, 1, 1};
    return t[i];
  }
  // the next configuration's entries of z
  __host__ __device__ static constexpr int q_sel(int i) {
    constexpr int t[NQ] = {0, 1};
    return t[i];
  }
  __host__ __device__ static constexpr int ort_idx(int i) {
    constexpr int t[N_ORT] = {2, 3, 4, 5};
    return t[i];
  }
  __host__ __device__ static constexpr int soc_dim(int g) {
    constexpr int t[1] = {0};
    return t[g];
  }
  __host__ __device__ static constexpr int soc_idx(int g, int j) {
    constexpr int t[1][SOC_MAX] = {{-1}};
    return t[g][j];
  }

  // constants of the residual, folded in double as the Python residual
  // folds its Python floats, then rounded to T
  T m_a0, m_a1, j2, m_b1, tau_a0, tau_a1, l1, lc2, tau_b, cor_k, half_pi;

  // p: m1, j1, l1, lc1, m2, j2, l2, lc2, gravity (AcrobotParams)
  __host__ AcrobotImpact(const double* p) {
    const double m1 = p[0], j1_ = p[1], l1_ = p[2], lc1 = p[3], m2 = p[4],
                 j2_ = p[5], lc2_ = p[7], g = p[8];
    m_a0 = T(j1_ + j2_ + m2 * l1_ * l1_);
    m_a1 = T(2.0 * m2 * l1_ * lc2_);
    j2 = T(j2_);
    m_b1 = T(m2 * l1_ * lc2_);
    tau_a0 = T(-m1 * g * lc1);
    tau_a1 = T(m2 * g);
    l1 = T(l1_);
    lc2 = T(lc2_);
    tau_b = T(-m2 * g * lc2_);
    cor_k = T(m2 * l1_ * lc2_);
    half_pi = T(0.5 * 3.141592653589793);
  }

  // the cold start init_z_impact(q1) of models/acrobot.py
  __device__ __forceinline__ static void init_z(const T (&q1)[NQ],
                                                T (&z)[NZ]) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) z[i] = q1[i];
#pragma unroll
    for (int i = 0; i < NZ - NQ; ++i) z[NQ + i] = T(init_tail(i));
  }

  // pack_theta: [q0, q1, u, h], with aux = (h,)
  __device__ __forceinline__ static void pack_theta(const T (&q0)[NQ],
                                                    const T (&q1)[NQ],
                                                    const T (&u)[NU],
                                                    const T (&aux)[NAUX],
                                                    T (&th)[NTH]) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      th[i] = q0[i];
      th[NQ + i] = q1[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) th[2 * NQ + i] = u[i];
#pragma unroll
    for (int i = 0; i < NAUX; ++i) th[2 * NQ + NU + i] = aux[i];
  }

  // D1L = -dynamics_bias(q, v) = -(coriolis - tau)
  template <typename S>
  __device__ __forceinline__ void d1l(S qa, S qb, S va, S vb, S& out_a,
                                      S& out_b) const {
    const S k = S(cor_k) * dsin(qb);
    const S cor_a = S(T(-2)) * k * vb * va - k * vb * vb;
    const S cor_b = k * va * va;
    const S s0 = dsin(qa);
    const S s01 = dsin(qa + qb);
    const S tau_a = S(tau_a0) * s0 - S(tau_a1) * (S(l1) * s0 + S(lc2) * s01);
    const S tau_b_ = S(tau_b) * s01;
    out_a = -(cor_a - tau_a);
    out_b = -(cor_b - tau_b_);
  }

  // D2L = M(q) v, the multiply-reduce of variational_dynamics
  template <typename S>
  __device__ __forceinline__ void d2l(S qb, S va, S vb, S& out_a,
                                      S& out_b) const {
    const S c1 = dcos(qb);
    const S a = S(m_a0) + S(m_a1) * c1;
    const S b = S(j2) + S(m_b1) * c1;
    out_a = a * va + b * vb;
    out_b = b * va + S(j2) * vb;
  }

  template <typename S>
  __device__ __forceinline__ void residual(const S* z, const T* th,
                                           S* r) const {
    const S q0a(th[0]), q0b(th[1]), q1a(th[2]), q1b(th[3]), u(th[4]);
    const S h(th[5]);
    const S q2a = z[0], q2b = z[1];
    const S lam0 = z[2], lam1 = z[3], s0 = z[4], s1 = z[5];
    const S half(T(0.5));

    // variational_dynamics
    const S qm1a = half * (q0a + q1a), qm1b = half * (q0b + q1b);
    const S vm1a = (q1a - q0a) / h, vm1b = (q1b - q0b) / h;
    const S qm2a = half * (q1a + q2a), qm2b = half * (q1b + q2b);
    const S vm2a = (q2a - q1a) / h, vm2b = (q2b - q1b) / h;

    S d1l1_a, d1l1_b, d2l1_a, d2l1_b, d1l2_a, d1l2_b, d2l2_a, d2l2_b;
    d1l(qm1a, qm1b, vm1a, vm1b, d1l1_a, d1l1_b);
    d2l(qm1b, vm1a, vm1b, d2l1_a, d2l1_b);
    d1l(qm2a, qm2b, vm2a, vm2b, d1l2_a, d1l2_b);
    d2l(qm2b, vm2a, vm2b, d2l2_a, d2l2_b);

    const S zero(T(0)), one(T(1));
    const S hh = half * h;
    // control [0, u]; contact J^T lambda = [0 l0 + 0 l1, -1 l0 + 1 l1];
    // damping h * 0.5 * vm2
    const S hd = h * half;
    r[0] = hh * d1l1_a + d2l1_a + hh * d1l2_a - d2l2_a + zero
           + (zero * lam0 + zero * lam1) - hd * vm2a;
    r[1] = hh * d1l1_b + d2l1_b + hh * d1l2_b - d2l2_b + u
           + (-(one * lam0) + one * lam1) - hd * vm2b;

    // s - phi(q2), phi = [pi/2 - q2b, q2b + pi/2]
    r[2] = s0 - (S(half_pi) - q2b);
    r[3] = s1 - (q2b + S(half_pi));
    // lambda * s, kappa = 0
    r[4] = lam0 * s0;
    r[5] = lam1 * s1;
  }
};

}  // namespace odt
