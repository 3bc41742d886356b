// Cartpole with joint friction as a device functor for the fused IP solve.
//
// The residual of optimization_dynamics_tpu_torch/models/cartpole.py
// (``residual_friction`` at kappa = 0), written once as a template on the
// number type S: S = T evaluates it, S = Dual<T> gives one Jacobian column
// per evaluation. The arithmetic follows the Python residual operation by
// operation (the same products of the same constants, in the same order).
//
// The cone tables below are ``cone_spec_friction()`` turned into constexpr
// lookups: the row masks of ``_row_masks``, the reset mask and template of
// ``_cone_reset``, and the SOC variable groups (each primal and each dual
// group is one cone of the fraction-to-boundary step). ``init_tail`` is
// the cold start of ``init_z_friction``. A CPU test parses these tables
// and checks them against the Python ConeSpec and init_z.
//
// ``init_z`` and ``pack_theta`` give the fused rollout (K4) the model's
// cold start and problem data, so that kernel holds nothing
// model-specific.
#pragma once

#include "odt_common.cuh"

namespace odt {

template <typename T>
struct CartpoleFriction {
  static constexpr int NZ = 10;
  static constexpr int NTH = 8;
  static constexpr int NQ = 2;          // configuration; state x = [q0; q1]
  static constexpr int NU = 1;
  static constexpr int NAUX = 3;        // theta tail: mu_slider, mu_angle, h
  static constexpr bool HAS_CONES = true;
  static constexpr int N_ORT = 0;       // orthant variables (prim + dual)
  static constexpr int N_SOC = 4;       // SOC groups, primal and dual
  static constexpr int SOC_DIM = 2;

  __host__ __device__ static constexpr double eq_mask(int i) {
    constexpr double t[NZ] = {1, 1, 1, 1, 1, 1, 0, 0, 0, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double bil_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double head_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 0, 1, 0, 1, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_mask(int i) {
    constexpr double t[NZ] = {0, 0, 1, 1, 1, 1, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_tmpl(int i) {
    constexpr double t[NZ] = {0, 0, 1, 1, 0.1, 0.1, 1, 1, 0.1, 0.1};
    return t[i];
  }
  // init_z_friction's tail after q: psi=1, b=0.1, s_psi=1, s_b=0.1
  __host__ __device__ static constexpr double init_tail(int i) {
    constexpr double t[NZ - NQ] = {1, 1, 0.1, 0.1, 1, 1, 0.1, 0.1};
    return t[i];
  }
  // the next configuration's entries of z
  __host__ __device__ static constexpr int q_sel(int i) {
    constexpr int t[NQ] = {0, 1};
    return t[i];
  }
  __host__ __device__ static constexpr int ort_idx(int i) {
    constexpr int t[1] = {0};
    return t[i];
  }
  __host__ __device__ static constexpr int soc_idx(int g, int j) {
    constexpr int t[N_SOC][SOC_DIM] = {{2, 4}, {3, 5}, {6, 8}, {7, 9}};
    return t[g][j];
  }

  // constants of the residual, combined in double in the order the
  // Python residual combines them, then rounded to T
  T neg_mp, length, m_total, mpl, mpl2, mpgl, mp_plus_mc, gravity;

  __host__ CartpoleFriction(const double* p) {
    const double mc = p[0], mp = p[1], l = p[2], g = p[3];
    neg_mp = T(-mp);
    length = T(l);
    m_total = T(mc + mp);
    mpl = T(mp * l);
    mpl2 = T(mp * (l * l));
    mpgl = T(mp * g * l);
    mp_plus_mc = T(mp + mc);
    gravity = T(g);
  }

  // the cold start init_z_friction(q1) of models/cartpole.py
  __device__ __forceinline__ static void init_z(const T (&q1)[NQ],
                                                T (&z)[NZ]) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) z[i] = q1[i];
#pragma unroll
    for (int i = 0; i < NZ - NQ; ++i) z[NQ + i] = T(init_tail(i));
  }

  // pack_theta_friction: [q0, q1, u, mu_slider, mu_angle, h], with
  // aux = (mu_slider, mu_angle, h)
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

  template <typename S>
  __device__ __forceinline__ void residual(const S* z, const T* th,
                                           S* r) const {
    const S q0a(th[0]), q0b(th[1]), q1a(th[2]), q1b(th[3]), u(th[4]);
    const S mu_s(th[5]), mu_a(th[6]), h(th[7]);
    const S q2a = z[0], q2b = z[1];
    const S psi1 = z[2], psi2 = z[3], b1 = z[4], b2 = z[5];
    const S spsi1 = z[6], spsi2 = z[7], sb1 = z[8], sb2 = z[9];
    const S half(T(0.5));

    // variational_dynamics
    const S qm1b = half * (q0b + q1b);
    const S vm1a = (q1a - q0a) / h, vm1b = (q1b - q0b) / h;
    const S qm2b = half * (q1b + q2b);
    const S vm2a = (q2a - q1a) / h, vm2b = (q2b - q1b) / h;

    // D1L = -dynamics_bias = [c_times_v[0], -g[1]]
    const S d1l1_a = S(neg_mp) * vm1b * S(length) * dsin(qm1b) * vm1b;
    const S d1l1_b = -(S(mpgl) * dsin(qm1b));
    const S d1l2_a = S(neg_mp) * vm2b * S(length) * dsin(qm2b) * vm2b;
    const S d1l2_b = -(S(mpgl) * dsin(qm2b));
    // D2L = M(q) v
    const S c1 = S(mpl) * dcos(qm1b);
    const S d2l1_a = S(m_total) * vm1a + c1 * vm1b;
    const S d2l1_b = c1 * vm1a + S(mpl2) * vm1b;
    const S c2 = S(mpl) * dcos(qm2b);
    const S d2l2_a = S(m_total) * vm2a + c2 * vm2b;
    const S d2l2_b = c2 * vm2a + S(mpl2) * vm2b;

    const S hh = half * h;
    r[0] = hh * d1l1_a + d2l1_a + hh * d1l2_a - d2l2_a + u + b1;
    r[1] = hh * d1l1_b + d2l1_b + hh * d1l2_b - d2l2_b + S(T(0)) + b2;

    const S vTa = (q2a - q1a) / h, vTb = (q2b - q1b) / h;
    r[2] = sb1 - vTa;
    r[3] = psi1 - mu_s * S(mp_plus_mc) * S(gravity) * h;
    r[4] = sb2 - vTb;
    r[5] = psi2 - mu_a * S(mpgl) * h;
    // cone products, kappa = 0
    r[6] = psi1 * spsi1 + b1 * sb1;
    r[7] = psi1 * sb1 + spsi1 * b1;
    r[8] = psi2 * spsi2 + b2 * sb2;
    r[9] = psi2 * sb2 + spsi2 * b2;
  }
};

}  // namespace odt
