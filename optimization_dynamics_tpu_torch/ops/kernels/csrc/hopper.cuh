// The planar hopper model as a device functor for the fused IP solve (K1
// at nz = 20).
//
// The residual of optimization_dynamics_tpu_torch/models/hopper.py
// (``residual`` at kappa = 0), written once as a template on the number
// type S: S = T evaluates it, S = Dual<T> gives one Jacobian column per
// evaluation (dsin/dcos carry the tangent through the leg angle). The
// mechanics are the Python module's closed forms, through the same steps
// as models/base.py::variational_dynamics: the mass matrix
// ``diag(m_b, m_b, I_b, 0) + m_f J_f^T J_f``, the bias ``-D1L``, each
// matrix-vector product as the multiply-reduce over a row (the zero
// entries included), then ``signed_distance``, ``slip_velocity`` and
// ``contact_force``, operation by operation. Products of parameters are
// folded in double, as the Python module folds its Python floats, then
// rounded to T.
//
// Variables: z = [q2 (4), gamma (4), s_gamma (4), psi (2), b (2),
// s_psi (2), s_b (2)], theta = [q0 (4), q1 (4), u (2), mu_body, mu_foot,
// h]. The cone tables below are ``cone_spec()`` turned into constexpr
// lookups: the row masks of ``_row_masks``, the reset mask and template
// of ``_cone_reset``, the orthant variables (gamma primal, s_gamma dual)
// and the four SOC(2) friction groups (psi_i, b_i) and (s_psi_i, s_b_i).
// ``init_tail`` is the cold start of ``init_z``; ``init_z`` and
// ``pack_theta`` are the model's cold start and problem data, as the
// other functors give them. A CPU test parses these tables and checks
// them against the Python ConeSpec and init_z.
#pragma once

#include "odt_common.cuh"

namespace odt {

template <typename T>
struct Hopper {
  static constexpr int NZ = 20;
  static constexpr int NTH = 13;
  static constexpr int NQ = 4;          // configuration; x = [q0; q1]
  static constexpr int NU = 2;
  static constexpr int NAUX = 3;        // theta tail: mu_body, mu_foot, h
  static constexpr bool HAS_CONES = true;
  static constexpr int N_ORT = 8;       // orthant variables (prim + dual)
  static constexpr int N_SOC = 4;       // SOC groups, primal and dual
  static constexpr int SOC_MAX = 2;     // the largest group's dimension

  __host__ __device__ static constexpr double eq_mask(int i) {
    constexpr double t[NZ] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 0, 0, 0, 0, 0, 0, 0, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double bil_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 1, 1, 1, 1, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double head_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 1, 1, 1, 1, 1, 0, 1, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_tmpl(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 1, 1, 1,   1,   1, 1,
                              1, 1, 1, 1, 0.1, 0.1, 1, 1, 0.1, 0.1};
    return t[i];
  }
  // init_z's tail after q: gamma, s_gamma, psi = 1; b = 0.1; s_psi = 1;
  // s_b = 0.1
  __host__ __device__ static constexpr double init_tail(int i) {
    constexpr double t[NZ - NQ] = {1, 1, 1, 1, 1, 1,   1,   1,
                                   1, 1, 0.1, 0.1, 1, 1, 0.1, 0.1};
    return t[i];
  }
  // the next configuration's entries of z
  __host__ __device__ static constexpr int q_sel(int i) {
    constexpr int t[NQ] = {0, 1, 2, 3};
    return t[i];
  }
  // gamma (primal) and s_gamma (dual)
  __host__ __device__ static constexpr int ort_idx(int i) {
    constexpr int t[N_ORT] = {4, 5, 6, 7, 8, 9, 10, 11};
    return t[i];
  }
  __host__ __device__ static constexpr int soc_dim(int g) {
    constexpr int t[N_SOC] = {2, 2, 2, 2};
    return t[g];
  }
  __host__ __device__ static constexpr int soc_idx(int g, int j) {
    constexpr int t[N_SOC][SOC_MAX] = {{12, 14}, {13, 15}, {16, 18},
                                       {17, 19}};
    return t[g][j];
  }

  // constants of the residual, folded in double as the Python module
  // folds its Python floats, then rounded to T
  T m_diag, mf, neg_mf, inertia, bias_z, mfg, neg_mfg, body_radius,
      foot_radius, leg_len_max, leg_len_min;

  // p: mass_body, mass_foot, inertia_body, body_radius, foot_radius,
  // leg_len_max, leg_len_min, gravity, friction_body, friction_foot
  // (HopperParams; the friction coefficients enter through theta)
  __host__ explicit Hopper(const double* p) {
    const double mb = p[0], mf_ = p[1], g = p[7];
    m_diag = T(mb + mf_);
    mf = T(mf_);
    neg_mf = T(-mf_);
    inertia = T(p[2]);
    bias_z = T((mb + mf_) * g);
    mfg = T(mf_ * g);
    neg_mfg = T(-mf_ * g);
    body_radius = T(p[3]);
    foot_radius = T(p[4]);
    leg_len_max = T(p[5]);
    leg_len_min = T(p[6]);
  }

  // the cold start init_z(q1) of models/hopper.py
  __device__ __forceinline__ static void init_z(const T (&q1)[NQ],
                                                T (&z)[NZ]) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) z[i] = q1[i];
#pragma unroll
    for (int i = 0; i < NZ - NQ; ++i) z[NQ + i] = T(init_tail(i));
  }

  // pack_theta: [q0, q1, u, mu_body, mu_foot, h], with aux = (mu_body,
  // mu_foot, h)
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

  // D2L = M(q) v: mass_matrix's rows, each multiplied and summed over
  // its four entries
  template <typename S>
  __device__ __forceinline__ void d2l(const S (&q)[NQ], const S (&v)[NQ],
                                      S (&out)[NQ]) const {
    const S c = dcos(q[2]), s = dsin(q[2]), r = q[3];
    const S diag(m_diag), zero(T(0));
    const S m02 = S(mf) * r * c, m03 = S(mf) * s;
    const S m12 = S(mf) * r * s, m13 = S(neg_mf) * c;
    const S m22 = S(inertia) + S(mf) * r * r, m33(mf);
    out[0] = diag * v[0] + zero * v[1] + m02 * v[2] + m03 * v[3];
    out[1] = zero * v[0] + diag * v[1] + m12 * v[2] + m13 * v[3];
    out[2] = m02 * v[0] + m12 * v[1] + m22 * v[2] + zero * v[3];
    out[3] = m03 * v[0] + m13 * v[1] + zero * v[2] + m33 * v[3];
  }

  // D1L = -dynamics_bias(q, v) = -(dV/dq - dK/dq)
  template <typename S>
  __device__ __forceinline__ void d1l(const S (&q)[NQ], const S (&v)[NQ],
                                      S (&out)[NQ]) const {
    const S c = dcos(q[2]), s = dsin(q[2]), r = q[3];
    // the foot's velocity J_f v and its derivatives in theta and r
    const S w0 = v[0] + r * c * v[2] + s * v[3];
    const S w1 = v[1] + r * s * v[2] - c * v[3];
    const S dk_th = S(mf) * (w0 * (c * v[3] - r * s * v[2])
                             + w1 * (r * c * v[2] + s * v[3]));
    const S dk_r = S(mf) * v[2] * (w0 * c + w1 * s);
    out[0] = -S(T(0));
    out[1] = -S(bias_z);
    out[2] = -(S(mfg) * r * s - dk_th);
    out[3] = -(S(neg_mfg) * c - dk_r);
  }

  template <typename S>
  __device__ __forceinline__ void residual(const S* z, const T* th,
                                           S* r) const {
    S q0[NQ], q1[NQ], q2[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      q0[i] = S(th[i]);
      q1[i] = S(th[NQ + i]);
      q2[i] = z[i];
    }
    const S u0(th[8]), u1(th[9]), mu_body(th[10]), mu_foot(th[11]);
    const S h(th[12]);
    const S *gam = z + 4, *s_gam = z + 8, *psi = z + 12, *b = z + 14;
    const S *s_psi = z + 16, *s_b = z + 18;
    const S half(T(0.5)), zero(T(0));

    // variational_dynamics
    S qm1[NQ], vm1[NQ], qm2[NQ], vm2[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      qm1[i] = half * (q0[i] + q1[i]);
      vm1[i] = (q1[i] - q0[i]) / h;
      qm2[i] = half * (q1[i] + q2[i]);
      vm2[i] = (q2[i] - q1[i]) / h;
    }
    S d1l1[NQ], d2l1[NQ], d1l2[NQ], d2l2[NQ];
    d1l(qm1, vm1, d1l1);
    d2l(qm1, vm1, d2l1);
    d1l(qm2, vm2, d1l2);
    d2l(qm2, vm2, d2l2);

    // control_force [0, 0, u0, u1] and contact_force at q2
    const S c = dcos(q2[2]), s = dsin(q2[2]), rl = q2[3];
    const S ctrl[NQ] = {zero, zero, u0, u1};
    const S cf[NQ] = {
        b[0] + b[1], gam[0] + gam[1],
        rl * c * b[1] + rl * s * gam[1] + S(body_radius) * b[0],
        s * b[1] - c * gam[1] - gam[2] + gam[3]};
    const S hh = half * h;
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      r[i] = hh * d1l1[i] + d2l1[i] + hh * d1l2[i] - d2l2[i] + ctrl[i]
             + cf[i];

    // s_gamma - signed_distance(q2)
    const S foot_z = q2[1] - q2[3] * dcos(q2[2]);
    r[4] = s_gam[0] - (q2[1] - S(body_radius));
    r[5] = s_gam[1] - (foot_z - S(foot_radius));
    r[6] = s_gam[2] - (S(leg_len_max) - q2[3]);
    r[7] = s_gam[3] - (q2[3] - S(leg_len_min));
    // friction cones' radii
    r[8] = psi[0] - mu_body * gam[0];
    r[9] = psi[1] - mu_foot * gam[1];
    // s_b - slip_velocity(q1, q2, h)
    S v[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) v[i] = (q2[i] - q1[i]) / h;
    r[10] = s_b[0] - (v[0] + S(body_radius) * v[2]);
    r[11] = s_b[1] - (v[0] + rl * c * v[2] + s * v[3]);
    // complementarity, kappa = 0: gamma * s_gamma, then the cone products
    // of (psi_i, b_i) and (s_psi_i, s_b_i)
#pragma unroll
    for (int i = 0; i < 4; ++i) r[12 + i] = gam[i] * s_gam[i];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[16 + 2 * i] = psi[i] * s_psi[i] + b[i] * s_b[i];
      r[17 + 2 * i] = psi[i] * s_b[i] + s_psi[i] * b[i];
    }
  }
};

}  // namespace odt
