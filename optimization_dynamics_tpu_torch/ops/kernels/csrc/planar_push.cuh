// Planar pushing as a device functor for the fused IP solve (K1n).
//
// The residual of optimization_dynamics_tpu_torch/models/planar_push.py
// (``residual`` at kappa = 0), written once as a template on the number
// type S: S = T evaluates it, S = Dual<T> gives one Jacobian column per
// evaluation. The residual holds derivatives of the geometry (the contact
// normal is the gradient of the p=10 smooth-max signed distance, the
// corner rows of the tangential Jacobian differentiate the corner
// positions); they are the closed forms of the Python module, operation
// by operation, so Dual<T> differentiates them once more for the Newton
// Jacobian. The powers are ipow (binary exponentiation, as jnp's
// integer_pow) and dpow (a real exponent).
//
// The cone tables below are ``cone_spec()`` turned into constexpr
// lookups: the row masks of ``_row_masks``, the reset mask and template
// of ``_cone_reset``, the orthant pair and the SOC variable groups with
// their own dimensions (four 3-dim and one 2-dim group, primal then
// dual; -1 pads a 2-dim group's row). ``init_tail`` is the cold start of
// ``init_z``. A CPU test parses these tables and checks them against the
// Python ConeSpec and init_z.
#pragma once

#include "odt_common.cuh"

namespace odt {

template <typename T>
struct PlanarPush {
  static constexpr int NZ = 35;
  static constexpr int NTH = 13;
  static constexpr int NQ = 5;          // configuration; x = [q0; q1]
  static constexpr int NU = 2;
  static constexpr int NAUX = 1;        // theta tail: h
  static constexpr bool HAS_CONES = true;
  static constexpr int N_ORT = 2;       // orthant variables (prim + dual)
  static constexpr int N_SOC = 10;      // SOC groups, primal and dual
  static constexpr int SOC_MAX = 3;     // the largest group's dimension
  static constexpr double R_DIM = 0.1;  // the box's half-width

  __host__ __device__ static constexpr double eq_mask(int i) {
    constexpr double t[NZ] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double bil_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double head_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0,
                              1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_tmpl(int i) {
    constexpr double t[NZ] = {0,   0,   0,   0,   0,   1,   1,   1,   1,
                              1,   1,   1,   0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
                              0.1, 0.1, 0.1, 1,   1,   1,   1,   1,   0.1,
                              0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1};
    return t[i];
  }
  // init_z's tail after q: gamma1, s1, psi = 1; b = 0.1; s_psi = 1;
  // s_b = 0.1
  __host__ __device__ static constexpr double init_tail(int i) {
    constexpr double t[NZ - NQ] = {1,   1,   1,   1,   1,   1,   1,   0.1,
                                   0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
                                   1,   1,   1,   1,   1,   0.1, 0.1, 0.1,
                                   0.1, 0.1, 0.1, 0.1, 0.1, 0.1};
    return t[i];
  }
  // the next configuration's entries of z
  __host__ __device__ static constexpr int q_sel(int i) {
    constexpr int t[NQ] = {0, 1, 2, 3, 4};
    return t[i];
  }
  // gamma1 (primal) and s1 (dual)
  __host__ __device__ static constexpr int ort_idx(int i) {
    constexpr int t[N_ORT] = {5, 6};
    return t[i];
  }
  __host__ __device__ static constexpr int soc_dim(int g) {
    constexpr int t[N_SOC] = {3, 3, 3, 3, 2, 3, 3, 3, 3, 2};
    return t[g];
  }
  __host__ __device__ static constexpr int soc_idx(int g, int j) {
    constexpr int t[N_SOC][SOC_MAX] = {
        {7, 12, 13},  {8, 14, 15},  {9, 16, 17},  {10, 18, 19}, {11, 20, -1},
        {21, 26, 27}, {22, 28, 29}, {23, 30, 31}, {24, 32, 33}, {25, 34, -1}};
    return t[g][j];
  }

  // constants of the residual, combined in double in the order the
  // Python residual combines them, then rounded to T
  T mass[NQ];        // the diagonal mass matrix
  T mu_m_g;          // mu_surface * mass_block * gravity (the budget / h/4)
  T mu_pusher;

  // p: mass_block, mass_pusher, inertia, mu_surface, mu_pusher, gravity
  __host__ PlanarPush(const double* p) {
    const double mb = p[0], mp = p[1], inertia = p[2], mus = p[3];
    mass[0] = T(mb);
    mass[1] = T(mb);
    mass[2] = T(inertia);
    mass[3] = T(mp);
    mass[4] = T(mp);
    mu_m_g = T(mus * mb * p[5]);
    mu_pusher = T(p[4]);
  }

  // the cold start init_z(q1) of models/planar_push.py
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
    th[2 * NQ + NU] = aux[0];
  }

  template <typename S>
  __device__ __forceinline__ void residual(const S* z, const T* th,
                                           S* r) const {
    const S h(th[12]);
    const S gamma1 = z[5], s1 = z[6];
    const S* psi = z + 7;
    const S* b = z + 12;
    const S* s_psi = z + 21;
    const S* s_b = z + 26;
    const S* q2 = z;

    // the block frame: delta = rot(-theta) (pusher - block position)
    const S ang = -q2[2];
    const S c = dcos(ang), s = dsin(ang);
    const S w0 = q2[3] - q2[0], w1 = q2[4] - q2[1];
    const S d0 = c * w0 - s * w1;
    const S d1 = s * w0 + c * w1;
    const S nsum = ipow<10>(d0) + ipow<10>(d1);
    const S phi = dpow(nsum, T(0.1)) - S(T(R_DIM));

    // normal = grad phi: 0.1 * S^(0.1 - 1) * (10 delta^9), rotated back
    const S coef = S(T(0.1)) * dpow(nsum, T(0.1) - T(1));
    const S g0 = coef * (S(T(10)) * ipow<9>(d0));
    const S g1 = coef * (S(T(10)) * ipow<9>(d1));
    const S n3 = g0 * c + g1 * s;
    const S n4 = g1 * c - g0 * s;
    const S n2 = g0 * d1 - g1 * d0;
    const S N[NQ] = {-n3, -n4, n2, n3, n4};

    // P (9 x 5): the corner Jacobian, then the pusher's tangential row
    S P[9][NQ];
    const S ct = dcos(q2[2]), st = dsin(q2[2]);
    const S one(T(1)), zero(T(0));
    const T ca[4] = {T(R_DIM), T(-R_DIM), T(R_DIM), T(-R_DIM)};
    const T cb[4] = {T(R_DIM), T(R_DIM), T(-R_DIM), T(-R_DIM)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const S a(ca[k]), bk(cb[k]);
      P[2 * k][0] = one;
      P[2 * k][1] = zero;
      P[2 * k][2] = -st * a - ct * bk;
      P[2 * k][3] = zero;
      P[2 * k][4] = zero;
      P[2 * k + 1][0] = zero;
      P[2 * k + 1][1] = one;
      P[2 * k + 1][2] = ct * a - st * bk;
      P[2 * k + 1][3] = zero;
      P[2 * k + 1][4] = zero;
    }
    const S nn = dsqrt(n3 * n3 + n4 * n4);
    const S t0 = -(n4 / nn), t1 = n3 / nn;
    const S m = w0 * t1 - w1 * t0;
    P[8][0] = t0;
    P[8][1] = t1;
    P[8][2] = m;
    P[8][3] = -t0;
    P[8][4] = -t1;

    // dynamics: M (vm1 - vm2) + [0, 0, 0, u] + N gamma1 + P^T b
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const S q0i(th[i]), q1i(th[NQ + i]);
      const S vm1 = (q1i - q0i) / h;
      const S vm2 = (q2[i] - q1i) / h;
      S di = S(mass[i]) * (vm1 - vm2);
      if (i >= 3) di = di + S(th[2 * NQ + i - 3]);
      di = di + N[i] * gamma1;
      S pb = P[0][i] * b[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) pb = pb + P[k][i] * b[k];
      r[i] = di + pb;
    }
    r[5] = s1 - phi;
    const S budget = S(mu_m_g) * h * S(T(0.25));
#pragma unroll
    for (int i = 0; i < 4; ++i) r[6 + i] = psi[i] - budget;
    r[10] = psi[4] - S(mu_pusher) * gamma1;
    // tangential velocities P (q2 - q1) / h against the slacks
    S dq[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) dq[j] = q2[j] - S(th[NQ + j]);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      S v = P[k][0] * dq[0];
#pragma unroll
      for (int j = 1; j < NQ; ++j) v = v + P[k][j] * dq[j];
      r[11 + k] = v / h - s_b[k];
    }
    // cone products, kappa = 0
    r[20] = gamma1 * s1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const S a0 = psi[i], a1 = b[2 * i], a2 = b[2 * i + 1];
      const S e0 = s_psi[i], e1 = s_b[2 * i], e2 = s_b[2 * i + 1];
      r[21 + 3 * i] = a0 * e0 + a1 * e1 + a2 * e2;
      r[22 + 3 * i] = a0 * e1 + e0 * a1;
      r[23 + 3 * i] = a0 * e2 + e0 * a2;
    }
    r[33] = psi[4] * s_psi[4] + b[8] * s_b[8];
    r[34] = psi[4] * s_b[8] + s_psi[4] * b[8];
  }
};

}  // namespace odt
