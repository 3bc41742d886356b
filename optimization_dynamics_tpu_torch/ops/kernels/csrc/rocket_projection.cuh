// The rocket's thrust-cone projection as a device functor for the fused
// IP solve (K1 at nz = 10).
//
// The residual of optimization_dynamics_tpu_torch/models/rocket.py
// (``residual_proj`` at kappa = 0): the KKT system of
//   min ||u - u_bar||  subject to  ||u_xy|| <= u_z <= u_max,
// with z = [u (3), p, s, w, y, v (3)] and theta = [u_bar (3), u_max].
// Written once as a template on the number type S: S = T evaluates it,
// S = Dual<T> gives one Jacobian column per evaluation. The arithmetic
// follows the Python residual operation by operation; it is all adds and
// products (no sin, cos or division), and the model has no constants:
// u_max arrives in theta, so the host constructor reads nothing.
//
// The cone tables below are ``cone_spec_proj()`` turned into constexpr
// lookups: the row masks of ``_row_masks``, the reset mask and template
// of ``_cone_reset``, the orthant variables (the pairs (s, w) and (u_z,
// p), primal then dual) and the two SOC(3) groups, axis first: the
// primal (u_z, u_x, u_y) = z[2, 0, 1] and the dual (v_z, v_x, v_y) =
// z[9, 7, 8]. u_z (z[2]) is both an orthant variable and the primal
// cone's axis, as in the Python spec, so both bounds of the
// fraction-to-boundary step read it. The projection always starts cold
// from ``init_z_proj``, which the caller passes as z0s, so the functor
// has no ``init_z``. A CPU test parses these tables and checks them
// against the Python ConeSpec.
#pragma once

#include "odt_common.cuh"

namespace odt {

template <typename T>
struct RocketProjection {
  static constexpr int NZ = 10;
  static constexpr int NTH = 4;
  static constexpr bool HAS_CONES = true;
  static constexpr int N_ORT = 4;       // orthant variables (prim + dual)
  static constexpr int N_SOC = 2;       // SOC groups, primal and dual
  static constexpr int SOC_MAX = 3;     // the largest group's dimension

  __host__ __device__ static constexpr double eq_mask(int i) {
    constexpr double t[NZ] = {1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double bil_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 1, 1, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double head_mask(int i) {
    constexpr double t[NZ] = {0, 0, 0, 0, 0, 1, 1, 1, 0, 0};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_mask(int i) {
    constexpr double t[NZ] = {1, 1, 1, 1, 1, 1, 0, 1, 1, 1};
    return t[i];
  }
  __host__ __device__ static constexpr double reset_tmpl(int i) {
    constexpr double t[NZ] = {0.1, 0.1, 1, 1, 1, 1, 0, 0.1, 0.1, 1};
    return t[i];
  }
  // s, u_z (primal) and w, p (dual)
  __host__ __device__ static constexpr int ort_idx(int i) {
    constexpr int t[N_ORT] = {4, 2, 5, 3};
    return t[i];
  }
  __host__ __device__ static constexpr int soc_dim(int g) {
    constexpr int t[N_SOC] = {3, 3};
    return t[g];
  }
  __host__ __device__ static constexpr int soc_idx(int g, int j) {
    constexpr int t[N_SOC][SOC_MAX] = {{2, 0, 1}, {9, 7, 8}};
    return t[g][j];
  }

  // no constants: model_params is empty
  __host__ explicit RocketProjection(const double*) {}

  template <typename S>
  __device__ __forceinline__ void residual(const S* z, const T* th,
                                           S* r) const {
    const S u0 = z[0], u1 = z[1], u2 = z[2], p = z[3], s = z[4];
    const S w = z[5], y = z[6], v0 = z[7], v1 = z[8], v2 = z[9];
    const S ub0(th[0]), ub1(th[1]), ub2(th[2]), u_max(th[3]);

    // d = u - u_bar - v
    const S d0 = u0 - ub0 - v0;
    const S d1 = u1 - ub1 - v1;
    const S d2 = u2 - ub2 - v2;
    r[0] = d0;
    r[1] = d1;
    r[2] = d2 - (y + p);
    r[3] = u_max - u2 - s;
    r[4] = -y - w;
    // orthant products, kappa = 0
    r[5] = w * s;
    r[6] = p * u2;
    // cone_product([u2, u0, u1], [v2, v0, v1]), kappa = 0
    r[7] = u2 * v2 + u0 * v0 + u1 * v1;
    r[8] = u2 * v0 + v2 * u0;
    r[9] = u2 * v1 + v2 * u1;
  }
};

}  // namespace odt
