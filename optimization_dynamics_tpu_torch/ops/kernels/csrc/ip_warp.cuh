// K1's warp kernel: the path-following interior-point solve of one
// scenario on one full warp, its Newton step held in registers and
// synchronised by shuffles (qr_shfl.cuh). Instantiated only for the
// rocket's thrust projection (fused_ip_rocket.cu: nz = 10, ntheta = 4,
// always cold, max_ls = 25 line-search candidates); K1 cartpole, K1a,
// K4 and the hopper model keep ip_tile.cuh.
//
// Replaces, for that functor, the wide-lane Pallas call of
// optimization_dynamics_tpu/ops/pallas/fused_ip.py (make_fused_ip_solver,
// the pl.pallas_call at :410, body make_ip_body :133, QR _qr_solve_block
// of batched_solve.py:34).
//
// What bounds it on an H100: neither bytes (a scenario reads 14 values and
// writes 14) nor operations (0.25% of the 16-thread tile's time at 512
// scenarios, PERF.md section 6), but the latency of each scenario's
// serial Newton chain, which sets the launch's time through its slowest
// scenario: the rocket deploy launches it 32-1,024 scenarios wide, one
// warp a scheduler or fewer, with nothing to hide a latency behind. On
// the card a float32 division or square root is 47-48 cycles of
// latency, a shuffle 26, an FMA 4; the tile's iteration took about 10,000
// cycles, 42% of them in the reflector steps, 14% in the back
// substitution and 32% in the line search with its step to the boundary
// (clock64 stamps, PERF.md section 6). So the design takes cycles off
// that chain; it computes what ip_solve_tile (ip_tile.cuh) computes, to
// the bit where its sums keep their order:
// * Redundant state, as the tile: every lane holds z, theta, r0, kappa,
//   the count and the flags, bit-identical, so the warp takes every
//   branch together.
// * Jacobian: lane j < NZ builds column j with one dual-number residual,
//   every other lane column NZ - 1 (so no lane branches off), and lane NZ
//   keeps the right-hand side rk.
// * Newton step: qr_solve_shfl<NZ, 32> (qr_shfl.cuh) instead of
//   qr_solve_group's shared-memory round trip and tile barrier a
//   reflector step and its one-lane back substitution out of shared
//   memory: every lane builds each reflector from a pivot column it keeps
//   updated itself and runs the back substitution from R's shuffled rows,
//   so every lane ends with delta and nothing is shuffled out of lane NZ.
// * Step to the boundary: boundary_alpha_warp spreads boundary_alpha's
//   dozen divisions and two square roots over the lanes (a piece a lane,
//   one division each) and combines them in its order, so its result is
//   boundary_alpha's to the bit.
// * The merits (|r - kappa head|_inf) are pairwise trees of the same
//   maxima (merit_tree): a maximum rounds nothing, so the value is the
//   serial chain's.
// * Line search: the 32 lanes hold all max_ls = 25 candidates in one
//   chunk. Candidate j's step is alpha0 * 2^-j with 2^-j built exactly
//   (pow_half), the serial sweep's alpha0 * pw with pw = 0.5^j exact,
//   instead of a chain of j multiplies. The first improving candidate is
//   the lowest set bit of one ballot (the tile: a 4-level butterfly);
//   failing that, the chunk's minimum is a 5-level butterfly on the merit
//   alone and its lowest j the lowest bit of a second ballot. The pick is
//   the serial sweep's: the lowest j below the current merit; else the
//   lowest j of the minimum below BIG; else alpha0 with BIG; a NaN merit
//   never wins. max_ls above 32 runs in chunks of 32, as the tile's
//   chunks of 16.
// * The residual at the new z is the picked candidate's, shuffled from
//   its lane, as the tile's.
#pragma once

#include <cstdint>

#include "ip_body.cuh"
#include "ip_tile.cuh"
#include "qr_shfl.cuh"

namespace odt {

// threads a block of the warp kernel: two scenarios, so a launch of 32 to
// 1,024 scenarios spreads over as many SMs as the card gives it
constexpr int IP_WARP_BLOCK = 64;

// The largest of |r_i - kappa head_i|, NaN-propagating (merit_of's), as a
// pairwise tree instead of merit_of's chain: a maximum rounds nothing, so
// the tree gives the chain's value, NaN where it gives NaN (only a zero's
// sign may differ, which no comparison sees)
template <typename T, typename M>
__device__ __forceinline__ T merit_tree(const T (&r)[M::NZ], T kappa) {
  T a[M::NZ];
#pragma unroll
  for (int i = 0; i < M::NZ; ++i)
    a[i] = jabs(r[i] - kappa * T(M::head_mask(i)));
#pragma unroll
  for (int w = 1; w < M::NZ; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < M::NZ; i += 2 * w) a[i] = jmax(a[i], a[i + w]);
  }
  return a[0];
}

// boundary_alpha (ip_body.cuh) with its divisions spread over the lanes.
// The pieces of the step to the boundary are the orthants' ratios z_k /
// d_k and, for each SOC group, four quotients of soc_alpha: the axis
// ratio z0 / d0, the quadratic's two roots and the linear root. Lane p <
// N_ORT computes orthant p's, lane N_ORT + 4 g + q group g's piece q,
// every lane running the same instructions on its own operands, so the
// warp pays one square root and one division where one lane paid a
// dozen in sequence; then every lane takes the pieces by shuffles and
// combines them in boundary_alpha's order with soc_alpha's tests. Each
// piece and each test is soc_alpha's expression on the same values, so
// every lane returns boundary_alpha's bits.
template <typename T, typename M>
__device__ __forceinline__ T boundary_alpha_warp(int lane,
                                                 const T (&z)[M::NZ],
                                                 const T (&d)[M::NZ]) {
  constexpr int NO = M::N_ORT, NS = M::N_SOC, SM = M::SOC_MAX;
  static_assert(NO + 4 * NS <= 32, "a lane a piece");
  const T BIG = T(1e12);
  // soc_alpha's sums and coefficients of group g
  struct Soc {
    T z0, d0, A, Bq, C, disc;
  };
  Soc all[NS];
#pragma unroll
  for (int g = 0; g < NS; ++g) {
    Soc& o = all[g];
    o.z0 = z[M::soc_idx(g, 0)];
    o.d0 = d[M::soc_idx(g, 0)];
    T dd = T(0), zd = T(0), zz = T(0);
#pragma unroll
    for (int j = 1; j < SM; ++j) {
      if (j < M::soc_dim(g)) {
        const T zj = z[M::soc_idx(g, j)], dj = d[M::soc_idx(g, j)];
        dd += dj * dj;
        zd += zj * dj;
        zz += zj * zj;
      }
    }
    o.A = o.d0 * o.d0 - dd;
    o.Bq = T(-2) * (o.z0 * o.d0 - zd);
    o.C = o.z0 * o.z0 - zz;
    o.disc = o.Bq * o.Bq - T(4) * o.A * o.C;
  }

  // this lane's piece: numerator and denominator
  const int q = (lane - NO) & 3;
  Soc mine = all[0];
#pragma unroll
  for (int g = 1; g < NS; ++g)
    if (lane >= NO + 4 * g) mine = all[g];
  const T sq = sqrt(jmax(mine.disc, T(0)));
  const T safe_A = jabs(mine.A) > T(1e-30) ? mine.A : T(1);
  T num = z[M::ort_idx(0)], den = d[M::ort_idx(0)];
#pragma unroll
  for (int k = 1; k < NO; ++k) {
    if (lane == k) {
      num = z[M::ort_idx(k)];
      den = d[M::ort_idx(k)];
    }
  }
  if (lane >= NO) {
    num = q == 0 ? mine.z0 : q == 1 ? -mine.Bq - sq
          : q == 2 ? -mine.Bq + sq : -mine.C;
    den = q == 0 ? mine.d0 : q == 3 ? mine.Bq : T(2) * safe_A;
  }
  const T quo = num / den;

  T a = BIG;
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const T r = __shfl_sync(FULL_WARP, quo, k);
    a = jmin(a, d[M::ort_idx(k)] > T(0) ? r : BIG);
  }
#pragma unroll
  for (int g = 0; g < NS; ++g) {
    const Soc& o = all[g];
    const int base = NO + 4 * g;
    const T axis = __shfl_sync(FULL_WARP, quo, base);
    const T r1 = __shfl_sync(FULL_WARP, quo, base + 1);
    const T r2 = __shfl_sync(FULL_WARP, quo, base + 2);
    const T lq = __shfl_sync(FULL_WARP, quo, base + 3);
    const T a_axis = o.d0 > T(0) ? axis : BIG;
    const T lo = jmin(r1, r2);
    const T hi = jmax(r1, r2);
    const T quad = lo > T(0) ? lo : (hi > T(0) ? hi : BIG);
    T lin = jabs(o.Bq) > T(1e-30) ? lq : BIG;
    lin = lin > T(0) ? lin : BIG;
    T root = jabs(o.A) > T(1e-30) ? quad : lin;
    root = o.disc >= T(0) ? root : BIG;
    a = jmin(a, jmin(root, a_axis));
  }
  return jmin(a, T(1));
}

// 0.5^j exactly: the serial sweep's running power, without its chain
__device__ __forceinline__ float pow_half(float, int j) {
  return j < 127 ? __int_as_float((127 - j) << 23) : ldexpf(1.0f, -j);
}
__device__ __forceinline__ double pow_half(double, int j) {
  return j < 1023 ? __longlong_as_double(static_cast<long long>(1023 - j)
                                         << 52)
                  : ldexp(1.0, -j);
}

template <typename T, typename M>
__device__ __forceinline__ void ip_solve_warp(T (&z)[M::NZ],
                                              const T (&th)[M::NTH],
                                              const M& model,
                                              const IPParams<T>& p,
                                              T (&stats)[4]) {
  constexpr int NZ = M::NZ;
  constexpr int W = 32;
  static_assert(NZ + 1 <= W, "a warp holds the Jacobian's columns and rk");
  const T BIG = T(1e12);
  const int lane = static_cast<int>(threadIdx.x) & (W - 1);
  T r0[NZ];

  model.template residual<T>(z, th, r0);
  T kappa = M::HAS_CONES
                ? jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max)
                : p.kappa_final;
  int it = 0;
  bool stalled = false, reinit = false;

  while (it < p.max_iter) {
    if (merit_tree<T, M>(r0, p.kappa_final) < p.r_tol || stalled) break;

    T rk[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) rk[i] = r0[i] - kappa * T(M::head_mask(i));
    const T merit_cur = merit_tree<T, M>(rk, T(0));
    // lane j < NZ: column j of J (+ gamma_reg kappa on the diagonal);
    // lane NZ: the right-hand side rk. Every lane builds a column (the
    // last one above NZ), so the warp runs one residual pass undivided.
    const int jc = lane < NZ ? lane : NZ - 1;
    T col[NZ];
    jacobian_column_into<T, M>(z, th, model, jc, col);
    if (p.gamma_reg > T(0)) {
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        if (i == jc) col[i] = col[i] + p.gamma_reg * kappa;
    }
#pragma unroll
    for (int i = 0; i < NZ; ++i) col[i] = lane < NZ ? col[i] : rk[i];
    T delta[NZ];
    qr_solve_shfl<NZ, W>(lane, col, delta);

    const T tau = jclip(T(1) - merit_cur, p.tau_min, p.tau_max);
    const T alpha0 =
        jmin(boundary_alpha_warp<T, M>(lane, z, delta) * tau, T(1));

    // candidate sweep, W candidates a chunk: first improving alpha, else
    // the first minimum; candidate 0 (alpha0 itself) is the pick when no
    // candidate counts. src_*: the picked candidate's lane and chunk,
    // which hold the residual at the new z.
    bool found = false;
    T best_a = T(0), best_m = BIG, min_a = alpha0, min_m = BIG;
    T rc[NZ];
    int src_lane = p.max_ls > 0 ? 0 : -1, src_base = 0, last_base = 0;
    for (int base = 0; base < p.max_ls && !found; base += W) {
      const int j = base + lane;
      const bool valid = j < p.max_ls;
      last_base = base;
      T a_j = T(0), m_j = BIG;
      if (valid) {
        a_j = alpha0 * pow_half(T(0), j);
        T zc[NZ];
#pragma unroll
        for (int i = 0; i < NZ; ++i) zc[i] = z[i] - a_j * delta[i];
        model.template residual<T>(zc, th, rc);
        m_j = merit_tree<T, M>(rc, kappa);
      }
      const unsigned improving =
          __ballot_sync(FULL_WARP, valid && m_j < merit_cur);
      if (improving != 0u) {
        const int first = __ffs(improving) - 1;
        best_a = __shfl_sync(FULL_WARP, a_j, first);
        best_m = __shfl_sync(FULL_WARP, m_j, first);
        found = true;
        src_lane = first;
        src_base = base;
      } else {
        // the chunk's lowest-j minimum; NaN, BIG and invalid lanes lose
        const T m = valid && m_j < BIG ? m_j : BIG;
        T lo = m;
#pragma unroll
        for (int off = W / 2; off > 0; off >>= 1) {
          const T o = __shfl_xor_sync(FULL_WARP, lo, off);
          lo = o < lo ? o : lo;
        }
        if (lo < min_m) {
          const int at = __ffs(__ballot_sync(FULL_WARP, m == lo)) - 1;
          min_a = __shfl_sync(FULL_WARP, a_j, at);
          min_m = lo;
          src_lane = at;
          src_base = base;
        }
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

    // r0 at the new z: z - alpha delta is the picked candidate's z - a_j
    // delta, so its residual is r0, unless the reinit moved z or the
    // candidate's chunk has been overwritten
    if (!do_reinit && src_lane >= 0 && src_base == last_base) {
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        r0[i] = __shfl_sync(FULL_WARP, rc[i], src_lane);
    } else {
      model.template residual<T>(z, th, r0);
    }
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

// One warp a scenario, IP_WARP_BLOCK / 32 a block. A warp whose scenario
// is past B returns as a whole, before any shuffle.
template <typename T, typename M>
__global__ void __launch_bounds__(IP_WARP_BLOCK)
fused_ip_warp_kernel(const T* __restrict__ z0s, const T* __restrict__ ths,
                     T* __restrict__ zs_out, T* __restrict__ stats, int B,
                     M model, IPParams<T> p) {
  constexpr int NZ = M::NZ;
  constexpr int NTH = M::NTH;
  const int64_t lane_id =
      ((int64_t)blockIdx.x * IP_WARP_BLOCK + threadIdx.x) / 32;
  if (lane_id >= B) return;

  T z[NZ], th[NTH], st[4];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = z0s[lane_id * NZ + i];
#pragma unroll
  for (int i = 0; i < NTH; ++i) th[i] = ths[lane_id * NTH + i];

  ip_solve_warp<T, M>(z, th, model, p, st);

  const int lane = static_cast<int>(threadIdx.x) & 31;
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    if (i == lane) zs_out[lane_id * NZ + i] = z[i];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) stats[lane_id * 4 + i] = st[i];
  }
}

template <typename T, typename M>
int launch_fused_ip_warp(const void* z0s, const void* ths, void* zs,
                         void* stats, int B, const double* model_params,
                         const double* ip, void* stream) {
  if (B <= 0) return 0;
  const IPParams<T> p = make_ip_params<T>(ip);
  const M model(model_params);
  constexpr int per_block = IP_WARP_BLOCK / 32;
  const int blocks = (B + per_block - 1) / per_block;
  fused_ip_warp_kernel<T, M>
      <<<blocks, IP_WARP_BLOCK, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(z0s), static_cast<const T*>(ths),
          static_cast<T*>(zs), static_cast<T*>(stats), B, model, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

#define ODT_FUSED_IP_WARP(NAME, FUNCTOR, SUFFIX, T)                          \
  int odt_fused_ip_warp_##NAME##_##SUFFIX(                                    \
      const void* z0s, const void* ths, void* zs, void* stats, int B,         \
      const double* model_params, const double* ip, void* stream) {           \
    return odt::launch_fused_ip_warp<T, odt::FUNCTOR<T>>(                     \
        z0s, ths, zs, stats, B, model_params, ip, stream);                    \
  }
