// The path-following interior-point solve of one scenario on a tile of W
// threads (a cooperative-groups thread_block_tile<W>): the counterpart of
// ip_solve_lane (ip_body.cuh) for the tile kernels of K1 (cartpole,
// fused_ip.cu), K1a (acrobot, fused_ip_acrobot.cu) and K4 (fused_rollout.cu,
// one solve a rollout step). W is ip_tile_width<M>(): 16 at nz = 10, 8 at
// nz = 6.
//
// It computes what ip_solve_lane computes, in the same order; only the
// work of one Newton iteration is spread over the tile:
// * Redundant state. Every thread holds z, theta, r0, kappa, the
//   iteration count and the stall and reinit flags, and computes the
//   merits, boundary_alpha, tau and the centring and reinit tests itself.
//   They are bit-identical on every thread, so the whole tile takes every
//   branch of the Newton loop together and leaves it at once.
// * Jacobian. Thread j < NZ computes column j with one dual-number
//   residual, thread NZ forms rk = r0 - kappa * head; the columns stay in
//   registers and qr_solve_group (qr_group.cuh) solves J delta = rk with a
//   column a thread; delta is shuffled from thread NZ to every thread.
// * Line search. Candidate j (alpha0 / 2^j) runs on thread j % W, W at a
//   time. The pick is ip_solve_lane's: the lowest j whose merit is below
//   the current one; otherwise the lowest j of the strict running minimum
//   below BIG; otherwise alpha0 with BIG. A NaN merit never wins, as with
//   the serial ``<``. A chunk that finds an improving candidate ends the
//   sweep: the serial code's later candidates change neither the pick nor
//   the flags. Reductions are xor-shuffle butterflies on (merit, j).
// * The residual at the new z is the picked candidate's (the same
//   expression z - alpha delta on the same values), shuffled from its
//   thread; only after a cone reinit, or a pick from an earlier chunk, is
//   it evaluated again.
//
// S (NZ * (NZ + 1) values) and vb (2 * (NZ + 1)) are the tile's slices of
// shared memory for the QR.
#pragma once

#include <cooperative_groups.h>

#include "ip_body.cuh"
#include "qr_group.cuh"

namespace odt {

// The tile of a scenario: the smallest power of two that holds the NZ
// Jacobian columns and the right-hand side, so a warp holds whole tiles
template <typename M>
__host__ __device__ constexpr int ip_tile_width() {
  int w = 1;
  while (w < M::NZ + 1) w *= 2;
  return w;
}

// threads a block of the tile kernels: 64 measured tied with 128 (PERF.md
// section 6); 64 kept, so 4 tiles of 16 or 8 tiles of 8 a block
constexpr int IP_TILE_BLOCK = 64;
// the tile kernels' __launch_bounds__ minimum of blocks an SM: with 1,
// ptxas gives a kernel the registers it needs; without it, it held K1a's
// float32 tile at 96 registers and spilled (PERF.md section 6)
constexpr int IP_TILE_MIN_BLOCKS = 1;

template <typename M>
__host__ __device__ constexpr int ip_tiles_per_block() {
  static_assert(ip_tile_width<M>() <= 32 &&
                    IP_TILE_BLOCK % ip_tile_width<M>() == 0,
                "a warp and a block hold whole tiles");
  return IP_TILE_BLOCK / ip_tile_width<M>();
}

// Column j of the residual's Jacobian in z into col: one dual-number
// residual seeded on z[j] (jacobian_column's arithmetic)
template <typename T, typename M>
__device__ __forceinline__ void jacobian_column_into(const T (&z)[M::NZ],
                                                     const T (&th)[M::NTH],
                                                     const M& model, int j,
                                                     T (&col)[M::NZ]) {
  constexpr int NZ = M::NZ;
  Dual<T> zd[NZ], rd[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) zd[i] = Dual<T>(z[i], i == j ? T(1) : T(0));
  model.template residual<Dual<T>>(zd, th, rd);
#pragma unroll
  for (int i = 0; i < NZ; ++i) col[i] = rd[i].d;
}

// Solve the tile's IP problem from z (in: the start, out: the solution,
// on every thread). stats as ip_solve_lane's, on every thread.
template <typename T, typename M, int W>
__device__ __forceinline__ void ip_solve_tile(
    const cooperative_groups::thread_block_tile<W>& tile, T (&z)[M::NZ],
    const T (&th)[M::NTH], const M& model, const IPParams<T>& p,
    T (&stats)[4], T* S, T* vb) {
  constexpr int NZ = M::NZ;
  static_assert(NZ + 1 <= W, "a tile holds the Jacobian's columns and rk");
  const T BIG = T(1e12);
  const int rank = static_cast<int>(tile.thread_rank());
  T r0[NZ];

  model.template residual<T>(z, th, r0);
  T kappa = M::HAS_CONES
                ? jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max)
                : p.kappa_final;
  int it = 0;
  bool stalled = false, reinit = false;

  while (it < p.max_iter) {
    if (merit_of<T, M>(r0, p.kappa_final) < p.r_tol || stalled) break;

    T rk[NZ];
    T merit_cur = T(0);
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      rk[i] = r0[i] - kappa * T(M::head_mask(i));
      merit_cur = i == 0 ? jabs(rk[i]) : jmax(merit_cur, jabs(rk[i]));
    }
    // thread j < NZ: column j of J (+ gamma_reg kappa on the diagonal);
    // thread NZ: the right-hand side rk
    T col[NZ];
    if (rank < NZ) {
      jacobian_column_into<T, M>(z, th, model, rank, col);
      if (p.gamma_reg > T(0)) {
#pragma unroll
        for (int i = 0; i < NZ; ++i)
          if (i == rank) col[i] = col[i] + p.gamma_reg * kappa;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NZ; ++i) col[i] = rk[i];
    }
    qr_solve_group<NZ, 1>(tile, col, S, NZ + 1, vb);
    T delta[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) delta[i] = tile.shfl(col[i], NZ);

    const T tau = jclip(T(1) - merit_cur, p.tau_min, p.tau_max);
    const T alpha0 = jmin(boundary_alpha<T, M>(z, delta) * tau, T(1));

    // candidate sweep, W candidates at a time: first improving alpha,
    // else the first minimum. The picked candidate's thread and chunk
    // (src_*) hold the residual at the new z: candidate 0 is alpha0
    // itself, the pick when no candidate counts.
    bool found = false;
    T best_a = T(0), best_m = BIG, min_a = alpha0, min_m = BIG;
    T rc[NZ];
    int src_lane = p.max_ls > 0 ? 0 : -1, src_base = 0, last_base = 0;
    for (int base = 0; base < p.max_ls && !found; base += W) {
      const int j = base + rank;
      const bool valid = j < p.max_ls;
      last_base = base;
      T a_j = T(0), m_j = BIG;
      if (valid) {
        T pw = T(1);  // 0.5^j, exactly as the serial sweep's running power
        for (int q = 0; q < j; ++q) pw = pw * T(0.5);
        a_j = alpha0 * pw;
        T zc[NZ];
#pragma unroll
        for (int i = 0; i < NZ; ++i) zc[i] = z[i] - a_j * delta[i];
        model.template residual<T>(zc, th, rc);
        m_j = merit_of<T, M>(rc, kappa);
      }
      int first = valid && m_j < merit_cur ? rank : W;
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        first = min(first, tile.shfl_xor(first, off));
      if (first < W) {
        best_a = tile.shfl(a_j, first);
        best_m = tile.shfl(m_j, first);
        found = true;
        src_lane = first;
        src_base = base;
      } else {
        // the chunk's lowest-j minimum; NaN, BIG and invalid lanes lose
        T m = valid && m_j < BIG ? m_j : BIG;
        int at = rank;
#pragma unroll
        for (int off = W / 2; off > 0; off >>= 1) {
          const T om = tile.shfl_xor(m, off);
          const int oat = tile.shfl_xor(at, off);
          if (om < m || (om == m && oat < at)) {
            m = om;
            at = oat;
          }
        }
        if (m < min_m) {
          min_a = tile.shfl(a_j, at);
          min_m = m;
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
      for (int i = 0; i < NZ; ++i) r0[i] = tile.shfl(rc[i], src_lane);
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

}  // namespace odt
