// The path-following interior-point solve of one scenario on a group of
// IP_GROUP_THREADS = 64 threads (two warps): the counterpart of
// ip_solve_lane (ip_body.cuh) for K1n's group kernel (planar push, nz =
// 35, fused_ip_push.cu). ip_solve_tile (ip_tile.cuh) does the same for
// nz <= 31, on a tile inside one warp; at nz = 35 the 35 Jacobian columns
// and the right-hand side take 36 threads, more than a warp, and a
// thread cannot hold z, r0, delta and a trial residual beside its
// column and a dual-number residual, so the group keeps one copy of the
// scenario's state in shared memory instead.
//
// It computes what ip_solve_lane computes, in the same order; only the
// work of one Newton iteration is spread over the group:
// * Shared state (IPGroupState): z, theta, r0, delta, kappa and the
//   loop's exit flag, once per scenario, beside the QR's S and vb. Each
//   value has one writer, and a group sync (a named barrier of 64
//   threads, IPGroup) stands between a write and the other warp's reads.
// * Jacobian. Thread j < NZ builds column j with one dual-number residual
//   (jacobian_column_into, ip_tile.cuh) plus gamma_reg kappa on its
//   diagonal, thread NZ forms rk = r0 - kappa * head; qr_solve_group
//   (qr_group.cuh, as K2 runs it at (35, 13)) solves J delta = rk with a
//   column a thread, and thread NZ writes delta to shared memory.
// * Scalar decisions. Every thread of warp 0 computes merit, tau,
//   boundary_alpha and alpha0, the pick, the centring test, the cone
//   reinit and the stall flag from the shared copy, in ip_solve_lane's
//   order, so they are bit-identical across the warp without a
//   broadcast (one thread and a broadcast would take the same time: the
//   chain is serial either way, and the redundant lanes cost no
//   registers that the Jacobian's threads do not already hold); lane 0
//   publishes kappa and the exit flag, and the group sync after the
//   iteration hands them to warp 1, so all 64 threads leave the loop at
//   the same iteration.
// * Line search. Candidate j (alpha0 / 2^j) runs on lane j % 32 of warp
//   0, 32 at a time (push's max_ls = 8 is one chunk), each with its own
//   residual. The pick is ip_solve_lane's: the lowest j whose merit is
//   below the current one; otherwise the lowest j of the strict running
//   minimum below BIG; otherwise alpha0 with BIG; a NaN merit never
//   wins. A chunk that finds an improving candidate ends the sweep.
//   Reductions are xor-shuffle butterflies on (merit, j) in warp 0.
// * The new z is z - alpha delta, element i on lane i % 32; the residual
//   there is the picked candidate's (the same expression on the same
//   values), written to r0 by its lane; only after a cone reinit, or a
//   pick from an earlier chunk, does lane 0 evaluate it again.
#pragma once

#include "ip_body.cuh"
#include "ip_tile.cuh"
#include "qr_group.cuh"

namespace odt {

// threads a scenario: two warps, for the NZ + 1 <= 64 columns
constexpr int IP_GROUP_THREADS = 64;
// threads a block of the group kernel, a multiple of IP_GROUP_THREADS;
// each group of a block syncs on its own named barrier. Two groups a
// block took 0.69-0.73x the time of one at 6,400 scenarios (0.98x at
// 512), four groups 1.02-1.13x (PERF.md section 6)
constexpr int IP_GROUP_BLOCK = 128;
// the group kernel's __launch_bounds__ minimum of blocks an SM: with 1,
// ptxas gives the float32 kernel the registers it needs (162, no spill);
// a minimum of 7 or 8 held it at 128 registers, spilled 276 B and took
// 1.02-1.04x the time (PERF.md section 6)
constexpr int IP_GROUP_MIN_BLOCKS = 1;

__host__ __device__ constexpr int ip_groups_per_block() {
  static_assert(IP_GROUP_BLOCK % IP_GROUP_THREADS == 0 &&
                    IP_GROUP_BLOCK / IP_GROUP_THREADS <= 15,
                "whole groups a block, one named barrier each (1..15)");
  return IP_GROUP_BLOCK / IP_GROUP_THREADS;
}

// A group of IP_GROUP_THREADS threads, warps 2g and 2g + 1 of its block,
// with the interface qr_solve_group takes (thread_rank, sync). sync is
// the named barrier 1 + g over the group's 64 threads (barrier 0 is
// __syncthreads'); it orders the group's shared-memory accesses as
// __syncthreads does a block's.
struct IPGroup {
  int id;
  __device__ explicit IPGroup(int g) : id(1 + g) {}
  __device__ unsigned thread_rank() const {
    return threadIdx.x % IP_GROUP_THREADS;
  }
  __device__ void sync() const {
    asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(IP_GROUP_THREADS)
                 : "memory");
  }
};

// A scenario's state in shared memory. S (NZ * (NZ + 1) values, row
// stride NZ + 1) and vb (2 * (NZ + 1)) are qr_solve_group's.
template <typename T, typename M>
struct IPGroupState {
  T S[M::NZ * (M::NZ + 1)];
  T vb[2 * (M::NZ + 1)];
  T z[M::NZ], th[M::NTH], r0[M::NZ], delta[M::NZ];
  T kappa;
  int stop;  // converged or stalled: leave the Newton loop
};

// Solve the group's IP problem from s.z (in: the start, out: the
// solution), with theta in s.th; the caller syncs the group after
// writing them. stats as ip_solve_lane's, on thread 0.
template <typename T, typename M>
__device__ __forceinline__ void ip_solve_group(const IPGroup& g,
                                               const M& model,
                                               const IPParams<T>& p,
                                               IPGroupState<T, M>& s,
                                               T (&stats)[4]) {
  constexpr int NZ = M::NZ;
  constexpr int W = 32;
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(NZ + 1 <= IP_GROUP_THREADS,
                "a group holds the Jacobian's columns and rk");
  const T BIG = T(1e12);
  const int rank = static_cast<int>(g.thread_rank());
  const int lane = rank % W;

  if (rank == 0) {
    T r0[NZ];
    model.template residual<T>(s.z, s.th, r0);
#pragma unroll
    for (int i = 0; i < NZ; ++i) s.r0[i] = r0[i];
    s.kappa = M::HAS_CONES ? jclip(row_vio<T, M>(r0, true), p.kappa_lo,
                                   p.kappa_init_max)
                           : p.kappa_final;
    s.stop = merit_of<T, M>(r0, p.kappa_final) < p.r_tol;
  }
  g.sync();
  int it = 0;
  bool stalled = false, reinit = false;  // warp 0's

  while (it < p.max_iter) {
    if (s.stop) break;
    T kappa = s.kappa;

    // thread j < NZ: column j of J (+ gamma_reg kappa on the diagonal);
    // thread NZ: the right-hand side rk
    T col[NZ];
    if (rank < NZ) {
      jacobian_column_into<T, M>(s.z, s.th, model, rank, col);
      if (p.gamma_reg > T(0)) {
#pragma unroll
        for (int i = 0; i < NZ; ++i)
          if (i == rank) col[i] = col[i] + p.gamma_reg * kappa;
      }
    } else if (rank == NZ) {
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        col[i] = s.r0[i] - kappa * T(M::head_mask(i));
    }
    qr_solve_group<NZ, 1>(g, col, s.S, NZ + 1, s.vb);
    if (rank == NZ) {
#pragma unroll
      for (int i = 0; i < NZ; ++i) s.delta[i] = col[i];
    }
    g.sync();

    if (rank < W) {
      T merit_cur = T(0);
#pragma unroll
      for (int i = 0; i < NZ; ++i) {
        const T rk = s.r0[i] - kappa * T(M::head_mask(i));
        merit_cur = i == 0 ? jabs(rk) : jmax(merit_cur, jabs(rk));
      }
      const T tau = jclip(T(1) - merit_cur, p.tau_min, p.tau_max);
      const T alpha0 = jmin(boundary_alpha<T, M>(s.z, s.delta) * tau, T(1));

      // candidate sweep, W candidates at a time: first improving alpha,
      // else the first minimum. The picked candidate's lane and chunk
      // (src_*) hold the residual at the new z: candidate 0 is alpha0
      // itself, the pick when no candidate counts.
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
          T pw = T(1);  // 0.5^j, exactly as the serial sweep's running power
          for (int q = 0; q < j; ++q) pw = pw * T(0.5);
          a_j = alpha0 * pw;
          T zc[NZ];
#pragma unroll
          for (int i = 0; i < NZ; ++i) zc[i] = s.z[i] - a_j * s.delta[i];
          model.template residual<T>(zc, s.th, rc);
          m_j = merit_of<T, M>(rc, kappa);
        }
        int first = valid && m_j < merit_cur ? lane : W;
#pragma unroll
        for (int off = W / 2; off > 0; off >>= 1)
          first = min(first, __shfl_xor_sync(FULL, first, off));
        if (first < W) {
          best_a = __shfl_sync(FULL, a_j, first);
          best_m = __shfl_sync(FULL, m_j, first);
          found = true;
          src_lane = first;
          src_base = base;
        } else {
          // the chunk's lowest-j minimum; NaN, BIG and invalid lanes lose
          T m = valid && m_j < BIG ? m_j : BIG;
          int at = lane;
#pragma unroll
          for (int off = W / 2; off > 0; off >>= 1) {
            const T om = __shfl_xor_sync(FULL, m, off);
            const int oat = __shfl_xor_sync(FULL, at, off);
            if (om < m || (om == m && oat < at)) {
              m = om;
              at = oat;
            }
          }
          if (m < min_m) {
            min_a = __shfl_sync(FULL, a_j, at);
            min_m = m;
            src_lane = at;
            src_base = base;
          }
        }
      }
      const T alpha = found ? best_a : min_a;
      const T new_merit = found ? best_m : min_m;
      bool stalled_new = !found;

      __syncwarp();  // every lane has read z for its candidate
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        if (i % W == lane) s.z[i] = s.z[i] - alpha * s.delta[i];
      const bool centered = new_merit < jmax(p.center_frac * kappa, p.r_tol);
      if (centered) kappa = jmax(kappa * p.kappa_scale, p.kappa_final);

      bool do_reinit = false;
      if (M::HAS_CONES) {
        do_reinit = stalled_new && !reinit;
        if (do_reinit) {
#pragma unroll
          for (int i = 0; i < NZ; ++i)
            if (i % W == lane && M::reset_mask(i) != 0.0)
              s.z[i] = T(M::reset_tmpl(i));
        }
        stalled_new = stalled_new && reinit;
        reinit = reinit || do_reinit;
      }
      stalled = stalled_new;
      __syncwarp();

      // r0 at the new z: z - alpha delta is the picked candidate's z -
      // a_j delta, so its residual is r0, unless the reinit moved z or
      // the candidate's chunk has been overwritten
      if (!do_reinit && src_lane >= 0 && src_base == last_base) {
        if (lane == src_lane) {
#pragma unroll
          for (int i = 0; i < NZ; ++i) s.r0[i] = rc[i];
        }
      } else if (lane == 0) {
        T r0[NZ];
        model.template residual<T>(s.z, s.th, r0);
#pragma unroll
        for (int i = 0; i < NZ; ++i) s.r0[i] = r0[i];
      }
      __syncwarp();
      if (do_reinit)
        kappa = jclip(row_vio<T, M>(s.r0, true), p.kappa_lo, p.kappa_init_max);
      if (lane == 0) {
        s.kappa = kappa;
        s.stop = merit_of<T, M>(s.r0, p.kappa_final) < p.r_tol || stalled;
      }
    }
    g.sync();
    ++it;
  }

  if (rank == 0) {
    const bool conv = merit_of<T, M>(s.r0, p.kappa_final) < p.r_tol;
    stats[0] = T(it);
    stats[1] = conv ? T(1) : T(0);
    stats[2] = row_vio<T, M>(s.r0, false);
    stats[3] = row_vio<T, M>(s.r0, true);
  }
}

}  // namespace odt
