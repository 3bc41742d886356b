// Where one Newton iteration of K1 on the rocket's projection, and one K2
// solve at (12, 1), spend their cycles: copies of the kernels' bodies with
// clock64() stamps between their phases, built apart from the library by
// tools/phase_split.py, so no stamp enters the kernels the port runs.
// * k1_probe: the 16-thread tile (ip_tile.cuh's ip_solve_tile with
//   qr_group.cuh's solve), stamped around the Jacobian, the reflector
//   steps, the back substitution, the line search and the rest, and
//   counting the iterations whose line search needed a second chunk;
// * k1w_probe: the warp kernel (ip_warp.cuh's ip_solve_warp with
//   qr_shfl.cuh's solve, ROLLED = false), its line search split into the
//   step to the boundary, the candidates and the pick; with ROLLED = true
//   its QR's step and back-substitution loops stay rolled (a runtime
//   pivot, every row under a predicate), to test whether instruction
//   fetch or the arithmetic's latency sets its time;
// * k2_probe, k2_thread_probe, k2s_probe: K2 at (12, 1) as the staging
//   tile (staging, solve, write-back), the per-thread kernel (whole) and
//   the shuffle kernel (load, steps, back substitution, store);
// * lat_probe: the latency of a dependent chain of each operation the
//   solves wait on, in one warp.
// The copies must follow the kernels they copy: a change to ip_tile.cuh,
// ip_warp.cuh, qr_group.cuh, qr_shfl.cuh or batched_solve.cu's tile goes
// here too.
#include "fused_ip.cuh"
#include "rocket_projection.cuh"
#include "ip_warp.cuh"

namespace odt {

template <typename G>
__device__ __forceinline__ long long stamp(const G& t) {
  t.sync();
  return clock64();
}

__device__ __forceinline__ long long wstamp() {
  __syncwarp();
  return clock64();
}

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int N, int K, typename G, typename T>
__device__ __forceinline__ void qr_probe(const G& g, T (&col)[N], T* S,
                                         int ld, T* vb, long long& t_mid) {
  const int c = static_cast<int>(g.thread_rank());
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T* v = vb + (i & 1) * (N + 1);
    if (c == i) {
      T normsq = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) normsq += col[r] * col[r];
      const T normx = sqrt(normsq);
      const T x0 = col[i];
      const T sign = x0 >= T(0) ? T(1) : T(-1);
      const T alpha = -sign * normx;
      T vnorm2 = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) {
        const T vr = r == i ? x0 - alpha : col[r];
        v[r] = vr;
        vnorm2 += vr * vr;
      }
      v[N] = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);
    }
    g.sync();
    if (c >= i && c < N + K) {
      const T inv = v[N];
      T w = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) w += v[r] * col[r];
#pragma unroll
      for (int r = i; r < N; ++r) col[r] = col[r] - (inv * v[r]) * w;
    }
  }
  g.sync();
  t_mid = clock64();
  if (c < N) {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r <= c) S[r * ld + c] = col[r];
  }
  g.sync();
  if (c >= N && c < N + K) {
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      const T diag = S[i * ld + i];
      const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
      T s = T(0);
#pragma unroll
      for (int j = i + 1; j < N; ++j) s += S[i * ld + j] * col[j];
      col[i] = (col[i] - s) / safe;
    }
  }
}

// prof[lane * 8 + ...]: iterations, second-chunk iterations, cycles of
// jacobian, qr steps, back substitution (+ delta shuffle), line search,
// the rest (step, centring, residual), whole solve
template <typename T, typename M, int W>
__device__ __forceinline__ void ip_probe(
    const cooperative_groups::thread_block_tile<W>& tile, T (&z)[M::NZ],
    const T (&th)[M::NTH], const M& model, const IPParams<T>& p,
    T (&stats)[4], T* S, T* vb, long long (&acc)[8]) {
  constexpr int NZ = M::NZ;
  const T BIG = T(1e12);
  const int rank = static_cast<int>(tile.thread_rank());
  T r0[NZ];
  const long long t_start = stamp(tile);
  model.template residual<T>(z, th, r0);
  T kappa = M::HAS_CONES
                ? jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max)
                : p.kappa_final;
  int it = 0;
  bool stalled = false, reinit = false;
  long long chunk2 = 0;
  while (it < p.max_iter) {
    if (merit_of<T, M>(r0, p.kappa_final) < p.r_tol || stalled) break;
    const long long t0 = stamp(tile);
    T rk[NZ];
    T merit_cur = T(0);
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      rk[i] = r0[i] - kappa * T(M::head_mask(i));
      merit_cur = i == 0 ? jabs(rk[i]) : jmax(merit_cur, jabs(rk[i]));
    }
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
    const long long t1 = stamp(tile);
    long long t2;
    qr_probe<NZ, 1>(tile, col, S, NZ + 1, vb, t2);
    T delta[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) delta[i] = tile.shfl(col[i], NZ);
    const long long t3 = stamp(tile);

    const T tau = jclip(T(1) - merit_cur, p.tau_min, p.tau_max);
    const T alpha0 = jmin(boundary_alpha<T, M>(z, delta) * tau, T(1));
    bool found = false;
    T best_a = T(0), best_m = BIG, min_a = alpha0, min_m = BIG;
    T rc[NZ];
    int src_lane = p.max_ls > 0 ? 0 : -1, src_base = 0, last_base = 0;
    for (int base = 0; base < p.max_ls && !found; base += W) {
      if (base > 0) ++chunk2;
      const int j = base + rank;
      const bool valid = j < p.max_ls;
      last_base = base;
      T a_j = T(0), m_j = BIG;
      if (valid) {
        T pw = T(1);
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
    const long long t4 = stamp(tile);
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
    if (!do_reinit && src_lane >= 0 && src_base == last_base) {
#pragma unroll
      for (int i = 0; i < NZ; ++i) r0[i] = tile.shfl(rc[i], src_lane);
    } else {
      model.template residual<T>(z, th, r0);
    }
    if (do_reinit)
      kappa = jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max);
    ++it;
    const long long t5 = stamp(tile);
    acc[2] += t1 - t0;
    acc[3] += t2 - t1;
    acc[4] += t3 - t2;
    acc[5] += t4 - t3;
    acc[6] += t5 - t4;
  }
  const bool conv = merit_of<T, M>(r0, p.kappa_final) < p.r_tol;
  stats[0] = T(it);
  stats[1] = conv ? T(1) : T(0);
  stats[2] = row_vio<T, M>(r0, false);
  stats[3] = row_vio<T, M>(r0, true);
  acc[0] = it;
  acc[1] = chunk2;
  acc[7] = stamp(tile) - t_start;
}

template <typename T>
__global__ void __launch_bounds__(IP_TILE_BLOCK, IP_TILE_MIN_BLOCKS)
k1_probe(const T* __restrict__ z0s, const T* __restrict__ ths,
         T* __restrict__ zs_out, T* __restrict__ stats,
         long long* __restrict__ prof, int B, RocketProjection<T> model,
         IPParams<T> p) {
  namespace cg = cooperative_groups;
  using M = RocketProjection<T>;
  constexpr int NZ = M::NZ;
  constexpr int NTH = M::NTH;
  constexpr int W = ip_tile_width<M>();
  constexpr int TILES = ip_tiles_per_block<M>();
  __shared__ T S[TILES][NZ * (NZ + 1)];
  __shared__ T vb[TILES][2 * (NZ + 1)];
  const cg::thread_block_tile<W> tile =
      cg::tiled_partition<W>(cg::this_thread_block());
  const int t = threadIdx.x / W;
  const int64_t lane = (int64_t)blockIdx.x * TILES + t;
  if (lane >= B) return;
  T z[NZ], th[NTH], st[4];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = z0s[lane * NZ + i];
#pragma unroll
  for (int i = 0; i < NTH; ++i) th[i] = ths[lane * NTH + i];
  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  ip_probe<T, M, W>(tile, z, th, model, p, st, S[t], vb[t], acc);
  const int rank = static_cast<int>(tile.thread_rank());
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    if (i % W == rank) zs_out[lane * NZ + i] = z[i];
  if (rank == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) stats[lane * 4 + i] = st[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) prof[lane * 8 + i] = acc[i];
  }
}

// K2 (12, 1): the staging tile (batched_solve.cu) with stamps, and the
// per-thread kernel with a whole-solve stamp. prof[block * 4 + ...]:
// staging, solve, write-back, whole (cycles, thread 0 of the block);
// per-thread: prof[s] whole cycles of system s.
constexpr int SOLVE_TILE_BLOCK_P = 128;

template <int R, int C, int TILES, int LD, int OFF, typename T, int SLAB>
__device__ __forceinline__ void stage_p(T (*S)[SLAB],
                                        const T* __restrict__ src,
                                        int64_t sys, int64_t row,
                                        int systems, int tid) {
  const bool interleaved = row > sys;
  for (int e = tid; e < TILES * R * C; e += SOLVE_TILE_BLOCK_P) {
    const int c = e % C;
    const int s = interleaved ? (e / C) % TILES : e / (R * C);
    const int r = interleaved ? e / (C * TILES) : (e / C) % R;
    if (s < systems) S[s][r * LD + OFF + c] = src[s * sys + r * row + c];
  }
}

template <typename T>
__global__ void __launch_bounds__(SOLVE_TILE_BLOCK_P)
k2_probe(const T* __restrict__ A, const T* __restrict__ b,
         T* __restrict__ x, long long* __restrict__ prof, int B,
         int64_t a_sys, int64_t a_row, int64_t b_sys, int64_t b_row) {
  namespace cg = cooperative_groups;
  constexpr int N = 12, K = 1, W = 16;
  constexpr int TILES = SOLVE_TILE_BLOCK_P / W;
  constexpr int LD = N + K;
  __shared__ T S[TILES][N * LD];
  __shared__ T vb[TILES][2 * (N + 1)];
  const long long t0 = clock64();
  const int first = blockIdx.x * TILES;
  const int systems = min(TILES, B - first);
  const int tid = static_cast<int>(threadIdx.x);
  stage_p<N, N, TILES, LD, 0>(S, A + first * a_sys, a_sys, a_row, systems,
                              tid);
  stage_p<N, K, TILES, LD, N>(S, b + first * b_sys, b_sys, b_row, systems,
                              tid);
  __syncthreads();
  const long long t1 = clock64();
  const cg::thread_block_tile<W> tile =
      cg::tiled_partition<W>(cg::this_thread_block());
  const int sys = tid / W;
  if (sys < systems) {
    const int c = static_cast<int>(tile.thread_rank());
    T col[N];
    if (c < LD) {
#pragma unroll
      for (int r = 0; r < N; ++r) col[r] = S[sys][r * LD + c];
    }
    qr_solve_group<N, K>(tile, col, S[sys], LD, vb[sys]);
    if (c >= N && c < LD) {
#pragma unroll
      for (int r = 0; r < N; ++r) S[sys][r * LD + c] = col[r];
    }
  }
  __syncthreads();
  const long long t2 = clock64();
  T* xs = x + (int64_t)first * N * K;
  for (int e = tid; e < systems * N * K; e += SOLVE_TILE_BLOCK_P) {
    const int r = e % (N * K);
    xs[e] = S[e / (N * K)][(r / K) * LD + N + r % K];
  }
  __syncthreads();
  const long long t3 = clock64();
  if (tid == 0) {
    prof[blockIdx.x * 4 + 0] = t1 - t0;
    prof[blockIdx.x * 4 + 1] = t2 - t1;
    prof[blockIdx.x * 4 + 2] = t3 - t2;
    prof[blockIdx.x * 4 + 3] = t3 - t0;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
k2_thread_probe(const T* __restrict__ A, const T* __restrict__ b,
                T* __restrict__ x, long long* __restrict__ prof, int B,
                int64_t a_sys, int64_t a_row, int64_t b_sys, int64_t b_row) {
  constexpr int N = 12, K = 1;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const long long t0 = clock64();
  const T* As = A + s * a_sys;
  const T* bs = b + s * b_sys;
  T R[N][N], y[N][K], xs[N][K];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) R[r][c] = As[r * a_row + c];
#pragma unroll
    for (int k = 0; k < K; ++k) y[r][k] = bs[r * b_row + k];
  }
  qr_solve<T, N, K>(R, y, xs);
  T* out = x + (int64_t)s * N * K;
#pragma unroll
  for (int r = 0; r < N; ++r) out[r] = xs[r][0];
  prof[s] = clock64() - t0;
}

}  // namespace odt

namespace odt {

// ---- the warp kernel (ip_warp.cuh) with stamps ----
// qr_solve_shfl (qr_shfl.cuh) with a stamp between the steps and the back
// substitution
template <int N, int W, typename T>
__device__ __forceinline__ void qr_shfl_probe(int c, T (&col)[N], T (&x)[N],
                                              long long& t_mid) {
  T piv[N];
#pragma unroll
  for (int r = 0; r < N; ++r) piv[r] = __shfl_sync(FULL_WARP, col[r], 0, W);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T nxt[N];
    if (i + 1 < N) {
#pragma unroll
      for (int r = i; r < N; ++r)
        nxt[r] = __shfl_sync(FULL_WARP, col[r], i + 1, W);
    }
    T normsq = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) normsq += piv[r] * piv[r];
    const T normx = sqrt(normsq);
    const T x0 = piv[i];
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * normx;
    T v[N];
    T vnorm2 = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) {
      v[r] = r == i ? x0 - alpha : piv[r];
      vnorm2 += v[r] * v[r];
    }
    const T inv = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);
    const bool owner = c >= i && c <= N;
    T w = T(0);
#pragma unroll
    for (int r = i; r < N; ++r) w += v[r] * col[r];
#pragma unroll
    for (int r = i; r < N; ++r) {
      const T u = col[r] - (inv * v[r]) * w;
      col[r] = owner ? u : col[r];
    }
    if (i + 1 < N) {
      T wn = T(0);
#pragma unroll
      for (int r = i; r < N; ++r) wn += v[r] * nxt[r];
#pragma unroll
      for (int r = i; r < N; ++r) piv[r] = nxt[r] - (inv * v[r]) * wn;
    }
  }
  t_mid = wstamp();
  T y[N], Ri[N];
#pragma unroll
  for (int r = 0; r < N; ++r) y[r] = __shfl_sync(FULL_WARP, col[r], N, W);
#pragma unroll
  for (int j = N - 1; j < N; ++j)
    Ri[j] = __shfl_sync(FULL_WARP, col[N - 1], j, W);
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T Rn[N];
    if (i > 0) {
#pragma unroll
      for (int j = i - 1; j < N; ++j)
        Rn[j] = __shfl_sync(FULL_WARP, col[i - 1], j, W);
    }
    const T diag = Ri[i];
    const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
    T s = T(0);
#pragma unroll
    for (int j = i + 1; j < N; ++j) s += Ri[j] * x[j];
    x[i] = (y[i] - s) / safe;
    if (i > 0) {
#pragma unroll
      for (int j = i - 1; j < N; ++j) Ri[j] = Rn[j];
    }
  }
}

// the same solve with its step and back-substitution loops rolled (a
// runtime pivot index; every row handled under a predicate, in the same
// order), for the instruction-fetch experiment
template <int N, int W, typename T>
__device__ __forceinline__ void qr_shfl_rolled(int c, T (&col)[N],
                                               T (&x)[N], long long& t_mid) {
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    T ci[N];
#pragma unroll
    for (int r = 0; r < N; ++r) ci[r] = __shfl_sync(FULL_WARP, col[r], i, W);
    T normsq = T(0), x0 = ci[0];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r >= i) normsq += ci[r] * ci[r];
      if (r == i) x0 = ci[r];
    }
    const T normx = sqrt(normsq);
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * normx;
    T v[N];
    T vnorm2 = T(0);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v[r] = r == i ? x0 - alpha : ci[r];
      if (r >= i) vnorm2 += v[r] * v[r];
    }
    const T inv = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);
    if (c >= i && c <= N) {
      T w = T(0);
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (r >= i) w += v[r] * col[r];
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (r >= i) col[r] = col[r] - (inv * v[r]) * w;
    }
  }
  t_mid = wstamp();
  T y[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    y[r] = __shfl_sync(FULL_WARP, col[r], N, W);
    x[r] = T(0);
  }
#pragma unroll 1
  for (int i = N - 1; i >= 0; --i) {
    T mine = col[0], yi = y[0];
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r == i) {
        mine = col[r];
        yi = y[r];
      }
    T Ri[N];
#pragma unroll
    for (int j = 0; j < N; ++j) Ri[j] = __shfl_sync(FULL_WARP, mine, j, W);
    T diag = Ri[0];
    T s = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j == i) diag = Ri[j];
      if (j > i) s += Ri[j] * x[j];
    }
    const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
    const T xi = (yi - s) / safe;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j == i) x[j] = xi;
  }
}

// acc: [0] iterations, [1] jacobian, [2] qr steps, [3] back sub,
// [4] boundary alpha, [5] candidates (residual + merit), [6] pick,
// [7] rest, [8] whole, [9] globaltimer ns whole
template <typename T, typename M, bool ROLLED>
__device__ __forceinline__ void warp_probe(T (&z)[M::NZ],
                                           const T (&th)[M::NTH],
                                           const M& model,
                                           const IPParams<T>& p,
                                           T (&stats)[4], long long (&acc)[10]) {
  constexpr int NZ = M::NZ;
  constexpr int W = 32;
  const T BIG = T(1e12);
  const int lane = static_cast<int>(threadIdx.x) & (W - 1);
  T r0[NZ];
  const unsigned long long g0 = gtimer();
  const long long t_start = wstamp();
  model.template residual<T>(z, th, r0);
  T kappa = M::HAS_CONES
                ? jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max)
                : p.kappa_final;
  int it = 0;
  bool stalled = false, reinit = false;
  while (it < p.max_iter) {
    if (merit_tree<T, M>(r0, p.kappa_final) < p.r_tol || stalled) break;
    const long long t0 = wstamp();
    T rk[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) rk[i] = r0[i] - kappa * T(M::head_mask(i));
    const T merit_cur = merit_tree<T, M>(rk, T(0));
    const int jc = lane < NZ ? lane : NZ - 1;
    T col[NZ];
    jacobian_column_into<T, M>(z, th, model, jc, col);
#pragma unroll
    for (int i = 0; i < NZ; ++i) col[i] = lane < NZ ? col[i] : rk[i];
    const long long t1 = wstamp();
    T delta[NZ];
    long long t2;
    if constexpr (ROLLED)
      qr_shfl_rolled<NZ, W>(lane, col, delta, t2);
    else
      qr_shfl_probe<NZ, W>(lane, col, delta, t2);
    const long long t3 = wstamp();
    const T tau = jclip(T(1) - merit_cur, p.tau_min, p.tau_max);
    const T alpha0 =
        jmin(boundary_alpha_warp<T, M>(lane, z, delta) * tau, T(1));
    const long long t4 = wstamp();
    bool found = false;
    T best_a = T(0), best_m = BIG, min_a = alpha0, min_m = BIG;
    T rc[NZ];
    int src_lane = 0;
    long long t5 = 0;
    {
      const int j = lane;
      const bool valid = j < p.max_ls;
      T a_j = T(0), m_j = BIG;
      if (valid) {
        a_j = alpha0 * pow_half(T(0), j);
        T zc[NZ];
#pragma unroll
        for (int i = 0; i < NZ; ++i) zc[i] = z[i] - a_j * delta[i];
        model.template residual<T>(zc, th, rc);
        m_j = merit_tree<T, M>(rc, kappa);
      }
      t5 = wstamp();
      const unsigned improving =
          __ballot_sync(FULL_WARP, valid && m_j < merit_cur);
      if (improving != 0u) {
        const int first = __ffs(improving) - 1;
        best_a = __shfl_sync(FULL_WARP, a_j, first);
        best_m = __shfl_sync(FULL_WARP, m_j, first);
        found = true;
        src_lane = first;
      } else {
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
        }
      }
    }
    const long long t6 = wstamp();
    const T alpha = found ? best_a : min_a;
    const T new_merit = found ? best_m : min_m;
    bool stalled_new = !found;
#pragma unroll
    for (int i = 0; i < NZ; ++i) z[i] = z[i] - alpha * delta[i];
    const bool centered = new_merit < jmax(p.center_frac * kappa, p.r_tol);
    if (centered) kappa = jmax(kappa * p.kappa_scale, p.kappa_final);
    bool do_reinit = false;
    do_reinit = stalled_new && !reinit;
    if (do_reinit) {
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        if (M::reset_mask(i) != 0.0) z[i] = T(M::reset_tmpl(i));
    }
    stalled_new = stalled_new && reinit;
    reinit = reinit || do_reinit;
    stalled = stalled_new;
    if (!do_reinit) {
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        r0[i] = __shfl_sync(FULL_WARP, rc[i], src_lane);
    } else {
      model.template residual<T>(z, th, r0);
    }
    if (do_reinit)
      kappa = jclip(row_vio<T, M>(r0, true), p.kappa_lo, p.kappa_init_max);
    ++it;
    const long long t7 = wstamp();
    acc[1] += t1 - t0;
    acc[2] += t2 - t1;
    acc[3] += t3 - t2;
    acc[4] += t4 - t3;
    acc[5] += t5 - t4;
    acc[6] += t6 - t5;
    acc[7] += t7 - t6;
  }
  const bool conv = merit_of<T, M>(r0, p.kappa_final) < p.r_tol;
  stats[0] = T(it);
  stats[1] = conv ? T(1) : T(0);
  stats[2] = row_vio<T, M>(r0, false);
  stats[3] = row_vio<T, M>(r0, true);
  acc[0] = it;
  acc[8] = wstamp() - t_start;
  acc[9] = (long long)(gtimer() - g0);
}

template <typename T, bool ROLLED>
__global__ void __launch_bounds__(64)
k1w_probe(const T* __restrict__ z0s, const T* __restrict__ ths,
          T* __restrict__ zs_out, T* __restrict__ stats,
          long long* __restrict__ prof, int B, RocketProjection<T> model,
          IPParams<T> p) {
  using M = RocketProjection<T>;
  constexpr int NZ = M::NZ;
  constexpr int NTH = M::NTH;
  const int64_t lane_id = ((int64_t)blockIdx.x * 64 + threadIdx.x) / 32;
  if (lane_id >= B) return;
  T z[NZ], th[NTH], st[4];
#pragma unroll
  for (int i = 0; i < NZ; ++i) z[i] = z0s[lane_id * NZ + i];
#pragma unroll
  for (int i = 0; i < NTH; ++i) th[i] = ths[lane_id * NTH + i];
  long long acc[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  warp_probe<T, M, ROLLED>(z, th, model, p, st, acc);
  const int lane = static_cast<int>(threadIdx.x) & 31;
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    if (i == lane) zs_out[lane_id * NZ + i] = z[i];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) stats[lane_id * 4 + i] = st[i];
#pragma unroll
    for (int i = 0; i < 10; ++i) prof[lane_id * 10 + i] = acc[i];
  }
}

// the shuffle K2 (12, 1) with stamps: prof[s * 5 + ...]: load, steps,
// back sub, store, whole
template <typename T, bool ROLLED>
__global__ void __launch_bounds__(64)
k2s_probe(const T* __restrict__ A, const T* __restrict__ b,
          T* __restrict__ x, long long* __restrict__ prof, int B,
          int64_t a_sys, int64_t a_row, int64_t b_sys, int64_t b_row) {
  constexpr int N = 12, W = 16;
  const long long t0 = wstamp();
  const int64_t s = ((int64_t)blockIdx.x * 64 + threadIdx.x) / W;
  const int c = static_cast<int>(threadIdx.x) % W;
  const bool live = s < B && c <= N;
  const T* src = c < N ? A + s * a_sys + c : b + s * b_sys;
  const int64_t stride = c < N ? a_row : b_row;
  T col[N];
#pragma unroll
  for (int r = 0; r < N; ++r) col[r] = live ? src[r * stride] : T(0);
  const long long t1 = wstamp();
  T xs[N];
  long long t2;
  if constexpr (ROLLED)
    qr_shfl_rolled<N, W>(c, col, xs, t2);
  else
    qr_shfl_probe<N, W>(c, col, xs, t2);
  const long long t3 = wstamp();
  if (s < B) {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r == c) x[s * N + r] = xs[r];
  }
  const long long t4 = wstamp();
  if (s < B && c == 0) {
    prof[s * 5 + 0] = t1 - t0;
    prof[s * 5 + 1] = t2 - t1;
    prof[s * 5 + 2] = t3 - t2;
    prof[s * 5 + 3] = t4 - t3;
    prof[s * 5 + 4] = t4 - t0;
  }
}

// dependent-chain latencies in one warp: cycles per op, out[0..7]: f32
// fma, f32 div, f32 sqrt, f32 shfl, f64 fma, f64 div, f64 sqrt, f64 shfl;
// out[8], out[9]: clock64 cycles and globaltimer ns over the whole run
__global__ void lat_probe(long long* out, float xf, double xd) {
  const int REP = 256;
  const unsigned long long g0 = gtimer();
  const long long c0 = clock64();
  float f = xf;
  double d = xd;
  long long t;
  t = clock64();
  for (int i = 0; i < REP; ++i) f = f * 0.999f + 0.001f;
  out[0] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) f = 1.0001f / (f + 1.0f);
  out[1] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) f = sqrtf(f + 1.0f);
  out[2] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) f = __shfl_sync(0xffffffffu, f, (threadIdx.x + 1) & 31);
  out[3] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) d = d * 0.999 + 0.001;
  out[4] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) d = 1.0001 / (d + 1.0);
  out[5] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) d = sqrt(d + 1.0);
  out[6] = (clock64() - t) / REP;
  t = clock64();
  for (int i = 0; i < REP; ++i) d = __shfl_sync(0xffffffffu, d, (threadIdx.x + 1) & 31);
  out[7] = (clock64() - t) / REP;
  out[8] = clock64() - c0;
  out[9] = (long long)(gtimer() - g0);
  if (f == 12345.0f && d == 12345.0) out[10] = 1;
}

}  // namespace odt

extern "C" {
int probe_k1_f32(const void* z0s, const void* ths, void* zs, void* stats,
                 void* prof, int B, const double* ip) {
  const odt::IPParams<float> p = odt::make_ip_params<float>(ip);
  constexpr int tiles = odt::ip_tiles_per_block<odt::RocketProjection<float>>();
  odt::k1_probe<float><<<(B + tiles - 1) / tiles, odt::IP_TILE_BLOCK>>>(
      (const float*)z0s, (const float*)ths, (float*)zs, (float*)stats,
      (long long*)prof, B, odt::RocketProjection<float>(nullptr), p);
  return (int)cudaGetLastError();
}
int probe_k1_f64(const void* z0s, const void* ths, void* zs, void* stats,
                 void* prof, int B, const double* ip) {
  const odt::IPParams<double> p = odt::make_ip_params<double>(ip);
  constexpr int tiles =
      odt::ip_tiles_per_block<odt::RocketProjection<double>>();
  odt::k1_probe<double><<<(B + tiles - 1) / tiles, odt::IP_TILE_BLOCK>>>(
      (const double*)z0s, (const double*)ths, (double*)zs, (double*)stats,
      (long long*)prof, B, odt::RocketProjection<double>(nullptr), p);
  return (int)cudaGetLastError();
}
int probe_k2_tile_f32(const void* A, const void* b, void* x, void* prof,
                      int B, int64_t a_sys, int64_t a_row, int64_t b_sys,
                      int64_t b_row) {
  odt::k2_probe<float><<<(B + 7) / 8, odt::SOLVE_TILE_BLOCK_P>>>(
      (const float*)A, (const float*)b, (float*)x, (long long*)prof, B,
      a_sys, a_row, b_sys, b_row);
  return (int)cudaGetLastError();
}
int probe_k2_thread_f32(const void* A, const void* b, void* x, void* prof,
                        int B, int64_t a_sys, int64_t a_row, int64_t b_sys,
                        int64_t b_row) {
  odt::k2_thread_probe<float><<<(B + 127) / 128, 128>>>(
      (const float*)A, (const float*)b, (float*)x, (long long*)prof, B,
      a_sys, a_row, b_sys, b_row);
  return (int)cudaGetLastError();
}
#define K1W(SUF, T, R, NAME)                                                \
  int NAME(const void* z0s, const void* ths, void* zs, void* stats,          \
           void* prof, int B, const double* ip) {                           \
    const odt::IPParams<T> p = odt::make_ip_params<T>(ip);                   \
    odt::k1w_probe<T, R><<<(B + 1) / 2, 64>>>(                               \
        (const T*)z0s, (const T*)ths, (T*)zs, (T*)stats, (long long*)prof,   \
        B, odt::RocketProjection<T>(nullptr), p);                            \
    return (int)cudaGetLastError();                                          \
  }
K1W(f32, float, false, probe_k1w_f32)
K1W(f64, double, false, probe_k1w_f64)
K1W(f32, float, true, probe_k1wr_f32)
K1W(f64, double, true, probe_k1wr_f64)
#define K2S(R, NAME)                                                        \
  int NAME(const void* A, const void* b, void* x, void* prof, int B,         \
           int64_t a_sys, int64_t a_row, int64_t b_sys, int64_t b_row) {     \
    odt::k2s_probe<float, R><<<(B + 3) / 4, 64>>>(                           \
        (const float*)A, (const float*)b, (float*)x, (long long*)prof, B,    \
        a_sys, a_row, b_sys, b_row);                                         \
    return (int)cudaGetLastError();                                          \
  }
K2S(false, probe_k2s_f32)
K2S(true, probe_k2sr_f32)
int probe_lat(void* out) {
  odt::lat_probe<<<1, 32>>>((long long*)out, 0.5f, 0.5);
  return (int)cudaGetLastError();
}
int probe_clock_khz() {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrClockRate, 0);
  return v;
}
}
