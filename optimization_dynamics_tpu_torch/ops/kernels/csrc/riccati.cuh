// K3: the whole iLQR Riccati backward recursion, in two kernels: one
// thread a scenario (riccati_kernel) and a tile of threads a scenario
// (riccati_tile_kernel, below), which the wrapper picks by the batch's
// width. Replaces the Pallas kernel of optimization_dynamics_tpu/ops/
// pallas/riccati.py (make_riccati_backward, body _make_body, Cholesky
// _chol_solve_block). See ops/kernels/riccati.py for the design note.
//
// Per scenario, t = T-2 .. 0, exactly what the Pallas body computes, in
// its order: Gauss-Newton Q-terms; u_mask (a device array, 1 = active)
// zeroes the masked rows of Qu and Qux and the masked rows and columns of
// Quu, whose diagonal then gets the lane's regulariser (active) or 1
// (masked); an unrolled Cholesky solve of
// Quu [k K] = -[Qu Qux] whose pivots are sqrt(max(d, 1e-30)) with ok =
// every d > 0, and whose substitutions divide by a diagonal guarded at
// 1e-30, so a lane that is not positive definite gets finite gains;
// the value update Vx, Vxx (symmetrised); dV1 += k.Qu, dV2 += k.Quu k / 2
// and |Qu|_inf, accumulated from t = T-2 down.
//
// Layout, batch first and contiguous: fxs (B, T-1, NX, NX), fus (B, T-1,
// NX, NU), lxs (B, T-1, NX), lus (B, T-1, NU), lxxs (B, T-1, NX, NX), luus
// (B, T-1, NU, NU), luxs (B, T-1, NU, NX), gTs (B, NX), HTs (B, NX, NX),
// regs (B,), u_mask (T-1, NU); out Ks (B, T-1, NU, NX), ks (B, T-1, NU),
// stats (B, 4) = dV1, dV2, qu_inf, ok (1/0).
//
// The kernels' code; the extern "C" entry points are instantiated in
// riccati.cu (the per-thread kernel up to (10, 4)), riccati_tile.cu (the
// tile kernel) and riccati_n16_u10_f32.cu / _f64.cu (the per-thread
// kernel at (16, 10), the slowest to compile), so that the build's
// parallel nvcc runs share its time.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "odt_common.cuh"

namespace odt {

constexpr int RICCATI_THREADS = 32;

// Cholesky Quu = L L^T, column by column, pivots sqrt(max(d, 1e-30));
// returns ok = every pivot d > 0
template <typename T, int NU>
__device__ __forceinline__ bool riccati_chol(const T (&Quu)[NU][NU],
                                             T (&L)[NU][NU]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T col[NU];
#pragma unroll
    for (int r = j; r < NU; ++r) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < j; ++c) acc += L[r][c] * L[j][c];
      col[r] = Quu[r][j] - acc;
    }
    const T d = col[j];
    ok = ok && d > T(0);
    const T sq = sqrt(jmax(d, T(1e-30)));
#pragma unroll
    for (int r = 0; r < NU; ++r)
      L[r][j] = r < j ? T(0) : (r == j ? sq : col[r] / sq);
  }
  return ok;
}

// x <- (L L^T)^-1 x for one right-hand side: L y = x, then L^T x = y,
// each dividing by the diagonal guarded at 1e-30 (a right-hand side's
// arithmetic does not depend on the others', so a column at a time is
// the same as all at once)
template <typename T, int NU>
__device__ __forceinline__ void riccati_chol_solve(const T (&L)[NU][NU],
                                                   T (&x)[NU]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const T diag = L[i][i];
    const T safe = diag > T(1e-30) ? diag : T(1);
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < i; ++r) acc += L[i][r] * x[r];
    x[i] = (x[i] - acc) / safe;
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    const T diag = L[i][i];
    const T safe = diag > T(1e-30) ? diag : T(1);
    T acc = T(0);
#pragma unroll
    for (int r = i + 1; r < NU; ++r) acc += L[r][i] * x[r];
    x[i] = (x[i] - acc) / safe;
  }
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(RICCATI_THREADS)
riccati_kernel(const T* __restrict__ fxs, const T* __restrict__ fus,
               const T* __restrict__ lxs, const T* __restrict__ lus,
               const T* __restrict__ lxxs, const T* __restrict__ luus,
               const T* __restrict__ luxs, const T* __restrict__ gTs,
               const T* __restrict__ HTs, const T* __restrict__ regs,
               const T* __restrict__ u_mask, T* __restrict__ Ks,
               T* __restrict__ ks, T* __restrict__ stats, int B, int Tm1) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const T reg = regs[lane];

  T Vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = gTs[(int64_t)lane * NX + i];
#pragma unroll
    for (int j = 0; j < NX; ++j)
      Vxx[i][j] = HTs[(int64_t)lane * NX * NX + i * NX + j];
  }
  T dV1 = T(0), dV2 = T(0), qu_inf = T(0);
  bool ok_all = true;

  for (int t = Tm1 - 1; t >= 0; --t) {
    const int64_t s = (int64_t)lane * Tm1 + t;
    const T* fx = fxs + s * NX * NX;
    const T* fu = fus + s * NX * NU;
    const T* lx = lxs + s * NX;
    const T* lu = lus + s * NU;
    const T* lxx = lxxs + s * NX * NX;
    const T* luu = luus + s * NU * NU;
    const T* lux = luxs + s * NU * NX;

    T Fx[NX][NX], Fu[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Fx[i][j] = fx[i * NX + j];
#pragma unroll
      for (int j = 0; j < NU; ++j) Fu[i][j] = fu[i * NU + j];
    }

    // Q-terms: Qx = lx + fx^T Vx, Qu = lu + fu^T Vx, VF = Vxx fx,
    // Qxx = lxx + fx^T VF, VFu = Vxx fu, Quu = luu + fu^T VFu,
    // Qux = lux + fu^T VF
    T Qx[NX], Qu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += Fx[j][i] * Vx[j];
      Qx[i] = lx[i] + acc;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += Fu[j][i] * Vx[j];
      Qu[i] = lu[i] + acc;
    }
    T VF[NX][NX], VFu[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Vxx[i][j] * Fx[j][k];
        VF[i][k] = acc;
      }
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Vxx[i][j] * Fu[j][k];
        VFu[i][k] = acc;
      }
    }
    T Qxx[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Fx[j][i] * VF[j][l];
        Qxx[i][l] = lxx[i * NX + l] + acc;
      }
    }
    T Quu[NU][NU], Qux[NU][NX];
    bool m[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) m[i] = u_mask[t * NU + i] != T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int l = 0; l < NU; ++l) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Fu[j][i] * VFu[j][l];
        const T q = m[i] && m[l] ? luu[i * NU + l] + acc : T(0);
        Quu[i][l] = i == l ? q + (m[i] ? reg : T(1)) : q;
      }
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Fu[j][i] * VF[j][l];
        Qux[i][l] = m[i] ? lux[i * NX + l] + acc : T(0);
      }
      if (!m[i]) Qu[i] = T(0);
    }

    T L[NU][NU];
    const bool ok = riccati_chol<T, NU>(Quu, L);
    // gains = -Quu^-1 [Qu Qux], a column at a time
    T kk[NU], KK[NU][NX];
    {
      T x[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) x[i] = Qu[i];
      riccati_chol_solve<T, NU>(L, x);
#pragma unroll
      for (int i = 0; i < NU; ++i) kk[i] = -x[i];
    }
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      T x[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) x[i] = Qux[i][l];
      riccati_chol_solve<T, NU>(L, x);
#pragma unroll
      for (int i = 0; i < NU; ++i) KK[i][l] = -x[i];
    }

    // value update
    T Quu_k[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) acc += Quu[i][j] * kk[j];
      Quu_k[i] = acc;
    }
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      T a = T(0), b = T(0), c = T(0);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        a += KK[i][l] * Qu[i];
        b += Qux[i][l] * kk[i];
        c += KK[i][l] * Quu_k[i];
      }
      Vx[l] = ((Qx[l] + a) + b) + c;
    }
    T QK[NU][NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) acc += Quu[i][j] * KK[j][l];
        QK[i][l] = acc;
      }
    }
    // Vxx = Qxx + KQ + KQ^T + K^T Quu K with KQ = K^T Qux; symmetrised
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        T kq = T(0), kqt = T(0), kwk = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          kq += KK[j][i] * Qux[j][l];
          kqt += KK[j][l] * Qux[j][i];
          kwk += KK[j][i] * QK[j][l];
        }
        Vxx[i][l] = ((Qxx[i][l] + kq) + kqt) + kwk;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int l = i + 1; l < NX; ++l) {
        const T sym = T(0.5) * (Vxx[i][l] + Vxx[l][i]);
        Vxx[i][l] = sym;
        Vxx[l][i] = sym;
      }
    }

    T d1 = T(0), d2 = T(0), qi = T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      d1 += kk[i] * Qu[i];
      d2 += kk[i] * Quu_k[i];
      qi = i == 0 ? jabs(Qu[i]) : jmax(qi, jabs(Qu[i]));
    }
    dV1 = dV1 + d1;
    dV2 = dV2 + T(0.5) * d2;
    qu_inf = jmax(qu_inf, qi);
    ok_all = ok_all && ok;

    T* Ko = Ks + s * NU * NX;
    T* ko = ks + s * NU;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ko[i] = kk[i];
#pragma unroll
      for (int l = 0; l < NX; ++l) Ko[i * NX + l] = KK[i][l];
    }
  }

  T* st = stats + (int64_t)lane * 4;
  st[0] = dV1;
  st[1] = dV2;
  st[2] = qu_inf;
  st[3] = ok_all ? T(1) : T(0);
}

template <typename T, int NX, int NU>
int launch_riccati(const void* fxs, const void* fus, const void* lxs,
                   const void* lus, const void* lxxs, const void* luus,
                   const void* luxs, const void* gTs, const void* HTs,
                   const void* regs, const void* u_mask, void* Ks, void* ks,
                   void* stats, int B, int Tm1, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + RICCATI_THREADS - 1) / RICCATI_THREADS;
  riccati_kernel<T, NX, NU>
      <<<blocks, RICCATI_THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(fxs), static_cast<const T*>(fus),
          static_cast<const T*>(lxs), static_cast<const T*>(lus),
          static_cast<const T*>(lxxs), static_cast<const T*>(luus),
          static_cast<const T*>(luxs), static_cast<const T*>(gTs),
          static_cast<const T*>(HTs), static_cast<const T*>(regs),
          static_cast<const T*>(u_mask), static_cast<T*>(Ks),
          static_cast<T*>(ks), static_cast<T*>(stats), B, Tm1);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The tile kernel: one scenario on a tile of W = riccati_tile_width<NX>()
// threads, several tiles a block. The scenario's state (Vx, Vxx), the
// step's inputs and the step's intermediates sit once in the tile's slab
// of shared memory; each value has one writer and a tile sync stands
// between its write and its reads. A step is three stages, each closed
// by a tile sync:
// A. VF = Vxx fx and VFu = Vxx fu, an element a thread (element e =
//    rank + q W of the row-major matrix); Qx[l] on thread l; Qu on every
//    thread.
// B. Qxx, an element a thread. Up to RICCATI_TILE_LANE_NU controls,
//    every thread computes Quu, its Cholesky factor, ok, k = -Quu^-1 Qu,
//    Quu k and the step's dV1, dV2, |Qu|_inf itself, so they are
//    bit-identical across the tile without a broadcast. Thread l < NX
//    owns column l: Qux[:, l], its gains K[:, l] = -Quu^-1 Qux[:, l],
//    (Quu K)[:, l] and the new Vx[l]. Above RICCATI_TILE_LANE_NU (the
//    hopper's NU = 10: Quu and its factor would be 200 values in every
//    thread's registers) Quu is formed an element a thread in the tile's
//    factor slab, a sync, thread 0 factors it there and forms k, Quu k
//    and the stats, a sync, and the column owners read the factor, k
//    and Quu k from the slab: two syncs more a step.
// C. The new Vxx, an element a thread: the owner of (i, l) forms both
//    (i, l) and (l, i) before symmetrising, so no second sync is needed.
// Step t-1's inputs are loaded into registers at the start of step t
// (neighbouring threads read neighbouring words) and stored to the slab
// after stage C, so their latency overlaps the step's arithmetic.
// Every value is the per-thread kernel's expression on the same operands
// in the same order, so the two kernels agree bit for bit.

// threads a scenario: an element of the NX x NX updates a thread, capped
// at a warp (the smallest power of two >= NX * NX, at most 32: 16 at nx=4,
// 32 at nx=6 and 10), so thread l < NX owns column l and a warp holds
// whole tiles. At the deploy's 512 lanes it took 0.039 ms against 0.059
// ms for a row a thread (4 threads at nx=4), which won at 25,600 lanes
// (0.247 against 0.272 ms; PERF.md section 6)
template <int NX>
__host__ __device__ constexpr int riccati_tile_width() {
  int w = 1;
  while (w < NX * NX && w < 32) w *= 2;
  return w;
}

// threads a block of the tile kernel
constexpr int RICCATI_TILE_BLOCK = 64;

// the most controls whose Quu every thread of a tile factors itself;
// above, thread 0 factors it once in the tile's RiccatiFactor slab
constexpr int RICCATI_TILE_LANE_NU = 4;

// one step's inputs in the slab: fx | fu | lx | lu | lxx | luu | lux
template <int NX, int NU>
struct RiccatiStep {
  static constexpr int FX = 0, FU = FX + NX * NX, LX = FU + NX * NU,
                       LU = LX + NX, LXX = LU + NU, LUU = LXX + NX * NX,
                       LUX = LUU + NU * NU, SIZE = LUX + NU * NX;
};

template <typename T, int NX, int NU>
struct RiccatiSlab {
  T in[RiccatiStep<NX, NU>::SIZE];
  T Vx[NX], Vxx[NX * NX], VF[NX * NX], VFu[NX * NU], Qxx[NX * NX];
  T Qux[NU * NX], KK[NU * NX], QK[NU * NX];  // row-major (NU, NX)
};

// a tile's Quu, its Cholesky factor, k and Quu k (NU > RICCATI_TILE_LANE_NU)
template <typename T, int NU>
struct RiccatiFactor {
  T Quu[NU][NU], L[NU][NU], kk[NU], Quu_k[NU];
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// a thread's share of an S-element segment: elements rank + q W into
// registers r[OFF + q]
template <int S, int W, int OFF, typename T, int NR>
__device__ __forceinline__ void tile_load(const T* __restrict__ src,
                                          int rank, T (&r)[NR]) {
#pragma unroll
  for (int q = 0; q < cdiv(S, W); ++q)
    if (rank + q * W < S) r[OFF + q] = src[rank + q * W];
}

template <int S, int W, int OFF, typename T, int NR>
__device__ __forceinline__ void tile_store(const T (&r)[NR], int rank,
                                           T* dst) {
#pragma unroll
  for (int q = 0; q < cdiv(S, W); ++q)
    if (rank + q * W < S) dst[rank + q * W] = r[OFF + q];
}

// registers a thread holds of one step's inputs, segment by segment
template <int NX, int NU, int W>
struct RiccatiShare {
  static constexpr int FX = 0, FU = FX + cdiv(NX * NX, W),
                       LX = FU + cdiv(NX * NU, W), LU = LX + cdiv(NX, W),
                       LXX = LU + cdiv(NU, W), LUU = LXX + cdiv(NX * NX, W),
                       LUX = LUU + cdiv(NU * NU, W),
                       SIZE = LUX + cdiv(NU * NX, W);
};

template <typename T, int NX, int NU, int W, int NR>
__device__ __forceinline__ void riccati_step_load(
    const T* fxs, const T* fus, const T* lxs, const T* lus, const T* lxxs,
    const T* luus, const T* luxs, int64_t s, int rank, T (&r)[NR]) {
  using P = RiccatiShare<NX, NU, W>;
  tile_load<NX * NX, W, P::FX>(fxs + s * NX * NX, rank, r);
  tile_load<NX * NU, W, P::FU>(fus + s * NX * NU, rank, r);
  tile_load<NX, W, P::LX>(lxs + s * NX, rank, r);
  tile_load<NU, W, P::LU>(lus + s * NU, rank, r);
  tile_load<NX * NX, W, P::LXX>(lxxs + s * NX * NX, rank, r);
  tile_load<NU * NU, W, P::LUU>(luus + s * NU * NU, rank, r);
  tile_load<NU * NX, W, P::LUX>(luxs + s * NU * NX, rank, r);
}

template <typename T, int NX, int NU, int W, int NR>
__device__ __forceinline__ void riccati_step_store(const T (&r)[NR],
                                                   int rank, T* in) {
  using P = RiccatiShare<NX, NU, W>;
  using S = RiccatiStep<NX, NU>;
  tile_store<NX * NX, W, P::FX>(r, rank, in + S::FX);
  tile_store<NX * NU, W, P::FU>(r, rank, in + S::FU);
  tile_store<NX, W, P::LX>(r, rank, in + S::LX);
  tile_store<NU, W, P::LU>(r, rank, in + S::LU);
  tile_store<NX * NX, W, P::LXX>(r, rank, in + S::LXX);
  tile_store<NU * NU, W, P::LUU>(r, rank, in + S::LUU);
  tile_store<NU * NX, W, P::LUX>(r, rank, in + S::LUX);
}

// k = -Quu^-1 Qu from Quu's factor L, and Quu k
template <typename T, int NU>
__device__ __forceinline__ void riccati_gain_k(const T (&Quu)[NU][NU],
                                               const T (&L)[NU][NU],
                                               const T (&Qu)[NU], T (&kk)[NU],
                                               T (&Quu_k)[NU]) {
  T x[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) x[i] = Qu[i];
  riccati_chol_solve<T, NU>(L, x);
#pragma unroll
  for (int i = 0; i < NU; ++i) x[i] = -x[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) acc += Quu[i][j] * x[j];
    Quu_k[i] = acc;
    kk[i] = x[i];
  }
}

// the step's dV1 += k.Qu, dV2 += k.Quu k / 2 and |Qu|_inf
template <typename T, int NU>
__device__ __forceinline__ void riccati_stats(const T (&kk)[NU],
                                              const T (&Qu)[NU],
                                              const T (&Quu_k)[NU], T& dV1,
                                              T& dV2, T& qu_inf) {
  T d1 = T(0), d2 = T(0), qi = T(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    d1 += kk[i] * Qu[i];
    d2 += kk[i] * Quu_k[i];
    qi = i == 0 ? jabs(Qu[i]) : jmax(qi, jabs(Qu[i]));
  }
  dV1 = dV1 + d1;
  dV2 = dV2 + T(0.5) * d2;
  qu_inf = jmax(qu_inf, qi);
}

// column l of the step (thread l < NX): Qux[:, l], its gains K[:, l] =
// -Quu^-1 Qux[:, l] (to Ko and the slab), (Quu K)[:, l] and the new Vx[l]
template <typename T, int NX, int NU>
__device__ __forceinline__ void riccati_tile_column(
    int l, const T* fu, const T* lux, const bool (&m)[NU], const T (&Qu)[NU],
    T Qx, const T (&Quu)[NU][NU], const T (&L)[NU][NU], const T (&kk)[NU],
    const T (&Quu_k)[NU], RiccatiSlab<T, NX, NU>& sm, T* Ko) {
  T qux[NU], K[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) acc += fu[j * NU + i] * sm.VF[j * NX + l];
    qux[i] = m[i] ? lux[i * NX + l] + acc : T(0);
    K[i] = qux[i];
  }
  riccati_chol_solve<T, NU>(L, K);
  T a = T(0), b = T(0), c = T(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    K[i] = -K[i];
    a += K[i] * Qu[i];
    b += qux[i] * kk[i];
    c += K[i] * Quu_k[i];
  }
  sm.Vx[l] = ((Qx + a) + b) + c;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) acc += Quu[i][j] * K[j];
    sm.QK[i * NX + l] = acc;
    sm.Qux[i * NX + l] = qux[i];
    sm.KK[i * NX + l] = K[i];
    Ko[i * NX + l] = K[i];
  }
}

// One tile a scenario. A tile whose scenario is past B returns as a
// whole before any sync; every sync is the tile's own.
template <typename T, int NX, int NU>
__global__ void __launch_bounds__(RICCATI_TILE_BLOCK)
riccati_tile_kernel(const T* __restrict__ fxs, const T* __restrict__ fus,
                    const T* __restrict__ lxs, const T* __restrict__ lus,
                    const T* __restrict__ lxxs, const T* __restrict__ luus,
                    const T* __restrict__ luxs, const T* __restrict__ gTs,
                    const T* __restrict__ HTs, const T* __restrict__ regs,
                    const T* __restrict__ u_mask, T* __restrict__ Ks,
                    T* __restrict__ ks, T* __restrict__ stats, int B,
                    int Tm1) {
  namespace cg = cooperative_groups;
  constexpr int W = riccati_tile_width<NX>();
  static_assert(NX <= W && W <= 32 && RICCATI_TILE_BLOCK % W == 0,
                "a tile owns the NX columns and a warp holds whole tiles");
  constexpr int TILES = RICCATI_TILE_BLOCK / W;
  constexpr int NN = NX * NX;
  using S = RiccatiStep<NX, NU>;
  __shared__ RiccatiSlab<T, NX, NU> slabs[TILES];
  constexpr bool shared_factor = NU > RICCATI_TILE_LANE_NU;
  __shared__ RiccatiFactor<T, NU> factors[shared_factor ? TILES : 1];
  const cg::thread_block_tile<W> tile =
      cg::tiled_partition<W>(cg::this_thread_block());
  const int lane = blockIdx.x * TILES + static_cast<int>(threadIdx.x) / W;
  if (lane >= B) return;
  RiccatiSlab<T, NX, NU>& sm = slabs[threadIdx.x / W];
  const int rank = static_cast<int>(tile.thread_rank());
  const T reg = regs[lane];
  const T* fx = sm.in + S::FX;
  const T* fu = sm.in + S::FU;
  const T* lx = sm.in + S::LX;
  const T* lu = sm.in + S::LU;
  const T* lxx = sm.in + S::LXX;
  const T* luu = sm.in + S::LUU;
  const T* lux = sm.in + S::LUX;

  T next[RiccatiShare<NX, NU, W>::SIZE];
#pragma unroll
  for (int q = 0; q < cdiv(NN, W); ++q)
    if (rank + q * W < NN)
      sm.Vxx[rank + q * W] = HTs[(int64_t)lane * NN + rank + q * W];
  if (rank < NX) sm.Vx[rank] = gTs[(int64_t)lane * NX + rank];
  if (Tm1 > 0) {
    riccati_step_load<T, NX, NU, W>(fxs, fus, lxs, lus, lxxs, luus, luxs,
                                    (int64_t)lane * Tm1 + Tm1 - 1, rank,
                                    next);
    riccati_step_store<T, NX, NU, W>(next, rank, sm.in);
  }
  T dV1 = T(0), dV2 = T(0), qu_inf = T(0);
  bool ok_all = true;
  tile.sync();

  for (int t = Tm1 - 1; t >= 0; --t) {
    const int64_t s = (int64_t)lane * Tm1 + t;
    if (t > 0)
      riccati_step_load<T, NX, NU, W>(fxs, fus, lxs, lus, lxxs, luus, luxs,
                                      s - 1, rank, next);

    // A: VF, VFu (an element a thread), Qx[l] (thread l), Qu (every
    // thread)
#pragma unroll
    for (int q = 0; q < cdiv(NN, W); ++q) {
      const int e = rank + q * W;
      if (e < NN) {
        const int i = e / NX, k = e % NX;
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += sm.Vxx[i * NX + j] * fx[j * NX + k];
        sm.VF[e] = acc;
      }
    }
#pragma unroll
    for (int q = 0; q < cdiv(NX * NU, W); ++q) {
      const int e = rank + q * W;
      if (e < NX * NU) {
        const int i = e / NU, k = e % NU;
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += sm.Vxx[i * NX + j] * fu[j * NU + k];
        sm.VFu[e] = acc;
      }
    }
    T Qx = T(0);
    if (rank < NX) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += fx[j * NX + rank] * sm.Vx[j];
      Qx = lx[rank] + acc;
    }
    T Qu[NU];
    bool m[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      m[i] = u_mask[t * NU + i] != T(0);
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += fu[j * NU + i] * sm.Vx[j];
      Qu[i] = lu[i] + acc;
    }
    tile.sync();

    // B: Qxx (an element a thread); Quu, its factor, k (every thread, or
    // thread 0 in the factor slab); column l of Qux, K, Quu K and Vx[l]
    // (thread l)
#pragma unroll
    for (int q = 0; q < cdiv(NN, W); ++q) {
      const int e = rank + q * W;
      if (e < NN) {
        const int i = e / NX, l = e % NX;
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += fx[j * NX + i] * sm.VF[j * NX + l];
        sm.Qxx[e] = lxx[e] + acc;
      }
    }
    if constexpr (!shared_factor) {
      T Quu[NU][NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int l = 0; l < NU; ++l) {
          T acc = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) acc += fu[j * NU + i] * sm.VFu[j * NU + l];
          const T q = m[i] && m[l] ? luu[i * NU + l] + acc : T(0);
          Quu[i][l] = i == l ? q + (m[i] ? reg : T(1)) : q;
        }
        if (!m[i]) Qu[i] = T(0);
      }
      T L[NU][NU];
      const bool ok = riccati_chol<T, NU>(Quu, L);
      T kk[NU], Quu_k[NU];
      riccati_gain_k<T, NU>(Quu, L, Qu, kk, Quu_k);
      if (rank < NX)
        riccati_tile_column<T, NX, NU>(rank, fu, lux, m, Qu, Qx, Quu, L, kk,
                                       Quu_k, sm, Ks + s * NU * NX);
      if (rank == 0) {
#pragma unroll
        for (int i = 0; i < NU; ++i) ks[s * NU + i] = kk[i];
      }
      riccati_stats<T, NU>(kk, Qu, Quu_k, dV1, dV2, qu_inf);
      ok_all = ok_all && ok;
    } else {
      RiccatiFactor<T, NU>& f = factors[threadIdx.x / W];
#pragma unroll
      for (int q = 0; q < cdiv(NU * NU, W); ++q) {
        const int e = rank + q * W;
        if (e < NU * NU) {
          const int i = e / NU, l = e % NU;
          T acc = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j)
            acc += fu[j * NU + i] * sm.VFu[j * NU + l];
          const T v = m[i] && m[l] ? luu[e] + acc : T(0);
          f.Quu[i][l] = i == l ? v + (m[i] ? reg : T(1)) : v;
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (!m[i]) Qu[i] = T(0);
      tile.sync();
      if (rank == 0) {
        const bool ok = riccati_chol<T, NU>(f.Quu, f.L);
        riccati_gain_k<T, NU>(f.Quu, f.L, Qu, f.kk, f.Quu_k);
#pragma unroll
        for (int i = 0; i < NU; ++i) ks[s * NU + i] = f.kk[i];
        riccati_stats<T, NU>(f.kk, Qu, f.Quu_k, dV1, dV2, qu_inf);
        ok_all = ok_all && ok;
      }
      tile.sync();
      if (rank < NX)
        riccati_tile_column<T, NX, NU>(rank, fu, lux, m, Qu, Qx, f.Quu, f.L,
                                       f.kk, f.Quu_k, sm, Ks + s * NU * NX);
    }
    tile.sync();

    // C: Vxx = Qxx + KQ + KQ^T + K^T Quu K with KQ = K^T Qux, symmetrised
    // (an element a thread); then the next step's inputs into the slab
#pragma unroll
    for (int q = 0; q < cdiv(NN, W); ++q) {
      const int e = rank + q * W;
      if (e < NN) {
        const int i = e / NX, l = e % NX;
        const int lo = i < l ? i : l, hi = i < l ? l : i;
        T v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h == 0 ? lo : hi, c = h == 0 ? hi : lo;
          T kq = T(0), kqt = T(0), kwk = T(0);
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            kq += sm.KK[j * NX + r] * sm.Qux[j * NX + c];
            kqt += sm.KK[j * NX + c] * sm.Qux[j * NX + r];
            kwk += sm.KK[j * NX + r] * sm.QK[j * NX + c];
          }
          v[h] = ((sm.Qxx[r * NX + c] + kq) + kqt) + kwk;
        }
        sm.Vxx[e] = i == l ? v[0] : T(0.5) * (v[0] + v[1]);
      }
    }
    if (t > 0) riccati_step_store<T, NX, NU, W>(next, rank, sm.in);
    tile.sync();
  }

  if (rank == 0) {
    T* st = stats + (int64_t)lane * 4;
    st[0] = dV1;
    st[1] = dV2;
    st[2] = qu_inf;
    st[3] = ok_all ? T(1) : T(0);
  }
}

template <typename T, int NX, int NU>
int launch_riccati_tile(const void* fxs, const void* fus, const void* lxs,
                        const void* lus, const void* lxxs, const void* luus,
                        const void* luxs, const void* gTs, const void* HTs,
                        const void* regs, const void* u_mask, void* Ks,
                        void* ks, void* stats, int B, int Tm1, void* stream) {
  if (B <= 0) return 0;
  constexpr int tiles = RICCATI_TILE_BLOCK / riccati_tile_width<NX>();
  const int blocks = (B + tiles - 1) / tiles;
  riccati_tile_kernel<T, NX, NU>
      <<<blocks, RICCATI_TILE_BLOCK, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(fxs), static_cast<const T*>(fus),
          static_cast<const T*>(lxs), static_cast<const T*>(lus),
          static_cast<const T*>(lxxs), static_cast<const T*>(luus),
          static_cast<const T*>(luxs), static_cast<const T*>(gTs),
          static_cast<const T*>(HTs), static_cast<const T*>(regs),
          static_cast<const T*>(u_mask), static_cast<T*>(Ks),
          static_cast<T*>(ks), static_cast<T*>(stats), B, Tm1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace odt

#define ODT_RICCATI(NX, NU, SUFFIX, T)                                        \
  int odt_riccati_nx##NX##_nu##NU##_##SUFFIX(                                 \
      const void* fxs, const void* fus, const void* lxs, const void* lus,     \
      const void* lxxs, const void* luus, const void* luxs, const void* gTs,  \
      const void* HTs, const void* regs, const void* u_mask, void* Ks,        \
      void* ks, void* stats, int B, int Tm1, void* stream) {                  \
    return odt::launch_riccati<T, NX, NU>(fxs, fus, lxs, lus, lxxs, luus,     \
                                          luxs, gTs, HTs, regs, u_mask, Ks,   \
                                          ks, stats, B, Tm1, stream);         \
  }

#define ODT_RICCATI_TILE(NX, NU, SUFFIX, T)                                   \
  int odt_riccati_tile_nx##NX##_nu##NU##_##SUFFIX(                            \
      const void* fxs, const void* fus, const void* lxs, const void* lus,     \
      const void* lxxs, const void* luus, const void* luxs, const void* gTs,  \
      const void* HTs, const void* regs, const void* u_mask, void* Ks,        \
      void* ks, void* stats, int B, int Tm1, void* stream) {                  \
    return odt::launch_riccati_tile<T, NX, NU>(                               \
        fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs, u_mask, Ks, ks, \
        stats, B, Tm1, stream);                                               \
  }
