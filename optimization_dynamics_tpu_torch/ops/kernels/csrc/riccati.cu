// K3: the whole iLQR Riccati backward recursion, one thread per scenario.
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/pallas/
// riccati.py (make_riccati_backward, body _make_body, Cholesky
// _chol_solve_block). See ops/kernels/riccati.py for the design note.
//
// Per lane, t = T-2 .. 0, with Vx and Vxx in registers, exactly what the
// Pallas body computes, in its order: Gauss-Newton Q-terms; u_mask
// (a device array, 1 = active) zeroes the masked rows of Qu and Qux and
// the masked rows and columns of Quu, whose diagonal then gets the lane's
// regulariser (active) or 1 (masked); an unrolled Cholesky solve of
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
#include <cstdint>

#include "odt_common.cuh"

namespace odt {

constexpr int RICCATI_THREADS = 32;

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

    // Cholesky Quu = L L^T, column by column
    T L[NU][NU];
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
    // L y = [Qu Qux], then L^T x = y; gains = -x
    T X[NU][NX + 1];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const T diag = L[i][i];
      const T safe = diag > T(1e-30) ? diag : T(1);
#pragma unroll
      for (int c = 0; c <= NX; ++c) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < i; ++r) acc += L[i][r] * X[r][c];
        X[i][c] = ((c == 0 ? Qu[i] : Qux[i][c - 1]) - acc) / safe;
      }
    }
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
      const T diag = L[i][i];
      const T safe = diag > T(1e-30) ? diag : T(1);
#pragma unroll
      for (int c = 0; c <= NX; ++c) {
        T acc = T(0);
#pragma unroll
        for (int r = i + 1; r < NU; ++r) acc += L[r][i] * X[r][c];
        X[i][c] = (X[i][c] - acc) / safe;
      }
    }
    T kk[NU], KK[NU][NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      kk[i] = -X[i][0];
#pragma unroll
      for (int l = 0; l < NX; ++l) KK[i][l] = -X[i][l + 1];
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

// one line per (nx, nu) of RICCATI_SHAPES in ops/kernels/_build.py
extern "C" {
ODT_RICCATI(4, 1, f32, float)
ODT_RICCATI(4, 1, f64, double)
ODT_RICCATI(4, 3, f32, float)
ODT_RICCATI(4, 3, f64, double)
ODT_RICCATI(6, 3, f32, float)
ODT_RICCATI(6, 3, f64, double)
ODT_RICCATI(10, 4, f32, float)
ODT_RICCATI(10, 4, f64, double)
}  // extern "C"
