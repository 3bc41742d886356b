// The body of the per-thread QR solve, included twice by qr.cuh: with
// ODT_QR_UNROLL = _Pragma("unroll") every loop unrolls (systems up to
// UNROLL_MAX_N unknowns live in registers), with _Pragma("unroll 1") the
// loops stay rolled (larger systems live in local memory, and nvcc does
// not expand ~N^3 statements). One text keeps both instantiations'
// arithmetic the same; see qr.cuh for what it computes.
// (No include guard: it is meant to be included twice.)

template <typename T, int N, int K>
__device__ __forceinline__ void ODT_QR_NAME(T (&R)[N][N], T (&y)[N][K],
                                            T (&x)[N][K]) {
  ODT_QR_UNROLL
  for (int i = 0; i < N; ++i) {
    T normsq = T(0);
    ODT_QR_UNROLL
    for (int r = i; r < N; ++r) normsq += R[r][i] * R[r][i];
    const T normx = sqrt(normsq);
    const T x0 = R[i][i];
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    const T alpha = -sign * normx;
    T v[N];
    ODT_QR_UNROLL
    for (int r = 0; r < N; ++r)
      v[r] = r < i ? T(0) : (r == i ? x0 - alpha : R[r][i]);
    T vnorm2 = T(0);
    ODT_QR_UNROLL
    for (int r = i; r < N; ++r) vnorm2 += v[r] * v[r];
    const T inv = vnorm2 > T(0) ? T(2) / vnorm2 : T(0);

    ODT_QR_UNROLL
    for (int c = i; c < N; ++c) {
      T w = T(0);
      ODT_QR_UNROLL
      for (int r = i; r < N; ++r) w += v[r] * R[r][c];
      ODT_QR_UNROLL
      for (int r = i; r < N; ++r) R[r][c] = R[r][c] - (inv * v[r]) * w;
    }
    ODT_QR_UNROLL
    for (int k = 0; k < K; ++k) {
      T wy = T(0);
      ODT_QR_UNROLL
      for (int r = i; r < N; ++r) wy += v[r] * y[r][k];
      ODT_QR_UNROLL
      for (int r = i; r < N; ++r) y[r][k] = y[r][k] - (inv * v[r]) * wy;
    }
  }

  ODT_QR_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    const T diag = R[i][i];
    const T safe = jabs(diag) > T(1e-30) ? diag : T(1);
    ODT_QR_UNROLL
    for (int k = 0; k < K; ++k) {
      T s = T(0);
      ODT_QR_UNROLL
      for (int j = i + 1; j < N; ++j) s += R[i][j] * x[j][k];
      x[i][k] = (y[i][k] - s) / safe;
    }
  }
}
