// Shared device helpers for the hand-written Hopper kernels.
//
// * jmin / jmax / jclip: NaN-propagating, like jnp.minimum / torch.minimum
//   (fminf/fmin drop a NaN operand, which would hide a failed solve).
// * Dual<T>: forward-mode dual numbers. A model residual written once as
//   a template on its number type gives its values with T and one
//   Jacobian column per evaluation with Dual<T> (the seed picks the
//   column): the CUDA counterpart of jax.jacfwd / torch.func.jacfwd.
// * UNROLL_MAX_N: the unroll policy of the loops over an N-unknown system
//   (the QR solve, the Jacobian's columns). Up to 16 unknowns they unroll
//   fully, so the system lives in registers; above (planar push, 35) they
//   stay rolled, so the arrays live in local memory and nvcc does not
//   expand ~N^3 statements. The two are separate instantiations (if
//   constexpr on N), so the rolled code never enters a small system's.
#pragma once

#include <cuda_runtime.h>

namespace odt {

constexpr int UNROLL_MAX_N = 16;

template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T jabs(T x) { return x < T(0) ? -x : x; }

__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }

template <typename T>
struct Dual {
  T v;  // value
  T d;  // tangent
  __device__ __forceinline__ Dual() : v(T(0)), d(T(0)) {}
  __device__ __forceinline__ Dual(T v_) : v(v_), d(T(0)) {}
  __device__ __forceinline__ Dual(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v + b.v, a.d + b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v - b.v, a.d - b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return Dual<T>(-a.v, -a.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return Dual<T>(q, (a.d - q * b.d) / b.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> dsin(Dual<T> a) {
  return Dual<T>(dsin(a.v), dcos(a.v) * a.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> dcos(Dual<T> a) {
  return Dual<T>(dcos(a.v), -dsin(a.v) * a.d);
}

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(Dual<T> a) {
  const T r = dsqrt(a.v);
  return Dual<T>(r, a.d / (T(2) * r));
}

// x ** y for a real exponent y (a constant of the model, not a variable)
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dpow(double x, double y) {
  return pow(x, y);
}
template <typename T>
__device__ __forceinline__ Dual<T> dpow(Dual<T> a, T y) {
  return Dual<T>(dpow(a.v, y), y * dpow(a.v, y - T(1)) * a.d);
}

// x ** N for an integer N >= 1 by binary exponentiation: the
// multiplications of jnp's integer_pow, for T and Dual<T> alike (on a
// dual number the product rule of each multiplication gives the tangent)
template <int N, typename S>
__device__ __forceinline__ S ipow(S x) {
  static_assert(N >= 1, "ipow: N >= 1");
  S acc = x;
  bool have = false;
  int n = N;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (n == 0) break;
    if (n & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return acc;
}

}  // namespace odt
