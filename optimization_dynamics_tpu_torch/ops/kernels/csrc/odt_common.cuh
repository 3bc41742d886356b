// Shared device helpers for the hand-written Hopper kernels.
//
// * jmin / jmax / jclip: NaN-propagating, like jnp.minimum / torch.minimum
//   (fminf/fmin drop a NaN operand, which would hide a failed solve).
// * Dual<T>: forward-mode dual numbers. A model residual written once as
//   a template on its number type gives its values with T and one
//   Jacobian column per evaluation with Dual<T> (the seed picks the
//   column): the CUDA counterpart of jax.jacfwd / torch.func.jacfwd.
#pragma once

#include <cuda_runtime.h>

namespace odt {

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

}  // namespace odt
