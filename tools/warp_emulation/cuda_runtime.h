// A host stand-in for the CUDA runtime header, enough to compile the
// register-resident warp kernels' device functions (qr_shfl.cuh,
// ip_warp.cuh's solve) with g++: a warp is 32 std::threads that meet at
// every shuffle, ballot and __syncwarp, so the lanes run in lockstep
// exactly where the kernels need them to. Used by
// tools/warp_emulation.py; nothing of the port includes it.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline

struct EmuDim {
  unsigned x = 0;
};
inline thread_local EmuDim threadIdx;

// the warp's meeting point: each lane's value, then everyone reads
struct EmuWarp {
  std::barrier<> bar{32};
  unsigned char slot[32][8];
};
inline thread_local EmuWarp* emu_warp = nullptr;

template <typename T>
inline T emu_exchange(T v, int src) {
  EmuWarp& w = *emu_warp;
  std::memcpy(w.slot[threadIdx.x & 31], &v, sizeof(T));
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, w.slot[src], sizeof(T));
  w.bar.arrive_and_wait();
  return out;
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = threadIdx.x & 31;
  return emu_exchange(v, (lane / width) * width + (src % width));
}

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int off, int = 32) {
  return emu_exchange(v, (threadIdx.x & 31) ^ off);
}

inline unsigned __ballot_sync(unsigned, bool p) {
  unsigned m = 0;
  for (int l = 0; l < 32; ++l)
    if (emu_exchange<int>(p ? 1 : 0, l)) m |= 1u << l;
  return m;
}

inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __syncwarp() { emu_warp->bar.arrive_and_wait(); }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline double __longlong_as_double(long long i) {
  double d;
  std::memcpy(&d, &i, 8);
  return d;
}
using std::sqrt;
