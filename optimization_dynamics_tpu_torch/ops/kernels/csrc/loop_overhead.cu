// K5: the loop-overhead probe. Replaces the three pl.pallas_call
// micro-kernels of scripts/loop_overhead_r5.py (the fori_loop kernels
// ``plain`` and ``reps8`` built at :50, the while_loop kernel at :92),
// which measured the cost of one loop trip inside a kernel.
//
// What it computes, on a (10, 128) float32 carry z, N = 1000 logical
// iterations of
//     z = z * 0.999 + 0.001;  z = z + max(z, axis=0) * 1e-6
// in three loop structures:
//   plain  a counted loop of N trips, one iteration a trip, kept rolled
//          (#pragma unroll 1), as fori_loop(unroll=1);
//   reps8  N/8 trips of eight unrolled iterations (the manual
//          amortisation of the reference's kernel C);
//   while  a loop whose trip count is a runtime argument, with an
//          early-exit test on the data each trip (a column max that is
//          not finite ends it), the structure of K1's Newton loop.
//
// What bounds it on an H100: neither memory (5,120 bytes in, the same
// out) nor arithmetic (5,120 operations an iteration: a scale, a shift
// and an add an element, nine compares and one scale a column; 5.12
// MFLOP, 76.4 ns at the float32 rate) but the serial chain of each
// column: 1,000 dependent updates. The design is one block of 128 threads, one column a thread, its ten values in
// registers, so the column max stays inside the thread (no shuffle, no
// shared memory, no barrier); it is not the TPU's (10, 128) vreg layout.
// The products and sums are written with __fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA and the kernel rounds exactly as the
// plain PyTorch loop does.
#include <cuda_runtime.h>

namespace odt {

constexpr int LO_ROWS = 10;
constexpr int LO_COLS = 128;
constexpr int LO_N = 1000;

struct LoopOverheadColumn {
  float z[LO_ROWS];

  // one logical iteration; returns the column max it used
  __device__ __forceinline__ float step() {
#pragma unroll
    for (int i = 0; i < LO_ROWS; ++i)
      z[i] = __fadd_rn(__fmul_rn(z[i], 0.999f), 0.001f);
    float m = z[0];
#pragma unroll
    for (int i = 1; i < LO_ROWS; ++i) m = fmaxf(m, z[i]);
    const float dm = __fmul_rn(m, 1e-6f);
#pragma unroll
    for (int i = 0; i < LO_ROWS; ++i) z[i] = __fadd_rn(z[i], dm);
    return m;
  }
};

// variant: 0 plain, 1 reps8, 2 while (n_iter trips)
__global__ void __launch_bounds__(LO_COLS)
loop_overhead_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int variant, int n_iter) {
  const int c = threadIdx.x;
  LoopOverheadColumn col;
#pragma unroll
  for (int i = 0; i < LO_ROWS; ++i) col.z[i] = x[i * LO_COLS + c];
  if (variant == 0) {
#pragma unroll 1
    for (int it = 0; it < LO_N; ++it) col.step();
  } else if (variant == 1) {
#pragma unroll 1
    for (int it = 0; it < LO_N / 8; ++it) {
#pragma unroll
      for (int r = 0; r < 8; ++r) col.step();
    }
  } else {
    int it = 0;
    bool done = false;
    while (it < n_iter && !done) {
      const float m = col.step();
      done = !(fabsf(m) <= 3.402823466e38f);  // not finite (FLT_MAX)
      ++it;
    }
  }
#pragma unroll
  for (int i = 0; i < LO_ROWS; ++i) out[i * LO_COLS + c] = col.z[i];
}

}  // namespace odt

extern "C" int odt_loop_overhead(const void* x, void* out, int variant,
                                 int n_iter, void* stream) {
  odt::loop_overhead_kernel<<<1, odt::LO_COLS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), variant,
      n_iter);
  return static_cast<int>(cudaGetLastError());
}
