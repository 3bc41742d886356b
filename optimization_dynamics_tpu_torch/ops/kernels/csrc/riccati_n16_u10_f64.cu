// K3, the per-thread kernel (riccati.cuh) at (16, 10) in float64: a
// source of its own, the slowest instantiation to compile.
#include "riccati.cuh"

// one line per (nx, nu) of RICCATI_SHAPES in ops/kernels/_build.py
extern "C" {
ODT_RICCATI(16, 10, f64, double)
}  // extern "C"
