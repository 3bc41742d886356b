// K3, the per-thread kernel (riccati.cuh) at the shapes up to (10, 4).
// Replaces the Pallas kernel of optimization_dynamics_tpu/ops/
// pallas/riccati.py (make_riccati_backward); the design is in riccati.cuh
// and ops/kernels/riccati.py.
#include "riccati.cuh"

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
