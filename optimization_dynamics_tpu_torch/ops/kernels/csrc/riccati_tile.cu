// K3, the tile kernel (riccati.cuh) at every shape of RICCATI_SHAPES.
#include "riccati.cuh"

// one line per (nx, nu) of RICCATI_SHAPES in ops/kernels/_build.py
extern "C" {
ODT_RICCATI_TILE(4, 1, f32, float)
ODT_RICCATI_TILE(4, 1, f64, double)
ODT_RICCATI_TILE(4, 3, f32, float)
ODT_RICCATI_TILE(4, 3, f64, double)
ODT_RICCATI_TILE(6, 3, f32, float)
ODT_RICCATI_TILE(6, 3, f64, double)
ODT_RICCATI_TILE(10, 4, f32, float)
ODT_RICCATI_TILE(10, 4, f64, double)
ODT_RICCATI_TILE(16, 10, f32, float)
ODT_RICCATI_TILE(16, 10, f64, double)
}  // extern "C"
