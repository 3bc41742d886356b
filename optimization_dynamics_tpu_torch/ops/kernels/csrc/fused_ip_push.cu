// K1n: the whole path-following interior-point solve for planar pushing
// (nz = 35, ntheta = 13), one thread per scenario. Replaces the
// narrow-lane Pallas call of optimization_dynamics_tpu/ops/pallas/
// fused_ip.py (``_kernel3``, the pl.pallas_call at :442, 32-lane blocks
// chosen by ``pick_lanes`` for nz > 24).
//
// What bounds it on an H100: not memory (a lane reads 48 values and
// writes 39) but the latency of a long serial chain per thread: per
// Newton iteration 35 dual-number residual passes for the Jacobian, a
// 35x35 Householder QR and up to max_ls residual passes. At nz = 35 the
// Jacobian and the QR factors (4.9 KB a lane in float32, 9.8 KB in
// float64) do not fit a thread's registers, so the design keeps K1's one
// thread per scenario and lets J, the factors and the Householder
// vectors live in per-thread local memory (cached in L1/L2), with the
// column loops of the Jacobian and the QR rolled (UNROLL_MAX_N in
// odt_common.cuh) so the build stays short; 32-thread blocks spread a
// sweep's 6,400 lanes over 200 blocks. Shared-memory or warp-per-scenario
// layouts are later work.
#include "fused_ip.cuh"
#include "planar_push.cuh"

// one line per functor of FUSED_IP_FUNCTORS in ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(planar_push, PlanarPush, f32, float)
ODT_FUSED_IP(planar_push, PlanarPush, f64, double)
}  // extern "C"
