// K1n: the whole path-following interior-point solve for planar pushing
// (nz = 35, ntheta = 13). Replaces the narrow-lane Pallas call of
// optimization_dynamics_tpu/ops/pallas/fused_ip.py (``_kernel3``, the
// pl.pallas_call at :442, 32-lane blocks chosen by ``pick_lanes`` for
// nz > 24).
//
// What bounds it on an H100: not memory (a scenario reads 48 values and
// writes 39) but the latency of a long serial chain a scenario: per
// Newton iteration 35 dual-number residual passes for the Jacobian, a
// 35x35 Householder QR and up to max_ls residual passes. One thread a
// scenario runs that chain alone, with the Jacobian and the QR factors
// (4.9 KB a scenario in float32) in local memory, and a rollout step's
// 512 scenarios fill 16 blocks on 16 of the 132 SMs. So two kernels of
// fused_ip.cuh, which the wrapper picks by width (FUSED_IP_TILE_MAX_B):
// * the group kernel, one 64-thread group (two warps) a scenario
//   (ip_group.cuh): thread j builds column j of the Jacobian with one
//   dual-number residual, thread 35 the right-hand side, the group solves
//   with a column a thread (qr_solve_group, the QR that K2 runs at (35,
//   13)) and warp 0 runs the 8 line-search candidates at once. The
//   Newton chain a scenario shrinks from about 35 + 8 residual passes
//   and a serial QR to two residual passes and a QR of 35 column steps;
//   the scenario's state sits once in shared memory (5.8 KB in float32,
//   11.6 KB in float64), the columns in registers, and 512 scenarios
//   fill 256 blocks of two groups;
// * the per-thread kernel, one thread a scenario (ip_body.cuh, J and the
//   factors in local memory with the column loops rolled, UNROLL_MAX_N in
//   odt_common.cuh, 32-thread blocks), for launches wider than the cut.
#include "fused_ip.cuh"
#include "planar_push.cuh"

// one line per functor of FUSED_IP_FUNCTORS and of FUSED_IP_TILE_MAX_B in
// ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(planar_push, PlanarPush, f32, float)
ODT_FUSED_IP(planar_push, PlanarPush, f64, double)
ODT_FUSED_IP_GROUP(planar_push, PlanarPush, f32, float)
ODT_FUSED_IP_GROUP(planar_push, PlanarPush, f64, double)
}  // extern "C"
