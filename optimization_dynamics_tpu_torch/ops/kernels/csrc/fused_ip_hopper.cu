// K1 at the planar hopper model (nz = 20, ntheta = 13): the whole
// path-following interior-point solve of a scenario's contact step (four
// unilateral contacts, two friction cones). Replaces the wide-lane Pallas
// call of optimization_dynamics_tpu/ops/pallas/fused_ip.py
// (make_fused_ip_solver, the pl.pallas_call at :410, body make_ip_body
// :133) on ``hopper.model()``, as the reference's fused-kernel test runs
// it and as ``make_implicit_dynamics(hopper.model(), fused=True)`` would.
//
// What bounds it on an H100: not memory (a scenario reads 33 values and
// writes 24) but the latency of each scenario's serial Newton chain: per
// iteration twenty dual-number residual passes for the Jacobian (each
// with four sines and cosines), a 20x20 Householder QR and up to max_ls
// residual passes. The deploy sends it a rollout step's B x alphas
// scenarios (256 to 512 at B=256, fewer after compaction) and a
// derivative sweep's B x (T-1) = 5,120. Two kernels of fused_ip.cuh that
// the wrapper picks by width (FUSED_IP_TILE_MAX_B):
// * the tile kernel, one 32-thread tile a scenario (ip_tile.cuh, two
//   tiles a 64-thread block): thread j builds column j of the Jacobian,
//   thread 20 the right-hand side, the tile solves with a column a thread
//   (qr_solve_group<20, 1>) and runs the line search's candidates at once;
// * the per-thread kernel, one thread a scenario (ip_body.cuh; above
//   UNROLL_MAX_N the Jacobian's columns and the QR stay rolled, so J and
//   its factors live in local memory; 32-thread blocks), for launches
//   wide enough to fill the card.
// The functor is hopper.cuh.
#include "fused_ip.cuh"
#include "hopper.cuh"

// one line per functor of FUSED_IP_FUNCTORS and of FUSED_IP_TILE_MAX_B in
// ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(hopper, Hopper, f32, float)
ODT_FUSED_IP(hopper, Hopper, f64, double)
ODT_FUSED_IP_TILE(hopper, Hopper, f32, float)
ODT_FUSED_IP_TILE(hopper, Hopper, f64, double)
}  // extern "C"
