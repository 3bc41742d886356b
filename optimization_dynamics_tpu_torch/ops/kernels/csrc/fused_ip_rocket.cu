// K1 at the rocket's thrust-cone projection (nz = 10, ntheta = 4): the
// whole cold path-following interior-point solve of a scenario's
// projection onto ||u_xy|| <= u_z <= u_max. Replaces the wide-lane Pallas
// call of optimization_dynamics_tpu/ops/pallas/fused_ip.py
// (make_fused_ip_solver, the pl.pallas_call at :410, body make_ip_body
// :133) on ``rocket.residual_proj``, as the reference's fused-kernel test
// runs it.
//
// What bounds it on an H100: not memory (a scenario reads 14 values and
// writes 14) but the latency of each scenario's serial Newton chain: per
// iteration ten dual-number residual passes for the Jacobian, a 10x10
// Householder QR and up to max_ls = 25 residual passes of the line
// search (the projection runs the IP options' defaults). The deploy
// sends it a rollout step's B x alphas scenarios (256 to 512, fewer
// after compaction) and a derivative sweep's B x (T-1) = 15,360. As K1
// for cartpole, two kernels of fused_ip.cuh that the wrapper picks by
// width (FUSED_IP_TILE_MAX_B):
// * the tile kernel, one 16-thread tile a scenario (ip_tile.cuh, four
//   tiles a 64-thread block): thread j builds column j of the Jacobian,
//   thread 10 the right-hand side, the tile solves with a column a thread
//   and runs 16 of the line search's candidates at once;
// * the per-thread kernel, one thread a scenario (ip_body.cuh, every loop
//   unrolled, 128-thread blocks), for launches wide enough to fill the
//   card.
// The functor is rocket_projection.cuh: two orthant pairs and two SOC(3)
// groups (primal and dual, axis first).
#include "fused_ip.cuh"
#include "rocket_projection.cuh"

// one line per functor of FUSED_IP_FUNCTORS and of FUSED_IP_TILE_MAX_B in
// ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(rocket_projection, RocketProjection, f32, float)
ODT_FUSED_IP(rocket_projection, RocketProjection, f64, double)
ODT_FUSED_IP_TILE(rocket_projection, RocketProjection, f32, float)
ODT_FUSED_IP_TILE(rocket_projection, RocketProjection, f64, double)
}  // extern "C"
