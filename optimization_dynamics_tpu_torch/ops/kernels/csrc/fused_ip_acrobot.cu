// K1a: the whole path-following interior-point solve for the acrobot with
// hard elbow joint limits (nz = 6, ntheta = 6). Replaces the wide-lane
// Pallas call of optimization_dynamics_tpu/ops/pallas/fused_ip.py
// (make_fused_ip_solver, the pl.pallas_call at :410, body make_ip_body
// :133) that the reference's acrobot deploy tier runs.
//
// What bounds it on an H100: not memory (a lane reads 12 values and
// writes 10) but the latency of each scenario's serial Newton chain: per
// iteration six dual-number residual passes for the Jacobian, a 6x6
// Householder QR and up to max_ls residual passes. The deploy's rollout
// steps launch B x 2 alphas = 512 scenarios, which a thread a scenario
// puts on 4 SMs. So, as K1 for cartpole, two kernels of fused_ip.cuh that
// the wrapper picks by width (FUSED_IP_TILE_MAX_B):
// * the tile kernel, one 8-thread tile a scenario (ip_tile.cuh, eight
//   tiles a 64-thread block): thread j builds column j of the Jacobian,
//   thread 6 the right-hand side, the tile solves with a column a thread
//   and runs the 8 line-search candidates at once;
// * the per-thread kernel, one thread a scenario (ip_body.cuh, every loop
//   unrolled, 128-thread blocks), for launches wide enough to fill the
//   card.
// The functor is acrobot_impact.cuh (orthant pairs only: N_SOC = 0, so
// boundary_alpha's SOC loop, shared by both solves, runs no iteration).
#include "acrobot_impact.cuh"
#include "fused_ip.cuh"

// one line per functor of FUSED_IP_FUNCTORS and of FUSED_IP_TILE_MAX_B in
// ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(acrobot_impact, AcrobotImpact, f32, float)
ODT_FUSED_IP(acrobot_impact, AcrobotImpact, f64, double)
ODT_FUSED_IP_TILE(acrobot_impact, AcrobotImpact, f32, float)
ODT_FUSED_IP_TILE(acrobot_impact, AcrobotImpact, f64, double)
}  // extern "C"
