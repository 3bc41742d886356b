// K1: the whole path-following interior-point solve for cartpole with
// joint friction (nz = 10). Replaces the Pallas kernel of
// optimization_dynamics_tpu/ops/pallas/fused_ip.py (make_ip_body,
// wide-lane call of make_fused_ip_solver). Two kernels of fused_ip.cuh:
// one 16-thread tile a scenario (ip_tile.cuh) for launches up to
// FUSED_IP_TILE_MAX_B scenarios (the rollout steps), one thread a scenario
// (ip_body.cuh) for wider ones (the derivative sweeps); the wrapper picks.
// See ops/kernels/fused_ip.py for the design note.
#include "cartpole_friction.cuh"
#include "fused_ip.cuh"

// one line per functor of FUSED_IP_FUNCTORS and of FUSED_IP_TILE_MAX_B in
// ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(cartpole_friction, CartpoleFriction, f32, float)
ODT_FUSED_IP(cartpole_friction, CartpoleFriction, f64, double)
ODT_FUSED_IP_TILE(cartpole_friction, CartpoleFriction, f32, float)
ODT_FUSED_IP_TILE(cartpole_friction, CartpoleFriction, f64, double)
}  // extern "C"
