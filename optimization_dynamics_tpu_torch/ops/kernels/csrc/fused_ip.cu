// K1: the whole path-following interior-point solve for cartpole with
// joint friction (nz = 10), one thread per scenario. Replaces the Pallas
// kernel of optimization_dynamics_tpu/ops/pallas/fused_ip.py
// (make_ip_body, wide-lane call of make_fused_ip_solver). The kernel is
// fused_ip.cuh; see ops/kernels/fused_ip.py for the design note.
#include "cartpole_friction.cuh"
#include "fused_ip.cuh"

// one line per functor of FUSED_IP_FUNCTORS in ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(cartpole_friction, CartpoleFriction, f32, float)
ODT_FUSED_IP(cartpole_friction, CartpoleFriction, f64, double)
}  // extern "C"
