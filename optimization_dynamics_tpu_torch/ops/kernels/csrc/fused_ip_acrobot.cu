// K1a: the whole path-following interior-point solve for the acrobot with
// hard elbow joint limits (nz = 6, ntheta = 6), one thread per scenario.
// Replaces the wide-lane Pallas call of optimization_dynamics_tpu/ops/
// pallas/fused_ip.py (make_fused_ip_solver, the pl.pallas_call at :410,
// body make_ip_body :133) that the reference's acrobot deploy tier runs.
//
// What bounds it on an H100: not memory (a lane reads 12 values and
// writes 10) but the latency of each thread's serial Newton chain: per
// iteration six dual-number residual passes for the Jacobian, a 6x6
// Householder QR and up to max_ls residual passes. At nz = 6 the whole
// system (J, the factors, z, theta) fits a thread's registers, so this is
// K1's design unchanged: the kernel of fused_ip.cuh with every loop
// unrolled and 128-thread blocks; the functor is acrobot_impact.cuh
// (orthant pairs only, no SOC group).
#include "acrobot_impact.cuh"
#include "fused_ip.cuh"

// one line per functor of FUSED_IP_FUNCTORS in ops/kernels/_build.py
extern "C" {
ODT_FUSED_IP(acrobot_impact, AcrobotImpact, f32, float)
ODT_FUSED_IP(acrobot_impact, AcrobotImpact, f64, double)
}  // extern "C"
