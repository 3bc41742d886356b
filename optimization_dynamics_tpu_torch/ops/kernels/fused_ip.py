"""K1: the whole path-following interior-point solve, fused in one kernel.

Replaces the Pallas kernel of ``optimization_dynamics_tpu/ops/pallas/
fused_ip.py``: ``make_fused_ip_solver`` (``:320``; the wide-lane
``pl.pallas_call`` at ``:410``) running ``make_ip_body`` (``:133``) with
``_orthant_alpha`` (``:58``), ``_soc_alpha`` (``:69``) and the QR of
``batched_solve.py::_qr_solve_block`` (``:34``). On the main path it runs
every lane-batched IP solve: the cold eval solves of each rollout step
(B x alphas lanes) and the warm grad solves of each derivative sweep
(B x (T-1) = 25,600 lanes at the deploy width).

What bounds it on an H100: arithmetic and latency, not memory. A lane
reads 18 values and writes 14, then runs a data-dependent Newton loop:
per iteration ten dual-number residual passes for the Jacobian, a 10x10
Householder QR, and up to ``max_ls`` residual passes of the line search.
The design gives each scenario one thread (128 per block) that keeps z,
theta, the residual, the Jacobian and the QR factors in registers (local
memory where they spill) and loops until its own lane is converged,
stalled or at ``max_iter``, so no lane waits for the batch and a lane's
iteration count is its own, as in ``make_solver_batched``. Divergent
lanes in one warp serialise; the first kernel accepts that. The model
enters as a device functor (``csrc/cartpole_friction.cuh``) whose
residual is a template on the number type; dual numbers give the
Jacobian columns, as ``jax.jacfwd`` does inside the Pallas body, so
hopper (nz=20) and push (nz=35) can reuse the kernel with a new functor.

The plain version is the port of ``make_solver_batched`` (geometric
schedule) with its Newton solve pinned to K2's plain QR. The wrapper
takes it for CPU tensors only; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    FUSED_IP_FUNCTORS,
    SUFFIX,
    fused_ip_symbol,
    load_library,
)
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve_plain,
)
from optimization_dynamics_tpu_torch.solver.interior_point import (
    IPOptions,
    IPSolution,
    _make_solver_batched,
)

__all__ = ["make_fused_ip_solver", "make_fused_ip_plain", "fused_ip"]


def make_fused_ip_plain(model, opts: IPOptions, device, dtype) -> Callable:
    """K1's plain version: ``make_solver_batched`` with the Newton solve
    through ``batched_solve_plain`` on any device."""
    return _make_solver_batched(model.residual, model.spec, opts, device,
                                dtype, batched_solve_plain)


def _ip_params(opts: IPOptions) -> np.ndarray:
    kappa_final = opts.kappa_final_frac * opts.kappa_tol
    kappa_lo = max(kappa_final, opts.kappa_init_min)
    return np.array([opts.r_tol, kappa_final, kappa_lo, opts.kappa_init_max,
                     opts.kappa_scale, opts.center_frac, opts.tau_min,
                     opts.tau_max, opts.gamma_reg, opts.max_iter,
                     opts.max_ls], np.float64)


def fused_ip(z0s: torch.Tensor, thetas: torch.Tensor, kernel: str,
             model_params: np.ndarray, ip_params: np.ndarray,
             plain: Callable) -> IPSolution:
    """The K1 wrapper. CPU tensors run ``plain``; CUDA tensors launch the
    kernel of the device functor ``kernel`` (float32 or float64)."""
    if z0s.device.type == "cpu" and thetas.device.type == "cpu":
        return plain(z0s, thetas)
    if z0s.device.type != "cuda" or thetas.device != z0s.device:
        raise ValueError("fused_ip: z0s and thetas must share one CUDA "
                         "device (got %s, %s)" % (z0s.device, thetas.device))
    if z0s.dtype not in SUFFIX or thetas.dtype != z0s.dtype:
        raise TypeError("fused_ip: float32 or float64 inputs of one dtype "
                        "(got %s, %s)" % (z0s.dtype, thetas.dtype))
    if kernel not in FUSED_IP_FUNCTORS:
        raise ValueError("fused_ip: no CUDA functor %r (compiled: %s)"
                         % (kernel, sorted(FUSED_IP_FUNCTORS)))
    B = z0s.shape[0]
    if (z0s.ndim != 2 or thetas.ndim != 2 or thetas.shape[0] != B
            or (z0s.shape[1], thetas.shape[1]) != FUSED_IP_FUNCTORS[kernel]):
        raise ValueError("fused_ip: %s takes z0s (B, %d), thetas (B, %d); "
                         "got %s, %s" % ((kernel,) + FUSED_IP_FUNCTORS[kernel]
                                          + (tuple(z0s.shape),
                                             tuple(thetas.shape))))
    if B >= 2 ** 31:
        raise ValueError("fused_ip: batch too large for int32")
    fn = getattr(load_library(), fused_ip_symbol(kernel, z0s.dtype))
    z0s = z0s.contiguous()
    thetas = thetas.contiguous()
    zs = torch.empty_like(z0s)
    stats = torch.empty((B, 4), dtype=z0s.dtype, device=z0s.device)
    if B > 0:
        with torch.cuda.device(z0s.device):
            err = fn(z0s.data_ptr(), thetas.data_ptr(), zs.data_ptr(),
                     stats.data_ptr(), B, model_params.ctypes.data,
                     ip_params.ctypes.data,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("fused_ip kernel launch failed: CUDA error "
                               "%d" % err)
        fused_ip.launches += 1
    return IPSolution(z=zs, iterations=stats[:, 0].to(torch.int32),
                      converged=stats[:, 1] > 0.5, r_vio=stats[:, 2],
                      kappa_vio=stats[:, 3])


fused_ip.launches = 0


def make_fused_ip_solver(model, opts: IPOptions, device, dtype
                         ) -> Callable:
    """Build ``solve(z0s (B, nz), thetas (B, ntheta)) -> IPSolution``: the
    drop-in for ``make_solver_batched`` (geometric schedule) that runs the
    whole solve in K1. ``model`` is an ``ImplicitModel`` whose ``kernel``
    names its device functor and ``kernel_params`` its constants."""
    plain = make_fused_ip_plain(model, opts, device, dtype)
    model_params = np.asarray(model.kernel_params, np.float64)
    ip_params = _ip_params(opts)

    def solve(z0s: torch.Tensor, thetas: torch.Tensor) -> IPSolution:
        return fused_ip(z0s, thetas, model.kernel, model_params, ip_params,
                        plain)

    return solve
