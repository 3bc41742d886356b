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
A launch lasts as long as its slowest scenario (up to ``max_iter`` = 40
iterations). Two kernels share that work out differently, and the
wrapper picks by the launch's width (``FUSED_IP_TILE_MAX_B``):

* Narrow launches, the rollout steps that are nearly all of K1's
  launches (B x alphas scenarios: 1,024 or 2,048 at B=512, fewer once
  the solver compacts its active lanes) and the sweeps that compaction
  narrowed (6,400 and fewer), would fill a few blocks of one thread a
  scenario on a few of the 132 SMs (eight at 1,024), each thread running
  the whole serial chain. There one 16-thread tile runs a scenario
  (``csrc/ip_tile.cuh``, four tiles a 64-thread block): thread j
  computes the Jacobian's column j with one dual-number residual, thread
  10 the right-hand side, the tile solves the Newton system with a column
  a thread (``csrc/qr_group.cuh``) and runs the line search's candidates
  at once. z, theta, the residual, kappa and the loop's flags are held
  redundantly by every thread of the tile, bit-identical, so the tile
  takes every branch together and stops at its own scenario's iteration,
  as in ``make_solver_batched``.
* Wide launches, the full derivative sweeps (B x (T-1) = 25,600
  scenarios), fill the card either way; the tile's redundant work then
  costs more issue slots than the chain it shortens, and one thread a
  scenario (``csrc/fused_ip.cuh``, 128-thread blocks, ``ip_solve_lane``,
  which K4's per-thread kernel shares, as its tile kernel shares
  ``ip_solve_tile``) is the faster.

Both keep the same arithmetic in the same order, so they give the same
results to rounding. The model enters as a device functor
(``csrc/cartpole_friction.cuh``) whose residual is a template on the
number type; dual numbers give the Jacobian columns, as ``jax.jacfwd``
does inside the Pallas body. K1a (acrobot, nz=6) has both kernels too:
its tile is 8 threads (the smallest power of two that holds NZ + 1, as
16 is for cartpole), eight tiles a block. With half cartpole's redundant
spine a scenario, its tile wins up to 204,800 scenarios, so it runs
every launch of the B=256 deploy, the 25,600-wide sweeps too.

K1n (planar push, nz=35) needs 36 threads for its columns and the
right-hand side, more than a warp's tile, and a thread cannot hold the
scenario's state beside its column and a dual-number residual. So its
narrow kernel runs a scenario on a group of 64 threads, two warps
(``csrc/ip_group.cuh``, two groups a 128-thread block): thread j < 35
builds column j, thread 35 the right-hand side, the group solves with
``qr_solve_group<35, 1>`` (the QR K2 runs at (35, 13)), and warp 0 runs
the line search's candidates; z, theta, the residual, the Newton step,
kappa and the exit flag sit once in shared memory, the scalar decisions
are made by every thread of warp 0 alike, and a group sync hands them
to warp 1. The wrapper sends it every launch up to its cut (every
launch of the B=256 deploy); wider ones run the per-thread kernel.

Two more functors run on the same two kernels, the residuals on which
the reference's tests run its fused kernel besides these three:
``rocket_projection`` (the rocket's thrust-cone projection, nz=10,
ntheta=4; ``csrc/rocket_projection.cuh``, ``fused_ip_rocket.cu``): a
16-thread tile, four a block, up to its cut of 3,840 scenarios (the
rollout steps and the compacted sweeps of the rocket deploy), the
per-thread kernel above (its 15,360-wide sweeps), where running all 25
line-search candidates with fewer instructions a scenario beats the
tile's redundant spine; and ``hopper`` (the hopper model, nz=20,
ntheta=13; ``csrc/hopper.cuh``, ``fused_ip_hopper.cu``): a 32-thread
tile, two a block, which wins at every width swept up to its cut of
51,200 (the per-thread kernel keeps the 20x20 Jacobian and its QR in
local memory), so every launch of the hopper deploy runs on the tile.
The rocket's projection is not an ``ImplicitModel``: ``models/rocket.py::
projection_model`` gives the residual, the cone spec and the functor,
and the wrapper takes its cold starts as z0s.

The plain version is the port of ``make_solver_batched`` (geometric
schedule; ``IPOptions.mehrotra`` raises) with its Newton solve pinned to
K2's plain QR. The wrapper
takes it for CPU tensors only; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import numpy as np
import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    FUSED_IP_FUNCTORS,
    FUSED_IP_TILE_MAX_B,
    SUFFIX,
    fused_ip_narrow,
    fused_ip_narrow_symbol,
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
    through ``batched_solve_plain`` on any device. The kernels implement
    the geometric kappa schedule only, so the Mehrotra predictor-corrector
    raises here (the reference's Pallas kernel ignores the flag)."""
    if opts.mehrotra:
        raise NotImplementedError(
            "fused IP kernel: IPOptions.mehrotra is not implemented; solve "
            "with make_solver_batched")
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
    kernel of the device functor ``kernel`` (float32 or float64): its
    narrow kernel (the tile kernel, or for K1n the group kernel) up to
    ``FUSED_IP_TILE_MAX_B["fused_ip", kernel]`` scenarios (counted in
    ``fused_ip.tile_launches`` too), else the per-thread kernel.
    ``fused_ip.widths`` counts the launches by (kernel, B), with kernel
    ``"tile"``, ``"group"`` or ``"thread"``."""
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
    tile = B <= FUSED_IP_TILE_MAX_B.get(("fused_ip", kernel), 0)
    symbol = fused_ip_narrow_symbol if tile else fused_ip_symbol
    fn = getattr(load_library(), symbol(kernel, z0s.dtype))
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
        fused_ip.tile_launches += tile
        fused_ip.widths[fused_ip_narrow(kernel) if tile else "thread",
                        B] += 1
    return IPSolution(z=zs, iterations=stats[:, 0].to(torch.int32),
                      converged=stats[:, 1] > 0.5, r_vio=stats[:, 2],
                      kappa_vio=stats[:, 3])


fused_ip.launches = 0
fused_ip.tile_launches = 0
fused_ip.widths = Counter()


def make_fused_ip_solver(model, opts: IPOptions, device, dtype
                         ) -> Callable:
    """Build ``solve(z0s (B, nz), thetas (B, ntheta)) -> IPSolution``: the
    drop-in for ``make_solver_batched`` (geometric schedule) that runs the
    whole solve in K1. ``model`` has the fields this reads: ``residual``
    and ``spec`` (the plain version's), ``kernel``, the name of its
    device functor, and ``kernel_params``, its constants (an
    ``ImplicitModel``, or the rocket's ``ProjectionModel``)."""
    plain = make_fused_ip_plain(model, opts, device, dtype)
    model_params = np.asarray(model.kernel_params, np.float64)
    ip_params = _ip_params(opts)

    def solve(z0s: torch.Tensor, thetas: torch.Tensor) -> IPSolution:
        return fused_ip(z0s, thetas, model.kernel, model_params, ip_params,
                        plain)

    return solve
