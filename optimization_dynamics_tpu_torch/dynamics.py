"""Differentiable implicit (optimization-based) dynamics.

Port of ``optimization_dynamics_tpu/dynamics.py``: a discrete step
``x = [q1; q2] --IP solve--> y = [q2; q3]`` where ``q3`` solves the
model's contact/friction residual, with two solver configurations (the
smoothed-gradient design):

  * ``eval`` — tight relaxation (``kappa_eval_tol``), used for rollouts;
  * ``grad`` — loose relaxation (``kappa_grad_tol``), whose IFT
    sensitivities are the smooth Jacobians fed to the trajectory optimizer.

A model with a CUDA device functor (``ImplicitModel.kernel``) runs both
solvers through the fused IP kernel (K1), whose wrapper takes its plain
version for CPU tensors; a model without one runs ``make_solver_batched``.
The IFT solve always goes through the batched QR (K2). The scalar members
(``step``, ``step_info``, ``step_jac``, ``step_carry``, ``step_diff``)
are the lane-batched ones on a batch of one, so a scalar step on a CUDA
tensor runs the same kernels at width 1. ``step_diff`` differentiates
through the solve by the IFT: its backward pass is ``fx.T g``, ``fu.T g``
from ``step_jac``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from optimization_dynamics_tpu_torch.ops.cones import ConeSpec
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver.interior_point import (
    IPOptions,
    IPSolution,
    make_sensitivity_batched,
    make_solver_batched,
)

__all__ = ["ImplicitModel", "ImplicitDynamics", "make_implicit_dynamics",
           "simulate", "state_to_configuration"]


class ImplicitModel(NamedTuple):
    """A model's optimization-based dynamics, fully specified.

    ``residual(z, theta, kappa)``, ``init_z(q)`` and ``theta_fn(q0, q1, u,
    aux)`` (the problem data) are plain torch over the last dimension, so
    they take one vector or a batch alike; ``q_sel`` selects
    the next configuration from ``z``; ``th_q0/th_q1/th_u`` are the theta
    columns of the respective inputs (for the IFT chain rule).
    ``kernel`` names the model's CUDA device functor for the fused IP
    kernel (None: no functor) and ``kernel_params`` its constants.
    """

    nq: int
    nu: int
    nz: int
    ntheta: int
    residual: Callable
    spec: ConeSpec
    init_z: Callable
    theta_fn: Callable
    q_sel: Tuple[int, ...]
    th_q0: Tuple[int, ...]
    th_q1: Tuple[int, ...]
    th_u: Tuple[int, ...]
    kernel: Optional[str] = None
    kernel_params: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class ImplicitDynamics:
    """Eval/grad steppers for one model: ``step(x, u, aux) -> y``;
    ``step_info`` also returns the ``IPSolution``; ``step_jac(x, u, aux)
    -> (y, fx, fu)`` from one kappa_grad solve; the lane-batched members
    take a batch first."""

    model: ImplicitModel
    step: Callable
    step_info: Callable
    step_jac: Callable
    step_batched: Callable      # (xs, us, aux) -> ys (lane-batched eval)
    step_jac_batched: Callable  # (xs, us, aux) -> (ys, fxs, fus)
    # warm-started variants: z0s are solver variables from a previous
    # solve of the same timestep
    step_batched_ws: Callable      # (xs, us, aux, z0s) -> (ys, zs)
    step_jac_batched_ws: Callable  # (xs, us, aux, z0s) -> (ys,fxs,fus,zs)
    step_diff: Callable   # step with an IFT backward pass for autograd
    step_carry: Callable  # (z_prev, x, u, aux) -> (y, z): warm-started
    carry_init: Callable  # (x0 or x0s,) -> initial warm-start variables


def make_implicit_dynamics(
    model: ImplicitModel,
    device,
    dtype,
    r_tol: float = 1.0e-8,
    kappa_eval_tol: float = 1.0e-4,
    kappa_grad_tol: float = 1.0e-3,
    eval_opts: IPOptions | None = None,
    grad_opts: IPOptions | None = None,
) -> ImplicitDynamics:
    nq = model.nq
    # kappa_init_min keeps warm-started solves on the cold path's
    # complementarity branch; no effect on cold starts
    if eval_opts is None:
        eval_opts = IPOptions(r_tol=r_tol, kappa_tol=kappa_eval_tol,
                              kappa_init_min=1.0e-2)
    if grad_opts is None:
        grad_opts = IPOptions(r_tol=r_tol, kappa_tol=kappa_grad_tol,
                              kappa_init_min=1.0e-2)

    if model.kernel is not None:
        eval_solve_batched = make_fused_ip_solver(model, eval_opts, device,
                                                  dtype)
        grad_solve_batched = make_fused_ip_solver(model, grad_opts, device,
                                                  dtype)
    else:
        eval_solve_batched = make_solver_batched(
            model.residual, model.spec, eval_opts, device, dtype)
        grad_solve_batched = make_solver_batched(
            model.residual, model.spec, grad_opts, device, dtype)
    sens_batched = make_sensitivity_batched(model.residual, model.spec)

    q_sel = list(model.q_sel)
    th_q0 = list(model.th_q0)
    th_q1 = list(model.th_q1)
    th_u = list(model.th_u)

    def _thetas_of(xs, us, aux):
        q1s = xs[:, nq:2 * nq]
        return q1s, model.theta_fn(xs[:, :nq], q1s, us, aux)

    def step_batched(xs, us, aux):
        """Lane-batched cold eval step."""
        q1s, thetas = _thetas_of(xs, us, aux)
        sols = eval_solve_batched(model.init_z(q1s), thetas)
        return torch.cat([q1s, sols.z[:, q_sel]], dim=1)

    def _jac_from_sol(xs, q1s, thetas, sols):
        q2s = sols.z[:, q_sel]
        ys = torch.cat([q1s, q2s], dim=1)
        dqs = sens_batched(sols.z, thetas)[:, q_sel, :]
        B = xs.shape[0]
        eye = torch.eye(nq, dtype=xs.dtype, device=xs.device).expand(
            B, nq, nq)
        zero = torch.zeros((B, nq, nq), dtype=xs.dtype, device=xs.device)
        top = torch.cat([zero, eye], dim=2)
        bot = torch.cat([dqs[:, :, th_q0], dqs[:, :, th_q1]], dim=2)
        fxs = torch.cat([top, bot], dim=1)
        du = dqs[:, :, th_u]
        fus = torch.cat([torch.zeros((B, nq, du.shape[2]), dtype=xs.dtype,
                                     device=xs.device), du], dim=1)
        return ys, fxs, fus

    def step_jac_batched(xs, us, aux):
        """Cold Jacobian sweep: one batched grad solve for all lanes."""
        q1s, thetas = _thetas_of(xs, us, aux)
        sols = grad_solve_batched(model.init_z(q1s), thetas)
        return _jac_from_sol(xs, q1s, thetas, sols)

    def step_jac_batched_ws(xs, us, aux, z0s):
        """Warm-started Jacobian sweep; also returns the solver variables."""
        q1s, thetas = _thetas_of(xs, us, aux)
        sols = grad_solve_batched(z0s, thetas)
        ys, fxs, fus = _jac_from_sol(xs, q1s, thetas, sols)
        return ys, fxs, fus, sols.z

    def step_batched_ws(xs, us, aux, z0s):
        """Warm-started lane-batched eval step -> (ys, zs)."""
        q1s, thetas = _thetas_of(xs, us, aux)
        sols = eval_solve_batched(z0s, thetas)
        return torch.cat([q1s, sols.z[:, q_sel]], dim=1), sols.z

    def carry_init(x0s):
        return model.init_z(x0s[..., nq:2 * nq])

    def step_info(x, u, aux) -> Tuple[torch.Tensor, IPSolution]:
        q1, theta = _thetas_of(x[None], u[None], aux)
        sol = eval_solve_batched(model.init_z(q1), theta)
        sol = IPSolution(*(a[0] for a in sol))
        return torch.cat([q1[0], sol.z[q_sel]]), sol

    def step(x, u, aux):
        return step_info(x, u, aux)[0]

    def step_jac(x, u, aux):
        """One relaxed solve -> (y, dy/dx, dy/du)."""
        return tuple(a[0] for a in step_jac_batched(x[None], u[None], aux))

    def step_carry(z_prev, x, u, aux):
        """Step warm-started from solver variables of an earlier solve
        -> (y, z)."""
        y, z = step_batched_ws(x[None], u[None], aux, z_prev[None])
        return y[0], z[0]

    class StepDiff(torch.autograd.Function):
        """``step`` whose vector-Jacobian product is the IFT's at the
        relaxed solution: one kappa_grad solve per cotangent instead of
        differentiating through the Newton iterations."""

        @staticmethod
        def forward(x, u, aux):
            return step(x, u, aux)

        @staticmethod
        def setup_context(ctx, inputs, output):
            x, u, aux = inputs
            ctx.save_for_backward(x, u)
            ctx.aux = aux

        @staticmethod
        def backward(ctx, g):
            x, u = ctx.saved_tensors
            _, fx, fu = step_jac(x, u, ctx.aux)
            return fx.T @ g, fu.T @ g, None

    return ImplicitDynamics(
        model=model,
        step=step,
        step_info=step_info,
        step_jac=step_jac,
        step_batched=step_batched,
        step_jac_batched=step_jac_batched,
        step_batched_ws=step_batched_ws,
        step_jac_batched_ws=step_jac_batched_ws,
        step_diff=StepDiff.apply,
        step_carry=step_carry,
        carry_init=carry_init,
    )


def simulate(dyn: ImplicitDynamics, x0: torch.Tensor, us: torch.Tensor,
             aux) -> Tuple[torch.Tensor, IPSolution]:
    """Open-loop simulation collecting the solver variables: the
    ``(N+1, 2 nq)`` states from ``x0`` under ``us (N, nu)`` and the
    per-step ``IPSolution`` stacked along the first dimension (``z`` holds
    each step's configuration, impulses and slacks)."""
    x = x0
    xs, sols = [x0], []
    for u in us:
        x, sol = dyn.step_info(x, u, aux)
        xs.append(x)
        sols.append(sol)
    return torch.stack(xs), IPSolution(*(torch.stack(f)
                                         for f in zip(*sols)))


def state_to_configuration(xs: torch.Tensor) -> torch.Tensor:
    """Unstack ``(T, 2 nq)`` states into the ``(T+1, nq)`` configurations."""
    nq = xs.shape[-1] // 2
    return torch.cat([xs[:1, :nq], xs[:, nq:]], dim=0)
