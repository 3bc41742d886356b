"""Direct (simultaneous) trajectory optimisation: dense AL Gauss-Newton.

Port of ``optimization_dynamics_tpu/solver/direct.py``, the baseline the
paper compares against: every state, control and contact force stacked
into one decision vector, the dynamics as equality defects, the
complementarity as inequality rows, solved by an augmented-Lagrangian
outer loop around a Levenberg-Marquardt-damped Gauss-Newton inner loop,
one dense symmetric solve an iteration. Both loops run on the host with
the reference's acceptance rule, LM schedule, multiplier clipping and
stopping tests; the gradient, Hessian and constraint Jacobians come from
``torch.func`` (``grad``, ``hessian``, ``jacfwd``), so the problem's
functions are plain torch on the decision vector's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd

__all__ = ["DirectOptions", "DirectProblem", "DirectResult", "solve_direct"]


@dataclasses.dataclass(frozen=True)
class DirectOptions:
    grad_tol: float = 1.0e-4
    con_tol: float = 1.0e-2        # the reference comparison's NLP tolerance
    max_iter: int = 50             # inner GN iterations per AL round
    max_al_iter: int = 10
    rho_init: float = 1.0
    rho_scale: float = 10.0
    lm_init: float = 1.0e-6
    lm_up: float = 10.0
    lm_down: float = 0.5
    lm_max: float = 1.0e10
    lambda_max: float = 1.0e8


class DirectProblem(NamedTuple):
    n: int
    objective: Callable                  # (w,) -> scalar
    eq_con: Optional[Callable] = None    # (w,) -> (m_eq,)  == 0
    ineq_con: Optional[Callable] = None  # (w,) -> (m_in,) <= 0


class DirectResult(NamedTuple):
    w: torch.Tensor
    objective: torch.Tensor
    constraint_violation: float
    iterations: int
    al_iterations: int
    converged: bool


def make_al(prob: DirectProblem):
    """``(al_value, gn_grad_hess, violation)`` of ``prob``: the
    augmented Lagrangian at ``(w, lam_eq, lam_in, rho)``, its Gauss-Newton
    gradient and Hessian (the constraints linearised), and the largest
    constraint violation."""
    has_eq = prob.eq_con is not None
    has_in = prob.ineq_con is not None

    def al_value(w, lam_eq, lam_in, rho):
        J = prob.objective(w)
        if has_eq:
            c = prob.eq_con(w)
            J = J + lam_eq @ c + 0.5 * rho * c @ c
        if has_in:
            c = prob.ineq_con(w)
            lam_new = torch.clamp_min(lam_in + rho * c, 0.0)
            J = J + torch.sum(lam_new ** 2 - lam_in ** 2) / (2.0 * rho)
        return J

    def gn_grad_hess(w, lam_eq, lam_in, rho):
        g = grad(prob.objective)(w)
        H = hessian(prob.objective)(w)
        if has_eq:
            c = prob.eq_con(w)
            Jc = jacfwd(prob.eq_con)(w)
            g = g + Jc.T @ (lam_eq + rho * c)
            H = H + rho * Jc.T @ Jc
        if has_in:
            c = prob.ineq_con(w)
            Jc = jacfwd(prob.ineq_con)(w)
            mult = torch.clamp_min(lam_in + rho * c, 0.0)
            active = (lam_in + rho * c) > 0.0
            g = g + Jc.T @ mult
            H = H + rho * (Jc.T * active) @ Jc
        return g, H

    def violation(w):
        v = 0.0
        if has_eq:
            v = max(v, float(prob.eq_con(w).abs().max()))
        if has_in:
            v = max(v, float(torch.clamp_min(prob.ineq_con(w), 0.0).max()))
        return v

    return al_value, gn_grad_hess, violation


def solve_direct(prob: DirectProblem, w0: torch.Tensor,
                 opts: DirectOptions = DirectOptions()) -> DirectResult:
    al_value, gn_grad_hess, violation = make_al(prob)
    has_eq = prob.eq_con is not None
    has_in = prob.ineq_con is not None
    eye = torch.eye(prob.n, dtype=w0.dtype, device=w0.device)

    def inner(w, lam_eq, lam_in, rho):
        lm, it, done = opts.lm_init, 0, False
        while it < opts.max_iter and not done:
            g, H = gn_grad_hess(w, lam_eq, lam_in, rho)
            step, info = torch.linalg.solve_ex(H + lm * eye, g)
            w_new = w - step
            f0 = float(al_value(w, lam_eq, lam_in, rho))
            f1 = float(al_value(w_new, lam_eq, lam_in, rho))
            # a singular system gives no step (the reference's NaN step)
            improved = int(info) == 0 and math.isfinite(f1) and f1 < f0
            if improved:
                w = w_new
                lm = max(lm * opts.lm_down, opts.lm_init)
            else:
                lm = min(lm * opts.lm_up, opts.lm_max)
            done = (float(g.abs().max()) < opts.grad_tol
                    or (not improved and lm >= opts.lm_max))
            it += 1
        return w, it

    m_eq = prob.eq_con(w0).shape[0] if has_eq else 0
    m_in = prob.ineq_con(w0).shape[0] if has_in else 0
    lam_eq = w0.new_zeros(max(m_eq, 1))
    lam_in = w0.new_zeros(max(m_in, 1))
    w = w0
    if not (has_eq or has_in):
        w, it = inner(w0, lam_eq, lam_in, 1.0)
        return DirectResult(w=w, objective=prob.objective(w),
                            constraint_violation=0.0, iterations=it,
                            al_iterations=1, converged=True)

    rho, it, al_it, vio = opts.rho_init, 0, 0, float("inf")
    while al_it < opts.max_al_iter and not vio < opts.con_tol:
        w, inner_it = inner(w, lam_eq, lam_in, rho)
        vio = violation(w)
        if has_eq:
            lam_eq = torch.clamp(lam_eq + rho * prob.eq_con(w),
                                 -opts.lambda_max, opts.lambda_max)
        if has_in:
            lam_in = torch.clamp(lam_in + rho * prob.ineq_con(w),
                                 0.0, opts.lambda_max)
        rho *= opts.rho_scale
        it += inner_it
        al_it += 1
    return DirectResult(w=w, objective=prob.objective(w),
                        constraint_violation=vio, iterations=it,
                        al_iterations=al_it, converged=vio < opts.con_tol)
