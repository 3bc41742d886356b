"""Constrained iterative LQR (augmented Lagrangian): types and AL pieces.

Port of ``optimization_dynamics_tpu/solver/ilqr.py`` (options, problem,
result, the Powell-Hestenes-Rockafellar penalty and the Gauss-Newton
expansions). Structural conventions are the reference's: horizon ``T``
states ``(T, nx)``, controls ``(T-1, nu)``; stage functions take
``(t, x, u)``; ``u_mask[t]`` marks active control dims; inequality rows
are marked by ``ineq_mask``, equality rows elsewhere.

The expansions use ``torch.func.grad``, ``hessian`` and ``jacfwd`` on one
stage and are batched with ``vmap`` by the batched phases. The scalar
``solve`` and ``rollout`` are not ported yet, so a problem carries only
its lane-batched dynamics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd

__all__ = ["ILQROptions", "ILQRProblem", "ILQRResult"]


@dataclasses.dataclass(frozen=True)
class ILQROptions:
    """Options; names follow ``iLQR.Options`` of the reference."""

    alpha_min: float = 1.0e-5
    obj_tol: float = 1.0e-5
    grad_tol: float = 1.0e-3
    max_iter: int = 100
    max_al_iter: int = 20
    con_tol: float = 0.005
    rho_init: float = 1.0
    rho_scale: float = 10.0
    # cap on the AL penalty: in f32 unbounded growth destroys the AL cost
    rho_max: float = float("inf")
    armijo_c1: float = 1.0e-4
    reg_init: float = 1.0e-6
    reg_min: float = 1.0e-8
    reg_max: float = 1.0e8
    reg_up: float = 10.0
    reg_down: float = 0.5
    lambda_max: float = 1.0e8


class ILQRProblem(NamedTuple):
    """Problem definition. All callables are torch.

    ``stage_con`` returns a fixed-size ``(ncon,)`` vector for all stages
    (pad with zeros); ``terminal_con`` a ``(nconT,)`` vector. The
    dynamics are lane-batched:

      * ``dynamics_batched(t, xs (B, nx), us (B, nu)) -> ys``;
      * ``dynamics_jac_batched(ts, xs, us) -> (ys, fxs, fus)``;
      * with warm starts, ``dynamics_batched_ws(t, xs, us, ws) -> (ys,
        ws')``, ``dynamics_jac_batched_ws(ts, xs, us, wss) -> (ys, fxs,
        fus, wss')`` and ``ws_init_batched(t, xs, us) -> ws``.

    ``ws_linesearch``: line-search rollouts warm-start from the previous
    accepted trajectory's solver variables (True) or start cold and only
    hand their variables to the next derivative sweep (False).
    """

    T: int
    nx: int
    nu: int
    ncon: int
    nconT: int
    stage_cost: Callable          # (t, x, u) -> scalar
    terminal_cost: Callable       # (x,) -> scalar
    stage_con: Optional[Callable] = None     # (t, x, u) -> (ncon,)
    terminal_con: Optional[Callable] = None  # (x,) -> (nconT,)
    ineq_mask: Optional[torch.Tensor] = None      # (T-1, ncon) bool
    terminal_ineq_mask: Optional[torch.Tensor] = None  # (nconT,) bool
    u_mask: Optional[torch.Tensor] = None         # (T-1, nu) bool
    dynamics_batched: Optional[Callable] = None
    dynamics_jac_batched: Optional[Callable] = None
    dynamics_batched_ws: Optional[Callable] = None
    dynamics_jac_batched_ws: Optional[Callable] = None
    ws_init_batched: Optional[Callable] = None
    ws_linesearch: bool = True


class ILQRResult(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    objective: torch.Tensor        # smooth objective of the solution
    al_objective: torch.Tensor     # augmented-Lagrangian objective
    iterations: torch.Tensor       # total inner iLQR iterations
    al_iterations: torch.Tensor
    constraint_violation: torch.Tensor
    gradient_norm: torch.Tensor
    converged: torch.Tensor
    # final AL state, for warm-starting a re-solve
    lam: Optional[torch.Tensor] = None      # (B, T-1, ncon)
    lamT: Optional[torch.Tensor] = None     # (B, nconT)
    rho: Optional[torch.Tensor] = None      # (B,)


# ---------------------------------------------------------------------------
# augmented Lagrangian pieces


def _al_penalty(c, lam, rho, ineq):
    """PHR augmented-Lagrangian penalty for mixed eq/ineq rows.

    eq rows:   lam*c + rho/2 c^2
    ineq rows (c <= 0): (max(0, lam + rho c)^2 - lam^2) / (2 rho)
    """
    eq_term = lam * c + 0.5 * rho * c * c
    lam_new = torch.clamp_min(lam + rho * c, 0.0)
    ineq_term = (lam_new * lam_new - lam * lam) / (2.0 * rho)
    return torch.sum(torch.where(ineq, ineq_term, eq_term))


def _al_multiplier(c, lam, rho, ineq):
    """Effective multiplier (gradient of the penalty wrt c)."""
    eq_mult = lam + rho * c
    ineq_mult = torch.clamp_min(lam + rho * c, 0.0)
    return torch.where(ineq, ineq_mult, eq_mult)


def _violation(c, lam, ineq):
    """Per-row constraint violation: |c| for eq, max(c, 0) for ineq."""
    del lam
    return torch.where(ineq, torch.clamp_min(c, 0.0), torch.abs(c))


def _make_al_costs(prob: ILQRProblem):
    """Stage/terminal AL objectives and their Gauss-Newton expansions.
    ``prob`` must have its masks filled (``ilqr_batched._pad_masks``)."""
    has_con = prob.stage_con is not None
    has_conT = prob.terminal_con is not None

    def stage_al(t, x, u, lam, rho):
        J = prob.stage_cost(t, x, u)
        if has_con:
            c = prob.stage_con(t, x, u)
            J = J + _al_penalty(c, lam, rho, prob.ineq_mask[t])
        return J

    def terminal_al(x, lamT, rho):
        J = prob.terminal_cost(x)
        if has_conT:
            c = prob.terminal_con(x)
            J = J + _al_penalty(c, lamT, rho, prob.terminal_ineq_mask)
        return J

    def stage_expansion(t, x, u, lam, rho):
        """Gradient and Gauss-Newton Hessian of the stage AL objective."""
        nx = prob.nx

        def smooth(xu):
            return prob.stage_cost(t, xu[:nx], xu[nx:])

        xu = torch.cat([x, u])
        g = grad(smooth)(xu)
        H = hessian(smooth)(xu)

        if has_con:
            def confun(xu):
                return prob.stage_con(t, xu[:nx], xu[nx:])
            c = confun(xu)
            cJ = jacfwd(confun)(xu)              # (ncon, nx+nu)
            ineq = prob.ineq_mask[t]
            mult = _al_multiplier(c, lam, rho, ineq)
            active = torch.where(ineq, (lam + rho * c) > 0.0,
                                 torch.ones_like(ineq))
            g = g + cJ.T @ mult
            H = H + rho * (cJ.T * active.to(cJ.dtype)) @ cJ
        return g[:nx], g[nx:], H[:nx, :nx], H[nx:, nx:], H[nx:, :nx]

    def terminal_expansion(x, lamT, rho):
        g = grad(prob.terminal_cost)(x)
        H = hessian(prob.terminal_cost)(x)
        if has_conT:
            c = prob.terminal_con(x)
            cJ = jacfwd(prob.terminal_con)(x)
            ineq = prob.terminal_ineq_mask
            mult = _al_multiplier(c, lamT, rho, ineq)
            active = torch.where(ineq, (lamT + rho * c) > 0.0,
                                 torch.ones_like(ineq))
            g = g + cJ.T @ mult
            H = H + rho * (cJ.T * active.to(cJ.dtype)) @ cJ
        return g, H

    return stage_al, terminal_al, stage_expansion, terminal_expansion
