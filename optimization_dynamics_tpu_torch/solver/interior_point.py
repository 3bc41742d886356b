"""Lane-batched path-following interior-point solver for cone-
complementarity problems, with implicit-function-theorem sensitivities.

Port of ``optimization_dynamics_tpu/solver/interior_point.py``: it
solves ``r(z, theta, kappa) = 0`` for a batch of scenarios, where the
residual's bilinear rows encode orthant / SOC complementarity relaxed by
the central-path parameter ``kappa``, with a damped Newton method, an
analytic fraction-to-boundary step and a vectorized first-improvement
backtracking line search, driving ``kappa`` down a geometric schedule to
``kappa_final_frac * kappa_tol``, or with ``IPOptions.mehrotra`` picking
it adaptively by a predictor-corrector step. Sensitivities come from the
IFT at the relaxed solution: ``dz/dtheta = -(dr/dz)^-1 dr/dtheta``.

The scalar ``make_solver`` and ``make_sensitivity`` run the batched
solver on a batch of one. The reference's scalar and batched solvers
differ in one place, the floor of the kappa restart after a stall
(``kappa_final`` in the scalar one, ``max(kappa_final, kappa_init_min)``
in the batched one), which never binds: the restart resets every cone
variable to 1 (an SOC group to (1, 0.1, ...)), so each orthant row's
product is 1 and each SOC head's above it, and the violation it clips is
at least 1, not below either floor for any ``kappa_init_min <= 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from optimization_dynamics_tpu_torch.ops.cones import (ConeSpec,
                                                       delta_products,
                                                       step_to_boundary)
from optimization_dynamics_tpu_torch.ops.linalg import batched_newton_solve

__all__ = ["IPOptions", "IPSolution", "make_solver", "make_solver_batched",
           "make_sensitivity", "make_sensitivity_batched",
           "batched_jacobian", "ls_trials"]


@dataclasses.dataclass(frozen=True)
class IPOptions:
    """Solver options; field names follow the reference's
    ``InteriorPointOptions``. ``kappa_tol`` is the convergence tolerance on
    the complementarity products; the solver parks the central path at
    ``kappa_final_frac * kappa_tol``."""

    r_tol: float = 1.0e-8
    kappa_tol: float = 1.0e-4
    max_iter: int = 80
    max_ls: int = 25
    gamma_reg: float = 0.0
    kappa_scale: float = 0.1       # geometric central-path decrease
    kappa_final_frac: float = 0.8  # park products at this fraction of kappa_tol
    kappa_init_max: float = 1.0    # cap on the initial relaxation
    # floor on the initial relaxation: keeps a short continuation for
    # warm starts whose products already sit at kappa_final
    kappa_init_min: float = 0.0
    center_frac: float = 0.1       # inner solve tol: |r|_inf < center_frac*kappa
    tau_min: float = 0.75          # most conservative fraction-to-boundary
    tau_max: float = 0.99
    # Mehrotra predictor-corrector: an affine predictor solve picks the
    # central-path target kappa = clip(max(sigma mu, infeas_frac
    # |r_eq|_inf), kappa_final, kappa) with sigma = (mu_aff / mu)^3, and
    # the corrector adds the a_aff^2-damped second-order term. The fused
    # IP kernel (K1) implements the geometric schedule only and raises.
    mehrotra: bool = False
    mehrotra_infeas_frac: float = 0.1


class IPSolution(NamedTuple):
    z: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    r_vio: torch.Tensor
    kappa_vio: torch.Tensor


class _LineSearchTrials:
    """While ``on``, ``n`` adds up the line-search trials that the batched
    solver's solves need: on each active lane of each Newton iteration the
    candidates up to and including the first improving one, or all
    ``max_ls`` where none improves. The solver evaluates all ``max_ls`` at
    once; the count is the work of a search that stops at the first
    improving candidate (an operation bound counts it)."""

    on = False
    n = 0


ls_trials = _LineSearchTrials()


def _cone_reset(spec: ConeSpec, device, dtype):
    """(mask, template) for a branch-free cone-variable reset:
    ``z_reset = where(mask, template, z)``."""
    mask = [False] * spec.nz
    template = [0.0] * spec.nz
    for i in list(spec.ort_prim) + list(spec.ort_dual):
        mask[i], template[i] = True, 1.0
    for grp in list(spec.soc_prim) + list(spec.soc_dual):
        mask[grp[0]], template[grp[0]] = True, 1.0
        for i in grp[1:]:
            mask[i], template[i] = True, 0.1
    return (torch.tensor(mask, device=device),
            torch.tensor(template, dtype=dtype, device=device))


def _row_masks(spec: ConeSpec, device, dtype):
    """(equality-row mask, bilinear-row mask, kappa-head mask) as 0/1
    vectors."""
    eq = [0.0] * spec.nz
    bil = [0.0] * spec.nz
    head = [0.0] * spec.nz
    for i in spec.eq_rows:
        eq[i] = 1.0
    for i in spec.ort_rows:
        bil[i] = head[i] = 1.0
    for grp in spec.soc_rows:
        for j, i in enumerate(grp):
            bil[i] = 1.0
            if j == 0:
                head[i] = 1.0
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return t(eq), t(bil), t(head)


def batched_jacobian(residual_fn: Callable, argnum: int = 0) -> Callable:
    """``jac(zs (B, nz), thetas (B, ntheta)) -> (B, nz, n)``: the Jacobian
    of ``residual_fn(z, theta, 0)`` with respect to z (``argnum=0``, n=nz)
    or theta (``argnum=1``, n=ntheta), lane by lane.

    One reverse pass for all rows: the inputs are repeated nz times and
    replica i pulls back the unit cotangent e_i, so one
    ``torch.autograd.grad`` of the batch-native residual on nz*B lanes
    gives every row. (Forward mode gives the same numbers, but in eager
    PyTorch its dual-tensor ops with Python-scalar operands cost far more
    per op.)"""
    def jac(zs: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
        B, m = zs.shape
        n = (zs, thetas)[argnum].shape[1]
        rep = [a.detach().expand(m, *a.shape).reshape(m * B, a.shape[-1])
               for a in (zs, thetas)]
        rep[argnum] = rep[argnum].clone().requires_grad_(True)
        cot = torch.eye(m, dtype=zs.dtype, device=zs.device)[:, None, :] \
            .expand(m, B, m).reshape(m * B, m)
        with torch.enable_grad():
            r = residual_fn(rep[0], rep[1], 0.0)
            (rows,) = torch.autograd.grad(r, rep[argnum], grad_outputs=cot)
        return rows.reshape(m, B, n).transpose(0, 1)

    return jac


def _make_solver_batched(residual_fn: Callable, spec: ConeSpec,
                         opts: IPOptions, device, dtype,
                         linear_solve: Callable) -> Callable:
    """``make_solver_batched`` with the Newton solve ``linear_solve(A (B,
    n, n), b (B, n, k))`` as a parameter, so the fused kernel's plain
    version can pin the solve to the plain QR."""
    spec.validate()
    jacobian_fn = batched_jacobian(residual_fn)

    has_cones = bool(spec.ort_prim) or bool(spec.soc_prim)
    use_meh = opts.mehrotra and has_cones
    n_cones = max(len(spec.ort_rows) + len(spec.soc_rows), 1)
    kappa_final = opts.kappa_final_frac * opts.kappa_tol
    kappa_lo = max(kappa_final, opts.kappa_init_min)
    eq_mask, bil_mask, head_mask = _row_masks(spec, device, dtype)
    reset_mask, reset_tmpl = _cone_reset(spec, device, dtype)
    # exact powers of two, as the reference's 0.5 ** arange
    ls_pows = torch.tensor([0.5 ** j for j in range(opts.max_ls)],
                           dtype=dtype, device=device)

    res_v = lambda zs, ths: residual_fn(zs, ths, 0.0)

    def vio(r0s):
        rv = torch.amax(torch.abs(r0s) * eq_mask, dim=1)
        kv = (torch.amax(torch.abs(r0s) * bil_mask, dim=1) if has_cones
              else torch.zeros_like(rv))
        return rv, kv

    def converged(r0s):
        merit = torch.amax(torch.abs(r0s - kappa_final * head_mask), dim=1)
        return merit < opts.r_tol

    def solve(z0s: torch.Tensor, thetas: torch.Tensor) -> IPSolution:
        B, nz = z0s.shape
        r0s = res_v(z0s, thetas)
        _, kv0 = vio(r0s)
        if has_cones:
            kappas = torch.clamp(kv0, kappa_lo, opts.kappa_init_max)
        else:
            kappas = torch.full((B,), kappa_final, dtype=dtype,
                                device=device)
        zs = z0s
        its = torch.zeros(B, dtype=torch.int32, device=device)
        stalled = torch.zeros(B, dtype=torch.bool, device=device)
        reinit = torch.zeros(B, dtype=torch.bool, device=device)
        lanes = torch.arange(B, device=device)

        while True:
            active = ~(converged(r0s) | stalled | (its >= opts.max_iter))
            if not bool(active.any()):
                break

            Js = jacobian_fn(zs, thetas)
            if opts.gamma_reg > 0.0:
                Js = Js + (opts.gamma_reg * kappas)[:, None, None] \
                    * torch.eye(nz, dtype=dtype, device=device)
            if use_meh:
                # predictor: the affine direction toward kappa = 0; its
                # step sets the centering weight and the new target,
                # monotone and never below the equality infeasibility
                d_aff = linear_solve(Js, r0s[..., None])[..., 0]
                a_aff = step_to_boundary(spec, zs, d_aff, tau=1.0)
                r_affs = res_v(zs - a_aff[:, None] * d_aff, thetas)
                mus = torch.sum(head_mask * r0s, dim=1) / n_cones
                mu_affs = torch.clamp_min(
                    torch.sum(head_mask * r_affs, dim=1) / n_cones, 0.0)
                sigmas = torch.clamp(
                    (mu_affs / torch.clamp_min(mus, 1e-30)) ** 3, 0.0, 1.0)
                r_eqs = torch.amax(torch.abs(r0s) * eq_mask, dim=1)
                descending = mus > 1.25 * kappa_final
                target = torch.minimum(torch.clamp_min(torch.maximum(
                    sigmas * mus, opts.mehrotra_infeas_frac * r_eqs),
                    kappa_final), kappas)
                kappas = torch.where(descending, target, kappa_final)
                r_k = r0s - kappas[:, None] * head_mask
                merit_cur = torch.amax(torch.abs(r_k), dim=1)
                # corrector: the second-order products of the achievable
                # affine step, off once mu reaches the parking floor
                corr = torch.where(descending[:, None],
                                   (a_aff * a_aff)[:, None]
                                   * delta_products(spec, d_aff), 0.0)
                deltas = linear_solve(Js, (r_k + corr)[..., None])[..., 0]
            else:
                r_k = r0s - kappas[:, None] * head_mask
                merit_cur = torch.amax(torch.abs(r_k), dim=1)
                deltas = linear_solve(Js, r_k[..., None])[..., 0]

            taus = torch.clamp(1.0 - merit_cur, opts.tau_min, opts.tau_max)
            alpha0 = torch.clamp_max(
                step_to_boundary(spec, zs, deltas, tau=1.0) * taus, 1.0)

            alphas = alpha0[:, None] * ls_pows[None, :]       # (B, L)
            L = alphas.shape[1]
            zc = zs[:, None, :] - alphas[..., None] * deltas[:, None, :]
            rc = res_v(zc.reshape(B * L, nz),
                       thetas.repeat_interleave(L, dim=0)).reshape(B, L, nz)
            mc = torch.amax(
                torch.abs(rc - kappas[:, None, None] * head_mask), dim=2)
            improves = mc < merit_cur[:, None]
            any_improve = improves.any(dim=1)
            # first True = largest improving alpha (argmax over an int
            # cast: first maximal index)
            first = torch.argmax(improves.to(torch.int32), dim=1)
            best = torch.argmin(mc, dim=1)
            pick = torch.where(any_improve, first, best)
            if ls_trials.on:
                ls_trials.n += int(torch.where(any_improve, first + 1,
                                               L)[active].sum())
            alpha = alphas[lanes, pick]
            new_merit = mc[lanes, pick]
            stalled_new = ~any_improve

            zs_new = zs - alpha[:, None] * deltas
            if use_meh:
                kappas_new = kappas   # adaptive target, re-picked next time
            else:
                centered = new_merit < torch.clamp_min(
                    opts.center_frac * kappas, opts.r_tol)
                kappas_new = torch.where(
                    centered,
                    torch.clamp_min(kappas * opts.kappa_scale, kappa_final),
                    kappas)

            if has_cones:
                # one-shot stall recovery: reset the cone variables to the
                # canonical interior point and restart the central path
                do_reinit = stalled_new & ~reinit
                z_reset = torch.where(reset_mask, reset_tmpl, zs_new)
                zs_new = torch.where(do_reinit[:, None], z_reset, zs_new)
                stalled_new = stalled_new & reinit
                reinit = reinit | do_reinit

            # freeze inactive lanes
            zs_new = torch.where(active[:, None], zs_new, zs)
            kappas_new = torch.where(active, kappas_new, kappas)
            stalled = torch.where(active, stalled_new, stalled)

            r0s_new = res_v(zs_new, thetas)
            if has_cones:
                _, kv_new = vio(r0s_new)
                kappas_new = torch.where(
                    active & do_reinit,
                    torch.clamp(kv_new, kappa_lo, opts.kappa_init_max),
                    kappas_new)
            its = its + active.to(torch.int32)
            zs, kappas, r0s = zs_new, kappas_new, r0s_new

        rv, kv = vio(r0s)
        return IPSolution(z=zs, iterations=its, converged=converged(r0s),
                          r_vio=rv, kappa_vio=kv)

    return solve


def make_solver_batched(residual_fn: Callable, spec: ConeSpec,
                        opts: IPOptions, device, dtype) -> Callable:
    """Build ``solve(z0s (B, nz), thetas (B, ntheta)) -> IPSolution``.

    One host loop over the whole batch with per-lane masks: converged,
    stalled or exhausted lanes freeze, the loop runs until every lane is
    done, and a lane's ``iterations`` counts only its active iterations.
    The Newton step goes through ``batched_newton_solve`` (the batched QR
    kernel on CUDA tensors). ``residual_fn(z, theta, kappa)`` works over
    the last dimension (one vector or a batch); its Jacobian comes from
    ``batched_jacobian``.
    """
    return _make_solver_batched(residual_fn, spec, opts, device, dtype,
                                batched_newton_solve)


def make_solver(residual_fn: Callable, spec: ConeSpec, opts: IPOptions,
                device, dtype) -> Callable:
    """Build ``solve(z0 (nz,), theta (ntheta,)) -> IPSolution`` with 0-dim
    fields: the batched solver on a batch of one."""
    solve_b = make_solver_batched(residual_fn, spec, opts, device, dtype)

    def solve(z0: torch.Tensor, theta: torch.Tensor) -> IPSolution:
        return IPSolution(*(a[0] for a in solve_b(z0[None], theta[None])))

    return solve


def make_sensitivity(residual_fn: Callable, spec: ConeSpec) -> Callable:
    """``sens(z (nz,), theta (ntheta,)) -> dz/dtheta (nz, ntheta)``: the
    lane-batched IFT sensitivities on a batch of one."""
    sens_b = make_sensitivity_batched(residual_fn, spec)

    def sens(z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        return sens_b(z[None], theta[None])[0]

    return sens


def make_sensitivity_batched(residual_fn: Callable,
                             spec: ConeSpec) -> Callable:
    """Lane-batched IFT sensitivities ``sens(zs, thetas) -> (B, nz,
    ntheta)``; the multi-RHS solve goes through ``batched_newton_solve``.
    The bilinear rows' kappa offset is constant, so the Jacobians are
    kappa-independent. It makes no tensors of its own: the result follows
    the inputs' device and dtype."""
    jacobian_fn = batched_jacobian(residual_fn, 0)
    jacobian_theta_fn = batched_jacobian(residual_fn, 1)

    def sens(zs: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
        return -batched_newton_solve(jacobian_fn(zs, thetas),
                                     jacobian_theta_fn(zs, thetas))

    return sens
