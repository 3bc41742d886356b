"""Constrained iterative LQR (augmented Lagrangian).

Port of ``optimization_dynamics_tpu/solver/ilqr.py``: options, problem,
result, the Powell-Hestenes-Rockafellar penalty and the Gauss-Newton
expansions, the open-loop ``rollout`` and the scalar ``solve``.
Structural conventions are the reference's: horizon ``T`` states ``(T,
nx)``, controls ``(T-1, nu)``; stage functions take ``(t, x, u)``;
``u_mask[t]`` marks active control dims; inequality rows are marked by
``ineq_mask``, equality rows elsewhere.

``solve`` runs one scenario:

  * inner loop: a derivative sweep over the whole horizon in one call
    (``dynamics_jac_batched``, else ``torch.func.vmap`` of
    ``dynamics_jac``), a regularised Riccati backward pass (sequential,
    or with ``parallel_riccati`` a log-depth doubling scan over the
    conditional value functions), and an Armijo line search of
    closed-loop rollouts (sequential halvings, or with
    ``parallel_linesearch`` the whole step-size grid as one lane-batched
    rollout);
  * outer loop: augmented-Lagrangian dual updates and penalty scaling
    until the constraint tolerance is met.

The reference's while loops run on the device; here they are host loops
that read their conditions with ``.item()``. The expansions use
``torch.func.grad``, ``hessian`` and ``jacfwd`` on one stage, batched
with ``vmap``; the lane-batched phases (``ilqr_batched.py``) share them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

__all__ = ["ILQROptions", "ILQRProblem", "ILQRResult", "solve", "rollout"]


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
    # scalar solve: print one line an AL round (the reference's
    # per-round log, with the seconds since the solve began)
    verbose: bool = False
    # scalar solve: evaluate the whole Armijo step-size grid as one
    # lane-batched rollout instead of sequential halvings
    parallel_linesearch: bool = False
    # scalar solve: the Riccati backward pass as a log2(T)-depth doubling
    # scan over conditional value functions (the same recursion with the
    # regulariser folded into luu)
    parallel_riccati: bool = False
    # lane-batched phases: run the Riccati backward pass as one CUDA
    # kernel (K3, ops/kernels/riccati.py): the reference's
    # ``pallas_riccati``
    riccati_kernel: bool = False


class ILQRProblem(NamedTuple):
    """Problem definition. All callables are torch.

    ``stage_con`` returns a fixed-size ``(ncon,)`` vector for all stages
    (pad with zeros); ``terminal_con`` a ``(nconT,)`` vector.

    The scalar ``solve`` reads the single-scenario dynamics:

      * ``dynamics(t, x, u) -> y`` and ``dynamics_jac(t, x, u) -> (y, fx,
        fu)``; ``dynamics_jac_batched(ts, xs, us)``, when given, takes a
        derivative sweep's T-1 timesteps in one call;
      * ``dynamics_ws(t, x, u, ws_t) -> (y, ws_t')`` with ``ws_init(t, x,
        u) -> ws_t``: steps warm-started from the previous accepted
        trajectory's solver variables at the same timestep;
      * ``dynamics_carry(t, x, u, c) -> (y, c')`` with ``carry_init(x0)``:
        the open-loop rollout threads the previous step's variables.

    The lane-batched phases read the lane-batched dynamics:

      * ``dynamics_batched(t, xs (B, nx), us (B, nu)) -> ys``;
      * ``dynamics_jac_batched(ts, xs, us) -> (ys, fxs, fus)``;
      * with warm starts, ``dynamics_batched_ws(t, xs, us, ws) -> (ys,
        ws')``, ``dynamics_jac_batched_ws(ts, xs, us, wss) -> (ys, fxs,
        fus, wss')`` and ``ws_init_batched(t, xs, us) -> ws``.

    ``ws_linesearch``: line-search rollouts of the batched phases
    warm-start from the previous accepted trajectory's solver variables
    (True) or start cold and only hand their variables to the next
    derivative sweep (False).

    ``ws_carry``: with ``ws_linesearch`` False, the batched open-loop and
    line-search rollouts warm-start each step t from the same rollout's
    step t-1 solver variables (step 0 from ``ws_init_batched``), the
    lane-batched analog of ``dynamics_carry``; the carry stays on the
    trajectory being rolled out. Read only when ``ws_linesearch`` is
    False.

    ``rollout_fused(x0s, xss_ref, uss_ref, Kss, kss, alphas) -> (xss, uss,
    wss)``: a whole closed-loop rollout in one kernel (K4, ops/kernels/
    fused_rollout.py); when set, both rollouts of the phases run through
    it. It implements the cold line-search policy (``ws_linesearch`` and
    ``ws_carry`` False).
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
    dynamics: Optional[Callable] = None
    dynamics_jac: Optional[Callable] = None
    dynamics_ws: Optional[Callable] = None
    ws_init: Optional[Callable] = None
    dynamics_carry: Optional[Callable] = None
    carry_init: Optional[Callable] = None
    dynamics_batched: Optional[Callable] = None
    dynamics_jac_batched: Optional[Callable] = None
    dynamics_batched_ws: Optional[Callable] = None
    dynamics_jac_batched_ws: Optional[Callable] = None
    ws_init_batched: Optional[Callable] = None
    ws_linesearch: bool = True
    ws_carry: bool = False
    rollout_fused: Optional[Callable] = None


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
    # final AL state, for warm-starting a re-solve (batched results carry
    # a leading lane dimension)
    lam: Optional[torch.Tensor] = None      # (T-1, ncon)
    lamT: Optional[torch.Tensor] = None     # (nconT,)
    rho: Optional[torch.Tensor] = None      # scalar


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


def _pad_masks(prob: ILQRProblem, device) -> ILQRProblem:
    """``prob`` with its masks filled in (no inequality rows, every
    control active) and on ``device``."""
    T, nu = prob.T, prob.nu
    ncon, nconT = prob.ncon, prob.nconT
    as_bool = lambda m: torch.as_tensor(m, dtype=torch.bool, device=device)
    return prob._replace(
        ineq_mask=(torch.zeros((T - 1, max(ncon, 1)), dtype=torch.bool,
                               device=device)
                   if prob.ineq_mask is None else as_bool(prob.ineq_mask)),
        terminal_ineq_mask=(torch.zeros(max(nconT, 1), dtype=torch.bool,
                                        device=device)
                            if prob.terminal_ineq_mask is None
                            else as_bool(prob.terminal_ineq_mask)),
        u_mask=(torch.ones((T - 1, nu), dtype=torch.bool, device=device)
                if prob.u_mask is None else as_bool(prob.u_mask)),
    )


def _make_al_costs(prob: ILQRProblem):
    """Stage/terminal AL objectives and their Gauss-Newton expansions.
    ``prob`` must have its masks filled (``_pad_masks``)."""
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


# ---------------------------------------------------------------------------
# the scalar solver


def rollout(prob: ILQRProblem, x0: torch.Tensor,
            us: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout ``(T, nx)``, through ``dynamics_carry`` when the
    problem has it."""
    x = x0
    xs = [x0]
    if prob.dynamics_carry is not None:
        c = prob.carry_init(x0)
        for t in range(prob.T - 1):
            x, c = prob.dynamics_carry(t, x, us[t], c)
            xs.append(x)
    else:
        for t in range(prob.T - 1):
            x = prob.dynamics(t, x, us[t])
            xs.append(x)
    return torch.stack(xs)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product over the leading dimensions."""
    return (M @ v[..., None])[..., 0]


def _cholesky_gains(Quu, Qu, Qux):
    """``(K, k, ok)`` from ``Quu [k | K] = -[Qu | Qux]`` by Cholesky, over
    any leading dimensions. A Quu that is not positive definite gives
    ``ok = False`` and NaN gains (the reference's Cholesky returns NaN
    there; ``cholesky_ex`` reports it through ``info``)."""
    L, info = torch.linalg.cholesky_ex(Quu)
    L = torch.where((info == 0)[..., None, None], L, float("nan"))
    ok = torch.isfinite(L).flatten(-2).all(dim=-1)
    sol = torch.cholesky_solve(torch.cat([Qu[..., None], Qux], dim=-1), L)
    return -sol[..., 1:], -sol[..., 0], ok


def solve(prob: ILQRProblem, x0: torch.Tensor, us_init: torch.Tensor,
          opts: ILQROptions = ILQROptions(),
          xs_init: torch.Tensor | None = None,
          lam_init: torch.Tensor | None = None,
          lamT_init: torch.Tensor | None = None,
          rho_init: torch.Tensor | None = None) -> ILQRResult:
    """Run the AL-iLQR solve of one scenario from ``x0 (nx,)`` and
    ``us_init (T-1, nu)`` on their device and dtype.

    ``lam_init``/``lamT_init``/``rho_init`` warm-start the augmented-
    Lagrangian state from a previous solve (``ILQRResult.lam/lamT/rho``)."""
    T, nx, nu = prob.T, prob.nx, prob.nu
    ncon, nconT = prob.ncon, prob.nconT
    dtype, device = x0.dtype, x0.device
    prob = _pad_masks(prob, device)
    ts = torch.arange(T - 1, device=device)
    stage_al, terminal_al, stage_exp, terminal_exp = _make_al_costs(prob)
    stage_al_v = vmap(stage_al, in_dims=(0, 0, 0, 0, None))
    stage_exp_v = vmap(stage_exp, in_dims=(0, 0, 0, 0, None))
    has_ws = prob.dynamics_ws is not None
    u_mask = prob.u_mask
    tensor = lambda v: torch.as_tensor(v, dtype=dtype, device=device)

    def traj_cost(xs, us, lam, lamT, rho):
        return (torch.sum(stage_al_v(ts, xs[:-1], us, lam, rho))
                + terminal_al(xs[-1], lamT, rho))

    def smooth_cost(xs, us):
        return (torch.sum(vmap(prob.stage_cost)(ts, xs[:-1], us))
                + prob.terminal_cost(xs[-1]))

    def rollout_costs(xss, uss, lam, lamT, rho):
        """AL costs (A,) of A rollouts (A, T, nx), the stage costs summed
        in time order as the reference's scan carries them."""
        A = xss.shape[0]
        Js = stage_al_v(ts.repeat_interleave(A),
                        xss[:, :-1].transpose(0, 1).reshape(-1, nx),
                        uss.transpose(0, 1).reshape(-1, nu),
                        lam.repeat_interleave(A, dim=0), rho).reshape(T - 1,
                                                                      A)
        J = Js[0]
        for t in range(1, T - 1):
            J = J + Js[t]
        return J + vmap(terminal_al, in_dims=(0, None, None))(
            xss[:, -1], lamT, rho)

    def closed_loop(xs_ref, us_ref, Ks, ks, alpha, lam, lamT, rho, wss):
        """One closed-loop rollout at step size ``alpha`` -> (xs, us, J,
        wss)."""
        x = xs_ref[0]
        xs, us, ws_new = [], [], []
        for t in range(T - 1):
            u = us_ref[t] + alpha * ks[t] + Ks[t] @ (x - xs_ref[t])
            u = torch.where(u_mask[t], u, us_ref[t])
            xs.append(x)
            us.append(u)
            if has_ws:
                x, ws = prob.dynamics_ws(t, x, u, wss[t])
                ws_new.append(ws)
            else:
                x = prob.dynamics(t, x, u)
        xs = torch.stack(xs + [x])
        us = torch.stack(us)
        J = rollout_costs(xs[None], us[None], lam, lamT, rho)[0]
        return xs, us, J, torch.stack(ws_new) if has_ws else wss

    if opts.parallel_linesearch:
        n_alpha = int(math.ceil(math.log2(1.0 / opts.alpha_min))) + 1
        alpha_grid = tensor([0.5 ** i for i in range(n_alpha)])
        if has_ws:
            dyn_ws_b = prob.dynamics_batched_ws or vmap(
                prob.dynamics_ws, in_dims=(None, 0, 0, 0))
        else:
            dyn_b = prob.dynamics_batched or vmap(prob.dynamics,
                                                  in_dims=(None, 0, 0))

    def closed_loop_grid(xs_ref, us_ref, Ks, ks, lam, lamT, rho, wss):
        """The closed-loop rollouts of every step size on the grid as one
        lane-batched rollout of width ``n_alpha``."""
        A = n_alpha
        x = xs_ref[0].expand(A, nx)
        xs, us, ws_new = [], [], []
        for t in range(T - 1):
            u = (us_ref[t] + alpha_grid[:, None] * ks[t]
                 + (x - xs_ref[t]) @ Ks[t].T)
            u = torch.where(u_mask[t], u, us_ref[t])
            xs.append(x)
            us.append(u)
            if has_ws:
                x, ws = dyn_ws_b(t, x, u, wss[t].expand(A, *wss.shape[1:]))
                ws_new.append(ws)
            else:
                x = dyn_b(t, x, u)
        xss = torch.stack(xs + [x], dim=1)
        uss = torch.stack(us, dim=1)
        wss_c = torch.stack(ws_new, dim=1) if has_ws else None
        return xss, uss, rollout_costs(xss, uss, lam, lamT, rho), wss_c

    def backward(fxs, fus, lxs, lus, lxxs, luus, luxs, gT, HT, reg):
        """Reverse Riccati recursion -> (Ks, ks, dV1, dV2, max|Qu|, ok)."""
        Vx, Vxx = gT, HT
        Ks, ks, dV1s, dV2s, qu_infs, oks = ([None] * (T - 1)
                                             for _ in range(6))
        for t in range(T - 2, -1, -1):
            fx, fu = fxs[t], fus[t]
            Qx = lxs[t] + fx.T @ Vx
            Qu = lus[t] + fu.T @ Vx
            Qxx = lxxs[t] + fx.T @ Vxx @ fx
            Quu = luus[t] + fu.T @ Vxx @ fu
            Qux = luxs[t] + fu.T @ Vxx @ fx

            m = u_mask[t]
            Qu = torch.where(m, Qu, 0.0)
            Qux = torch.where(m[:, None], Qux, 0.0)
            Quu = torch.where(torch.outer(m, m), Quu, 0.0) + torch.diag(
                torch.where(m, reg, 1.0))
            K, k, ok = _cholesky_gains(Quu, Qu, Qux)

            Vx = Qx + K.T @ Qu + Qux.T @ k + K.T @ Quu @ k
            Vxx = Qxx + K.T @ Qux + Qux.T @ K + K.T @ Quu @ K
            Vxx = 0.5 * (Vxx + Vxx.T)
            Ks[t], ks[t], oks[t] = K, k, ok
            dV1s[t] = k @ Qu
            dV2s[t] = 0.5 * (k @ (Quu @ k))
            qu_infs[t] = torch.amax(torch.abs(Qu))
        return (torch.stack(Ks), torch.stack(ks), torch.sum(torch.stack(
            dV1s)), torch.sum(torch.stack(dV2s)),
            torch.amax(torch.stack(qu_infs)), torch.stack(oks).all())

    def backward_parallel(fxs, fus, lxs, lus, lxxs, luus, luxs, gT, HT,
                          reg):
        """The same recursion with the regulariser folded into luu, as a
        suffix scan of log2(T) doubling rounds over the elements (A, b,
        C, eta, J) of the conditional value functions
        W(x, z) = max_l [l^T (z - A x - b) - l^T C l / 2] + x^T J x / 2
        - eta^T x; the gains then come from every timestep at once."""
        m = u_mask
        mm = m[:, :, None] & m[:, None, :]
        luu_m = (torch.where(mm, luus, 0.0)
                 + torch.diag_embed(torch.where(m, reg, 1.0)))
        lu_m = torch.where(m, lus, 0.0)
        lux_m = torch.where(m[:, :, None], luxs, 0.0)
        fus_m = torch.where(m[:, None, :], fus, 0.0)
        solve_ = torch.linalg.solve
        uinv_lux = solve_(luu_m, lux_m)
        uinv_lu = solve_(luu_m, lu_m[..., None])[..., 0]
        uinv_gt = solve_(luu_m, fus_m.transpose(1, 2))
        luxT = lux_m.transpose(1, 2)
        # the elements of the T-1 stages and the terminal one (A=0, b=0,
        # C=0, J=HT, eta=-gT)
        zm = fxs.new_zeros((1, nx, nx))
        zv = fxs.new_zeros((1, nx))
        A = torch.cat([fxs - fus_m @ uinv_lux, zm])
        b = torch.cat([-_mv(fus_m, uinv_lu), zv])
        C = torch.cat([fus_m @ uinv_gt, zm])
        Jm = torch.cat([lxxs - luxT @ uinv_lux, HT[None]])
        eta = torch.cat([-(lxs - _mv(luxT, uinv_lu)), -gT[None]])
        eye = torch.eye(nx, dtype=dtype, device=device)
        sym = lambda M: 0.5 * (M + M.transpose(-1, -2))

        def combine(early, late):
            A1, b1, C1, e1, J1 = early
            A2, b2, C2, e2, J2 = late
            M = eye + C1 @ J2
            Minv_A1 = solve_(M, A1)
            Minv_rhs = solve_(M, (b1 + _mv(C1, e2))[..., None])[..., 0]
            Nt = eye + J2 @ C1
            Ninv_J2A1 = solve_(Nt, J2 @ A1)
            Ninv_vec = solve_(Nt, (e2 - _mv(J2, b1))[..., None])[..., 0]
            A1T = A1.transpose(-1, -2)
            return (A2 @ Minv_A1, _mv(A2, Minv_rhs) + b2,
                    sym(A2 @ solve_(M, C1) @ A2.transpose(-1, -2) + C2),
                    _mv(A1T, Ninv_vec) + e1, sym(A1T @ Ninv_J2A1 + J1))

        # element t composes stages t..t+2d-1 after the round with span d
        S = (A, b, C, eta, Jm)
        d = 1
        while d < T:
            head = combine(tuple(a[:T - d] for a in S),
                           tuple(a[d:] for a in S))
            S = tuple(torch.cat([h, a[T - d:]]) for h, a in zip(head, S))
            d *= 2
        Vx, Vxx = -S[3][1:], S[4][1:]       # V_{t+1} for t = 0..T-2

        fuT = fus.transpose(1, 2)
        Qu = torch.where(m, lus + _mv(fuT, Vx), 0.0)
        Qux = torch.where(m[:, :, None], luxs + fuT @ Vxx @ fxs, 0.0)
        Quu = (torch.where(mm, luus + fuT @ Vxx @ fus, 0.0)
               + torch.diag_embed(torch.where(m, reg, 1.0)))
        Ks, ks, oks = _cholesky_gains(Quu, Qu, Qux)
        dV1 = torch.sum(ks * Qu, dim=1)
        dV2 = 0.5 * torch.sum(ks * _mv(Quu, ks), dim=1)
        return (Ks, ks, torch.sum(dV1), torch.sum(dV2),
                torch.amax(torch.abs(Qu)), oks.all())

    backward_fn = backward_parallel if opts.parallel_riccati else backward

    def derivatives(xs, us, lam, lamT, rho):
        if prob.dynamics_jac_batched is not None:
            _, fxs, fus = prob.dynamics_jac_batched(ts, xs[:-1], us)
        else:
            _, fxs, fus = vmap(prob.dynamics_jac)(ts, xs[:-1], us)
        lxs, lus, lxxs, luus, luxs = stage_exp_v(ts, xs[:-1], us, lam, rho)
        gT, HT = terminal_exp(xs[-1], lamT, rho)
        return fxs, fus, lxs, lus, lxxs, luus, luxs, gT, HT

    def line_search(xs, us, wss, J, Ks, ks, dV1, dV2, lam, lamT, rho):
        """-> (accepted, xs, us, J, wss) of the largest Armijo-passing
        step size, or the inputs where none passes."""
        if opts.parallel_linesearch:
            xs_c, us_c, J_c, wss_c = closed_loop_grid(xs, us, Ks, ks, lam,
                                                      lamT, rho, wss)
            expected = alpha_grid * dV1 + alpha_grid * alpha_grid * dV2
            ok = torch.isfinite(J_c) & (
                J_c <= J + opts.armijo_c1 * torch.clamp_max(expected, 0.0))
            if not bool(ok.any()):
                return False, xs, us, J, wss
            pick = int(torch.argmax(ok.to(torch.int32)))
            return (True, xs_c[pick], us_c[pick], J_c[pick],
                    wss_c[pick] if has_ws else wss)
        alpha = 1.0
        while alpha >= opts.alpha_min:
            xs_c, us_c, J_c, wss_c = closed_loop(xs, us, Ks, ks, alpha, lam,
                                                 lamT, rho, wss)
            expected = alpha * dV1 + alpha * alpha * dV2
            if bool(torch.isfinite(J_c) & (
                    J_c <= J + opts.armijo_c1
                    * torch.clamp_max(expected, 0.0))):
                return True, xs_c, us_c, J_c, wss_c
            alpha *= 0.5
        return False, xs, us, J, wss

    def ilqr_inner(xs, us, wss, lam, lamT, rho):
        """The unconstrained (AL-objective) iLQR of one AL round, at most
        ``max_iter`` iterations."""
        J = traj_cost(xs, us, lam, lamT, rho)
        reg = tensor(opts.reg_init)
        gnorm = tensor(float("inf"))
        it, done = 0, False
        while it < opts.max_iter and not done:
            Ks, ks, dV1, dV2, qu_inf, bp_ok = backward_fn(
                *derivatives(xs, us, lam, lamT, rho), reg)
            # a failed factorisation gives NaN gains and a NaN expected
            # decrease, so no step size could pass: skip the rollouts
            accepted, xs_n, us_n, J_n, wss_n = (
                line_search(xs, us, wss, J, Ks, ks, dV1, dV2, lam, lamT,
                            rho) if bool(bp_ok)
                else (False, xs, us, J, wss))
            ls_failed = not accepted
            if ls_failed:
                reg_n = torch.clamp_max(torch.clamp_min(
                    reg * opts.reg_up, opts.reg_min * opts.reg_up),
                    opts.reg_max)
            else:
                reg_n = torch.clamp_min(reg * opts.reg_down, opts.reg_min)
            done = bool((qu_inf < opts.grad_tol)
                        | (accepted & (torch.abs(J - J_n) < opts.obj_tol))
                        | (ls_failed & (reg_n >= opts.reg_max)))
            xs, us, J, wss, reg = xs_n, us_n, J_n, wss_n, reg_n
            it += 1
            gnorm = qu_inf
        return xs, us, wss, J, it, gnorm

    has_con = prob.stage_con is not None
    has_conT = prob.terminal_con is not None

    def con_violation(xs, us):
        v = tensor(0.0)
        if has_con:
            cs = vmap(prob.stage_con)(ts, xs[:-1], us)
            v = torch.maximum(v, torch.amax(_violation(cs, None,
                                                       prob.ineq_mask)))
        if has_conT:
            cT = prob.terminal_con(xs[-1])
            v = torch.maximum(v, torch.amax(
                _violation(cT, None, prob.terminal_ineq_mask)))
        return v

    def dual_update(xs, us, lam, lamT, rho):
        if has_con:
            cs = vmap(prob.stage_con)(ts, xs[:-1], us)
            lam = torch.clamp(_al_multiplier(cs, lam, rho, prob.ineq_mask),
                              -opts.lambda_max, opts.lambda_max)
        if has_conT:
            cT = prob.terminal_con(xs[-1])
            lamT = torch.clamp(
                _al_multiplier(cT, lamT, rho, prob.terminal_ineq_mask),
                -opts.lambda_max, opts.lambda_max)
        return lam, lamT

    xs = rollout(prob, x0, us_init) if xs_init is None else xs_init
    us = us_init
    wss = (torch.stack([prob.ws_init(t, xs[t], us[t]) for t in range(T - 1)])
           if has_ws else None)
    lam = (torch.zeros((T - 1, max(ncon, 1)), dtype=dtype, device=device)
           if lam_init is None else tensor(lam_init))
    lamT = (torch.zeros(max(nconT, 1), dtype=dtype, device=device)
            if lamT_init is None else tensor(lamT_init))
    rho = tensor(opts.rho_init if rho_init is None else rho_init)

    it = al_it = 0
    t0 = time.perf_counter()
    if has_con or has_conT:
        vio = tensor(float("inf"))
        gnorm = tensor(float("inf"))
        while al_it < opts.max_al_iter and not bool(vio < opts.con_tol):
            xs, us, wss, J, inner_it, gnorm = ilqr_inner(xs, us, wss, lam,
                                                         lamT, rho)
            it += inner_it
            vio = con_violation(xs, us)
            if opts.verbose:
                print("al it=%d inner=%d J=%.6e vio=%.3e rho=%.1e t=%.1f s"
                      % (al_it, inner_it, float(J), float(vio), float(rho),
                         time.perf_counter() - t0), flush=True)
            lam, lamT = dual_update(xs, us, lam, lamT, rho)
            rho = torch.clamp_max(rho * opts.rho_scale, opts.rho_max)
            al_it += 1
    else:
        xs, us, wss, _, it, gnorm = ilqr_inner(xs, us, wss, lam, lamT, rho)
        al_it = 1
        vio = tensor(0.0)

    as_int = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return ILQRResult(
        xs=xs, us=us,
        objective=smooth_cost(xs, us),
        al_objective=traj_cost(xs, us, lam, lamT, rho),
        iterations=as_int(it),
        al_iterations=as_int(al_it),
        constraint_violation=vio,
        gradient_norm=gnorm,
        converged=vio < opts.con_tol,
        lam=lam, lamT=lamT, rho=rho,
    )
