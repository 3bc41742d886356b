"""Batched-native AL-iLQR phase functions: lockstep scenario batches.

Port of ``optimization_dynamics_tpu/solver/ilqr_batched.py::make_phases``
restricted to what the segmented executor's line-search cascade needs:
the open- and closed-loop rollouts, the trajectory cost, the derivative
sweep, the Riccati backward pass, the (lane x alpha) grid line search,
the cascade (``ls_prep`` / ``ls_rungs`` / ``ls_apply``) and the AL
bookkeeping (constraint violation, dual update, smooth cost).

Every phase works on lane-batched tensors (batch first) and computes each
lane independently; the time loops are Python loops over batched ops,
except where a kernel takes a whole loop: ``ILQROptions.riccati_kernel``
runs the backward pass as K3 and ``ILQRProblem.rollout_fused`` both
rollouts as K4.
The monolithic ``solve_batched``, the ``iters_per_dispatch`` scan, the
per-lane adaptive line searches and the cross-time ``ws_carry`` are not
ported.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch.func import vmap

from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
    make_riccati_backward,
)
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    _al_multiplier,
    _make_al_costs,
    _violation,
)

__all__ = ["make_phases"]


def _pad_masks(prob: ILQRProblem, device) -> ILQRProblem:
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


def make_phases(prob: ILQRProblem, opts: ILQROptions, B: int, dtype,
                device) -> SimpleNamespace:
    """Build the batched AL-iLQR phase functions for batch width B."""
    if prob.dynamics_batched is None:
        raise ValueError("make_phases needs prob.dynamics_batched")
    prob = _pad_masks(prob, device)
    T, nx, nu = prob.T, prob.nx, prob.nu
    ts = torch.arange(T - 1, device=device)
    stage_al, terminal_al, stage_exp, terminal_exp = _make_al_costs(prob)

    # stage AL costs of a whole trajectory in one call, time-major (T-1, B)
    stage_al_flat = vmap(stage_al)
    terminal_al_v = vmap(terminal_al)
    stage_exp_flat = vmap(stage_exp)
    terminal_exp_v = vmap(terminal_exp)

    # same-timestep warm starts: the line-search rollouts and derivative
    # sweeps hand their solver variables to the next sweep
    has_bws = (prob.dynamics_batched_ws is not None
               and prob.ws_init_batched is not None)

    def _stage_costs(xss, uss, lams, rhos):
        """Stage AL costs (T-1, Bw) of states xss (Bw, >=T-1, nx)."""
        Bw = xss.shape[0]
        tm = lambda a: a.transpose(0, 1).reshape((T - 1) * Bw,
                                                 *a.shape[2:])
        Js = stage_al_flat(ts.repeat_interleave(Bw), tm(xss[:, :T - 1]),
                           tm(uss), tm(lams), rhos.repeat(T - 1))
        return Js.reshape(T - 1, Bw)

    def rollout_open(x0s, uss):
        """Open-loop rollout; also returns the per-step solver variables
        ``wss (Bw, T-1, nws)`` seeding the first sweep."""
        xs = x0s
        ys_all, ws_all = [], []
        for t in range(T - 1):
            us = uss[:, t]
            if has_bws:
                ws0 = prob.ws_init_batched(t, xs, us)
                ys, ws = prob.dynamics_batched_ws(t, xs, us, ws0)
            else:
                ys = prob.dynamics_batched(t, xs, us)
                ws = torch.zeros((xs.shape[0], 1), dtype=xs.dtype,
                                 device=xs.device)
            ys_all.append(ys)
            ws_all.append(ws)
            xs = ys
        xss = torch.stack([x0s] + ys_all, dim=1)
        return xss, torch.stack(ws_all, dim=1)

    def traj_cost(xss, uss, lams, lamTs, rhos):
        Js = _stage_costs(xss, uss, lams, rhos)
        return torch.sum(Js, dim=0) + terminal_al_v(xss[:, -1], lamTs, rhos)

    def closed_loop(xss_ref, uss_ref, Kss, kss, alphas, lams, lamTs, rhos,
                    wss):
        """alphas: (Bw,). Returns xss, uss, Js, wss_new."""
        xs = xss_ref[:, 0]
        xs_all, us_all, ws_all = [], [], []
        for t in range(T - 1):
            us_ref_t = uss_ref[:, t]
            us = (us_ref_t + alphas[:, None] * kss[:, t]
                  + torch.einsum("bij,bj->bi", Kss[:, t],
                                 xs - xss_ref[:, t]))
            us = torch.where(prob.u_mask[t][None], us, us_ref_t)
            if has_bws:
                ws0 = (wss[:, t] if prob.ws_linesearch
                       else prob.ws_init_batched(t, xs, us))
                ys, ws_new = prob.dynamics_batched_ws(t, xs, us, ws0)
            else:
                ys = prob.dynamics_batched(t, xs, us)
                ws_new = wss[:, t]
            xs_all.append(xs)
            us_all.append(us)
            ws_all.append(ws_new)
            xs = ys
        xss = torch.stack(xs_all + [xs], dim=1)
        uss = torch.stack(us_all, dim=1)
        return (xss, uss, _time_order_cost(xss, uss, lams, lamTs, rhos),
                torch.stack(ws_all, dim=1))

    def _time_order_cost(xss, uss, lams, lamTs, rhos):
        """A rollout's AL costs, the stage costs accumulated in time
        order, as the reference's scan carry does."""
        Jst = _stage_costs(xss, uss, lams, rhos)
        Js = torch.zeros(xss.shape[0], dtype=dtype, device=device)
        for t in range(T - 1):
            Js = Js + Jst[t]
        return Js + terminal_al_v(xss[:, -1], lamTs, rhos)

    if prob.rollout_fused is not None:
        # both rollouts as one K4 launch, costs as the loop above sums
        # them, so a float64 solve is the same with K4 on or off
        if prob.ws_linesearch:
            raise ValueError("rollout_fused implements the cold line-search "
                             "policy (per-step init_z starts); set "
                             "ws_linesearch=False")
        fused_roll = prob.rollout_fused

        def closed_loop(xss_ref, uss_ref, Kss, kss, alphas, lams, lamTs,
                        rhos, wss):
            xss, uss, wss_new = fused_roll(xss_ref[:, 0], xss_ref, uss_ref,
                                           Kss, kss, alphas)
            return (xss, uss, _time_order_cost(xss, uss, lams, lamTs, rhos),
                    wss_new)

        def rollout_open(x0s, uss):
            Bw = x0s.shape[0]
            zeros = lambda *s: torch.zeros((Bw,) + s, dtype=x0s.dtype,
                                           device=x0s.device)
            xss, _, wss = fused_roll(x0s, zeros(T, nx), uss,
                                     zeros(T - 1, nu, nx), zeros(T - 1, nu),
                                     zeros())
            return xss, wss

    def derivatives(xss, uss, lams, lamTs, rhos, wss):
        flat_x = xss[:, :-1].reshape(B * (T - 1), nx)
        flat_u = uss.reshape(B * (T - 1), nu)
        flat_t = ts.repeat(B)
        if has_bws and prob.dynamics_jac_batched_ws is not None:
            flat_w = wss.reshape(B * (T - 1), -1)
            _, fxs, fus, _ = prob.dynamics_jac_batched_ws(
                flat_t, flat_x, flat_u, flat_w)
        elif prob.dynamics_jac_batched is not None:
            _, fxs, fus = prob.dynamics_jac_batched(flat_t, flat_x, flat_u)
        else:
            raise ValueError("derivatives need dynamics_jac_batched(_ws)")
        fxs = fxs.reshape(B, T - 1, nx, nx)
        fus = fus.reshape(B, T - 1, nx, nu)

        lxs, lus, lxxs, luus, luxs = stage_exp_flat(
            flat_t, flat_x, flat_u, lams.reshape(B * (T - 1), -1),
            rhos.repeat_interleave(T - 1))
        lane = lambda a: a.reshape(B, T - 1, *a.shape[1:])
        gTs, HTs = terminal_exp_v(xss[:, -1], lamTs, rhos)
        return (fxs, fus, lane(lxs), lane(lus), lane(lxxs), lane(luus),
                lane(luxs), gTs, HTs)

    def backward_xla(fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs):
        """Per-lane Riccati recursion over batched tensors, t = T-2..0.

        A Quu that is not positive definite gives ``ok = False`` and NaN
        gains for its lane (the reference's Cholesky returns NaN there;
        ``torch.linalg.cholesky`` would raise, so ``cholesky_ex`` reports
        it through ``info``)."""
        Vx, Vxx = gTs, HTs
        Ks, ks, dV1s, dV2s, qu_infs, oks = ([None] * (T - 1)
                                             for _ in range(6))
        nan = torch.tensor(float("nan"), dtype=dtype, device=device)
        for t in range(T - 2, -1, -1):
            fx, fu = fxs[:, t], fus[:, t]
            Qx = lxs[:, t] + torch.einsum("bji,bj->bi", fx, Vx)
            Qu = lus[:, t] + torch.einsum("bji,bj->bi", fu, Vx)
            VF = torch.einsum("bij,bjk->bik", Vxx, fx)
            Qxx = lxxs[:, t] + torch.einsum("bji,bjk->bik", fx, VF)
            VFu = torch.einsum("bij,bjk->bik", Vxx, fu)
            Quu = luus[:, t] + torch.einsum("bji,bjk->bik", fu, VFu)
            Qux = luxs[:, t] + torch.einsum("bji,bjk->bik", fu, VF)

            m = prob.u_mask[t]
            Qu = torch.where(m[None], Qu, 0.0)
            Qux = torch.where(m[None, :, None], Qux, 0.0)
            mm = torch.outer(m, m)[None]
            Quu = torch.where(mm, Quu, 0.0) + torch.diag_embed(
                torch.where(m[None], regs[:, None], 1.0))

            L, info = torch.linalg.cholesky_ex(Quu)
            L = torch.where((info == 0)[:, None, None], L, nan)
            ok = torch.isfinite(L).all(dim=2).all(dim=1)
            rhs = torch.cat([Qu[..., None], Qux], dim=2)
            sol = torch.cholesky_solve(rhs, L)
            k = -sol[:, :, 0]
            K = -sol[:, :, 1:]

            Vx = (Qx + torch.einsum("bji,bj->bi", K, Qu)
                  + torch.einsum("bji,bj->bi", Qux, k)
                  + torch.einsum("bji,bjk,bk->bi", K, Quu, k))
            KQ = torch.einsum("bji,bjk->bik", K, Qux)
            Vxx = (Qxx + KQ + KQ.transpose(1, 2)
                   + torch.einsum("bji,bjk,bkl->bil", K, Quu, K))
            Vxx = 0.5 * (Vxx + Vxx.transpose(1, 2))
            Ks[t], ks[t], oks[t] = K, k, ok
            dV1s[t] = torch.einsum("bi,bi->b", k, Qu)
            dV2s[t] = 0.5 * torch.einsum("bi,bij,bj->b", k, Quu, k)
            qu_infs[t] = torch.amax(torch.abs(Qu), dim=1)
        return (torch.stack(Ks, dim=1), torch.stack(ks, dim=1),
                torch.sum(torch.stack(dV1s), dim=0),
                torch.sum(torch.stack(dV2s), dim=0),
                torch.amax(torch.stack(qu_infs), dim=0),
                torch.stack(oks).all(dim=0))

    backward = (make_riccati_backward(T, nx, nu, prob.u_mask, device, dtype)
                if opts.riccati_kernel else backward_xla)

    n_alpha = int(math.ceil(math.log2(1.0 / opts.alpha_min))) + 1
    alpha_grid = torch.tensor([0.5 ** i for i in range(n_alpha)],
                              dtype=dtype, device=device)

    def _make_line_search(grid):
        A = int(grid.shape[0])

        def line_search(xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs,
                        rhos, wss):
            """(lane x alpha) grid as one batched rollout of Bw*A lanes;
            each lane keeps its FIRST Armijo-passing alpha."""
            Bw = xss.shape[0]
            rep = lambda a: torch.repeat_interleave(a, A, dim=0)
            alphas_flat = grid.repeat(Bw)                # (Bw*A,)
            xss_c, uss_c, Js_c, wss_c = closed_loop(
                rep(xss), rep(uss), rep(Kss), rep(kss), alphas_flat,
                rep(lams), rep(lamTs), rep(rhos), rep(wss))
            Js_c = Js_c.reshape(Bw, A)
            expected = (grid[None] * dV1[:, None]
                        + grid[None] ** 2 * dV2[:, None])
            ok = torch.isfinite(Js_c) & (
                Js_c <= Js[:, None]
                + opts.armijo_c1 * torch.clamp_max(expected, 0.0))
            accepted = ok.any(dim=1)
            # first True: argmax over an int cast (first maximal index)
            pick = torch.argmax(ok.to(torch.int32), dim=1)
            lanes = torch.arange(Bw, device=device)
            sel = lanes * A + pick
            return (xss_c[sel], uss_c[sel], Js_c[lanes, pick], accepted,
                    wss_c[sel])

        return line_search

    # Incremental line-search cascade: the gains are computed once per
    # iteration (ls_prep), then DISJOINT alpha slices {1,.5} -> {.25,.125}
    # -> {rest} are rolled only while some active lane has not accepted,
    # each lane keeping its FIRST accept across rungs (ls_rungs), then the
    # accept/reject bookkeeping (ls_apply). The slices partition the grid
    # in order, so the merged pick is the full grid's first-passing alpha.
    ls_slice_bounds = sorted({b for b in (0, 2, 4, n_alpha)
                              if b <= n_alpha})
    ls_slices = [_make_line_search(alpha_grid[lo:hi])
                 for lo, hi in zip(ls_slice_bounds[:-1],
                                   ls_slice_bounds[1:])]

    def ls_prep(xss, uss, Js, regs, lams, lamTs, rhos, active, wss):
        """Derivative sweep + backward pass + the FIRST alpha slice.

        Returns the gains (reused by the later rungs), the backward-pass
        convergence signals, the candidate after slice 0, and ``covered``
        (every active lane already accepted, a 0-dim bool tensor)."""
        d = derivatives(xss, uss, lams, lamTs, rhos, wss)
        Kss, kss, dV1, dV2, qu_inf, bp_ok = backward(*d, regs)
        cand = ls_slices[0](xss, uss, Kss, kss, Js, dV1, dV2, lams,
                            lamTs, rhos, wss)
        covered = (cand[3] | ~active).all()
        return Kss, kss, dV1, dV2, qu_inf, bp_ok, cand, covered

    def _make_ls_rung(i):
        ls = ls_slices[i]

        def ls_rung(xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs, rhos,
                    wss, cand, active):
            """Roll slice ``i`` and merge first-accepts into ``cand``."""
            xs_c, us_c, J_c, acc_c, ws_c = ls(
                xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs, rhos, wss)
            xs_b, us_b, J_b, acc_b, ws_b = cand
            take = acc_c & ~acc_b
            xs_b = torch.where(take[:, None, None], xs_c, xs_b)
            us_b = torch.where(take[:, None, None], us_c, us_b)
            J_b = torch.where(take, J_c, J_b)
            ws_b = torch.where(take[:, None, None], ws_c, ws_b)
            acc_b = acc_b | acc_c
            covered = (acc_b | ~active).all()
            return (xs_b, us_b, J_b, acc_b, ws_b), covered

        return ls_rung

    ls_rungs = [_make_ls_rung(i) for i in range(1, len(ls_slices))]

    def ls_apply(xss, uss, Js, regs, wss, active, cand, qu_inf, bp_ok):
        """Accept/reject bookkeeping with the merged cascade candidate."""
        xss_n, uss_n, Js_n, accepted, wss_n = cand
        ls_failed = ~(accepted & bp_ok)
        regs_n = torch.where(
            ls_failed,
            torch.clamp_max(regs * opts.reg_up, opts.reg_max),
            torch.clamp_min(regs * opts.reg_down, opts.reg_min))
        keep = ls_failed | ~active
        xss_n = torch.where(keep[:, None, None], xss, xss_n)
        uss_n = torch.where(keep[:, None, None], uss, uss_n)
        Js_n = torch.where(keep, Js, Js_n)
        regs_n = torch.where(active, regs_n, regs)
        wss_n = torch.where(keep[:, None, None], wss, wss_n)

        grad_small = qu_inf < opts.grad_tol
        obj_small = torch.abs(Js - Js_n) < opts.obj_tol
        reg_capped = regs_n >= opts.reg_max
        newly_done = grad_small | (accepted & obj_small) | (
            ls_failed & reg_capped)
        ok_lanes = (accepted & bp_ok) | ~active
        return (xss_n, uss_n, Js_n, regs_n, wss_n, newly_done,
                qu_inf, ok_lanes)

    has_con = prob.stage_con is not None
    has_conT = prob.terminal_con is not None
    con_v = vmap(prob.stage_con, in_dims=(None, 0, 0)) if has_con else None
    conT_v = vmap(prob.terminal_con) if has_conT else None

    def con_violation(xss, uss):
        v = torch.zeros(xss.shape[0], dtype=dtype, device=device)
        if has_con:
            per_t = [torch.amax(_violation(con_v(t, xss[:, t], uss[:, t]),
                                           None, prob.ineq_mask[t][None]),
                                dim=1) for t in range(T - 1)]
            v = torch.maximum(v, torch.amax(torch.stack(per_t), dim=0))
        if has_conT:
            cT = conT_v(xss[:, -1])
            v = torch.maximum(v, torch.amax(
                _violation(cT, None, prob.terminal_ineq_mask[None]), dim=1))
        return v

    def dual_update(xss, uss, lams, lamTs, rhos):
        if has_con:
            per_t = [_al_multiplier(con_v(t, xss[:, t], uss[:, t]),
                                    lams[:, t], rhos[:, None],
                                    prob.ineq_mask[t][None])
                     for t in range(T - 1)]
            lams = torch.clamp(torch.stack(per_t, dim=1), -opts.lambda_max,
                               opts.lambda_max)
        if has_conT:
            cT = conT_v(xss[:, -1])
            lamTs = torch.clamp(
                _al_multiplier(cT, lamTs, rhos[:, None],
                               prob.terminal_ineq_mask[None]),
                -opts.lambda_max, opts.lambda_max)
        return lams, lamTs

    stage_cost_flat = vmap(prob.stage_cost)
    terminal_cost_v = vmap(prob.terminal_cost)

    def smooth_cost(xss, uss):
        Bw = xss.shape[0]
        Js = stage_cost_flat(ts.repeat(Bw),
                             xss[:, :-1].reshape(Bw * (T - 1), nx),
                             uss.reshape(Bw * (T - 1), nu))
        return (torch.sum(Js.reshape(Bw, T - 1), dim=1)
                + terminal_cost_v(xss[:, -1]))

    return SimpleNamespace(
        prob=prob, B=B, T=T, nx=nx, nu=nu, dtype=dtype, device=device,
        has_con=has_con, has_conT=has_conT,
        rollout_open=rollout_open, traj_cost=traj_cost,
        closed_loop=closed_loop, derivatives=derivatives,
        backward_xla=backward_xla,
        ls_prep=ls_prep, ls_rungs=ls_rungs, ls_apply=ls_apply,
        n_alpha=n_alpha,
        # alphas rolled by slice0 and each cascade rung (the segmented
        # executor's dispatch accounting uses these)
        ls_slice_widths=[hi - lo for lo, hi in zip(ls_slice_bounds[:-1],
                                                   ls_slice_bounds[1:])],
        con_violation=con_violation, dual_update=dual_update,
        smooth_cost=smooth_cost)
