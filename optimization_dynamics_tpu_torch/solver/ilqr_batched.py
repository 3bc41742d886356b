"""Batched-native AL-iLQR: lockstep scenario batches.

Port of ``optimization_dynamics_tpu/solver/ilqr_batched.py``.
``make_phases`` builds the phase functions: the open- and closed-loop
rollouts, the trajectory cost, the derivative sweep, the Riccati backward
pass, the (lane x alpha) grid line searches, the inner steps built on
them (full grid, the first two alphas, the first four), the incremental
line-search cascade (``ls_prep`` / ``ls_rungs`` / ``ls_apply``), the
per-lane-alpha rungs (``ls_prep_at`` / ``ls_rung_at``), the one-call
adaptive inner step (``inner_step_adaptive``), k inner iterations as one
call (``make_inner_scan``) and the AL bookkeeping (constraint violation,
dual update, smooth cost). The segmented executor
(``ilqr_segmented.py``) drives these phases; ``solve_batched``, the
lockstep solver (one full-grid inner step a iteration for the whole
batch, inside the AL rounds), is that executor with only its full-grid
branch on.

Every phase works on lane-batched tensors (batch first) and computes each
lane independently; the time loops are Python loops over batched ops,
except where a kernel takes a whole loop: ``ILQROptions.riccati_kernel``
runs the backward pass as K3 and ``ILQRProblem.rollout_fused`` both
rollouts as K4. Where the reference keeps a loop on the device
(``while_loop``, ``lax.cond``, ``lax.scan``), the port runs it on the host
and reads the loop's flag there, one read a pass, with the same
decisions.
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
    ILQRResult,
    _al_multiplier,
    _cholesky_gains,
    _make_al_costs,
    _pad_masks,
    _violation,
)

__all__ = ["solve_batched", "make_phases"]


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
    # cross-time carry: step t of a rollout warm-starts from the same
    # rollout's step t-1 solution; only with cold line-search rollouts
    ws_carry = has_bws and prob.ws_carry and not prob.ws_linesearch

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
        ws = prob.ws_init_batched(0, x0s, uss[:, 0]) if ws_carry else None
        for t in range(T - 1):
            us = uss[:, t]
            if has_bws:
                ws0 = ws if ws_carry else prob.ws_init_batched(t, xs, us)
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

    if torch.device(device).type == "cuda":
        # K dx as a product and a sum over the state, not a batched
        # matmul: cuBLAS picks that kernel by the batch count, so a lane's
        # controls would move in their last bits with the width it is
        # rolled at (a rung of B lanes against a slice of 2B), and its
        # line-search decision with them. The CPU's batched product is
        # the same at any width.
        def feedback(K, dx):
            return torch.sum(K * dx[:, None], dim=2)
    else:
        def feedback(K, dx):
            return torch.einsum("bij,bj->bi", K, dx)

    def closed_loop(xss_ref, uss_ref, Kss, kss, alphas, lams, lamTs, rhos,
                    wss):
        """alphas: (Bw,). Returns xss, uss, Js, wss_new."""
        xs = xss_ref[:, 0]
        xs_all, us_all, ws_all = [], [], []
        ws_new = (prob.ws_init_batched(0, xs, uss_ref[:, 0]) if ws_carry
                  else None)
        for t in range(T - 1):
            us_ref_t = uss_ref[:, t]
            us = (us_ref_t + alphas[:, None] * kss[:, t]
                  + feedback(Kss[:, t], xs - xss_ref[:, t]))
            us = torch.where(prob.u_mask[t][None], us, us_ref_t)
            if has_bws:
                if prob.ws_linesearch:
                    ws0 = wss[:, t]
                elif ws_carry:
                    ws0 = ws_new
                else:
                    ws0 = prob.ws_init_batched(t, xs, us)
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
        if prob.ws_linesearch or prob.ws_carry:
            raise ValueError("rollout_fused implements the cold line-search "
                             "policy (per-step init_z starts); set "
                             "ws_linesearch=False and ws_carry=False")
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
        gains for its lane (``ilqr._cholesky_gains``)."""
        Vx, Vxx = gTs, HTs
        Ks, ks, dV1s, dV2s, qu_infs, oks = ([None] * (T - 1)
                                             for _ in range(6))
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

            K, k, ok = _cholesky_gains(Quu, Qu, Qux)

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

    def _armijo_ok(J_c, J_ref, alphas, dV1, dV2):
        """Finite and with sufficient decrease against the backward pass's
        expected change ``alpha dV1 + alpha^2 dV2`` (arguments broadcast:
        a lane's grid or one alpha a lane)."""
        expected = alphas * dV1 + alphas ** 2 * dV2
        return torch.isfinite(J_c) & (
            J_c <= J_ref + opts.armijo_c1 * torch.clamp_max(expected, 0.0))

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
            ok = _armijo_ok(Js_c, Js[:, None], grid[None], dV1[:, None],
                            dV2[:, None])
            accepted = ok.any(dim=1)
            # first True: argmax over an int cast (first maximal index)
            pick = torch.argmax(ok.to(torch.int32), dim=1)
            lanes = torch.arange(Bw, device=device)
            sel = lanes * A + pick
            return (xss_c[sel], uss_c[sel], Js_c[lanes, pick], accepted,
                    wss_c[sel])

        return line_search

    def ls_apply(xss, uss, Js, regs, wss, active, cand, qu_inf, bp_ok):
        """Accept/reject bookkeeping of one iteration from its line-search
        pick ``cand = (xss, uss, Js, accepted, wss)``: returns the updated
        (xss, uss, Js, regs, wss), the per-lane convergence signals, the
        backward pass's gradient norm |Qu|_inf and ``ok_lanes``
        (accepted-or-inactive: all-True means a quick pass needs no
        full-grid fallback)."""
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

    line_search = _make_line_search(alpha_grid)
    # The full grid picks the FIRST Armijo-passing alpha, so whenever every
    # active lane accepts within the first two (or four) alphas the pick
    # equals the full grid's: the quick and mid grids.
    line_search_quick = _make_line_search(alpha_grid[:min(2, n_alpha)])
    line_search_mid = _make_line_search(alpha_grid[:min(4, n_alpha)])

    def _make_inner_step(ls):
        def inner_step(xss, uss, Js, regs, lams, lamTs, rhos, active,
                       wss):
            """One iLQR iteration for every active lane: sweep, backward
            pass, the line search ``ls``, then ``ls_apply``."""
            d = derivatives(xss, uss, lams, lamTs, rhos, wss)
            Kss, kss, dV1, dV2, qu_inf, bp_ok = backward(*d, regs)
            cand = ls(xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs, rhos,
                      wss)
            return ls_apply(xss, uss, Js, regs, wss, active, cand, qu_inf,
                            bp_ok)

        return inner_step

    inner_step = _make_inner_step(line_search)
    inner_step_quick = _make_inner_step(line_search_quick)
    # None when the full grid is already <= 4 alphas (mid == full)
    inner_step_mid = (_make_inner_step(line_search_mid)
                      if n_alpha > 4 else None)

    def _take_first(cand, new):
        """Merge a rung's candidates into ``cand``: a lane takes the new
        one only if it accepts there and had not accepted before."""
        xs_c, us_c, J_c, acc_c, ws_c = new
        xs_b, us_b, J_b, acc_b, ws_b = cand
        take = acc_c & ~acc_b
        return (torch.where(take[:, None, None], xs_c, xs_b),
                torch.where(take[:, None, None], us_c, us_b),
                torch.where(take, J_c, J_b), acc_b | acc_c,
                torch.where(take[:, None, None], ws_c, ws_b))

    def _merge(cand, new, active):
        """``_take_first`` and ``covered``: every active lane has
        accepted (a 0-dim bool tensor)."""
        cand = _take_first(cand, new)
        return cand, (cand[3] | ~active).all()

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
            return _merge(cand, ls(xss, uss, Kss, kss, Js, dV1, dV2, lams,
                                   lamTs, rhos, wss), active)

        return ls_rung

    ls_rungs = [_make_ls_rung(i) for i in range(1, len(ls_slices))]

    # Per-lane alpha: ONE alpha a lane a rung, ``ais`` (grid indices) an
    # input, so one function serves every rung.
    def _line_search_at(xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs,
                        rhos, wss, ais):
        """One rollout at per-lane alphas ``alpha_grid[ais]``."""
        alphas = alpha_grid[ais]
        xss_c, uss_c, Js_c, wss_c = closed_loop(
            xss, uss, Kss, kss, alphas, lams, lamTs, rhos, wss)
        return (xss_c, uss_c, Js_c,
                _armijo_ok(Js_c, Js, alphas, dV1, dV2), wss_c)

    def ls_rung_at(xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs, rhos,
                   wss, cand, active, ais):
        """Roll per-lane alphas ``ais`` and merge first-accepts."""
        return _merge(cand, _line_search_at(xss, uss, Kss, kss, Js, dV1,
                                            dV2, lams, lamTs, rhos, wss,
                                            ais), active)

    def ls_prep_at(xss, uss, Js, regs, lams, lamTs, rhos, active, wss,
                   ais):
        """Derivative sweep + backward pass + the first per-lane rung
        (each lane at alpha index ``ais``)."""
        d = derivatives(xss, uss, lams, lamTs, rhos, wss)
        Kss, kss, dV1, dV2, qu_inf, bp_ok = backward(*d, regs)
        cand0 = (xss, uss, Js,
                 torch.zeros(xss.shape[0], dtype=torch.bool, device=device),
                 wss)
        cand, covered = ls_rung_at(xss, uss, Kss, kss, Js, dV1, dV2, lams,
                                   lamTs, rhos, wss, cand0, active, ais)
        return Kss, kss, dV1, dV2, qu_inf, bp_ok, cand, covered

    # The adaptive inner step, one call an iteration with alpha memory:
    # rung 0 rolls a per-lane TWO-alpha window {1.0, alpha_grid[ais]} as
    # one 2B-lane rollout (alpha=1 is always tried, which keeps the
    # obj_tol done-criterion honest); then ONE further per-lane candidate
    # a rung (grid order, skipping the two already tried) only while some
    # active lane has no accept. Accepted lanes remember max(index - 1,
    # 1). Not decision-identical to the grid: indices strictly between 1.0
    # and alpha_grid[ais] are tried only in the fallback, so a lane can
    # step smaller than the grid's first-passing alpha.
    def inner_step_adaptive(xss, uss, Js, regs, lams, lamTs, rhos,
                            active, wss, ais):
        """``ais (Bw,)`` integer indices in ``[1, n_alpha-1]``. Returns the
        ``inner_step`` outputs plus ``ais_next`` and ``depth`` (1 +
        fallback rungs rolled, a Python int: the fallback's condition is
        read on the host once a rung)."""
        Bw = xss.shape[0]
        lanes = torch.arange(Bw, device=device)
        ais = torch.clamp(ais.to(torch.int64), 1, n_alpha - 1)
        d = derivatives(xss, uss, lams, lamTs, rhos, wss)
        Kss, kss, dV1, dV2, qu_inf, bp_ok = backward(*d, regs)

        # rung 0: lane b on rows 2b (alpha 1) and 2b + 1 (alpha_grid[ais])
        idx2 = torch.stack([torch.zeros_like(ais), ais], 1).reshape(-1)
        alphas2 = alpha_grid[idx2]
        rep = lambda a: torch.repeat_interleave(a, 2, dim=0)
        xs_c, us_c, J_c, ws_c = closed_loop(
            rep(xss), rep(uss), rep(Kss), rep(kss), alphas2,
            rep(lams), rep(lamTs), rep(rhos), rep(wss))
        ok2 = _armijo_ok(J_c, rep(Js), alphas2, rep(dV1),
                         rep(dV2)).reshape(Bw, 2)
        # grid order: prefer alpha=1 over the remembered smaller alpha
        pick = torch.where(ok2[:, 0], 0, 1)
        sel = lanes * 2 + pick
        xs_b, us_b = xs_c[sel], us_c[sel]
        J_b, ws_b = J_c.reshape(Bw, 2)[lanes, pick], ws_c[sel]
        acc_b = ok2.any(dim=1)
        ai_b = torch.where(ok2[:, 0], 0, ais)

        # fallback: rung r rolls index r if r < ai else r + 1 (r = 1 ..
        # n_alpha-2 covers the rest of the grid)
        r = 1
        while r <= n_alpha - 2 and bool((active & ~acc_b).any()):
            f = torch.where(r < ais, r, r + 1)
            xs_c, us_c, J_c, ok, ws_c = _line_search_at(
                xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs, rhos, wss, f)
            ai_b = torch.where(ok & ~acc_b, f, ai_b)
            xs_b, us_b, J_b, acc_b, ws_b = _take_first(
                (xs_b, us_b, J_b, acc_b, ws_b), (xs_c, us_c, J_c, ok, ws_c))
            r += 1

        out = ls_apply(xss, uss, Js, regs, wss, active,
                       (xs_b, us_b, J_b, acc_b, ws_b), qu_inf, bp_ok)
        ais_next = torch.where(active & acc_b,
                               torch.clamp_min(ai_b - 1, 1), ais)
        return out + (ais_next, r)

    def make_inner_scan(k: int, two_stage: bool = True):
        """``k`` inner iterations as one call. Each tries the quick
        2-alpha step first and reruns the full Armijo grid from the same
        state only when some active lane rejected both quick alphas (the
        full grid takes the FIRST passing alpha, so an all-accept quick
        pass already equals it), so the decisions are those of k
        host-driven two-stage iterations; ``two_stage=False`` runs the
        full grid every iteration. An iteration with no active lane is
        skipped. The host reads one flag an iteration (and the quick
        pass's when ``two_stage``), where the reference keeps the
        choice on the device."""

        def inner_scan(xss, uss, Js, regs, lams, lamTs, rhos, active,
                       wss, its, gnorms, rit, budget):
            """``rit`` is the round-local iteration counter (zeros at the
            start of each AL round); with ``budget`` (this AL round's
            inner budget) it enforces the round's budget exactly as the
            host loop does, also where a chunk straddles it."""
            for _ in range(k):
                if not bool(active.any()):
                    break
                if two_stage:
                    out = inner_step_quick(xss, uss, Js, regs, lams, lamTs,
                                           rhos, active, wss)
                    if not bool(out[7].all()):
                        out = inner_step(xss, uss, Js, regs, lams, lamTs,
                                         rhos, active, wss)
                else:
                    out = inner_step(xss, uss, Js, regs, lams, lamTs, rhos,
                                     active, wss)
                xss, uss, Js, regs, wss, newly_done, qu_inf, _ = out
                gnorms = torch.where(active, qu_inf, gnorms)
                step = active.to(its.dtype)
                its = its + step
                rit = rit + step
                active = active & ~newly_done & (rit < budget)
            return xss, uss, Js, regs, wss, active, its, gnorms, rit

        return inner_scan

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
        backward=backward, backward_xla=backward_xla,
        line_search=line_search, inner_step=inner_step,
        inner_step_quick=inner_step_quick, inner_step_mid=inner_step_mid,
        ls_prep=ls_prep, ls_rungs=ls_rungs, ls_apply=ls_apply,
        ls_prep_at=ls_prep_at, ls_rung_at=ls_rung_at,
        inner_step_adaptive=inner_step_adaptive,
        n_alpha=n_alpha, alpha_grid=alpha_grid,
        # alphas rolled by slice0 and each cascade rung (the segmented
        # executor's dispatch accounting uses these)
        ls_slice_widths=[hi - lo for lo, hi in zip(ls_slice_bounds[:-1],
                                                   ls_slice_bounds[1:])],
        make_inner_scan=make_inner_scan,
        con_violation=con_violation, dual_update=dual_update,
        smooth_cost=smooth_cost)


def solve_batched(prob: ILQRProblem, x0s: torch.Tensor,
                  us_init: torch.Tensor,
                  opts: ILQROptions = ILQROptions(),
                  lam_init=None, lamT_init=None,
                  rho_init=None) -> ILQRResult:
    """The lockstep batched AL-iLQR solve on ``x0s``'s device and dtype.

    x0s: (B, nx); us_init: (B, T-1, nu) or (T-1, nu) shared. Every inner
    iteration runs the full-grid ``inner_step`` for the whole batch (no
    compaction, no schedule, no stall policy) while some lane is neither
    done nor at ``opts.max_iter``; the AL rounds run while ``al_it <
    opts.max_al_iter`` and some lane's violation is not below
    ``con_tol``. A problem without constraints runs one inner solve
    (``al_iterations`` 1, violation 0). ``lam_init (B, T-1, ncon)`` /
    ``lamT_init (B, nconT)`` / ``rho_init (B,)`` warm-start the per-lane
    AL state from a previous solve's ``ILQRResult.lam/lamT/rho``.

    This is the segmented executor with its full-grid branch and nothing
    else on (``two_stage_ls=False, compact=False``), which takes the same
    decisions. One difference: a lane whose violation is NaN leaves the
    AL rounds, as the segmented executor's do, where the reference's
    lockstep loop keeps it in them to ``max_al_iter``."""
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    if prob.dynamics_batched is None:
        raise ValueError("solve_batched needs prob.dynamics_batched")
    solve = make_segmented_solver(prob, opts, x0s.shape[0], x0s.dtype,
                                  x0s.device, two_stage_ls=False,
                                  compact=False)
    return solve(x0s, us_init, lam_init, lamT_init, rho_init)
