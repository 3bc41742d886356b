"""Segmented AL-iLQR executor: the host drives the AL rounds and the inner
iterations, each phase runs lane-batched on the device.

Port of ``optimization_dynamics_tpu/solver/ilqr_segmented.py::
make_segmented_solver`` on its cascade path (two-stage line search, one
inner iteration per dispatch, lockstep alpha slices). Per inner
iteration: one derivative sweep and backward pass, then disjoint alpha
slices {1, .5} -> {.25, .125} -> {rest} rolled only while some active lane
has not accepted, each lane keeping its first accept (decision-identical
to the full Armijo grid).

* Active-lane compaction: when the active lanes fit a smaller power-of-4
  bucket (``B, B/4, ... >= compact_min``) they are gathered, cyclically
  padded, into width-specialised phases and scattered back; the deeper
  rungs compact their still-rejecting lanes the same way. Lanes never
  interact inside a phase, so the per-lane algorithm is unchanged.
* ``max_iter_schedule``: per-AL-round inner budgets (round i uses entry
  ``min(i, len-1)``); None keeps ``opts.max_iter``.
* ``al_stall_rounds`` (0 = off): drop a lane (``converged=False``) once,
  for that many consecutive AL rounds, its penalty sits at ``rho_max`` and
  the rounds its measured violation-improvement rate needs to reach
  ``con_tol`` exceed the rounds left (a rate of 0.999 or worse counts as
  no improvement).
* ``log``: called with a progress line after every inner iteration and
  AL round (the reference's words, and the lanes below ``con_tol``), and
  for every lane dropped.
* ``timers``: a ``utils.profiling.PhaseTimer``; every phase call is
  wrapped with a barrier under the reference's phase names
  (``rollout_open``, ``traj_cost``, ``ls_prep+slice0``, ``ls_rung<i>``,
  ``ls_apply``, ``al_round``, ``finish``; ``@<W>`` appended at a
  compacted width), so ``timers.report()`` gives the per-phase latency
  budget (profiling only: the barriers serialise the card's queue).
  Without it the executor makes the same calls in the same order.

``solve.stats`` counts, per call, the inner iterations dispatched and the
derivative-sweep and line-search lane-rollouts (each x (T-1) IP solves).
The host reads a few flags per rung (``covered``, the accept mask), as the
reference does; those are the syncs per cascade rung.
"""

from __future__ import annotations

import numpy as np
import torch

from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    ILQRResult,
)
from optimization_dynamics_tpu_torch.solver.ilqr_batched import make_phases

__all__ = ["make_segmented_solver"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


_AL_STALL_IMPROVE = 0.999


def make_segmented_solver(prob: ILQRProblem, opts: ILQROptions, B: int,
                          dtype, device,
                          al_stall_rounds: int = 0,
                          compact: bool = True,
                          compact_min: int = 8,
                          max_iter_schedule=None, log=None,
                          timers=None):
    """Build ``solve(x0s, us_init, lam_init=None, lamT_init=None,
    rho_init=None) -> ILQRResult`` for batch width B on ``device``.

    ``lam_init (B, T-1, ncon)`` / ``lamT_init (B, nconT)`` / ``rho_init
    (B,)`` warm-start the per-lane AL state from a previous solve's
    ``ILQRResult.lam/lamT/rho`` (tensors or numpy arrays)."""
    device = torch.device(device)
    ph = make_phases(prob, opts, B, dtype, device)
    T, nu = ph.T, ph.nu
    timed = ((lambda name, fn: fn) if timers is None else timers.wrap)
    ncon, nconT = prob.ncon, prob.nconT

    buckets = [B]
    if compact:
        w = B
        while w // 4 >= max(int(compact_min), 1):
            w //= 4
            buckets.append(w)
    _width_cache = {}

    def _width_entry(W):
        """(ls_prep, ls_rungs, ls_apply) of the phases at width W."""
        if W not in _width_cache:
            phw = ph if W == B else make_phases(prob, opts, W, dtype,
                                                device)
            at = "" if W == B else "@%d" % W
            _width_cache[W] = (
                timed("ls_prep+slice0" + at, phw.ls_prep),
                [timed("ls_rung%d%s" % (i + 1, at), r)
                 for i, r in enumerate(phw.ls_rungs)],
                timed("ls_apply" + at, phw.ls_apply))
        return _width_cache[W]

    def _bucket_below(W, n):
        """Smallest bucket width < W that holds n lanes (W if none)."""
        for w in sorted(buckets):
            if w < W and n <= w:
                return w
        return W

    def gather(idx, *arrays):
        return tuple(torch.index_select(a, 0, idx) for a in arrays)

    def scatter(idx, dsts, srcs):
        # duplicate indices (cyclic padding) carry identical values, so
        # whichever duplicate lands, the result is the same
        return tuple(d.index_put((idx,), s) for d, s in zip(dsts, srcs))

    stats = {}

    def _stat(key, v=1):
        stats[key] = stats.get(key, 0) + v

    slice_w = ph.ls_slice_widths        # alphas per cascade slice/rung

    def _run_cascade(W, xssW, ussW, JsW, regsW, lamsW, lamTsW, rhosW,
                     activeW, wssW):
        """One cascade iteration at phase width ``W``; each deeper rung
        runs on the smallest bucket that holds its still-rejecting
        lanes."""
        p, rs, a = _width_entry(W)
        (Kss, kss, dV1, dV2, qu_inf, bp_ok, cand,
         covered) = p(xssW, ussW, JsW, regsW, lamsW, lamTsW, rhosW,
                      activeW, wssW)
        _stat("sweep_lanes", W)
        _stat("roll_lanes", W * slice_w[0])
        act_np = None
        for ri in range(len(rs)):
            if bool(covered):
                break
            if act_np is None:
                act_np = _np(activeW)
            acc_np = _np(cand[3]).copy()
            todo = np.flatnonzero(act_np & ~acc_np)
            Wr = _bucket_below(W, todo.size)
            if Wr < W:
                idx_np = np.resize(todo, Wr)
                idx = torch.as_tensor(idx_np, device=device)
                (xr, ur, Kr, kr, Jr, d1r, d2r, lamr, lamTr, rhor,
                 wr) = gather(idx, xssW, ussW, Kss, kss, JsW, dV1, dV2,
                              lamsW, lamTsW, rhosW, wssW)
                cand_r = gather(idx, *cand)
                rung_w = _width_entry(Wr)[1][ri]
                cand_r, _ = rung_w(xr, ur, Kr, kr, Jr, d1r, d2r, lamr,
                                   lamTr, rhor, wr, cand_r,
                                   torch.ones(Wr, dtype=torch.bool,
                                              device=device))
                _stat("roll_lanes", Wr * slice_w[ri + 1])
                cand = scatter(idx, cand, cand_r)
                acc_np[idx_np] = _np(cand_r[3])
                covered = bool((acc_np | ~act_np).all())
            else:
                cand, covered = rs[ri](xssW, ussW, Kss, kss, JsW, dV1,
                                       dV2, lamsW, lamTsW, rhosW, wssW,
                                       cand, activeW)
                _stat("roll_lanes", W * slice_w[ri + 1])
        return a(xssW, ussW, JsW, regsW, wssW, activeW, cand, qu_inf, bp_ok)

    def al_round(xss, uss, lams, lamTs, rhos, act):
        """Constraint violation + PHR dual update + penalty scaling."""
        vio_n = ph.con_violation(xss, uss)
        lams_n, lamTs_n = ph.dual_update(xss, uss, lams, lamTs, rhos)
        lams = torch.where(act[:, None, None], lams_n, lams)
        lamTs = torch.where(act[:, None], lamTs_n, lamTs)
        rhos = torch.where(
            act, torch.clamp_max(rhos * opts.rho_scale, opts.rho_max), rhos)
        return vio_n, lams, lamTs, rhos

    def finish(xss, uss, lams, lamTs, rhos):
        return (ph.traj_cost(xss, uss, lams, lamTs, rhos),
                ph.smooth_cost(xss, uss))

    rollout_open = timed("rollout_open", ph.rollout_open)
    traj_cost = timed("traj_cost", ph.traj_cost)
    al_round = timed("al_round", al_round)
    finish = timed("finish", finish)

    def inner(xss, uss, wss, lams, lamTs, rhos, act_al, its, gnorms,
              max_iter_round=None):
        """One AL round's inner iterations for the lanes in ``act_al``
        (numpy bool); ``max_iter_round`` is the round's inner budget."""
        Js = traj_cost(xss, uss, lams, lamTs, rhos)
        regs = torch.full((B,), opts.reg_init, dtype=dtype, device=device)
        done = ~act_al
        its_inc = np.zeros(B, np.int64)
        budget = (opts.max_iter if max_iter_round is None
                  else min(int(max_iter_round), opts.max_iter))
        for it in range(budget):
            act_idx = np.flatnonzero(~done)
            if act_idx.size == 0:
                break
            W = B
            for w in sorted(buckets):
                if act_idx.size <= w:
                    W = w
                    break
            if W < B:
                # compacted iteration: gather the active lanes (cyclically
                # padded to the bucket width) into width-W phases
                idx_np = np.resize(act_idx, W)
                idx = torch.as_tensor(idx_np, device=device)
                (xb, ub, Jb, rb, lamb, lamTb, rhob, wb) = gather(
                    idx, xss, uss, Js, regs, lams, lamTs, rhos, wss)
                out = _run_cascade(
                    W, xb, ub, Jb, rb, lamb, lamTb, rhob,
                    torch.ones(W, dtype=torch.bool, device=device), wb)
                xb, ub, Jb, rb, wb, nd_b, qu_b, _ = out
                xss, uss, Js, regs, wss, gnorms = scatter(
                    idx, (xss, uss, Js, regs, wss, gnorms),
                    (xb, ub, Jb, rb, wb, qu_b))
                nd = np.zeros(B, bool)
                nd[idx_np] = _np(nd_b)
            else:
                active = torch.as_tensor(~done, device=device)
                out = _run_cascade(B, xss, uss, Js, regs, lams, lamTs,
                                   rhos, active, wss)
                xss, uss, Js, regs, wss, newly_done, qu_inf, _ = out
                gnorms = torch.where(active, qu_inf, gnorms)
                nd = _np(newly_done)
            _stat("inner_iters")
            its_inc[~done] += 1
            done = done | nd
            if log is not None:
                log("  inner it=%d J=%.6g done=%d/%d W=%d"
                    % (it, float(Js.min()), int(done.sum()), B, W))
            if done.all():
                break
        its = its + torch.as_tensor(its_inc, dtype=torch.int32,
                                    device=device)
        return xss, uss, wss, Js, its, gnorms

    def solve(x0s: torch.Tensor, us_init: torch.Tensor,
              lam_init=None, lamT_init=None, rho_init=None) -> ILQRResult:
        if x0s.shape[0] != B:
            raise ValueError("x0s has %d lanes, the solver was built for %d"
                             % (x0s.shape[0], B))
        x0s = torch.as_tensor(x0s, dtype=dtype, device=device)
        us_init = torch.as_tensor(us_init, dtype=dtype, device=device)
        if us_init.ndim == 2:
            us_init = us_init[None].expand(B, T - 1, nu).contiguous()

        stats.clear()
        xss, wss = rollout_open(x0s, us_init)
        _stat("roll_lanes", B)
        uss = us_init
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        lams = (torch.zeros((B, T - 1, max(ncon, 1)), dtype=dtype,
                            device=device)
                if lam_init is None else as_t(lam_init))
        lamTs = (torch.zeros((B, max(nconT, 1)), dtype=dtype, device=device)
                 if lamT_init is None else as_t(lamT_init))
        rhos = (torch.full((B,), opts.rho_init, dtype=dtype, device=device)
                if rho_init is None else as_t(rho_init).expand(B).clone())
        its = torch.zeros(B, dtype=torch.int32, device=device)
        gnorms = torch.full((B,), float("inf"), dtype=dtype, device=device)
        vio = np.full(B, np.inf)
        stall = np.zeros(B, np.int64)
        failed = np.zeros(B, bool)
        al_it = 0

        if ph.has_con or ph.has_conT:
            for al_it in range(1, opts.max_al_iter + 1):
                act_np = (vio >= opts.con_tol) & ~failed
                if not act_np.any():
                    break
                act = torch.as_tensor(act_np, device=device)
                mir = None
                if max_iter_schedule is not None:
                    mir = max_iter_schedule[
                        min(al_it - 1, len(max_iter_schedule) - 1)]
                xss, uss, wss, Js, its, gnorms = inner(
                    xss, uss, wss, lams, lamTs, rhos, act_np, its, gnorms,
                    mir)
                vio_n, lams, lamTs, rhos = al_round(xss, uss, lams, lamTs,
                                                    rhos, act)
                vio_new = np.where(act_np, _np(vio_n), vio)
                if al_stall_rounds > 0 and np.isfinite(opts.rho_max):
                    rho_capped = _np(rhos) >= 0.99 * opts.rho_max
                    with np.errstate(divide="ignore", invalid="ignore"):
                        rate = vio_new / np.maximum(vio, 1e-300)
                        need = np.where(
                            rate < _AL_STALL_IMPROVE,
                            np.log(np.maximum(opts.con_tol, 1e-300)
                                   / np.maximum(vio_new, 1e-300))
                            / np.log(np.maximum(rate, 1e-300)),
                            np.inf)
                    rounds_left = opts.max_al_iter - al_it
                    hopeless = (act_np & rho_capped
                                & (vio_new >= opts.con_tol)
                                & (need > rounds_left))
                    stall = np.where(hopeless, stall + 1, 0)
                    newly_failed = act_np & (stall >= al_stall_rounds)
                    if newly_failed.any() and log is not None:
                        log("al round %d: dropping %d hopeless lane(s) "
                            "(vio %s)" % (al_it, int(newly_failed.sum()),
                                          vio_new[newly_failed]))
                    failed |= newly_failed
                vio = vio_new
                if log is not None:
                    log("al round %d: max vio %.3e, %d/%d lanes below "
                        "con_tol" % (al_it, vio.max(),
                                     int((vio < opts.con_tol).sum()), B))
                if ((vio < opts.con_tol) | failed).all():
                    break
        else:
            xss, uss, wss, Js, its, gnorms = inner(
                xss, uss, wss, lams, lamTs, rhos, np.ones(B, bool), its,
                gnorms)
            al_it = 1
            vio = np.zeros(B)

        al_obj, obj = finish(xss, uss, lams, lamTs, rhos)
        vio_dev = torch.as_tensor(vio, dtype=dtype, device=device)
        return ILQRResult(
            xs=xss, us=uss, objective=obj, al_objective=al_obj,
            iterations=its,
            al_iterations=torch.full((B,), al_it, dtype=torch.int32,
                                     device=device),
            constraint_violation=vio_dev,
            gradient_norm=gnorms,
            converged=vio_dev < opts.con_tol,
            lam=lams, lamT=lamTs, rho=rhos)

    solve.stats = stats
    return solve
