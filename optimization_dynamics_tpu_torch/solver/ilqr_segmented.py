"""Segmented AL-iLQR executor: the host drives the AL rounds and the inner
iterations, each phase runs lane-batched on the device.

Port of ``optimization_dynamics_tpu/solver/ilqr_segmented.py``, with
every option of the reference's ``make_segmented_solver``:

* ``two_stage_ls`` (default): the incremental line-search cascade. Per
  inner iteration one derivative sweep and backward pass, then disjoint
  alpha slices {1, .5} -> {.25, .125} -> {rest} rolled only while some
  active lane has not accepted, each lane keeping its first accept
  (decision-identical to the full Armijo grid). ``two_stage_ls=False``
  runs the full grid in one call an iteration (``inner_step``).
* ``per_lane_alpha`` (needs the cascade path: ``two_stage_ls`` and
  ``iters_per_dispatch=1``, else ``ValueError``): one alpha a lane a
  rung (``ls_prep_at`` / ``ls_rung_at``), rung r at grid index r, so the
  pick is the full grid's; the deeper rungs compact their
  still-rejecting lanes as the slice cascade's do. ``alpha_memory``
  makes each lane start at the index it accepted last (one notch back
  toward 1.0 an accept, back to 1.0 after a rejection), backtrack from
  there and wrap to the untried larger alphas last: not
  decision-identical (a remembered small step can trip ``obj_tol``
  early).
* ``per_lane_alpha="device"``: the whole iteration in one call
  (``inner_step_adaptive``): sweep, backward pass, a per-lane two-alpha
  window {1.0, remembered alpha} and the fallback over the rest of the
  grid, the alpha memory kept as a device tensor through compaction. Not
  decision-identical (the window skips mid-grid alphas).
* ``iters_per_dispatch`` (k > 1): k inner iterations a call
  (``make_inner_scan``; the two-stage choice made an iteration, or the
  full grid alone with ``two_stage_ls=False``), the host reading the
  active count between chunks; the same decisions as k host-driven
  iterations. No compaction on this path, and ``solve.stats`` counts no
  sweep, rollout or inner iteration of it (as the reference's).
* Active-lane compaction (``compact``, the cascade paths): when the
  active lanes fit a smaller power-of-4 bucket (``B, B/4, ... >=
  compact_min``) they are gathered, cyclically padded, into
  width-specialised phases and scattered back; the deeper rungs compact
  their still-rejecting lanes the same way. Lanes never interact inside
  a phase, so the per-lane algorithm is unchanged.
* ``max_iter_schedule``: per-AL-round inner budgets (round i uses entry
  ``min(i, len-1)``); None keeps ``opts.max_iter``.
* ``al_stall_rounds`` (0 = off): drop a lane (``converged=False``) once,
  for that many consecutive AL rounds, its penalty sits at ``rho_max`` and
  the rounds its measured violation-improvement rate needs to reach
  ``con_tol`` exceed the rounds left (a rate of ``al_stall_improve`` or
  worse counts as no improvement).
* ``log``: called with a progress line after every inner iteration (with
  ``depth=[...]``, the iterations by rungs rolled) or chunk and every AL
  round (the reference's words, and the lanes below ``con_tol``), and
  for every lane dropped.
* ``timers``: a ``utils.profiling.PhaseTimer``; every phase call is
  wrapped with a barrier under the reference's phase names
  (``rollout_open``, ``traj_cost``, ``ls_prep+slice0``, ``ls_rung<i>``,
  ``ls_prep_at``, ``ls_rung_at``, ``inner_adaptive``, ``inner_full``,
  ``inner_scan_k<k>``, ``ls_apply``, ``al_round``, ``finish``; ``@<W>``
  appended at a compacted width), so ``timers.report()`` gives the
  per-phase latency budget (profiling only: the barriers serialise the
  card's queue). Without it the executor makes the same calls in the
  same order.

``solve.stats`` counts, per call, the inner iterations dispatched and the
derivative-sweep and line-search lane-rollouts (each x (T-1) IP solves),
key for key as the reference's. The host reads a few flags per rung
(``covered``, the accept mask), as the reference does; those are the
syncs per cascade rung.
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

__all__ = ["make_segmented_solver", "solve_segmented"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def make_segmented_solver(prob: ILQRProblem, opts: ILQROptions, B: int,
                          dtype, device,
                          two_stage_ls: bool = True,
                          iters_per_dispatch: int = 1,
                          al_stall_rounds: int = 0,
                          al_stall_improve: float = 0.999,
                          per_lane_alpha=False,
                          alpha_memory: bool = False,
                          compact: bool = True,
                          compact_min: int = 8,
                          max_iter_schedule=None, log=None,
                          timers=None):
    """Build ``solve(x0s, us_init, lam_init=None, lamT_init=None,
    rho_init=None) -> ILQRResult`` for batch width B on ``device``.

    ``lam_init (B, T-1, ncon)`` / ``lamT_init (B, nconT)`` / ``rho_init
    (B,)`` warm-start the per-lane AL state from a previous solve's
    ``ILQRResult.lam/lamT/rho`` (tensors or numpy arrays). The options
    are the module docstring's."""
    device = torch.device(device)
    ph = make_phases(prob, opts, B, dtype, device)
    T, nu = ph.T, ph.nu
    timed = ((lambda name, fn: fn) if timers is None else timers.wrap)
    ncon, nconT = prob.ncon, prob.nconT

    k = max(int(iters_per_dispatch), 1)
    cascade = two_stage_ls and k == 1
    adaptive_dev = per_lane_alpha == "device" and k == 1
    adaptive = bool(per_lane_alpha) and not adaptive_dev and cascade
    if per_lane_alpha and not (cascade or adaptive_dev):
        raise ValueError("per_lane_alpha needs two_stage_ls=True and "
                         "iters_per_dispatch=1 (the cascade path)")
    n_alpha = ph.n_alpha
    iter_full = timed("inner_full", ph.inner_step)
    scan = (timed("inner_scan_k%d" % k,
                  ph.make_inner_scan(k, two_stage=two_stage_ls))
            if k > 1 else None)

    buckets = [B]
    if compact and cascade:
        w = B
        while w // 4 >= max(int(compact_min), 1):
            w //= 4
            buckets.append(w)
    _width_cache = {}

    def _width_entry(W):
        """The phases of one inner iteration at width W: ``(adaptive
        step,)``, ``(ls_prep_at, ls_rung_at, ls_apply)`` or ``(ls_prep,
        ls_rungs, ls_apply)``."""
        if W not in _width_cache:
            phw = ph if W == B else make_phases(prob, opts, W, dtype,
                                                device)
            at = "" if W == B else "@%d" % W
            if adaptive_dev:
                entry = (timed("inner_adaptive" + at,
                               phw.inner_step_adaptive),)
            elif adaptive:
                entry = (timed("ls_prep_at" + at, phw.ls_prep_at),
                         timed("ls_rung_at" + at, phw.ls_rung_at),
                         timed("ls_apply" + at, phw.ls_apply))
            else:
                entry = (timed("ls_prep+slice0" + at, phw.ls_prep),
                         [timed("ls_rung%d%s" % (i + 1, at), r)
                          for i, r in enumerate(phw.ls_rungs)],
                         timed("ls_apply" + at, phw.ls_apply))
            _width_cache[W] = entry
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

    ones = lambda W: torch.ones(W, dtype=torch.bool, device=device)
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)

    stats = {}

    def _stat(key, v=1):
        stats[key] = stats.get(key, 0) + v

    slice_w = ph.ls_slice_widths        # alphas per cascade slice/rung

    def _run_cascade(W, xssW, ussW, JsW, regsW, lamsW, lamTsW, rhosW,
                     activeW, wssW):
        """One cascade iteration at phase width ``W``; each deeper rung
        runs on the smallest bucket that holds its still-rejecting
        lanes. Returns the ``ls_apply`` output and the rungs rolled."""
        p, rs, a = _width_entry(W)
        (Kss, kss, dV1, dV2, qu_inf, bp_ok, cand,
         covered) = p(xssW, ussW, JsW, regsW, lamsW, lamTsW, rhosW,
                      activeW, wssW)
        _stat("sweep_lanes", W)
        _stat("roll_lanes", W * slice_w[0])
        depth = 1
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
                idx = as_idx(idx_np)
                (xr, ur, Kr, kr, Jr, d1r, d2r, lamr, lamTr, rhor,
                 wr) = gather(idx, xssW, ussW, Kss, kss, JsW, dV1, dV2,
                              lamsW, lamTsW, rhosW, wssW)
                cand_r = gather(idx, *cand)
                rung_w = _width_entry(Wr)[1][ri]
                cand_r, _ = rung_w(xr, ur, Kr, kr, Jr, d1r, d2r, lamr,
                                   lamTr, rhor, wr, cand_r, ones(Wr))
                _stat("roll_lanes", Wr * slice_w[ri + 1])
                cand = scatter(idx, cand, cand_r)
                acc_np[idx_np] = _np(cand_r[3])
                covered = bool((acc_np | ~act_np).all())
            else:
                cand, covered = rs[ri](xssW, ussW, Kss, kss, JsW, dV1,
                                       dV2, lamsW, lamTsW, rhosW, wssW,
                                       cand, activeW)
                _stat("roll_lanes", W * slice_w[ri + 1])
            depth += 1
        out = a(xssW, ussW, JsW, regsW, wssW, activeW, cand, qu_inf, bp_ok)
        return out, depth

    def _rung_alpha_idx(ai_np, r):
        """Per-lane candidate order: backtrack from the remembered index
        (``ai, ai+1, ...``) down to alpha_min, then the untried larger
        alphas (``ai-1, ..., 0``): the candidate set equals the grid."""
        return np.where(ai_np + r < n_alpha, ai_np + r,
                        n_alpha - 1 - r).astype(np.int64)

    def _run_cascade_adaptive(W, xssW, ussW, JsW, regsW, lamsW, lamTsW,
                              rhosW, activeW, wssW, ai_np):
        """One per-lane-alpha iteration at phase width ``W``: ONE alpha a
        lane a rung (the lane's start index first, then per-lane
        backtracking), with the slice cascade's rung-level compaction.
        Returns the ``ls_apply`` output, the rungs rolled, and each
        lane's accepted alpha index (-1 where every candidate
        rejected)."""
        p, r_at, a = _width_entry(W)
        act_np = _np(activeW)
        ais_0 = np.clip(ai_np, 0, n_alpha - 1).astype(np.int64)
        (Kss, kss, dV1, dV2, qu_inf, bp_ok, cand,
         covered) = p(xssW, ussW, JsW, regsW, lamsW, lamTsW, rhosW,
                      activeW, wssW, as_idx(ais_0))
        _stat("sweep_lanes", W)
        _stat("roll_lanes", W)
        acc_np = _np(cand[3]).copy()
        ai_acc = np.where(acc_np & act_np, ais_0, -1)
        depth = 1
        for r in range(1, n_alpha):
            if bool(covered):
                break
            todo = np.flatnonzero(act_np & ~acc_np)
            if todo.size == 0:
                break
            ais_r = _rung_alpha_idx(ais_0, r)
            Wr = _bucket_below(W, todo.size)
            if Wr < W:
                idx_np = np.resize(todo, Wr)
                idx = as_idx(idx_np)
                (xr, ur, Kr, kr, Jr, d1r, d2r, lamr, lamTr, rhor,
                 wr) = gather(idx, xssW, ussW, Kss, kss, JsW, dV1, dV2,
                              lamsW, lamTsW, rhosW, wssW)
                cand_r = gather(idx, *cand)
                rung_w = _width_entry(Wr)[1]
                cand_r, _ = rung_w(xr, ur, Kr, kr, Jr, d1r, d2r, lamr,
                                   lamTr, rhor, wr, cand_r, ones(Wr),
                                   as_idx(ais_r[idx_np]))
                _stat("roll_lanes", Wr)
                cand = scatter(idx, cand, cand_r)
                acc_r = _np(cand_r[3])
                newly = acc_r & (ai_acc[idx_np] < 0)
                ai_acc[idx_np[newly]] = ais_r[idx_np[newly]]
                acc_np[idx_np] = acc_r
                covered = bool((acc_np | ~act_np).all())
            else:
                cand, covered = r_at(xssW, ussW, Kss, kss, JsW, dV1, dV2,
                                     lamsW, lamTsW, rhosW, wssW, cand,
                                     activeW, as_idx(ais_r))
                _stat("roll_lanes", W)
                acc_new = _np(cand[3]).copy()
                newly = acc_new & ~acc_np
                ai_acc[newly] = ais_r[newly]
                acc_np = acc_new
            depth += 1
        out = a(xssW, ussW, JsW, regsW, wssW, activeW, cand, qu_inf, bp_ok)
        return out, depth, ai_acc

    def _remember(ai_acc):
        """``alpha_memory``'s next start index: one notch back toward 1.0
        after an accept, 1.0 after a rejection."""
        return np.where(ai_acc >= 0, np.maximum(ai_acc - 1, 0), 0)

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

    def _budget(max_iter_round):
        return (opts.max_iter if max_iter_round is None
                else min(int(max_iter_round), opts.max_iter))

    def inner_chunked(xss, uss, wss, lams, lamTs, rhos, act_al, its,
                      gnorms, max_iter_round=None):
        """The inner loop at k iterations a call (``iters_per_dispatch``
        > 1); the round's budget rides into every chunk."""
        Js = traj_cost(xss, uss, lams, lamTs, rhos)
        regs = torch.full((B,), opts.reg_init, dtype=dtype, device=device)
        active = torch.as_tensor(act_al, device=device)
        rit = torch.zeros(B, dtype=torch.int32, device=device)
        budget = _budget(max_iter_round)
        for chunk in range((budget + k - 1) // k):
            (xss, uss, Js, regs, wss, active, its, gnorms,
             rit) = scan(xss, uss, Js, regs, lams, lamTs, rhos, active,
                         wss, its, gnorms, rit, budget)
            n_active = int(active.sum())
            if log is not None:
                log("  inner chunk=%d (k=%d) J=%.6g active=%d/%d"
                    % (chunk, k, float(Js.min()), n_active, B))
            if n_active == 0:
                break
        return xss, uss, wss, Js, its, gnorms

    n_rungs = (n_alpha if (adaptive or adaptive_dev)
               else 1 + len(ph.ls_rungs) if cascade else None)

    def inner(xss, uss, wss, lams, lamTs, rhos, act_al, its, gnorms,
              ai_state=None, max_iter_round=None):
        """One AL round's inner iterations for the lanes in ``act_al``
        (numpy bool); ``ai_state`` the per-lane alpha start indices of
        the per-lane paths (numpy on the host path, ``{"ais": tensor}``
        on the device path), kept across AL rounds and updated in place;
        ``max_iter_round`` the round's inner budget."""
        if scan is not None:
            return inner_chunked(xss, uss, wss, lams, lamTs, rhos, act_al,
                                 its, gnorms, max_iter_round)
        Js = traj_cost(xss, uss, lams, lamTs, rhos)
        regs = torch.full((B,), opts.reg_init, dtype=dtype, device=device)
        done = ~act_al
        its_inc = np.zeros(B, np.int64)
        depth_counts = [0] * n_rungs if n_rungs else None
        for it in range(_budget(max_iter_round)):
            act_idx = np.flatnonzero(~done)
            if act_idx.size == 0:
                break
            W = B
            if cascade:
                for w in sorted(buckets):
                    if act_idx.size <= w:
                        W = w
                        break
            if W < B:
                # compacted iteration: gather the active lanes (cyclically
                # padded to the bucket width) into width-W phases
                idx_np = np.resize(act_idx, W)
                idx = as_idx(idx_np)
                (xb, ub, Jb, rb, lamb, lamTb, rhob, wb) = gather(
                    idx, xss, uss, Js, regs, lams, lamTs, rhos, wss)
                if adaptive_dev:
                    out = _width_entry(W)[0](
                        xb, ub, Jb, rb, lamb, lamTb, rhob, ones(W), wb,
                        torch.index_select(ai_state["ais"], 0, idx))
                    out, ai_b, depth = out[:8], out[8], out[9]
                    ai_state["ais"] = ai_state["ais"].index_put((idx,),
                                                                ai_b)
                elif adaptive:
                    out, depth, ai_acc_b = _run_cascade_adaptive(
                        W, xb, ub, Jb, rb, lamb, lamTb, rhob, ones(W), wb,
                        ai_state[idx_np])
                    if alpha_memory:
                        ai_state[idx_np] = _remember(ai_acc_b)
                else:
                    out, depth = _run_cascade(W, xb, ub, Jb, rb, lamb,
                                              lamTb, rhob, ones(W), wb)
                xb, ub, Jb, rb, wb, nd_b, qu_b, _ = out
                xss, uss, Js, regs, wss, gnorms = scatter(
                    idx, (xss, uss, Js, regs, wss, gnorms),
                    (xb, ub, Jb, rb, wb, qu_b))
                nd = np.zeros(B, bool)
                nd[idx_np] = _np(nd_b)
            else:
                active = torch.as_tensor(~done, device=device)
                if adaptive_dev:
                    out = _width_entry(B)[0](xss, uss, Js, regs, lams,
                                             lamTs, rhos, active, wss,
                                             ai_state["ais"])
                    out, ai_state["ais"], depth = out[:8], out[8], out[9]
                elif adaptive:
                    out, depth, ai_acc = _run_cascade_adaptive(
                        B, xss, uss, Js, regs, lams, lamTs, rhos, active,
                        wss, ai_state)
                    if alpha_memory:
                        ai_state[~done] = _remember(ai_acc[~done])
                elif cascade:
                    out, depth = _run_cascade(B, xss, uss, Js, regs, lams,
                                              lamTs, rhos, active, wss)
                else:                    # full grid, one call
                    out = iter_full(xss, uss, Js, regs, lams, lamTs, rhos,
                                    active, wss)
                    _stat("sweep_lanes", B)
                    _stat("roll_lanes", B * n_alpha)
                xss, uss, Js, regs, wss, newly_done, qu_inf, _ = out
                gnorms = torch.where(active, qu_inf, gnorms)
                nd = _np(newly_done)
            if adaptive_dev:
                _stat("sweep_lanes", W)
                _stat("roll_lanes", W * (1 + depth))
                depth_counts[min(depth, n_rungs) - 1] += 1
            elif cascade:
                depth_counts[depth - 1] += 1
            _stat("inner_iters")
            its_inc[~done] += 1
            done = done | nd
            if log is not None:
                log("  inner it=%d J=%.6g done=%d/%d W=%d depth=%s"
                    % (it, float(Js.min()), int(done.sum()), B, W,
                       depth_counts))
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
        # per-lane alpha: every lane starts at alpha = 1.0 on the host path
        # and at index 1 in the device path's memory; both persist across
        # the AL rounds of this solve
        ai_state = (np.zeros(B, np.int64) if adaptive
                    else {"ais": torch.ones(B, dtype=torch.int64,
                                            device=device)}
                    if adaptive_dev else None)

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
                    ai_state, mir)
                vio_n, lams, lamTs, rhos = al_round(xss, uss, lams, lamTs,
                                                    rhos, act)
                vio_new = np.where(act_np, _np(vio_n), vio)
                if al_stall_rounds > 0 and np.isfinite(opts.rho_max):
                    rho_capped = _np(rhos) >= 0.99 * opts.rho_max
                    with np.errstate(divide="ignore", invalid="ignore"):
                        rate = vio_new / np.maximum(vio, 1e-300)
                        need = np.where(
                            rate < al_stall_improve,
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
                gnorms, ai_state)
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


def solve_segmented(prob: ILQRProblem, x0s: torch.Tensor,
                    us_init: torch.Tensor,
                    opts: ILQROptions = ILQROptions(), **kw) -> ILQRResult:
    """One-shot wrapper over ``make_segmented_solver`` on ``x0s``'s device
    and dtype; ``kw`` are its options (``log``, ``compact``, ...)."""
    solve = make_segmented_solver(prob, opts, x0s.shape[0], x0s.dtype,
                                  x0s.device, **kw)
    return solve(x0s, us_init)
