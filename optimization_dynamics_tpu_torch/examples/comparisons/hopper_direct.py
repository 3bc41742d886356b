"""Comparison: hopper gait by direct contact-implicit transcription.

Port of ``optimization_dynamics_tpu/examples/comparisons/hopper_direct.py``,
the baseline the paper argues against: the contact forces gamma (4),
friction beta (4), psi (2), eta (4) and the complementarity slack
s_alpha are decision variables with complementarity inequality rows, and
the whole gait is one NLP, solved by the dense AL Gauss-Newton solver
(``solver/direct.py``) at the reference's tolerances.

Decision vector per stage t = 1..T-1 (21 variables a stage):
    [q3_t (4), u_t (2), gamma_t (4), beta_t (4), psi_t (2), eta_t (4),
     s_alpha_t (1)]
States chain through configurations: (q1, q2) fixed at t=0; q3_t is the
next stage's q2. The stage functions act on all stages at once (stage
first); the defect's Lagrangian derivatives are ``torch.func.grad`` of
``models/hopper.py::lagrangian``. A Gauss-Newton iteration is a dense
420 x 420 solve with the forward-mode Jacobians of 163 equality and 621
inequality rows. Run it on the card with

    python -m optimization_dynamics_tpu_torch.examples.comparisons.hopper_direct

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.func import grad

from optimization_dynamics_tpu_torch.models import hopper as hp
from optimization_dynamics_tpu_torch.solver.direct import (
    DirectOptions,
    DirectProblem,
    solve_direct,
)

H = 0.05
T = 21
NQ = hp.NQ
NW_STAGE = NQ + 2 + 4 + 4 + 2 + 4 + 1    # 21


def _split_stage(ws):
    """(q3, u, gamma, beta, psi, eta, s_alpha) of stage rows (S, 21)."""
    return (ws[:, 0:4], ws[:, 4:6], ws[:, 6:10], ws[:, 10:14],
            ws[:, 14:16], ws[:, 16:20], ws[:, 20])


def build_problem(params: hp.HopperParams = hp.HopperParams(),
                  device="cuda", dtype=torch.float64):
    """Returns ``(prob, w0, opts)``: the NLP, its standing warm start and
    the reference's solver options."""
    device = torch.device(device)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    q_init = t([0.0, 0.5 + params.foot_radius, 0.0, 0.5])
    q_ref = t([0.5, 0.75 + params.foot_radius, 0.0, 0.25])

    # stages are independent, so the gradient of the summed Lagrangian is
    # each stage's own
    lag = lambda q, v: hp.lagrangian(params, q, v).sum()
    d1l, d2l = grad(lag, argnums=0), grad(lag, argnums=1)
    e_theta = t([0.0, 0.0, 1.0, 0.0])

    def dynamics_defect(q1, q2, q3, u, gam, beta):
        """The variational integrator with explicit contact forces."""
        qm1, vm1 = 0.5 * (q1 + q2), (q2 - q1) / H
        qm2, vm2 = 0.5 * (q2 + q3), (q3 - q2) / H
        J = hp.contact_jacobian(params, q3)          # (S, 6, 4)
        b_body = beta[:, 0] - beta[:, 1]
        b_foot = beta[:, 2] - beta[:, 3]
        JT = J.transpose(1, 2)
        lam = (JT[:, :, 0:2] @ torch.stack([b_body, gam[:, 0]], 1)[..., None]
               + JT[:, :, 2:4] @ torch.stack([b_foot, gam[:, 1]], 1)[..., None]
               )[..., 0] + J[:, 4] * gam[:, 2:3] + J[:, 5] * gam[:, 3:4]
        lam = lam + params.body_radius * b_body[:, None] * e_theta
        return (0.5 * H * d1l(qm1, vm1) + d2l(qm1, vm1)
                + 0.5 * H * d1l(qm2, vm2) - d2l(qm2, vm2)
                + hp.control_force(u) + lam)

    n = (T - 1) * NW_STAGE

    def stages(w):
        return w.reshape(T - 1, NW_STAGE)

    def config_chain(w):
        """(q1_t, q2_t, q3_t) of each stage."""
        q3s = stages(w)[:, 0:4]
        q2s = torch.cat([q_init[None], q3s[:-1]], 0)
        q1s = torch.cat([q_init[None], q2s[:-1]], 0)
        return q1s, q2s, q3s

    w8 = t([1.0, 10.0, 1.0, 10.0, 1.0, 10.0, 1.0, 10.0])
    r_cost, q_cost = 1.0e-1, 1.0e-1

    def objective(w):
        q1s, q2s, q3s = config_chain(w)
        dx = torch.cat([q2s, q3s], 1) - torch.cat([q_ref, q_ref])
        s_alphas = stages(w)[:, 20]
        us = stages(w)[:, 4:6]
        return (0.5 * q_cost * torch.sum(dx * (w8 * dx))
                + 0.5 * r_cost * torch.sum(us * us)
                + 1000.0 * torch.sum(s_alphas))

    mu = t([params.friction_body, params.friction_foot])

    def stage_eq(q1, q2, ws):
        q3, u, gam, beta, psi, eta, s_alpha = _split_stage(ws)
        defect = dynamics_defect(q1, q2, q3, u, gam, beta)
        v = (q3 - q2) / H
        vt_body = v[:, 0] + params.body_radius * v[:, 2]
        vt_foot = torch.func.jvp(lambda q: hp.kinematics_foot(params, q),
                                 (q3,), (v,))[1][:, 0]
        vT = torch.stack([vt_body, -vt_body, vt_foot, -vt_foot], 1)
        psi_stack = psi[:, [0, 0, 1, 1]]
        return torch.cat([defect, eta - vT - psi_stack], 1)

    def stage_ineq(q1, q2, ws):
        q3, u, gam, beta, psi, eta, s_alpha = _split_stage(ws)
        phi = hp.signed_distance(params, q3)
        fc = mu * gam[:, 0:2] - torch.stack([beta[:, 0] + beta[:, 1],
                                             beta[:, 2] + beta[:, 3]], 1)
        s = s_alpha[:, None]
        return torch.cat([
            -phi,                        # contact separation >= 0
            -fc,                         # friction cone slack >= 0
            -gam, -beta, -psi, -eta,     # nonnegativity
            -s,
            beta * eta - s,              # complementarity (relaxed)
            psi * fc - s,
            gam * phi - s,
        ], 1)

    x_travel = 0.5

    def eq_con(w):
        q1s, q2s, q3s = config_chain(w)
        rows = stage_eq(q1s, q2s, stages(w))
        # gait terminal: body height, attitude and leg return to the start
        terminal = q3s[-1, 1:4] - q_init[1:4]
        return torch.cat([rows.reshape(-1), terminal])

    def ineq_con(w):
        q1s, q2s, q3s = config_chain(w)
        rows = stage_ineq(q1s, q2s, stages(w))
        travel = x_travel - q3s[-1, 0:1]          # travel >= 0.5
        return torch.cat([rows.reshape(-1), travel])

    prob = DirectProblem(n=n, objective=objective, eq_con=eq_con,
                         ineq_con=ineq_con)
    opts = DirectOptions(con_tol=1.0e-2, grad_tol=1.0e-4,
                         max_iter=50, max_al_iter=8)

    # standing warm start with small positive contact variables
    w0 = torch.zeros((T - 1, NW_STAGE), dtype=dtype, device=device)
    w0[:, 0:4] = q_init
    w0[:, 5] = params.gravity * params.mass_body * 0.5 * H
    w0[:, 6:20] = 0.1
    w0[:, 20] = 0.1
    return prob, w0.reshape(-1), opts


def run(device="cuda", dtype=torch.float64):
    """The reference's ``run``: ``(prob, result)``."""
    prob, w0, opts = build_problem(device=device, dtype=dtype)
    return prob, solve_direct(prob, w0, opts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hopper_direct: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    t0 = time.perf_counter()
    prob, res = run(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = res.w.reshape(T - 1, NW_STAGE).cpu().numpy()
    print("converged:", bool(res.converged),
          "obj:", round(float(res.objective), 4),
          "vio: %.2e" % res.constraint_violation,
          "iters:", res.iterations, "al:", res.al_iterations)
    print("final config:", np.round(w[-1, 0:4], 4))
    print("complementarity slack sum:", float(np.sum(w[:, 20])))
    print("device=%s wall %.3f s" % (device, wall))
    return res


if __name__ == "__main__":
    main()
