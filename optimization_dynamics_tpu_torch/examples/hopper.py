"""Hopper gait generation with a co-optimized initial state.

Port of ``optimization_dynamics_tpu/examples/hopper.py`` (the reference's
``hopper.jl``): the initial configurations (q1, q2) are decision
variables carried in the first control (u_1 = [u; q1; q2]) and the state
is augmented to carry theta = (q1, q2) through the horizon for the
terminal periodicity constraint:

  * t = 0: y = [step(theta, u[0:2]); theta] with theta = u[2:10];
  * t >= 1: y = [step(x[0:8], u[0:2]); x[8:16]], theta copied through;
  * terminal: gait periodicity x[1:4], x[5:8] against theta, and travel
    x[0] - theta[0] >= 0.5.

Every stage is padded to NX=16, NU=10; the control mask is ragged (all
10 controls on step 0, the two real ones after), and the stage cost and
constraints branch on ``t == 0``. The port's phases call the stage
functions under ``torch.func.vmap`` with a tensor ``t`` (or with a Python
int), so the branches are ``torch.where`` on a tensor ``t``, never
Python control flow on its value. The dynamics
unify the two branches as the reference's deploy tier does: both solve
``step(x8_eff, u[0:2])`` with ``x8_eff = where(t == 0, u[2:10],
x[0:8])``, so one batched IP solve serves a derivative sweep whose rows
have mixed t, and the first-step and pass-through Jacobian blocks are
assembled per row. A rollout hands ``t`` as a Python int, a sweep as a
(B (T-1),) tensor.

The hopper model's device functor (``ops/kernels/csrc/hopper.cuh``)
puts every IP solve of the deploy, the rollouts' and the sweeps', whole
in the fused IP kernel (K1): its 32-thread tile kernel up to its width
cut, its per-thread kernel above. The IFT solves go through the batched
QR kernel (K2) at (20, 13), one 64-thread block a system;
``--riccati-kernel`` runs each backward pass as K3 at (nx, nu) = (16,
10). The reference's deploy runs ``make_solver_batched``, which is K1's
plain version. Run the deploy solve on the card with

    python -m optimization_dynamics_tpu_torch.examples.hopper \\
        --deploy --batch 256 [--gait 1|2|3] [--dtype f32|f64] \\
        [--riccati-kernel]

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs the plain versions. The executor
settings are the reference bench's hopper cell (per-AL-round inner
budgets, two stalled AL rounds). The scenarios are ``x0 + 0.005 N(0, 1)``
from a numpy seed (the reference bench draws them from ``jax.random``).

Without ``--deploy`` the script runs the reference's ``main``: the gait
(``--gait``) from the reference's initial guess (``build_problem``)
solved by the scalar AL-iLQR ``solver.ilqr.solve`` in float64, whose
scalar dynamics are the unified lane-batched member on a batch of one.
On the card each rollout step runs K1 (``hopper``) at width 1 and each
derivative sweep K1 at width T-1 = 20 with its IFT solves in K2 at (20,
13).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import hopper as hp
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    solve,
)
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions
from optimization_dynamics_tpu_torch.utils.measure import scalar_solve

H = 0.05
T = 21
NQ = hp.NQ           # 4
NXS = 2 * NQ         # small state (the step's input)
NX = 4 * NQ          # padded state: [q1; q2; theta (8)]
NUS = hp.NU          # 2
NU = NUS + 2 * NQ    # padded control: [u; q1 theta; q2 theta]
NCON = 12
NCONT = 8

GAIT_COSTS = {1: (1.0e-1, 1.0e-1), 2: (1.0, 1.0), 3: (1.0e-3, 1.0e-1)}
# the deploy executor settings of the reference bench's hopper cell
DEPLOY_MAX_ITER_SCHEDULE = (15, 15, 25, 25, 30)
DEPLOY_AL_STALL_ROUNDS = 2
# the deploy IP settings of the reference's accelerator branch (float32
# floor) and of its CPU branch (the reference tolerances)
DEPLOY_IP_ACCEL = dict(r_tol=3.0e-5, kappa_tol=1.0e-3, max_iter=40, max_ls=8)
DEPLOY_IP_CPU = dict(r_tol=1.0e-8, kappa_eval_tol=1.0e-4,
                     kappa_grad_tol=1.0e-3)
X_TRAVEL = 0.5


def _select(first, a, b):
    """``a`` where ``first`` (t == 0) else ``b``. ``first`` is a Python
    bool where ``t`` was a Python int (a rollout's step, a constraint
    check), else a bool tensor: (B,) for a sweep's rows, picking lane by
    lane, or 0-dim for a stage function under ``torch.func.vmap``, where
    the pick has to be ``torch.where``."""
    if isinstance(first, bool):
        return a if first else b
    return torch.where(first.reshape(first.shape + (1,) * (a.ndim - 1)),
                       a, b)


def _x8_eff(t, xs, us):
    """The step's input ``where(t == 0, u[2:10], x[0:8])`` and the
    first-step flag (a bool for an int t, a (B,) tensor otherwise)."""
    first = t == 0
    return _select(first, us[:, 2:10], xs[:, 0:8]), first


def _assemble_y(first, ys8, xs, us):
    return torch.cat([ys8, _select(first, us[:, 2:10], xs[:, 8:16])], dim=1)


def _assemble_jac(first, ys8, fx8, fu8, xs, us):
    """(ys, fxs, fus) of the padded program from the step's (8, 8) and
    (8, 2) Jacobians: after the first step ``fx = [[fx8, 0], [0, I]]``,
    ``fu = [[fu8, 0], [0, 0]]``; on the first step ``fx = 0`` and the
    step's input is theta = u[2:10], so ``fu = [[fu8, fx8], [0, I]]``.
    ``first`` is the sweep's (B,) flags."""
    B = xs.shape[0]
    f = first[:, None, None]
    eye8 = torch.eye(NXS, dtype=xs.dtype, device=xs.device).expand(B, -1, -1)
    fx = xs.new_zeros((B, NX, NX))
    fx[:, 0:8, 0:8] = torch.where(f, 0.0, fx8)
    fx[:, 8:16, 8:16] = torch.where(f, 0.0, eye8)
    fu = xs.new_zeros((B, NX, NU))
    fu[:, 0:8, 0:2] = fu8
    fu[:, 0:8, 2:10] = torch.where(f, fx8, 0.0)
    fu[:, 8:16, 2:10] = torch.where(f, eye8, 0.0)
    return _assemble_y(first, ys8, xs, us), fx, fu


def _wire(prob: ILQRProblem, dyn, aux, warm: bool) -> ILQRProblem:
    """The problem with the unified first-step dynamics over ``dyn``:
    cold members (the scalar ones are the lane-batched ones on a batch of
    one), and with ``warm`` the warm-start members and the cold
    line-search policy (``ws_linesearch=False``)."""
    def dynamics_batched(t, xs, us):
        x8, first = _x8_eff(t, xs, us)
        return _assemble_y(first, dyn.step_batched(x8, us[:, 0:2], aux),
                           xs, us)

    def dynamics_jac_batched(ts, xs, us):
        x8, first = _x8_eff(ts, xs, us)
        return _assemble_jac(first, *dyn.step_jac_batched(
            x8, us[:, 0:2], aux), xs, us)

    def dynamics_jac(t, x, u):
        ts = torch.as_tensor(t, device=x.device).reshape(1)
        return tuple(a[0] for a in dynamics_jac_batched(ts, x[None],
                                                        u[None]))

    prob = prob._replace(
        dynamics=lambda t, x, u: dynamics_batched(t, x[None], u[None])[0],
        dynamics_jac=dynamics_jac,
        dynamics_batched=dynamics_batched,
        dynamics_jac_batched=dynamics_jac_batched)
    if not warm:
        return prob

    def dynamics_batched_ws(t, xs, us, ws):
        x8, first = _x8_eff(t, xs, us)
        ys8, zs = dyn.step_batched_ws(x8, us[:, 0:2], aux, ws)
        return _assemble_y(first, ys8, xs, us), zs

    def dynamics_jac_batched_ws(ts, xs, us, wss):
        x8, first = _x8_eff(ts, xs, us)
        ys8, fx8, fu8, zs = dyn.step_jac_batched_ws(x8, us[:, 0:2], aux,
                                                    wss)
        return (*_assemble_jac(first, ys8, fx8, fu8, xs, us), zs)

    def ws_init_batched(t, xs, us):
        return dyn.carry_init(_x8_eff(t, xs, us)[0])

    return prob._replace(dynamics_batched_ws=dynamics_batched_ws,
                         dynamics_jac_batched_ws=dynamics_jac_batched_ws,
                         ws_init_batched=ws_init_batched,
                         ws_linesearch=False)


def control_mask(device) -> torch.Tensor:
    """The ragged ``u_mask`` (T-1, NU): every control on the first step,
    the two real ones after."""
    u_mask = torch.zeros((T - 1, NU), dtype=torch.bool, device=device)
    u_mask[:, 0:NUS] = True
    u_mask[0] = True
    return u_mask


def build_problem(gait: int = 1, device="cuda", dtype=torch.float64):
    """Returns (prob, x0, us_init, opts) of the gait at the reference
    tolerances; the problem carries the unified dynamics, scalar and
    lane-batched (cold solves)."""
    device = torch.device(device)
    params = hp.HopperParams()
    aux = hp.HopperAux(h=H)
    dyn = make_implicit_dynamics(hp.model(params), device, dtype,
                                 r_tol=1.0e-8, kappa_eval_tol=1.0e-4,
                                 kappa_grad_tol=1.0e-3)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    q1 = t([0.0, 0.5 + params.foot_radius, 0.0, 0.5])
    q_ref = t([0.5, 0.75 + params.foot_radius, 0.0, 0.25])
    x1_small = torch.cat([q1, q1])
    x_ref = torch.cat([q_ref, q_ref])
    r_cost, q_cost = GAIT_COSTS[gait]
    w8 = t([1.0, 10.0, 1.0, 10.0, 1.0, 10.0, 1.0, 10.0])
    uw = t([r_cost] * 2 + [1.0e-1] * 4 + [1.0e-5] * 4)
    kf = lambda q: hp.kinematics_foot(params, q)
    foot1_ref, foot2_ref = kf(x1_small[0:4]), kf(x1_small[4:8])
    u_lim = 10.0

    # explicit sums in the dot products' order (``cartpole.build_problem``
    # says why)
    def stage_cost(t, x, u):
        dx = x[0:8] - x_ref
        first = (torch.sum(0.5 * dx * (w8 * dx))
                 + torch.sum(0.5 * u * (uw * u)))
        u2 = u[0:2]
        rest = (torch.sum(0.5 * q_cost * dx * (w8 * dx))
                + torch.sum(0.5 * r_cost * u2 * u2))
        return _select(t == 0, first, rest)

    def terminal_cost(x):
        dx = x[0:8] - x_ref
        return torch.sum(0.5 * dx * dx)

    # 12 padded stage rows: 0:4 the control box (inequalities, every
    # stage); on the first stage 4:8 pin u's q1 to x1's, 8:12 the foot
    # positions of u's q1 and q2 to x1's (equalities)
    def stage_con(t, x, u):
        u2 = u[0:2]
        box = torch.cat([-u_lim - u2, u2 - u_lim])
        q1t, q2t = u[2:6], u[6:10]
        first = torch.cat([q1t - x1_small[0:4], kf(q1t) - foot1_ref,
                           kf(q2t) - foot2_ref])
        return torch.cat([box, _select(t == 0, first,
                                       torch.zeros_like(first))])

    def terminal_con(x):
        theta = x[8:16]
        return torch.cat([
            torch.stack([X_TRAVEL - (x[0] - theta[0]),
                         X_TRAVEL - (x[4] - theta[4])]),
            x[1:4] - theta[1:4],
            x[5:8] - theta[5:8],
        ])

    ineq = torch.zeros((T - 1, NCON), dtype=torch.bool, device=device)
    ineq[:, 0:4] = True
    ineqT = torch.zeros(NCONT, dtype=torch.bool, device=device)
    ineqT[0:2] = True
    prob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=NCON, nconT=NCONT,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        stage_con=stage_con,
        terminal_con=terminal_con,
        ineq_mask=ineq,
        terminal_ineq_mask=ineqT,
        u_mask=control_mask(device),
    )
    opts = ILQROptions(
        alpha_min=1.0e-5,
        obj_tol=1.0e-3,
        grad_tol=1.0e-3,
        max_iter=10,
        max_al_iter=15,
        con_tol=0.001,
        rho_init=1.0,
        rho_scale=10.0,
    )
    u_stand = params.gravity * params.mass_body * 0.5 * H
    us0 = torch.zeros((T - 1, NU), dtype=dtype, device=device)
    us0[:, 1] = u_stand
    us0[0, 2:10] = x1_small
    x0 = torch.cat([x1_small, x1_small.new_zeros(8)])
    return _wire(prob, dyn, aux, warm=False), x0, us0, opts


def build_deploy_problem(device, gait: int = 1, dtype=None,
                         accelerator_ip: bool | None = None):
    """The deploy-tier gait problem, wired for the segmented executor.
    Returns ``(prob, x0, us_init, opts)``.

    The reference's policy: line-search rollouts run cold, the derivative
    sweep warm-starts from the accepted trajectory's own eval solution
    (``ws_linesearch=False``). A CUDA device takes the reference's
    accelerator branch: float32, ``DEPLOY_IP_ACCEL`` for both solvers and
    the AL options ``con_tol=0.01``, ``rho_max=1e6``, ``alpha_min=1e-2``.
    The CPU takes float64 and the reference tolerances
    (``DEPLOY_IP_CPU``) with ``build_problem``'s options;
    ``accelerator_ip`` picks the branch explicitly (the accelerator
    settings on the CPU, for parity checks)."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    if dtype is None:
        dtype = torch.float32 if on_gpu else torch.float64
    if accelerator_ip is None:
        accelerator_ip = on_gpu
    prob, x0, us0, opts = build_problem(gait, device=device, dtype=dtype)
    if accelerator_ip:
        ip = IPOptions(**DEPLOY_IP_ACCEL)
        dyn = make_implicit_dynamics(hp.model(), device, dtype,
                                     eval_opts=ip, grad_opts=ip)
        opts = dataclasses.replace(opts, con_tol=0.01, rho_max=1.0e6,
                                   alpha_min=1.0e-2)
    else:
        dyn = make_implicit_dynamics(hp.model(), device, dtype,
                                     **DEPLOY_IP_CPU)
    prob = _wire(prob, dyn, hp.HopperAux(h=H), warm=True)
    if prob.ws_linesearch:
        raise AssertionError("the hopper deploy runs cold line-search "
                             "rollouts")
    return prob, x0, us0, opts


def deploy_x0s(x0: torch.Tensor, B: int, seed: int = 0) -> torch.Tensor:
    """The deploy scenarios: ``x0 + 0.005 N(0, 1)`` from a numpy seed."""
    noise = np.random.default_rng(seed).standard_normal((B, x0.shape[0]))
    return x0[None] + 0.005 * torch.as_tensor(noise, dtype=x0.dtype,
                                              device=x0.device)


def gait_errors(xT: torch.Tensor):
    """``(travel, periodicity)`` of final states (B, 16): travel ``x[0] -
    theta[0]`` (the goal is >= 0.5) and the largest periodicity error
    ``|x[1:4] - theta[1:4]|``, ``|x[5:8] - theta[5:8]|``."""
    theta = xT[:, 8:16]
    per = torch.cat([xT[:, 1:4] - theta[:, 1:4], xT[:, 5:8] - theta[:, 5:8]],
                    dim=1).abs().amax(dim=1)
    return xT[:, 0] - theta[:, 0], per


def run(gait: int = 1, device="cuda", dtype=torch.float64):
    """The reference's ``run``: ``build_problem`` solved by the scalar
    ``solve``. Returns ``(prob, result)``."""
    prob, x0, us_init, opts = build_problem(gait, device=device, dtype=dtype)
    return prob, solve(prob, x0, us_init, opts)


def main_scalar(gait, device, dtype=torch.float64):
    """The reference's ``main``: the gait by the scalar ``solve``, printed
    with its wall and its K1 and K2 launches."""
    prob, x0, us0, opts = build_problem(gait, device=device, dtype=dtype)
    res, wall, launches = scalar_solve(prob, x0, us0, opts)
    travel, per = (float(a[0]) for a in gait_errors(res.xs[-1][None]))
    print("converged:", bool(res.converged),
          "obj:", round(float(res.objective), 4),
          "iters:", int(res.iterations), "al:", int(res.al_iterations),
          "vio: %.2e" % float(res.constraint_violation))
    print("travel:", round(travel, 4), "(>= 0.5)")
    print("periodicity err:", per)
    print("device=%s dtype=%s gait=%d wall %.3f s launches %s"
          % (device, dtype, gait, wall, launches))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deploy", action="store_true",
                    help="run the lane-batched deploy solve (default: the "
                         "scalar solve of the reference's main)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--gait", type=int, choices=sorted(GAIT_COSTS),
                    default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="default: f32 on a CUDA device with --deploy, "
                         "else f64")
    ap.add_argument("--riccati-kernel", action="store_true",
                    help="with --deploy: the backward pass in one K3 "
                         "launch")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hopper: no CUDA device; pass --device cpu to "
                         "run the plain versions on the CPU")
    dtype = {None: None, "f32": torch.float32,
             "f64": torch.float64}[args.dtype]

    if args.riccati_kernel and not args.deploy:
        ap.error("--riccati-kernel needs --deploy")
    if not args.deploy:
        return main_scalar(args.gait, device, dtype or torch.float64)
    prob, x0, us0, opts = build_deploy_problem(device, gait=args.gait,
                                               dtype=dtype)
    B = args.batch
    x0s = deploy_x0s(x0, B, args.seed)
    opts = dataclasses.replace(opts, riccati_kernel=args.riccati_kernel)
    solve_b = make_segmented_solver(
        prob, opts, B, x0.dtype, device,
        max_iter_schedule=DEPLOY_MAX_ITER_SCHEDULE,
        al_stall_rounds=DEPLOY_AL_STALL_ROUNDS)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve,
    )
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip,
    )
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward,
    )
    if device.type == "cuda":
        from optimization_dynamics_tpu_torch.ops.kernels._build import (
            load_library,
        )
        load_library()          # build the kernels before the clock
        torch.cuda.synchronize()
    for c in (fused_ip, batched_solve, riccati_backward):
        c.launches = c.tile_launches = 0
        c.widths.clear()
    t0 = time.perf_counter()
    res = solve_b(x0s, us0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    travel, per = (a.cpu().numpy() for a in gait_errors(res.xs[:, -1]))
    n_conv = int(conv.sum())
    on = lambda a: float(a[conv].mean()) if n_conv else float("nan")
    print("device=%s dtype=%s batch=%d gait=%d riccati_kernel=%s"
          % (device, x0.dtype, B, args.gait, opts.riccati_kernel))
    print("converged %d/%d (%.4f)" % (n_conv, B, n_conv / B))
    print("mean converged objective %.6f" % on(obj))
    print("converged lanes: travel min %.6f mean %.6f (>= %.1f), "
          "periodicity max %.3e"
          % (float(travel[conv].min()) if n_conv else float("nan"),
             on(travel), X_TRAVEL,
             float(per[conv].max()) if n_conv else float("nan")))
    print("wall %.3f s, %.4f converged solves/s" % (wall, n_conv / wall))
    print("mean inner iterations %.2f, AL rounds %d"
          % (float(res.iterations.float().mean()),
             int(res.al_iterations.max())))
    print("K1 launches %d (tile %d) by (kernel, width) %s"
          % (fused_ip.launches, fused_ip.tile_launches,
             dict(sorted(fused_ip.widths.items()))))
    print("K2 launches %d by (kernel, width) %s"
          % (batched_solve.launches, dict(sorted(batched_solve.widths
                                                 .items()))))
    print("K3 launches %d by (kernel, width) %s"
          % (riccati_backward.launches,
             dict(sorted(riccati_backward.widths.items()))))
    print("stats %s" % dict(solve_b.stats))
    return res


if __name__ == "__main__":
    main()
