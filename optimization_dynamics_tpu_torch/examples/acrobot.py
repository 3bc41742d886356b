"""Acrobot swing-up with hard elbow joint limits.

Port of ``optimization_dynamics_tpu/examples/acrobot.py``: h=0.05, T=101,
kappa_eval=1e-4, kappa_grad=1e-3, velocity and effort costs, terminal
equality constraint x = [pi, 0, pi, 0], AL options con_tol=0.001. The
initial controls are ``1e-3 N(0, 1)`` from a numpy seed (the reference
draws them from ``jax.random``).

``build_deploy_problem`` is the deploy tier, solved lane-batched by
``solver.ilqr_segmented.make_segmented_solver``: on a CUDA device every
IP solve of the joint-limit model runs in the fused IP kernel at nz=6
(K1a) in float32 at the accelerator IP settings, and every IFT solve in
the batched QR kernel at (6, 6) (K2); on the CPU the kernels' plain
versions run in float64. Run it on the card with

    python -m optimization_dynamics_tpu_torch.examples.acrobot \\
        --deploy --batch 256 [--dtype f32|f64]

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs the plain versions. The executor
settings are the reference bench's (per-AL-round inner budgets, the
straggler policy).

Without ``--deploy`` the script runs the reference's ``main``: the
swing-up from rest (``build_problem``, ``--mode impact|nominal``) solved
by the scalar AL-iLQR ``solver.ilqr.solve`` in float64, its line-search
rollouts warm-started step by step from the accepted trajectory's solver
variables. On the card each rollout step runs K1a at width 1 and each
derivative sweep K1a at width T-1 = 100 with its IFT solves in K2 at (6,
6) (the nominal model, without a functor, K2 at (2, 1) and (2, 6)).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import acrobot
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
T = 101
NX = 2 * acrobot.NQ
NU = acrobot.NU
# the deploy executor settings of the reference bench: per-AL-round inner
# budgets and the straggler policy
DEPLOY_MAX_ITER_SCHEDULE = (15, 15, 25, 25, 30)
DEPLOY_AL_STALL_ROUNDS = 1
# the deploy IP settings of the reference's accelerator branch (float32
# floor) and of its CPU branch; the accelerator branch adds the one-stage
# kappa continuation unless it is switched off
DEPLOY_IP_ACCEL = dict(r_tol=3.0e-5, kappa_tol=1.0e-3, max_iter=40, max_ls=8)
DEPLOY_KAPPA_SCHEDULE = dict(kappa_scale=0.01, kappa_init_max=0.3,
                             center_frac=0.2)
DEPLOY_IP_CPU = dict(r_tol=1.0e-8, kappa_tol=1.0e-3, max_iter=40, max_ls=8)


def build_problem(mode: str = "impact", kappa_grad: float = 1.0e-3,
                  device="cuda", dtype=torch.float64, seed: int = 1):
    """Returns (prob, x0, us_init, opts). ``mode``: "impact" | "nominal".
    The problem carries the scalar dynamics for ``solver.ilqr.solve``
    (steps warm-started from the accepted trajectory's solver variables
    at the same timestep) and the lane-batched ones (cold solves)."""
    device = torch.device(device)
    aux = acrobot.AcrobotAux(h=H)
    if mode == "impact":
        model = acrobot.impact_model()
        kappa_eval = 1.0e-4
    else:
        model = acrobot.nominal_model()
        kappa_eval = kappa_grad = 1.0
    dyn = make_implicit_dynamics(
        model, device, dtype, r_tol=1.0e-8, kappa_eval_tol=kappa_eval,
        kappa_grad_tol=kappa_grad)

    xT = torch.tensor([math.pi, 0.0, math.pi, 0.0], dtype=dtype,
                      device=device)

    def velocity_cost(x):
        v1 = (x[2:] - x[:2]) / H
        return torch.sum(0.5 * 0.1 * v1 * v1)

    # explicit sums in the dot products' order (``cartpole.build_problem``
    # says why)
    def stage_cost(t, x, u):
        return velocity_cost(x) + torch.sum(0.5 * u * u)

    prob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=0, nconT=NX,
        stage_cost=stage_cost,
        terminal_cost=velocity_cost,
        terminal_con=lambda x: x - xT,
        dynamics=lambda t, x, u: dyn.step(x, u, aux),
        dynamics_jac=lambda t, x, u: dyn.step_jac(x, u, aux),
        dynamics_ws=lambda t, x, u, z: dyn.step_carry(z, x, u, aux),
        ws_init=lambda t, x, u: dyn.carry_init(x),
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
    )

    opts = ILQROptions(
        alpha_min=1.0e-5,
        obj_tol=1.0e-5,
        grad_tol=1.0e-5,
        max_iter=50,
        max_al_iter=20,
        con_tol=0.001,
        rho_init=1.0,
        rho_scale=10.0,
    )

    x0 = torch.zeros(NX, dtype=dtype, device=device)
    noise = np.random.default_rng(seed).standard_normal((T - 1, NU))
    us_init = torch.as_tensor(1.0e-3 * noise, dtype=dtype, device=device)
    return prob, x0, us_init, opts


def build_deploy_problem(device, dtype=None, one_stage_kappa: bool = True,
                         accelerator_ip: bool | None = None):
    """The deploy-tier problem (joint limits). Returns ``(prob, x0,
    us_init, opts)``.

    The reference's policy: line-search rollouts run cold, the derivative
    sweep warm-starts from the accepted trajectory's own eval solution. A
    CUDA device takes the reference's accelerator branch: float32,
    ``DEPLOY_IP_ACCEL`` and, with ``one_stage_kappa``, the one-stage
    kappa continuation ``DEPLOY_KAPPA_SCHEDULE``. The CPU takes float64
    and ``DEPLOY_IP_CPU``; ``accelerator_ip`` picks the branch
    explicitly (the accelerator settings on the CPU, for parity
    checks). Either way the lane-batched solves go through the fused IP
    kernel's wrapper, which runs the plain version on the CPU. Both cap
    the AL penalty at 1e6, relax con_tol to 0.01 and grad_tol to 1e-3 and
    use an 8-candidate Armijo grid."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    if dtype is None:
        dtype = torch.float32 if on_gpu else torch.float64
    if accelerator_ip is None:
        accelerator_ip = on_gpu
    prob, x0, us0, opts = build_problem("impact", device=device, dtype=dtype)
    aux = acrobot.AcrobotAux(h=H)
    if accelerator_ip:
        ip = dict(DEPLOY_IP_ACCEL)
        if one_stage_kappa:
            ip.update(DEPLOY_KAPPA_SCHEDULE)
    else:
        ip = dict(DEPLOY_IP_CPU)
    dyn = make_implicit_dynamics(
        acrobot.impact_model(), device, dtype,
        eval_opts=IPOptions(**ip),
        grad_opts=IPOptions(**ip))
    prob = prob._replace(
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        dynamics_batched_ws=lambda t, xs, us, ws: dyn.step_batched_ws(
            xs, us, aux, ws),
        dynamics_jac_batched_ws=lambda ts, xs, us, wss:
            dyn.step_jac_batched_ws(xs, us, aux, wss),
        ws_init_batched=lambda t, xs, us: dyn.carry_init(xs),
        ws_linesearch=False)
    opts = dataclasses.replace(opts, con_tol=0.01, rho_max=1.0e6,
                               alpha_min=1.0e-2, grad_tol=1.0e-3)
    return prob, x0, us0, opts


def deploy_x0s(x0: torch.Tensor, B: int, seed: int = 0) -> torch.Tensor:
    """The deploy scenarios: ``x0 + 0.01 N(0, 1)`` from a numpy seed."""
    noise = np.random.default_rng(seed).standard_normal((B, x0.shape[0]))
    return x0[None] + 0.01 * torch.as_tensor(noise, dtype=x0.dtype,
                                             device=x0.device)


def envelope_draws(B: int, seed: int):
    """States and torques over the swing-up envelope, from a numpy seed:
    shoulder angle pi N(0, 1), elbow uniform in [-1.7, 1.7] (some lanes
    start past the pi/2 limits, so the limit rows are active), q0 = q1 -
    0.05 N(0, 1), u = 3 N(0, 1). Returns numpy ``(q0, q1, u)``."""
    rng = np.random.default_rng(seed)
    q1 = np.stack([np.pi * rng.standard_normal(B),
                   rng.uniform(-1.7, 1.7, B)], axis=1)
    q0 = q1 - 0.05 * rng.standard_normal((B, 2))
    u = 3.0 * rng.standard_normal((B, 1))
    return q0, q1, u


def envelope_batch(B: int, seed: int, device, dtype):
    """Cold impact-model IP solves over ``envelope_draws``: returns
    ``(model, z0s, thetas)`` packed for the fused IP solver."""
    q0, q1, u = (torch.as_tensor(a, dtype=dtype, device=device)
                 for a in envelope_draws(B, seed))
    model = acrobot.impact_model()
    return model, model.init_z(q1), model.theta_fn(
        q0, q1, u, acrobot.AcrobotAux(h=H))


def run(mode: str = "impact", device="cuda", dtype=torch.float64):
    """The reference's ``run``: ``build_problem`` solved by the scalar
    ``solve``. Returns ``(prob, result)``."""
    prob, x0, us_init, opts = build_problem(mode, device=device, dtype=dtype)
    return prob, solve(prob, x0, us_init, opts)


def main_scalar(mode, device, dtype=torch.float64, us_init=None):
    """The reference's ``main``: the swing-up by the scalar ``solve``,
    printed with its wall and its K1 and K2 launches. ``us_init``: the
    initial controls (T-1, 1) in place of ``build_problem``'s."""
    prob, x0, us0, opts = build_problem(mode, device=device, dtype=dtype)
    if us_init is not None:
        us0 = torch.as_tensor(us_init, dtype=dtype, device=device)
    res, wall, launches = scalar_solve(prob, x0, us0, opts)
    xT = np.array([math.pi, 0.0, math.pi, 0.0])
    print("iterations:", int(res.iterations),
          "al_iterations:", int(res.al_iterations))
    print("objective:", float(res.objective))
    print("AL objective:", float(res.al_objective))
    print("terminal violation:",
          float(np.max(np.abs(res.xs[-1].cpu().numpy() - xT))))
    print("converged:", bool(res.converged))
    print("max |elbow angle|: %.9f (limit pi/2 = %.9f)"
          % (float(res.xs[:, 3].abs().max()), 0.5 * math.pi))
    print("device=%s dtype=%s mode=%s wall %.3f s launches %s"
          % (device, dtype, mode, wall, launches))
    from optimization_dynamics_tpu_torch.dynamics import (
        state_to_configuration)
    from optimization_dynamics_tpu_torch.utils.viz import maybe_visualize
    maybe_visualize("acrobot", state_to_configuration(res.xs), dt=H)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deploy", action="store_true",
                    help="run the lane-batched deploy solve (default: the "
                         "scalar solve of the reference's main)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mode", choices=("impact", "nominal"),
                    default="impact",
                    help="without --deploy: the model of the scalar solve")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="default: f32 on a CUDA device with --deploy, "
                         "else f64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--us-init", default=None,
                    help="without --deploy: a .npy file of initial "
                         "controls (T-1, 1), for example the reference "
                         "example's")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("acrobot: no CUDA device; pass --device cpu to "
                         "run the plain versions on the CPU")
    dtype = {None: None, "f32": torch.float32,
             "f64": torch.float64}[args.dtype]

    if not args.deploy:
        return main_scalar(args.mode, device, dtype or torch.float64,
                           args.us_init and np.load(args.us_init))
    prob, x0, us0, opts = build_deploy_problem(device, dtype=dtype)
    B = args.batch
    x0s = deploy_x0s(x0, B, args.seed)
    solve_b = make_segmented_solver(
        prob, opts, B, x0.dtype, device,
        max_iter_schedule=DEPLOY_MAX_ITER_SCHEDULE,
        al_stall_rounds=DEPLOY_AL_STALL_ROUNDS)
    if device.type == "cuda":
        from optimization_dynamics_tpu_torch.ops.kernels._build import (
            load_library,
        )
        load_library()          # build the kernels before the clock
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_b(x0s, us0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    n_conv = int(conv.sum())
    mean_obj = float(obj[conv].mean()) if n_conv else float("nan")
    med_obj = float(np.median(obj[conv])) if n_conv else float("nan")
    print("device=%s dtype=%s batch=%d mode=impact" % (device, x0.dtype, B))
    print("converged %d/%d (%.4f)" % (n_conv, B, n_conv / B))
    print("mean converged objective %.6f, median %.6f" % (mean_obj, med_obj))
    print("wall %.3f s, %.4f converged solves/s" % (wall, n_conv / wall))
    print("mean inner iterations %.2f, AL rounds %d"
          % (float(res.iterations.float().mean()),
             int(res.al_iterations.max())))
    print("max |elbow angle| %.6f (limit pi/2 = %.6f)"
          % (float(res.xs[..., 3].abs().max()), 0.5 * math.pi))
    print("stats %s" % dict(solve_b.stats))
    return res


if __name__ == "__main__":
    main()
