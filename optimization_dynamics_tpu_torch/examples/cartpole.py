"""Cartpole swing-up with joint friction.

Port of ``optimization_dynamics_tpu/examples/cartpole.py``: h=0.05, T=51,
friction [0.35, 0.35], kappa_eval=1e-4, kappa_grad=1e-3, effort stage
cost, terminal goal cost + equality constraint, con_tol=0.005.

``build_deploy_problem`` is the deploy tier, solved lane-batched by
``solver.ilqr_segmented.make_segmented_solver``: on a CUDA device it runs
the fused IP kernel in float32 at the accelerator IP settings; on the CPU
it runs the kernel's plain version in float64. Run it on the card with

    python -m optimization_dynamics_tpu_torch.examples.cartpole \\
        --deploy --batch 512 [--fused-rollout] [--riccati-kernel]

``--fused-rollout`` runs every rollout as one K4 launch and
``--riccati-kernel`` the backward pass as one K3 launch; both are off by
default. ``--device`` defaults to ``cuda`` and the script stops if there
is no CUDA device; ``--device cpu`` runs the plain versions.

Without ``--deploy`` the script runs the reference's ``main``: the
frictionless and the friction swing-up from rest (``build_problem``),
each solved by the scalar AL-iLQR ``solver.ilqr.solve`` in float64. On
the card each rollout step runs K1 at width 1 (the frictionless model,
which has no device functor, K2 at (2, 1)) and each derivative sweep K1
at width T-1 = 50 with its IFT solves in K2 at (10, 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import cartpole
from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
    make_fused_rollout,
)
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    solve,
)
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils.measure import scalar_solve

H = 0.05
T = 51
NX = 2 * cartpole.NQ
NU = cartpole.NU
# the deploy executor settings of the reference bench: per-AL-round inner
# budgets and the straggler policy
DEPLOY_MAX_ITER_SCHEDULE = (15, 15, 25, 25, 30)
DEPLOY_AL_STALL_ROUNDS = 1
# the deploy IP settings of the reference's accelerator branch: tolerances
# at the float32 floor and a one-stage kappa continuation; the CPU branch
# keeps r_tol 1e-8 and the default schedule
DEPLOY_IP_ACCEL = dict(r_tol=3.0e-5, kappa_tol=1.0e-3, max_iter=40, max_ls=8,
                       kappa_scale=0.01, kappa_init_max=0.3, center_frac=0.2)
DEPLOY_IP_CPU = dict(r_tol=1.0e-8, kappa_tol=1.0e-3, max_iter=40, max_ls=8)


def build_problem(mode: str = "friction", friction=(0.35, 0.35),
                  device="cuda", dtype=torch.float64):
    """Returns (prob, x0, us_init, opts). ``mode``: "friction" |
    "frictionless". The problem carries the scalar dynamics for
    ``solver.ilqr.solve`` (its open-loop rollout threads each step's
    solver variables into the next, its line-search rollouts start cold)
    and the lane-batched ones (cold solves)."""
    device = torch.device(device)
    if mode == "friction":
        model = cartpole.friction_model()
        aux = cartpole.CartpoleAux(
            h=H, friction=torch.tensor(friction, dtype=dtype, device=device))
        kappa_eval, kappa_grad = 1.0e-4, 1.0e-3
    else:
        model = cartpole.frictionless_model()
        aux = cartpole.CartpoleAux(h=H, friction=None)
        kappa_eval = kappa_grad = 1.0
    dyn = make_implicit_dynamics(
        model, device, dtype, r_tol=1.0e-8, kappa_eval_tol=kappa_eval,
        kappa_grad_tol=kappa_grad)

    xT = torch.tensor([0.0, math.pi, 0.0, math.pi], dtype=dtype,
                      device=device)

    def stage_cost(t, x, u):
        return u @ u

    def terminal_cost(x):
        return (x - xT) @ (x - xT)

    prob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=0, nconT=NX,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        terminal_con=lambda x: x - xT,
        dynamics=lambda t, x, u: dyn.step(x, u, aux),
        dynamics_jac=lambda t, x, u: dyn.step_jac(x, u, aux),
        dynamics_carry=lambda t, x, u, z: dyn.step_carry(z, x, u, aux),
        carry_init=dyn.carry_init,
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
    )

    opts = ILQROptions(
        alpha_min=1.0e-5,
        obj_tol=1.0e-5,
        grad_tol=1.0e-3,
        max_iter=100,
        max_al_iter=20,
        con_tol=0.005,
        rho_init=1.0,
        rho_scale=10.0,
    )

    x0 = torch.zeros(NX, dtype=dtype, device=device)
    us_init = torch.zeros((T - 1, NU), dtype=dtype, device=device)
    us_init[0, 0] = -1.5
    return prob, x0, us_init, opts


def build_deploy_problem(device, dtype=None, friction=(0.35, 0.35),
                         ip_overrides: dict | None = None,
                         fused_rollout: bool = False):
    """The deploy-tier problem. Returns ``(prob, x0, us_init, opts)``.

    Policy (the reference's, bisected on the TPU): line-search rollouts
    run COLD (warm-starting them flips complementarity branches on the
    knife-edge friction-0.35 swing-up), the derivative sweep warm-starts
    from the accepted trajectory's own eval solution. A CUDA device takes
    the reference's accelerator branch: float32 and ``DEPLOY_IP_ACCEL``.
    The CPU takes float64 and ``DEPLOY_IP_CPU``. Either way the
    lane-batched solves go through the fused IP kernel's wrapper, which
    runs the plain version on the CPU. Both cap the AL penalty at 1e6,
    relax con_tol to 0.01 and use an 8-candidate Armijo grid.
    ``ip_overrides`` replaces IP options (e.g. the accelerator settings
    on the CPU). ``fused_rollout`` sets ``prob.rollout_fused`` to K4,
    built with the eval IP options and ``prob.u_mask`` (all controls
    active here), so every rollout is one launch."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    if dtype is None:
        dtype = torch.float32 if on_gpu else torch.float64
    prob, x0, us0, opts = build_problem("friction", device=device,
                                        dtype=dtype)
    model = cartpole.friction_model()
    aux = cartpole.CartpoleAux(
        h=H, friction=torch.tensor(friction, dtype=dtype, device=device))
    ip = dict(DEPLOY_IP_ACCEL if on_gpu else DEPLOY_IP_CPU)
    if ip_overrides:
        ip.update(ip_overrides)
    dyn = make_implicit_dynamics(
        model, device, dtype,
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
    if fused_rollout:
        prob = prob._replace(rollout_fused=make_fused_rollout(
            model, IPOptions(**ip), aux, T, prob.u_mask, device, dtype))
    opts = dataclasses.replace(opts, con_tol=0.01, rho_max=1.0e6,
                               alpha_min=1.0e-2)
    return prob, x0, us0, opts


def deploy_x0s(x0: torch.Tensor, B: int, seed: int = 0) -> torch.Tensor:
    """The deploy scenarios: ``x0 + 0.01 N(0, 1)`` from a numpy seed."""
    noise = np.random.default_rng(seed).standard_normal((B, x0.shape[0]))
    return x0[None] + 0.01 * torch.as_tensor(noise, dtype=x0.dtype,
                                             device=x0.device)


def run(mode: str = "friction", friction=(0.35, 0.35), device="cuda",
        dtype=torch.float64):
    """The reference's ``run``: ``build_problem`` solved by the scalar
    ``solve``. Returns ``(prob, result)``."""
    prob, x0, us_init, opts = build_problem(mode, friction, device, dtype)
    return prob, solve(prob, x0, us_init, opts)


def main_scalar(device, dtype=torch.float64):
    """The reference's ``main``: both swing-ups by the scalar ``solve``,
    each printed with its wall and its K1 and K2 launches. Returns the
    friction swing-up's result."""
    xT = np.array([0.0, math.pi, 0.0, math.pi])
    for mode in ("frictionless", "friction"):
        prob, x0, us0, opts = build_problem(mode, device=device,
                                            dtype=dtype)
        res, wall, launches = scalar_solve(prob, x0, us0, opts)
        print(f"[{mode}] converged: {bool(res.converged)}"
              f" obj: {float(res.objective):.4f}"
              f" iters: {int(res.iterations)}"
              f" al: {int(res.al_iterations)}"
              f" |xT - goal|inf: "
              f"{float(np.max(np.abs(res.xs[-1].cpu().numpy() - xT))):.2e}")
        print("[%s] device=%s dtype=%s wall %.3f s launches %s"
              % (mode, device, dtype, wall, launches))
    return res


def visualize_solution(res):
    """The reference's hook: an HTML player and a PNG of the solution in
    ``$ODX_VIZ_DIR`` when that is set (``utils/viz.py``)."""
    from optimization_dynamics_tpu_torch.dynamics import (
        state_to_configuration)
    from optimization_dynamics_tpu_torch.utils.viz import maybe_visualize
    return maybe_visualize("cartpole", state_to_configuration(res.xs), dt=H)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deploy", action="store_true",
                    help="run the lane-batched deploy solve (default: the "
                         "scalar solves of the reference's main)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="default: f32 on a CUDA device with --deploy, "
                         "else f64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-rollout", action="store_true",
                    help="with --deploy: every rollout in one K4 launch")
    ap.add_argument("--riccati-kernel", action="store_true",
                    help="with --deploy: the backward pass in one K3 launch")
    args = ap.parse_args(argv)
    if (args.fused_rollout or args.riccati_kernel) and not args.deploy:
        ap.error("--fused-rollout and --riccati-kernel need --deploy")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cartpole: no CUDA device; pass --device cpu to "
                         "run the plain versions on the CPU")
    dtype = {None: None, "f32": torch.float32,
             "f64": torch.float64}[args.dtype]

    if not args.deploy:
        return main_scalar(device, dtype or torch.float64)
    prob, x0, us0, opts = build_deploy_problem(
        device, dtype=dtype, fused_rollout=args.fused_rollout)
    opts = dataclasses.replace(opts, riccati_kernel=args.riccati_kernel)
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
    print("device=%s dtype=%s batch=%d fused_rollout=%s riccati_kernel=%s"
          % (device, x0.dtype, B, prob.rollout_fused is not None,
             opts.riccati_kernel))
    print("converged %d/%d (%.4f)" % (n_conv, B, n_conv / B))
    print("mean converged objective %.6f" % mean_obj)
    print("wall %.3f s, %.4f converged solves/s" % (wall, n_conv / wall))
    print("mean inner iterations %.2f, AL rounds %d"
          % (float(res.iterations.float().mean()),
             int(res.al_iterations[0])))
    print("stats %s" % dict(solve_b.stats))
    return res


if __name__ == "__main__":
    main()
