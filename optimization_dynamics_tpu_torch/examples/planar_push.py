"""Planar pushing: translate or rotate a box with a point pusher.

Port of ``optimization_dynamics_tpu/examples/planar_push.py``: h=0.1,
T=26, kappa_eval=1e-4, kappa_grad=1e-2, control box |u| <= 5 (four
inequality rows a stage), terminal equality on the block pose of both
configurations, max_iter=10 / max_al_iter=10. ``gradient_bundle=True``
swaps the IFT Jacobians for the sampled gradient bundle
(``solver/gradient_bundle.py``; N=50, eps=1e-4, the reference's): each
timestep's draws are fixed once, from a numpy seed, or passed in. A
bundle derivative sweep is one IP solve per lane and sample, (T-1)(N+1)
= 1,275 cold eval solves in one launch of K1n's group kernel on the
card.

``build_deploy_problem`` is the deploy tier, solved lane-batched by
``solver.ilqr_segmented.make_segmented_solver``: on a CUDA device every
IP solve runs in the fused IP kernel at nz=35 (K1n) in float32 at the
accelerator IP settings, and every IFT solve in the batched QR kernel at
(35, 13) (K2); on the CPU the kernels' plain versions run in float64.
Run it on the card with

    python -m optimization_dynamics_tpu_torch.examples.planar_push \\
        --deploy --batch 256 [--mode translate|rotate] [--dtype f32|f64]

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs the plain versions. The deploy
scenarios translate the whole scene (block and pusher) rigidly, so the
contact geometry stays feasible while the reach-the-goal problem varies;
the executor settings are the reference bench's (no inner-budget
schedule, ``al_stall_rounds=2``).

Without ``--deploy`` the script runs the reference's ``main``: the
translate and the rotate problem (``build_problem``) solved by the scalar
AL-iLQR ``solver.ilqr.solve`` in float64, line-search rollouts
warm-started step by step from the accepted trajectory's solver
variables. On the card each rollout step runs K1n at width 1 and each
derivative sweep K1n at width T-1 = 25 with its IFT solves in K2 at (35,
13). With ``--gradient-bundle`` it solves the translate problem with the
gradient bundle's Jacobians instead, the draws from ``--seed`` or from
``--gb-draws FILE.npz`` (arrays ``coords`` and ``mags``, (T-1, N)).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import planar_push as pp
from optimization_dynamics_tpu_torch.solver.gradient_bundle import (
    make_gradient_bundle,
)
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

H = 0.1
T = 26
NX = 2 * pp.NQ
NU = pp.NU
R = pp.R_DIM
# the deploy executor's straggler policy of the reference bench
DEPLOY_AL_STALL_ROUNDS = 2
# the deploy IP settings of the reference's accelerator branch (float32
# floor) and of its CPU branch
DEPLOY_IP_ACCEL = dict(r_tol=3.0e-5, kappa_tol=1.0e-3, max_iter=40, max_ls=8)
DEPLOY_IP_CPU = dict(r_tol=1.0e-8, kappa_tol=1.0e-3, max_iter=40, max_ls=8)
U_LIM = 5.0
TERMINAL_SEL = (0, 1, 2, 5, 6, 7)   # block pose of both configurations
GB_SAMPLES = 50                     # the gradient bundle's, reference :79
GB_EPS = 1.0e-4


def build_problem(mode: str = "rotate", gradient_bundle: bool = False,
                  device="cuda", dtype=torch.float64, gb_seed: int = 0,
                  gb_draws=None):
    """Returns (prob, x0, us_init, opts). ``mode``: "translate" | "rotate".
    The problem carries the scalar dynamics for ``solver.ilqr.solve``
    (steps warm-started from the accepted trajectory's solver variables
    at the same timestep) and the lane-batched ones (cold solves).

    ``gradient_bundle``: the Jacobians come from the gradient bundle,
    with each timestep's draws ``(coords, mags)`` (T-1, N) either
    ``gb_draws`` (arrays or tensors) or drawn once from numpy seed
    ``gb_seed``."""
    device = torch.device(device)
    aux = pp.PlanarPushAux(h=H)
    dyn = make_implicit_dynamics(
        pp.model(), device, dtype, r_tol=1.0e-8, kappa_eval_tol=1.0e-4,
        kappa_grad_tol=1.0e-2)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)

    if mode == "translate":
        q0 = [0.0, 0.0, 0.0, -R - 1.0e-8, 0.0]
        xg, yg, tg = 1.0, 0.0, 0.0
    else:
        q0 = [0.0, 0.0, 0.0, -R - 1.0e-8, -0.01]
        xg, yg, tg = 0.5, 0.5, 0.5 * math.pi
    qT = [xg, yg, tg, xg - R, yg - R]
    xT = t(qT + qT)
    x0 = t(q0 + q0)

    vw = t([1.0, 1.0, 1.0, 0.1, 0.1])
    xw = t([1.0, 1.0, 1.0, 0.1, 0.1] * 2)
    uw = 1.0e-1 if mode == "translate" else 1.0e-2

    # explicit sums in the dot products' order (``cartpole.build_problem``
    # says why)
    def stage_cost(t_, x, u):
        v1 = (x[5:] - x[:5]) / H
        dx = x - xT
        return (torch.sum(0.5 * v1 * (vw * v1))
                + torch.sum(0.5 * dx * (xw * dx))
                + torch.sum(0.5 * uw * u * u))

    def terminal_cost(x):
        v1 = (x[5:] - x[:5]) / H
        dx = x - xT
        return (torch.sum(0.5 * v1 * (vw * v1))
                + torch.sum(0.5 * dx * (xw * dx)))

    def stage_con(t_, x, u):
        return torch.cat([-U_LIM - u, u - U_LIM])

    sel = torch.tensor(TERMINAL_SEL, device=device)

    def terminal_con(x):
        return (x - xT)[sel]

    if gradient_bundle:
        gb = make_gradient_bundle(dyn, n_samples=GB_SAMPLES, eps=GB_EPS)
        if gb_draws is None:
            gb_draws = gb.sample(np.random.default_rng(gb_seed), (T - 1,))
        coords = torch.as_tensor(gb_draws[0], dtype=torch.int64,
                                 device=device)
        mags = torch.as_tensor(gb_draws[1], dtype=dtype, device=device)

        def dynamics_jac(t_, x, u):
            return gb.gb_jac(x, u, aux, (coords[t_], mags[t_]))

        def dynamics_jac_batched(ts, xs, us):
            return gb.gb_jac_batched(xs, us, aux, (coords[ts], mags[ts]))
    else:
        def dynamics_jac(t_, x, u):
            return dyn.step_jac(x, u, aux)

        def dynamics_jac_batched(ts, xs, us):
            return dyn.step_jac_batched(xs, us, aux)

    prob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=2 * NU, nconT=len(TERMINAL_SEL),
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        stage_con=stage_con,
        terminal_con=terminal_con,
        ineq_mask=torch.ones((T - 1, 2 * NU), dtype=torch.bool,
                             device=device),
        dynamics=lambda t_, x, u: dyn.step(x, u, aux),
        dynamics_jac=dynamics_jac,
        dynamics_ws=lambda t_, x, u, z: dyn.step_carry(z, x, u, aux),
        ws_init=lambda t_, x, u: dyn.carry_init(x),
        dynamics_batched=lambda t_, xs, us: dyn.step_batched(xs, us, aux),
        dynamics_jac_batched=dynamics_jac_batched,
    )

    opts = ILQROptions(
        alpha_min=1.0e-5,
        obj_tol=1.0e-3,
        grad_tol=1.0e-3,
        max_iter=10,
        max_al_iter=10,
        con_tol=0.005,
        rho_init=1.0,
        rho_scale=10.0,
    )

    # the reference's warm start: push forward for the first steps
    u0 = torch.zeros((T - 1, NU), dtype=dtype, device=device)
    u0[:4, 0] = 1.0
    if mode != "translate":
        u0[4:9, 0] = 0.5
    return prob, x0, u0, opts


def build_deploy_problem(device, mode: str = "translate", dtype=None,
                         ip_overrides: dict | None = None):
    """The deploy-tier problem. Returns ``(prob, x0, us_init, opts)``.

    The reference's policy: line-search rollouts run cold, the derivative
    sweep warm-starts from the accepted trajectory's own eval solution. A
    CUDA device takes the reference's accelerator branch (float32 and
    ``DEPLOY_IP_ACCEL``), the CPU its CPU branch (float64 and
    ``DEPLOY_IP_CPU``); either way the lane-batched solves go through the
    fused IP kernel's wrapper, which runs the plain version on the CPU.
    Both cap the AL penalty at 1e6, relax con_tol to 0.01 and use an
    8-candidate Armijo grid. ``ip_overrides`` replaces IP options (e.g.
    the accelerator settings on the CPU)."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    if dtype is None:
        dtype = torch.float32 if on_gpu else torch.float64
    prob, x0, us0, opts = build_problem(mode, device=device, dtype=dtype)
    aux = pp.PlanarPushAux(h=H)
    ip = dict(DEPLOY_IP_ACCEL if on_gpu else DEPLOY_IP_CPU)
    if ip_overrides:
        ip.update(ip_overrides)
    dyn = make_implicit_dynamics(
        pp.model(), device, dtype,
        eval_opts=IPOptions(**ip),
        grad_opts=IPOptions(**ip))
    prob = prob._replace(
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
        dynamics_batched=lambda t_, xs, us: dyn.step_batched(xs, us, aux),
        dynamics_batched_ws=lambda t_, xs, us, ws: dyn.step_batched_ws(
            xs, us, aux, ws),
        dynamics_jac_batched_ws=lambda ts, xs, us, wss:
            dyn.step_jac_batched_ws(xs, us, aux, wss),
        ws_init_batched=lambda t_, xs, us: dyn.carry_init(xs),
        ws_linesearch=False)
    opts = dataclasses.replace(opts, con_tol=0.01, rho_max=1.0e6,
                               alpha_min=1.0e-2)
    return prob, x0, us0, opts


def deploy_x0s(x0: torch.Tensor, B: int, seed: int = 0) -> torch.Tensor:
    """The deploy scenarios: the whole scene translated rigidly by
    ``delta = 0.02 N(0, 1)`` (B, 2) from a numpy seed, added to the block
    and pusher x (indices 0, 3, 5, 8) and y (1, 4, 6, 9) of both
    configurations."""
    delta = 0.02 * np.random.default_rng(seed).standard_normal((B, 2))
    shift = np.zeros((B, NX))
    for i in (0, 1):
        for j in (i, i + 3, i + 5, i + 8):
            shift[:, j] += delta[:, i]
    return x0[None] + torch.as_tensor(shift, dtype=x0.dtype,
                                      device=x0.device)


def run(mode: str = "rotate", gradient_bundle: bool = False, device="cuda",
        dtype=torch.float64):
    """The reference's ``run``: ``build_problem`` solved by the scalar
    ``solve``. Returns ``(prob, result)``."""
    prob, x0, us_init, opts = build_problem(mode, gradient_bundle,
                                            device=device, dtype=dtype)
    return prob, solve(prob, x0, us_init, opts)


def main_scalar(modes, device, dtype=torch.float64,
                gradient_bundle: bool = False, gb_seed: int = 0,
                gb_draws=None):
    """The reference's ``main``: each mode by the scalar ``solve``,
    printed with its wall and its K1 and K2 launches. Returns the last
    result."""
    for mode in modes:
        prob, x0, us0, opts = build_problem(
            mode, gradient_bundle, device=device, dtype=dtype,
            gb_seed=gb_seed, gb_draws=gb_draws)
        res, wall, launches = scalar_solve(prob, x0, us0, opts)
        print(f"[{mode}] converged: {bool(res.converged)}"
              f" obj: {float(res.objective):.4f}"
              f" iters: {int(res.iterations)}"
              f" al: {int(res.al_iterations)}"
              f" vio: {float(res.constraint_violation):.2e}")
        print("  final block pose:",
              np.round(res.xs[-1][5:8].cpu().numpy(), 4))
        print("[%s] device=%s dtype=%s gradient_bundle=%s wall %.3f s "
              "launches %s" % (mode, device, dtype, gradient_bundle, wall,
                               launches))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deploy", action="store_true",
                    help="run the lane-batched deploy solve (default: the "
                         "scalar solves of the reference's main)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mode", choices=("translate", "rotate"),
                    default=None,
                    help="default: translate with --deploy, both without")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="default: f32 on a CUDA device with --deploy, "
                         "else f64")
    ap.add_argument("--gradient-bundle", action="store_true",
                    help="solve the translate problem with the gradient "
                         "bundle's Jacobians (scalar solve only)")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the deploy scenarios or of the "
                         "gradient bundle's draws")
    ap.add_argument("--gb-draws", metavar="FILE.npz",
                    help="with --gradient-bundle: the draws, arrays "
                         "coords and mags (T-1, N) (such as the "
                         "reference's jax.random ones, saved on the CPU)")
    args = ap.parse_args(argv)
    if args.gradient_bundle and (args.deploy or args.mode == "rotate"):
        ap.error("--gradient-bundle solves the scalar translate problem")
    if args.gb_draws and not args.gradient_bundle:
        ap.error("--gb-draws needs --gradient-bundle")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("planar_push: no CUDA device; pass --device cpu to "
                         "run the plain versions on the CPU")
    dtype = {None: None, "f32": torch.float32,
             "f64": torch.float64}[args.dtype]

    if args.gradient_bundle:
        draws = None
        if args.gb_draws:
            with np.load(args.gb_draws) as f:
                draws = (f["coords"], f["mags"])
        return main_scalar(("translate",), device, dtype or torch.float64,
                           gradient_bundle=True, gb_seed=args.seed,
                           gb_draws=draws)
    if not args.deploy:
        return main_scalar((args.mode,) if args.mode
                           else ("translate", "rotate"), device,
                           dtype or torch.float64)
    mode = args.mode or "translate"
    prob, x0, us0, opts = build_deploy_problem(device, mode, dtype=dtype)
    B = args.batch
    x0s = deploy_x0s(x0, B, args.seed)
    solve_b = make_segmented_solver(
        prob, opts, B, x0.dtype, device,
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
    print("device=%s dtype=%s batch=%d mode=%s"
          % (device, x0.dtype, B, mode))
    print("converged %d/%d (%.4f)" % (n_conv, B, n_conv / B))
    print("mean converged objective %.6f, median %.6f" % (mean_obj, med_obj))
    print("wall %.3f s, %.4f converged solves/s" % (wall, n_conv / wall))
    print("mean inner iterations %.2f, AL rounds %d"
          % (float(res.iterations.float().mean()),
             int(res.al_iterations[0])))
    print("final block pose (lane 0) %s"
          % np.round(res.xs[0, -1, 5:8].cpu().numpy(), 4).tolist())
    print("stats %s" % dict(solve_b.stats))
    return res


if __name__ == "__main__":
    main()
