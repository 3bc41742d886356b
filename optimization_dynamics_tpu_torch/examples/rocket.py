"""Rocket soft landing with thrust-cone limits.

Port of ``optimization_dynamics_tpu/examples/rocket.py``: h=0.05, T=61,
u_max=12.5, initial tilt RotZ(pi/4) RotY(-pi/2) at (2.5, 2.5, 10) falling
at 1 m/s, goal upright at the pad. Two modes:

  * "projection": the thrust cone enforced inside the dynamics by the
    differentiable SOC projection (``models/rocket.py``);
  * "nominal": the thrust limits as iLQR box inequality constraints.

The initial controls are ``1e-3 N(0, 1)`` from numpy seed 1 (the
reference draws them from ``jax.random``).

``build_deploy_problem`` is the deploy tier, solved lane-batched by
``solver.ilqr_segmented.make_segmented_solver``: every step chains two
IP solves, the cold thrust projection (nz=10), whole in the fused IP
kernel (K1, its ``rocket_projection`` functor; its IFT solves in the
batched QR kernel, K2, at (10, 4)), and the warm-startable
implicit-midpoint solve (nz=12) through ``make_solver_batched``, whose
Newton and IFT solves run in K2 at (12, 1) and (12, 16). On a CUDA
device it runs in float32 at
the reference's accelerator settings; on the CPU the plain versions run
in float64. Run it on the card with

    python -m optimization_dynamics_tpu_torch.examples.rocket \\
        --deploy --batch 256 [--dtype f32|f64] [--mode projection|nominal]

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs the plain versions. The executor
settings are the reference bench's rocket cell (per-AL-round inner
budgets, two stalled AL rounds, compaction). The scenarios scatter the
initial position by 0.1 N(0, 1) and the velocity by 0.05 N(0, 1), the
attitude kept, from a numpy seed. ``--batch 16`` is the reference
bench's own width.

Without ``--deploy`` the script runs the reference's ``main``: the
landing (``build_problem``) solved by the scalar AL-iLQR
``solver.ilqr.solve`` in float64, each step the scalar ``step`` (the
lane-batched members on a batch of one): on the card K1
(``rocket_projection``) at width 1 and the midpoint solve's Newton steps
in K2 at (12, 1), width 1, a host loop; each derivative sweep K1 at width
T-1 = 60 and K2 at (10, 4), (12, 1) and (12, 16). It takes minutes on
the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.models import rocket
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    solve,
)
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils.measure import scalar_solve

H = 0.05
T = 61
U_MAX = 12.5
NX, NU = rocket.NX, rocket.NU
NCONT = 14
# the deploy executor settings of the reference bench's rocket cell
DEPLOY_MAX_ITER_SCHEDULE = (15, 15, 25, 25, 30)
DEPLOY_AL_STALL_ROUNDS = 2
# the IP tolerance of the reference's accelerator branch (float32 floor)
# and of its CPU branch; the projection parks kappa at 1e-4 in both
DEPLOY_R_TOL_ACCEL = 3.0e-5
DEPLOY_R_TOL_CPU = 1.0e-8
PROJ_KAPPA_TOL = 1.0e-4


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def mrp_from_rotzy(alpha: float, beta: float) -> np.ndarray:
    """MRP of RotZ(alpha) RotY(beta) (the Rotations.jl convention)."""
    qz = np.array([math.cos(alpha / 2), 0.0, 0.0, math.sin(alpha / 2)])
    qy = np.array([math.cos(beta / 2), 0.0, math.sin(beta / 2), 0.0])
    q = _quat_mul(qz, qy)
    if q[0] < 0:
        q = -q
    return q[1:] / (1.0 + q[0])


def initial_and_goal(device="cuda", dtype=torch.float64):
    """(x1, xT): tilted at (2.5, 2.5, 10) falling at 1 m/s; upright at the
    pad, its centre of mass one length above it."""
    params = rocket.RocketParams()
    x1 = np.zeros(NX)
    x1[0], x1[1], x1[2] = 2.5, 2.5, 10.0
    x1[3:6] = mrp_from_rotzy(0.25 * np.pi, -0.5 * np.pi)
    x1[8] = -1.0
    xT = np.zeros(NX)
    xT[2] = params.length
    xT[3:6] = mrp_from_rotzy(0.25 * np.pi, 0.0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(x1), t(xT)


def _wire(prob: ILQRProblem, dyn, warm: bool) -> ILQRProblem:
    """The problem with ``dyn``'s scalar members and its lane-batched
    ones: cold ones, and with ``warm`` the warm-start members and the
    cold line-search policy (``ws_linesearch=False``)."""
    prob = prob._replace(
        dynamics=lambda t, x, u: dyn.step(x, u),
        dynamics_jac=lambda t, x, u: dyn.step_jac(x, u),
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us),
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(xs,
                                                                     us))
    if not warm:
        return prob
    return prob._replace(
        dynamics_batched_ws=lambda t, xs, us, ws: dyn.step_batched_ws(
            xs, us, ws),
        dynamics_jac_batched_ws=lambda ts, xs, us, wss:
            dyn.step_jac_batched_ws(xs, us, wss),
        ws_init_batched=lambda t, xs, us: dyn.ws_init_batched(xs),
        # cold line-search rollouts: y = x starts are already about one
        # Newton step from the midpoint solution
        ws_linesearch=False)


def build_problem(mode: str = "projection", device="cuda",
                  dtype=torch.float64, seed: int = 1):
    """Returns (prob, x1, us_init, opts, dyn) at the reference
    tolerances; the problem carries the scalar and the lane-batched
    dynamics (cold solves). ``mode``: "projection" | "nominal"."""
    device = torch.device(device)
    params = rocket.RocketParams()
    projection = mode == "projection"
    dyn = rocket.make_rocket_dynamics(params, u_max=U_MAX, h=H,
                                      projection=projection, device=device,
                                      dtype=dtype)
    x1, xT = initial_and_goal(device, dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    qw = t(H * np.concatenate([1.0e-1 * np.ones(3), 1.0e-5 * np.ones(3),
                               1.0e-1 * np.ones(3), 1000.0 * np.ones(3)]))
    rw = t(H * np.array([1000.0, 1000.0, 100.0]))
    qwT = t(H * 1000.0 * np.ones(NX))

    def stage_cost(t, x, u):
        dx = x - xT
        return 0.5 * dx @ (qw * dx) + 0.5 * u @ (rw * u)

    def terminal_cost(x):
        dx = x - xT
        return 0.5 * dx @ (qwT * dx)

    x_con = (-0.5, 0.5)
    y_con = (-0.75, 0.75)

    if projection:
        ncon = 1

        def stage_con(t, x, u):
            return params.length - x[2:3]
    else:
        ncon = 7

        def stage_con(t, x, u):
            return torch.cat([-1.0 - u[0:1], u[0:1] - 1.0,
                              -1.0 - u[1:2], u[1:2] - 1.0,
                              0.0 - u[2:3], u[2:3] - U_MAX,
                              params.length - x[2:3]])

    # rows of one-element slices, not 0-dim entries: torch.func.jacfwd
    # gives a 0-dim float32 tensor minus a Python float a float64 tangent
    def terminal_con(x):
        return torch.cat([x_con[0] - x[0:1], x[0:1] - x_con[1],
                          y_con[0] - x[1:2], x[1:2] - y_con[1],
                          (x - xT)[2:12]])

    ineqT = torch.zeros(NCONT, dtype=torch.bool, device=device)
    ineqT[:4] = True
    prob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=ncon, nconT=NCONT,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        stage_con=stage_con,
        terminal_con=terminal_con,
        ineq_mask=torch.ones((T - 1, ncon), dtype=torch.bool, device=device),
        terminal_ineq_mask=ineqT,
    )
    opts = ILQROptions(
        alpha_min=1.0e-5,
        obj_tol=1.0e-3,
        grad_tol=1.0e-3,
        max_iter=100,
        max_al_iter=15,
        con_tol=0.005,
        rho_init=1.0,
        rho_scale=10.0,
    )
    noise = np.random.default_rng(seed).standard_normal((T - 1, NU))
    us_init = t(1.0e-3 * noise)
    return _wire(prob, dyn, warm=False), x1, us_init, opts, dyn


def build_deploy_problem(device, mode: str = "projection", dtype=None,
                         accelerator_ip: bool | None = None):
    """The deploy-tier landing, wired for the segmented executor. Returns
    ``(prob, x1, us_init, opts)``.

    The reference's policy: line-search rollouts run cold, the derivative
    sweep warm-starts the midpoint solve from the accepted trajectory's
    own eval solution (``ws_linesearch=False``); the projection always
    starts cold. A CUDA device takes the reference's accelerator branch:
    float32, r_tol ``DEPLOY_R_TOL_ACCEL`` for both solves and the AL
    options ``con_tol=0.01``, ``rho_max=1e6``, ``alpha_min=1e-2``. The
    CPU takes float64, r_tol ``DEPLOY_R_TOL_CPU`` and ``build_problem``'s
    options; ``accelerator_ip`` picks the branch explicitly (the
    accelerator settings on the CPU, for parity checks)."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    if dtype is None:
        dtype = torch.float32 if on_gpu else torch.float64
    if accelerator_ip is None:
        accelerator_ip = on_gpu
    prob, x1, us0, opts, _ = build_problem(mode, device=device, dtype=dtype)
    dyn = rocket.make_rocket_dynamics(
        rocket.RocketParams(), u_max=U_MAX, h=H,
        projection=mode == "projection",
        r_tol=DEPLOY_R_TOL_ACCEL if accelerator_ip else DEPLOY_R_TOL_CPU,
        proj_kappa_tol=PROJ_KAPPA_TOL, device=device, dtype=dtype)
    prob = _wire(prob, dyn, warm=True)
    if prob.ws_linesearch:
        raise AssertionError("the rocket deploy runs cold line-search "
                             "rollouts")
    if accelerator_ip:
        opts = dataclasses.replace(opts, con_tol=0.01, rho_max=1.0e6,
                                   alpha_min=1.0e-2)
    return prob, x1, us0, opts


def deploy_x0s(x0: torch.Tensor, B: int, seed: int = 0) -> torch.Tensor:
    """The deploy scenarios: the position scattered by 0.1 N(0, 1) and the
    velocity by 0.05 N(0, 1), the attitude and rates kept, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    delta = np.zeros((B, NX))
    delta[:, 0:3] = 0.1 * rng.standard_normal((B, 3))
    delta[:, 6:9] = 0.05 * rng.standard_normal((B, 3))
    return x0[None] + torch.as_tensor(delta, dtype=x0.dtype,
                                      device=x0.device)


def effective_thrust(us: torch.Tensor, mode: str = "projection"):
    """The thrust the dynamics apply to controls (..., 3): their
    projection onto the thrust cone (solved on their device and dtype at
    the deploy tolerance of that dtype), or the controls themselves in
    mode "nominal"."""
    if mode != "projection":
        return us
    r_tol = (DEPLOY_R_TOL_ACCEL if us.dtype == torch.float32
             else DEPLOY_R_TOL_CPU)
    dyn = rocket.make_rocket_dynamics(
        rocket.RocketParams(), u_max=U_MAX, h=H, r_tol=r_tol,
        proj_kappa_tol=PROJ_KAPPA_TOL, device=us.device, dtype=us.dtype)
    return dyn.project_batched(us.reshape(-1, NU)).reshape(us.shape)


def thrust_cone_ok(us: torch.Tensor, mode: str = "projection"):
    """Per lane of controls (B, T-1, 3): every effective thrust in the
    cone, ``||u_xy|| <= u_z + 1e-6``."""
    u = effective_thrust(us, mode)
    inside = torch.linalg.vector_norm(u[..., 0:2], dim=-1) <= u[..., 2] + 1e-6
    return inside.all(dim=-1)


def final_state_error(xs: torch.Tensor, xT: torch.Tensor):
    """Per lane of states (B, T, 12): ``max |x_T - xT|`` over the
    constrained entries 2:12."""
    return (xs[:, -1, 2:] - xT[2:]).abs().amax(dim=-1)


def run(mode: str = "projection", device="cuda", dtype=torch.float64):
    """The reference's ``run``: ``build_problem`` solved by the scalar
    ``solve``. Returns ``(prob, result, dyn)``."""
    prob, x1, us_init, opts, dyn = build_problem(mode, device=device,
                                                 dtype=dtype)
    return prob, solve(prob, x1, us_init, opts), dyn


def main_scalar(mode, device, dtype=torch.float64, log: bool = False):
    """The reference's ``main``: the landing by the scalar ``solve``,
    printed with its wall and its K1 and K2 launches; ``log`` prints a
    line an AL round (``ILQROptions.verbose``)."""
    prob, x1, us0, opts, _ = build_problem(mode, device=device, dtype=dtype)
    opts = dataclasses.replace(opts, verbose=log)
    res, wall, launches = scalar_solve(prob, x1, us0, opts)
    cone_ok = bool(thrust_cone_ok(res.us[None], mode)[0])
    _, xT = initial_and_goal(device, dtype)
    print(f"[{mode}] converged: {bool(res.converged)}"
          f" obj: {float(res.objective):.4f}"
          f" iters: {int(res.iterations)}"
          f" al: {int(res.al_iterations)}"
          f" vio: {float(res.constraint_violation):.2e}"
          f" thrust-cone feasible: {cone_ok}")
    print("final state err:",
          float(final_state_error(res.xs[None], xT)[0]))
    print("device=%s dtype=%s wall %.3f s launches %s"
          % (device, dtype, wall, launches))
    viz_dir = os.environ.get("ODX_VIZ_DIR")
    if viz_dir:
        from optimization_dynamics_tpu_torch.utils.viz import (
            visualize_rocket_3d)
        os.makedirs(viz_dir, exist_ok=True)
        out = visualize_rocket_3d(
            res.xs, os.path.join(viz_dir, "rocket_3d.html"),
            us=effective_thrust(res.us, mode), dt=H)
        print("3-D player:", out)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deploy", action="store_true",
                    help="run the lane-batched deploy solve (default: the "
                         "scalar solve of the reference's main)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mode", choices=("projection", "nominal"),
                    default="projection")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="default: f32 on a CUDA device with --deploy, "
                         "else f64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", action="store_true",
                    help="print the solve's progress (with --deploy each "
                         "inner iteration and AL round, else each AL "
                         "round) with the seconds since the solve began")
    args = ap.parse_args(argv)
    log = None
    if args.log:
        log = lambda line: print("[%.1f s] %s" % (time.perf_counter() - t0,
                                                  line), flush=True)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rocket: no CUDA device; pass --device cpu to run "
                         "the plain versions on the CPU")
    dtype = {None: None, "f32": torch.float32,
             "f64": torch.float64}[args.dtype]

    if not args.deploy:
        return main_scalar(args.mode, device, dtype or torch.float64,
                           log=args.log)
    prob, x0, us0, opts = build_deploy_problem(device, mode=args.mode,
                                               dtype=dtype)
    B = args.batch
    x0s = deploy_x0s(x0, B, args.seed)
    solve_b = make_segmented_solver(
        prob, opts, B, x0.dtype, device,
        max_iter_schedule=DEPLOY_MAX_ITER_SCHEDULE,
        al_stall_rounds=DEPLOY_AL_STALL_ROUNDS, log=log)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve,
    )
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip,
    )
    if device.type == "cuda":
        from optimization_dynamics_tpu_torch.ops.kernels._build import (
            load_library,
        )
        load_library()          # build the kernels before the clock
        torch.cuda.synchronize()
    batched_solve.shape_widths.clear()
    fused_ip.launches = fused_ip.tile_launches = 0
    fused_ip.widths.clear()
    t0 = time.perf_counter()
    res = solve_b(x0s, us0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the solve's K1 and K2 launches, before the thrust-cone check adds
    # its own
    main.k1_launches = (fused_ip.launches, fused_ip.tile_launches,
                        dict(sorted(fused_ip.widths.items())))
    main.k2_launches = dict(sorted(batched_solve.shape_widths.items()))
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    n_conv = int(conv.sum())
    cone = thrust_cone_ok(res.us, args.mode).cpu().numpy()
    _, xT = initial_and_goal(device, x0.dtype)
    err = final_state_error(res.xs, xT).cpu().numpy()
    on = lambda a: float(a[conv].mean()) if n_conv else float("nan")
    print("device=%s dtype=%s batch=%d mode=%s"
          % (device, x0.dtype, B, args.mode))
    print("converged %d/%d (%.4f)" % (n_conv, B, n_conv / B))
    print("mean converged objective %.6f" % on(obj))
    print("max violation %.6e"
          % float(res.constraint_violation.max()))
    print("thrust-cone feasible: %d/%d lanes, %d/%d converged lanes"
          % (int(cone.sum()), B, int(cone[conv].sum()), n_conv))
    print("final state error: max %.6e, converged mean %.6e"
          % (float(err.max()), on(err)))
    print("wall %.3f s, %.4f converged solves/s" % (wall, n_conv / wall))
    print("mean inner iterations %.2f, AL rounds %d"
          % (float(res.iterations.float().mean()),
             int(res.al_iterations.max())))
    print("K1 launches %d (tile %d) by (kernel, width) %s"
          % main.k1_launches)
    print("K2 launches %d by (n, k, kernel, width) %s"
          % (sum(main.k2_launches.values()), main.k2_launches))
    print("stats %s" % dict(solve_b.stats))
    return res


main.k1_launches = (0, 0, {})
main.k2_launches = {}


if __name__ == "__main__":
    main()
