"""Production-style scenario sweep: many contact-implicit solves, shard by
shard over the visible devices.

Port of ``optimization_dynamics_tpu/examples/sweep.py``. A grid of
(friction coefficient, initial state) cartpole swing-up scenarios is
split into shards; each shard is spread over the devices
(``parallel/mesh.py``), its failed lanes are retried from perturbed
starts, and it streams through the checkpointer, so a preempted sweep
resumes at the first shard not on disk. Convergence statistics reduce
the per-lane flags to fleet numbers.

* ``run_sweep``: the friction grid, each scenario the scalar AL-iLQR
  ``solver/ilqr.py::solve`` in float64 (on the card K1 at widths 1 and
  T-1 = 50, K2 at (10, 8)).
* ``run_sweep_deploy``: the deploy tier (``cartpole.build_deploy_problem``,
  float32 on the card) solved lane-batched by the segmented executor,
  shard after shard, optionally warm-started from the previous shard
  (on the card K1 at the compacted widths, K2 at (10, 8)).

Run it on the card with

    python -m optimization_dynamics_tpu_torch.examples.sweep --deploy 256 \\
        [--warm] [--out DIR]
    python -m optimization_dynamics_tpu_torch.examples.sweep 64 [--out DIR]

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs the plain versions (the deploy sweep
then in float64 on shards of at most 8 lanes). Multi-host sweeps (the
reference's ``jax.distributed``) are not ported.

The reference draws its initial states, retry perturbations and deploy
directions with ``jax.random``, which torch cannot reproduce; here they
are arguments (``x0s``, ``retry_noise``, ``dirs``, and the friction grid
``frictions``), drawn from a numpy seed when not given.
"""

from __future__ import annotations

import argparse
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import cartpole
from optimization_dynamics_tpu_torch.parallel.mesh import (
    convergence_summary,
    merge_retry,
    quarantine,
    scenario_mesh,
    sharded_map,
)
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    ILQRResult,
    solve,
)
from optimization_dynamics_tpu_torch.utils.checkpoint import SweepCheckpointer
from optimization_dynamics_tpu_torch.utils.profiling import block_until_ready

H, T = 0.05, 51
# the deploy sweep's executor policy: per-AL-round inner budgets and the
# straggler drop
DEPLOY_MAX_ITER_SCHEDULE = (15, 15, 25, 25, 30)
DEPLOY_AL_STALL_ROUNDS = 2
DEPLOY_STEP = 0.02


def make_solver(dtype=torch.float64):
    """One scenario = (friction pair (2,), initial state (4,)) -> the full
    AL-iLQR solve on the state's device. ``T`` and ``ILQROptions`` are
    read when a scenario is solved."""
    dyns = {}

    def solve_one(friction, x0):
        dev = x0.device
        if dev not in dyns:
            dyns[dev] = make_implicit_dynamics(
                cartpole.friction_model(), dev, dtype,
                kappa_eval_tol=1.0e-4, kappa_grad_tol=1.0e-3)
        dyn = dyns[dev]
        aux = cartpole.CartpoleAux(h=H, friction=friction.to(dev, dtype))
        xT = torch.tensor([0.0, math.pi, 0.0, math.pi], dtype=dtype,
                          device=dev)
        prob = ILQRProblem(
            T=T, nx=4, nu=1, ncon=0, nconT=4,
            dynamics=lambda t, x, u: dyn.step(x, u, aux),
            dynamics_jac=lambda t, x, u: dyn.step_jac(x, u, aux),
            dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
                xs, us, aux),
            stage_cost=lambda t, x, u: u @ u,
            terminal_cost=lambda x: (x - xT) @ (x - xT),
            terminal_con=lambda x: x - xT,
            # line-search steps warm-started from the accepted
            # trajectory's solver variables at the same timestep
            dynamics_ws=lambda t, x, u, z: dyn.step_carry(z, x, u, aux),
            ws_init=lambda t, x, u: dyn.carry_init(x),
        )
        opts = ILQROptions(max_iter=100, max_al_iter=20, con_tol=0.005)
        us0 = torch.zeros((T - 1, 1), dtype=dtype, device=dev)
        us0[0, 0] = -1.5
        return solve(prob, x0.to(dtype), us0, opts)

    return solve_one


def _solve_lanes(solve_one):
    """A lane-batched form of ``solve_one``: the scenarios of a chunk one
    after another, their results stacked (the reference ``vmap``s it)."""
    def run(frictions, x0s):
        res = [solve_one(frictions[i], x0s[i]) for i in range(x0s.shape[0])]
        return ILQRResult(*(torch.stack(f) for f in zip(*res)))

    return run


def run_sweep(n_scenarios: int = 64, shard_size: int = 32,
              out_dir: str = "runs/cartpole_sweep", dtype=torch.float64,
              devices=None, frictions=None, x0s=None, retry_noise=None,
              seed: int = 0, verbose: bool = True):
    """The friction grid: scenario i has friction ``frictions[i]`` (both
    joints; default ``linspace(0.05, 0.4)``) and starts at ``x0s[i]``
    (default ``0.02 N(0, 1)`` from numpy ``seed``). Each shard of
    ``shard_size`` scenarios is split over ``devices`` (default every
    visible CUDA device) and solved, one device's chunk after another:
    a scalar solve syncs with the host at every step, so the devices do
    not overlap. When some lane failed, the shard is solved again whole
    from ``x0 + 0.05 retry_noise[s]`` (default a numpy draw), the retry
    kept on the lanes it converged; then it is saved under ``out_dir``.
    Shards already there are skipped. Returns the new shards' summaries
    (``convergence_summary`` with ``retried``, ``wall_s`` and
    ``solves_per_s``)."""
    mesh = scenario_mesh(devices=devices)
    run = sharded_map(_solve_lanes(make_solver(dtype)), mesh)
    ck = SweepCheckpointer(out_dir)

    if frictions is None:
        frictions = np.repeat(np.linspace(0.05, 0.4, n_scenarios)[:, None],
                              2, axis=1)
    if x0s is None:
        x0s = 0.02 * np.random.default_rng(seed).standard_normal(
            (n_scenarios, 4))
    as_t = lambda a: torch.as_tensor(np.array(a), dtype=dtype)
    frictions, x0s = as_t(frictions), as_t(x0s)

    n_shards = (n_scenarios + shard_size - 1) // shard_size
    stats = []
    for s in range(n_shards):
        if ck.done(s):
            continue
        sl = slice(s * shard_size, (s + 1) * shard_size)
        fr, x0 = frictions[sl], x0s[sl]
        t0 = time.perf_counter()
        res = block_until_ready(run(fr, x0))
        failed = quarantine(res.converged)
        if failed:
            # quarantine + random-restart pass: re-solve the whole shard
            # from perturbed initial states and keep the retry results
            # only on the failed lanes that it converged
            noise = (np.random.default_rng([seed, 1000 + s]).standard_normal(
                tuple(x0.shape)) if retry_noise is None else retry_noise[s])
            res_r = block_until_ready(run(fr, x0 + 0.05 * as_t(noise)))
            res = merge_retry(res, res_r)
        wall = time.perf_counter() - t0
        summary = convergence_summary(res.converged, res.iterations)
        summary["retried"] = len(failed)
        summary["wall_s"] = round(wall, 3)
        summary["solves_per_s"] = round(fr.shape[0] / wall, 2)
        ck.save(s, res, meta=summary)
        stats.append(summary)
        if verbose:
            print(f"shard {s}: {summary}", flush=True)
    return stats


def run_sweep_deploy(n_scenarios: int = 256, shard: int = 128,
                     warm: bool = False, out_dir: str | None = None,
                     verbose: bool = True, device="cuda", dirs=None,
                     seed: int = 0, timers=None):
    """The deploy sweep: ``cartpole.build_deploy_problem`` (float32 on a
    CUDA device, float64 on the CPU with ``shard = min(shard, 8)``) solved
    by the segmented executor (``DEPLOY_MAX_ITER_SCHEDULE``,
    ``DEPLOY_AL_STALL_ROUNDS``), shard by shard over a scenario grid
    where lane i of shard s starts at ``x0 + (s+1) 0.02 dirs[i]``: a ray of
    growing initial-state perturbations at the knife-edge friction 0.35,
    so lane i of shard s+1 is the nearest neighbour of lane i of shard s.
    ``dirs`` (shard, 4) are unit directions (default a numpy draw from
    ``seed``, normalised).

    ``warm=True`` seeds each shard's controls and augmented-Lagrangian
    duals from the previous shard's result; the penalty restarts at
    ``rho_init`` so the AL loop re-verifies feasibility. On this problem
    neighbour warm starts can hurt: the open-loop rollout of a
    neighbour's bang-bang controls from a different initial state can
    diverge (chaotic swing-up dynamics), and the stale duals then pull
    toward the neighbour's basin; the reference's A/B on its own
    hardware saw the warm arm converge fewer lanes, more slowly. Warm
    starts do pay on stable regulation problems, so the mechanism stays
    and the default is cold.

    With ``out_dir`` each shard is saved there and a shard already there
    is skipped (its result seeds the next shard of a warm sweep).
    ``timers`` (a ``utils.profiling.PhaseTimer``) goes to the executor.
    Returns the solved shards' summaries: ``convergence_summary`` with
    the wall, converged solves/s, the IP solves the executor counted
    (lane-rollouts x (T-1)) and whether the shard was warm-started."""
    from optimization_dynamics_tpu_torch.examples import cartpole as excp
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    device = torch.device(device)
    on_gpu = device.type == "cuda"
    dtype = torch.float32 if on_gpu else torch.float64
    if not on_gpu:
        shard = min(shard, 8)        # CPU: keep the lane width small
    prob, x0, us0, opts = excp.build_deploy_problem(device, dtype=dtype)
    run = make_segmented_solver(prob, opts, shard, dtype, device,
                                max_iter_schedule=DEPLOY_MAX_ITER_SCHEDULE,
                                al_stall_rounds=DEPLOY_AL_STALL_ROUNDS,
                                timers=timers)
    ck = SweepCheckpointer(out_dir) if out_dir else None

    n_shards = (n_scenarios + shard - 1) // shard
    if dirs is None:
        dirs = np.random.default_rng(seed).standard_normal((shard, 4))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = np.asarray(dirs)
    x0_np = x0.cpu().numpy()

    prev = None
    stats = []
    for s in range(n_shards):
        if ck is not None and ck.done(s):
            if warm:
                data, _ = ck.load(s)
                prev = SimpleNamespace(us=data["us"], lam=data["lam"],
                                       lamT=data["lamT"])
            continue
        x0s = torch.as_tensor(x0_np[None] + (s + 1) * DEPLOY_STEP * dirs,
                              dtype=dtype, device=device)
        if warm and prev is not None:
            us_init, lam_i, lamT_i = prev.us, prev.lam, prev.lamT
        else:
            us_init, lam_i, lamT_i = us0, None, None
        t0 = time.perf_counter()
        res = run(x0s, us_init, lam_init=lam_i, lamT_init=lamT_i)
        block_until_ready(res.xs)
        wall = time.perf_counter() - t0
        prev = res
        summary = convergence_summary(res.converged, res.iterations)
        summary.update(
            wall_s=round(wall, 2),
            solves_per_s=round(summary["n_converged"] / wall, 3),
            ip_solves=int((run.stats.get("sweep_lanes", 0)
                           + run.stats.get("roll_lanes", 0))
                          * (prob.T - 1)),
            warm=bool(warm and s > 0))
        if ck is not None:
            ck.save(s, res, meta=summary)
        stats.append(summary)
        if verbose:
            print(f"shard {s}: {summary}", flush=True)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="scenarios (default 64, with --deploy 256)")
    ap.add_argument("--deploy", action="store_true",
                    help="the deploy sweep (default: the friction grid)")
    ap.add_argument("--warm", action="store_true",
                    help="with --deploy: warm-start each shard from the "
                         "previous one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--out", default=None,
                    help="checkpoint directory (the friction grid's "
                         "default: runs/cartpole_sweep)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.warm and not args.deploy:
        ap.error("--warm needs --deploy")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device; pass --device cpu to run "
                         "the plain versions on the CPU")
    if args.deploy:
        return run_sweep_deploy(256 if args.n is None else args.n,
                                warm=args.warm, out_dir=args.out,
                                device=device, seed=args.seed)
    return run_sweep(64 if args.n is None else args.n,
                     out_dir=args.out or "runs/cartpole_sweep",
                     devices=None if device.type == "cuda" else [device],
                     seed=args.seed)


if __name__ == "__main__":
    main()
