"""The JAX package's cartpole deploy solve on the CPU, lane by lane.

The reference column for the port's deploy solve: the same starts
(``x0 + 0.01 N(0, 1)`` from numpy seed 0), the accelerator IP settings
(``build_deploy_problem(on_tpu=True, fused=False)``) and the deploy
executor schedule, solved by ``make_segmented_solver``. Run from the
repository root:

    JAX_PLATFORMS=cpu python -m tools.jax_deploy_reference --dtype f32
    JAX_PLATFORMS=cpu python -m tools.jax_deploy_reference --dtype f64

Prints one JSON line: converged count, mean and median converged
objective, and each lane's flag and objective.
"""

import argparse
import json
import time

import numpy as np

DEPLOY_MAX_ITER_SCHEDULE = (15, 15, 25, 25, 30)
DEPLOY_AL_STALL_ROUNDS = 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", args.dtype == "f64")
    import jax.numpy as jnp

    from optimization_dynamics_tpu.examples import cartpole as jex
    from optimization_dynamics_tpu.solver.ilqr_segmented import (
        make_segmented_solver)

    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    prob, x0, us0, opts = jex.build_deploy_problem(True, dtype=dtype,
                                                   fused=False)
    B = args.batch
    noise = np.random.default_rng(args.seed).standard_normal(
        (B, x0.shape[0]))
    x0s = jnp.asarray(np.asarray(x0)[None] + 0.01 * noise, dtype)
    solve = make_segmented_solver(
        prob, opts, B, dtype=dtype,
        max_iter_schedule=DEPLOY_MAX_ITER_SCHEDULE,
        al_stall_rounds=DEPLOY_AL_STALL_ROUNDS)
    t0 = time.perf_counter()
    res = solve(x0s, jnp.asarray(us0, dtype))
    jax.block_until_ready(res.xs)
    wall = time.perf_counter() - t0
    conv = np.asarray(res.converged)
    obj = np.asarray(res.objective, np.float64)
    print(json.dumps(dict(
        dtype=args.dtype, batch=B, wall_s_cpu=wall, stats=dict(solve.stats),
        converged=int(conv.sum()),
        mean_obj_converged=float(obj[conv].mean()) if conv.any() else None,
        median_obj_converged=(float(np.median(obj[conv])) if conv.any()
                              else None),
        lane_converged=conv.tolist(), lane_objective=obj.tolist())))


if __name__ == "__main__":
    main()
