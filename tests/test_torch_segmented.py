"""Port parity: the segmented AL-iLQR executor against the JAX package.

* The slice: the cartpole deploy problem on the CPU (float64, T=51, B=4,
  ``compact=False``, one AL round of two inner iterations), at the CPU IP
  settings and at the accelerator IP settings. Objective to rtol 1e-6,
  controls to atol 1e-6 (the IP solves agree to ~1e-12: QR against LU),
  dispatch counters and iteration counts exactly.
* The executor's policies on a cheap nonlinear problem (a pendulum with a
  terminal equality constraint) whose lanes finish at different
  iterations: active-lane compaction into power-of-4 buckets, the
  ``lam_init``/``lamT_init``/``rho_init`` warm starts, and the AL
  straggler policy. The same phases run on both sides, so results agree
  to atol 1e-8 and the counters exactly.
* A slow end-to-end check: the friction swing-up lands inside the range
  of the known optima of tests/goldens.json. The knife-edge problem has
  several local optima and which one a solve lands on moves with the
  rounding of the platform, so the check is the range, not one value.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import cartpole as jex
from optimization_dynamics_tpu.solver.ilqr import (
    ILQROptions as JaxILQROptions,
    ILQRProblem as JaxILQRProblem,
)
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.examples import cartpole as tex
from optimization_dynamics_tpu_torch.solver.ilqr import ILQRProblem
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64


def _compare(rt, rj, stats_t, stats_j, tol):
    np.testing.assert_allclose(rt.objective.numpy(),
                               np.asarray(rj.objective), rtol=tol)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=tol)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.al_iterations.numpy(),
                                  np.asarray(rj.al_iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert dict(stats_t) == dict(stats_j)


@pytest.mark.parametrize("ip", ["cpu", "accelerator"])
def test_cartpole_deploy_slice_matches_jax(ip):
    B = 4
    if ip == "cpu":
        jprob, x0, us0, jopts = jex.build_deploy_problem(False,
                                                         dtype=jnp.float64)
        tprob, tx0, tus0, topts = tex.build_deploy_problem("cpu")
    else:
        jprob, x0, us0, jopts = jex.build_deploy_problem(
            True, dtype=jnp.float64, fused=False)
        tprob, tx0, tus0, topts = tex.build_deploy_problem(
            "cpu", dtype=F64, ip_overrides=tex.DEPLOY_IP_ACCEL)
    # the warm-start policy: cold line-search rollouts, warm sweeps
    assert tprob.ws_linesearch is False and jprob.ws_linesearch is False
    assert tprob.dynamics_jac_batched_ws is not None
    assert convert.ilqr_options(jopts) == topts
    jopts = dataclasses.replace(jopts, max_al_iter=1)
    topts = dataclasses.replace(topts, max_al_iter=1)

    x0s = tex.deploy_x0s(tx0, B, seed=0)
    js = jax_segmented_solver(jprob, jopts, B, dtype=jnp.float64,
                              compact=False, max_iter_schedule=[2])
    rj = js(jnp.asarray(x0s.numpy()), us0)
    ts = make_segmented_solver(tprob, topts, B, F64, "cpu", compact=False,
                               max_iter_schedule=[2])
    rt = ts(x0s, tus0)
    _compare(rt, rj, ts.stats, js.stats, tol=1e-6)
    assert ts.stats["inner_iters"] == 2


# ---------------------------------------------------------------------------
# executor policies on a pendulum swing toward a terminal target

T_P, H_P, B_P = 12, 0.1, 16
GOAL = np.array([0.6, 0.0])


def _pendulum(np_mod, sin, cos, stack, zeros):
    """Explicit-Euler pendulum pieces over the last dimension."""
    def step(xs, us):
        return stack([xs[..., 0] + H_P * xs[..., 1],
                      xs[..., 1] + H_P * (-4.0 * sin(xs[..., 0])
                                          + us[..., 0])])

    def jac(xs, us):
        o, z = np_mod.ones_like(xs[..., 0]), zeros(xs[..., 0])
        fx = stack([stack([o, H_P * o]),
                    stack([-4.0 * H_P * cos(xs[..., 0]), o])], axis=-2)
        fu = stack([stack([z]), stack([H_P * o])], axis=-2)
        return step(xs, us), fx, fu

    return step, jac


def _jax_pendulum():
    st = lambda a, axis=-1: jnp.stack(a, axis=axis)
    step, jac = _pendulum(jnp, jnp.sin, jnp.cos, st, jnp.zeros_like)
    goal = jnp.asarray(GOAL)
    return JaxILQRProblem(
        T=T_P, nx=2, nu=1, ncon=0, nconT=2,
        dynamics=lambda t, x, u: step(x, u),
        dynamics_jac=lambda t, x, u: jac(x, u),
        dynamics_batched=lambda t, xs, us: step(xs, us),
        dynamics_jac_batched=lambda ts, xs, us: jac(xs, us),
        stage_cost=lambda t, x, u: 0.05 * jnp.sum(u * u)
        + 0.01 * jnp.sum((x - goal) ** 2),
        terminal_cost=lambda x: jnp.sum((x - goal) ** 2),
        terminal_con=lambda x: x - goal)


def _torch_pendulum():
    st = lambda a, axis=-1: torch.stack(a, dim=axis)
    step, jac = _pendulum(torch, torch.sin, torch.cos, st,
                          torch.zeros_like)
    goal = torch.as_tensor(GOAL)
    return ILQRProblem(
        T=T_P, nx=2, nu=1, ncon=0, nconT=2,
        dynamics_batched=lambda t, xs, us: step(xs, us),
        dynamics_jac_batched=lambda ts, xs, us: jac(xs, us),
        stage_cost=lambda t, x, u: 0.05 * torch.sum(u * u)
        + 0.01 * torch.sum((x - goal) ** 2),
        terminal_cost=lambda x: torch.sum((x - goal) ** 2),
        terminal_con=lambda x: x - goal)


def _pendulum_x0s():
    rng = np.random.default_rng(5)
    return np.stack([rng.uniform(-1.5, 1.5, B_P),
                     rng.uniform(-1.0, 1.0, B_P)], axis=1)


def test_compaction_and_al_warm_start_match_jax():
    """Lanes finish at different iterations, so the executor compacts
    into the 4- and 1-lane buckets; a second solve warm-started from the
    first's AL state (carried across by ``convert.al_state``) matches
    too."""
    jopts = JaxILQROptions(max_iter=12, max_al_iter=4, con_tol=1e-4,
                           obj_tol=1e-7, grad_tol=1e-6)
    topts = convert.ilqr_options(jopts)
    x0s = _pendulum_x0s()
    us0 = np.zeros((T_P - 1, 1))
    kw = dict(compact=True, compact_min=1, max_iter_schedule=[3, 5])
    js = jax_segmented_solver(_jax_pendulum(), jopts, B_P,
                              dtype=jnp.float64, **kw)
    ts = make_segmented_solver(_torch_pendulum(), topts, B_P, F64, "cpu",
                               **kw)
    rj = js(jnp.asarray(x0s), jnp.asarray(us0))
    stats_j = dict(js.stats)
    rt = ts(torch.as_tensor(x0s), torch.as_tensor(us0))
    _compare(rt, rj, ts.stats, stats_j, tol=1e-8)
    its = rt.iterations.numpy()
    assert its.min() < its.max()          # lanes finished apart
    assert ts.stats["sweep_lanes"] < B_P * ts.stats["inner_iters"]

    lam, lamT, rho = convert.al_state(rj)
    rj2 = js(jnp.asarray(x0s), jnp.asarray(us0), lam_init=lam,
             lamT_init=lamT, rho_init=rho)
    rt2 = ts(torch.as_tensor(x0s), torch.as_tensor(us0), lam_init=lam,
             lamT_init=lamT, rho_init=rho)
    _compare(rt2, rj2, ts.stats, js.stats, tol=1e-8)
    np.testing.assert_allclose(rt2.lamT.numpy(), np.asarray(rj2.lamT),
                               atol=1e-8)


def test_al_stall_policy_matches_jax():
    """An unreachable con_tol with a capped penalty: the straggler policy
    drops the lanes after one stalled round, in both packages alike."""
    jopts = JaxILQROptions(max_iter=6, max_al_iter=8, con_tol=1e-12,
                           rho_max=10.0, obj_tol=1e-7)
    topts = convert.ilqr_options(jopts)
    x0s = _pendulum_x0s()[:4]
    us0 = np.zeros((T_P - 1, 1))
    kw = dict(compact=False, al_stall_rounds=1)
    js = jax_segmented_solver(_jax_pendulum(), jopts, 4, dtype=jnp.float64,
                              **kw)
    ts = make_segmented_solver(_torch_pendulum(), topts, 4, F64, "cpu",
                               **kw)
    rj = js(jnp.asarray(x0s), jnp.asarray(us0))
    rt = ts(torch.as_tensor(x0s), torch.as_tensor(us0))
    _compare(rt, rj, ts.stats, js.stats, tol=1e-8)
    assert not rt.converged.any()
    assert int(rt.al_iterations[0]) < topts.max_al_iter


@pytest.mark.slow
def test_cartpole_friction_swingup_golden():
    """The friction swing-up from rest (build_problem, batch 1) converges,
    reaches the goal and lands inside the range of the known optima."""
    goldens = json.load(open(os.path.join(os.path.dirname(__file__),
                                          "goldens.json")))
    refs = goldens["cartpole_friction_objective"]
    prob, x0, us0, opts = tex.build_problem("friction", device="cpu")
    solve = make_segmented_solver(prob, opts, 1, F64, "cpu")
    res = solve(x0[None], us0)
    assert bool(res.converged[0])
    assert float(res.constraint_violation[0]) < opts.con_tol
    np.testing.assert_allclose(res.xs[0, -1].numpy(),
                               [0.0, np.pi, 0.0, np.pi], atol=1e-2)
    obj = float(res.objective[0])
    assert min(refs) <= obj <= max(refs), (obj, refs)
