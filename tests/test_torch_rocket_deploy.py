"""Port parity: the rocket deploy slice against the JAX package.

* The deploy problem's sizes, masks, options, initial and goal states,
  and the cold line-search policy equal the reference's at both IP
  branches; the initial controls are the port's documented numpy draw.
* Both modes' stage and terminal costs and constraints equal the
  reference's at random states and controls (1e-12).
* ``deploy_x0s`` scatters position and velocity only;
  ``thrust_cone_ok`` passes projected thrusts and flags raw ones outside
  the cone.
* A short-horizon deploy (T=11, B=4, started hovering just above the pad,
  as tests/test_rocket.py's short descent) through the port's segmented
  solver against the reference's ``make_segmented_solver`` on the same
  scenarios and controls, at the CPU IP settings and at the accelerator
  IP settings (float64), two AL rounds of at most three inner
  iterations, ``compact=False``: objective to rtol 1e-6, controls to
  atol 1e-6, iterations, converged flags and dispatch counters exactly;
  the port's progress log has a line an inner iteration and an AL
  round.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import rocket as jex
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.examples import rocket as tex
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64


@pytest.mark.parametrize("accelerator_ip", [False, True])
def test_deploy_problem_settings_match_jax(accelerator_ip):
    """Options, sizes, masks, x0 and the goal equal the reference's at
    each IP branch; line-search rollouts start cold; the initial controls
    are 1e-3 N(0, 1) from numpy seed 1."""
    jprob, jx0, jus0, jopts = jex.build_deploy_problem(accelerator_ip,
                                                       dtype=jnp.float64)
    tprob, tx0, tus0, topts = tex.build_deploy_problem(
        "cpu", dtype=F64, accelerator_ip=accelerator_ip)
    assert convert.ilqr_options(jopts) == topts
    assert tprob.ws_linesearch is False and jprob.ws_linesearch is False
    for f in ("dynamics_batched_ws", "dynamics_jac_batched_ws",
              "ws_init_batched"):
        assert getattr(tprob, f) is not None, f
    for f in ("T", "nx", "nu", "ncon", "nconT"):
        assert getattr(tprob, f) == getattr(jprob, f), f
    assert (tprob.T, tprob.ncon, tprob.nconT) == (61, 1, 14)
    for f in ("ineq_mask", "terminal_ineq_mask"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(),
                                      np.asarray(getattr(jprob, f)), f)
    assert tprob.u_mask is None
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    _, jxT = jex.initial_and_goal()
    np.testing.assert_array_equal(tex.initial_and_goal("cpu")[1].numpy(),
                                  np.asarray(jxT))
    noise = np.random.default_rng(1).standard_normal((60, 3))
    np.testing.assert_array_equal(tus0.numpy(), 1e-3 * noise)
    assert tus0.shape == jus0.shape
    if accelerator_ip:
        assert (topts.con_tol, topts.rho_max, topts.alpha_min) == (
            0.01, 1.0e6, 1.0e-2)
    tp32 = tex.build_deploy_problem("cpu", dtype=torch.float32,
                                    accelerator_ip=accelerator_ip)
    assert tp32[1].dtype == torch.float32 and tp32[2].dtype == torch.float32


def _points(seed, B=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 12))
    u = 3.0 * rng.standard_normal((B, 3))
    return x, u


@pytest.mark.parametrize("mode", ["projection", "nominal"])
def test_costs_and_constraints_match_jax(mode):
    """Stage and terminal costs and constraints of both modes, and the
    nominal mode's sizes (seven box rows, the dynamics solve alone)."""
    jprob = jex.build_problem(mode)[0]
    tprob = tex.build_problem(mode, device="cpu")[0]
    assert (tprob.ncon, tprob.nconT) == (jprob.ncon, jprob.nconT)
    assert tprob.ncon == (1 if mode == "projection" else 7)
    np.testing.assert_array_equal(tprob.ineq_mask.numpy(),
                                  np.asarray(jprob.ineq_mask))
    x, u = _points(8)
    for i in range(x.shape[0]):
        xi, ui = torch.as_tensor(x[i]), torch.as_tensor(u[i])
        for name, args, targs in (
                ("stage_cost", (3, x[i], u[i]), (3, xi, ui)),
                ("stage_con", (3, x[i], u[i]), (3, xi, ui)),
                ("terminal_cost", (x[i],), (xi,)),
                ("terminal_con", (x[i],), (xi,))):
            np.testing.assert_allclose(
                getattr(tprob, name)(*targs).numpy(),
                np.asarray(getattr(jprob, name)(*args)), rtol=1e-12,
                atol=1e-12, err_msg=name)
    # the nominal mode's dynamics take the thrust as it is
    xs = torch.as_tensor(x)
    xs[:, 2] += 10.0
    us = torch.tensor([[3.0, 0.0, 1.0]] * 6, dtype=F64)
    ys = tprob.dynamics_batched(0, xs, us)
    jy = jax.vmap(lambda a, b: jprob.dynamics(0, a, b))(xs.numpy(),
                                                        us.numpy())
    np.testing.assert_allclose(ys.numpy(), np.asarray(jy), atol=1e-10)


def test_deploy_x0s_and_thrust_cone_check():
    _, x0, _, _ = tex.build_deploy_problem("cpu")
    x0s = tex.deploy_x0s(x0, 5, seed=3)
    rng = np.random.default_rng(3)
    pos = 0.1 * rng.standard_normal((5, 3))
    vel = 0.05 * rng.standard_normal((5, 3))
    d = (x0s - x0).numpy()
    np.testing.assert_allclose(d[:, 0:3], pos, atol=1e-15)
    np.testing.assert_allclose(d[:, 6:9], vel, atol=1e-15)
    np.testing.assert_array_equal(d[:, 3:6], 0.0)
    np.testing.assert_array_equal(d[:, 9:12], 0.0)
    us = torch.tensor([[[1.0, -2.0, 5.0], [3.0, 0.0, 1.0]],
                       [[0.1, 0.1, 9.0], [0.0, 0.0, 20.0]]], dtype=F64)
    assert tex.thrust_cone_ok(us).tolist() == [True, True]
    assert tex.thrust_cone_ok(us, "nominal").tolist() == [False, True]
    u_hat = tex.effective_thrust(us)
    np.testing.assert_allclose(u_hat[1, 1].numpy(), [0.0, 0.0, 12.5],
                               atol=1e-3)
    xs = torch.zeros((2, 61, 12), dtype=F64)
    _, xT = tex.initial_and_goal("cpu")
    xs[:, -1] = xT
    xs[1, -1, 8] += 0.25
    xs[1, -1, 0] += 5.0          # x is an inequality row: not counted
    np.testing.assert_allclose(tex.final_state_error(xs, xT).numpy(),
                               [0.0, 0.25])


T_SHORT = 11
B_SHORT = 4


def _near_pad_x0s():
    """Hovering 0.3 m above the pad at the goal attitude, falling at 0.3
    m/s, scattered by 0.01 N(0, 1) (numpy seed 0)."""
    _, xT = tex.initial_and_goal("cpu")
    x = xT.numpy().copy()
    x[2] += 0.3
    x[8] = -0.3
    rng = np.random.RandomState(0)
    return x[None] + 0.01 * rng.randn(B_SHORT, 12)


@functools.lru_cache(maxsize=None)
def _short_slices(accelerator_ip):
    """The port's and the reference's short deploys on the same
    scenarios and controls: ((result, stats), (result, stats))."""
    jprob, _, _, jopts = jex.build_deploy_problem(accelerator_ip,
                                                  dtype=jnp.float64)
    tprob, _, us0, topts = tex.build_deploy_problem(
        "cpu", dtype=F64, accelerator_ip=accelerator_ip)
    jprob = jprob._replace(T=T_SHORT,
                           ineq_mask=jprob.ineq_mask[:T_SHORT - 1])
    tprob = tprob._replace(T=T_SHORT,
                           ineq_mask=tprob.ineq_mask[:T_SHORT - 1])
    jopts = dataclasses.replace(jopts, max_al_iter=2)
    topts = dataclasses.replace(topts, max_al_iter=2)
    x0s = _near_pad_x0s()
    us = us0[:T_SHORT - 1]
    lines = []
    ts = make_segmented_solver(tprob, topts, B_SHORT, F64, "cpu",
                               compact=False, max_iter_schedule=[3, 3],
                               al_stall_rounds=tex.DEPLOY_AL_STALL_ROUNDS,
                               log=lines.append)
    rt = ts(torch.as_tensor(x0s), us)
    # the progress log: a line an inner iteration, a line an AL round
    assert sum(ln.startswith("  inner it=") for ln in lines) == \
        ts.stats["inner_iters"]
    assert [ln.split(":")[0] for ln in lines if ln.startswith("al round")] \
        == ["al round 1", "al round 2"][:rt.al_iterations.max()]
    js = jax_segmented_solver(jprob, jopts, B_SHORT, dtype=jnp.float64,
                              compact=False, max_iter_schedule=[3, 3],
                              al_stall_rounds=tex.DEPLOY_AL_STALL_ROUNDS)
    rj = js(jnp.asarray(x0s), jnp.asarray(us.numpy()))
    return (rt, dict(ts.stats)), (rj, dict(js.stats)), us


@pytest.mark.parametrize("ip", ["cpu", "accelerator"])
def test_short_deploy_matches_jax(ip):
    (rt, st), (rj, sj), us0 = _short_slices(ip == "accelerator")
    np.testing.assert_allclose(rt.objective.numpy(),
                               np.asarray(rj.objective), rtol=1e-6)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-6)
    np.testing.assert_allclose(rt.constraint_violation.numpy(),
                               np.asarray(rj.constraint_violation),
                               rtol=1e-6)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert st == sj
    assert bool(torch.isfinite(rt.xs).all())
    # the controls moved off the initial guess towards hover thrust, and
    # the projected thrust is in the cone on every lane
    assert float((rt.us - us0).abs().max()) > 1.0
    assert bool(tex.thrust_cone_ok(rt.us).all())
