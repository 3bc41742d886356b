"""Port parity: the planar-push deploy slice against the JAX package.

Planar push is the port's first problem with stage constraints (a control
box |u| <= 5, four inequality rows a stage, ``ineq_mask[t]`` indexed with
a batched ``t`` under ``vmap``) beside a six-row terminal equality.

* The batched phases with ``ncon = 4`` (``derivatives``, ``traj_cost``,
  ``con_violation``, ``dual_update``) on the deploy problem's costs and
  constraints cut to T=6, B=4, in float64, with controls past the box on
  some stages and multipliers of both signs, so active and inactive
  inequality rows both occur. A linear step stands in for the IP step in
  both packages (the deploy slice below runs the real one), so the phases
  agree to atol 1e-8.
* The deploy slice: ``build_deploy_problem("cpu")`` (float64, T=26) and
  the reference's ``build_deploy_problem(on_tpu=False)`` at B=4 with
  ``compact=False``, one AL round of two inner iterations. Objective to
  rtol 1e-6, controls to atol 1e-6, dispatch counters exactly.
* A slow end-to-end check: the translate problem of ``build_problem`` at
  batch 1 reaches the goal and lands within 5% of tests/goldens.json.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import planar_push as jex
from optimization_dynamics_tpu.solver.ilqr_batched import (
    make_phases as jax_make_phases,
)
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.examples import planar_push as tex
from optimization_dynamics_tpu_torch.models import planar_push as tpp
from optimization_dynamics_tpu_torch.solver.gradient_bundle import (
    make_gradient_bundle,
)
from optimization_dynamics_tpu_torch.solver.ilqr_batched import make_phases
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64


def _close(got, ref, atol=1e-8):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=1e-8)


def _linear_dynamics(xp, nx=tex.NX, nu=tex.NU):
    """A cheap stand-in for the IP step, in the framework ``xp`` (jnp or
    torch): x = [q0; q1] -> [q1; 2 q1 - q0 + G u], with G the pusher's
    h^2 / m on the controlled rows. The phases' AL pieces see the push
    problem's costs and constraints unchanged."""
    nq = nx // 2
    A = np.zeros((nx, nx))
    A[:nq, nq:] = np.eye(nq)
    A[nq:, :nq] = -np.eye(nq)
    A[nq:, nq:] = 2.0 * np.eye(nq)
    G = np.zeros((nx, nu))
    G[nq + 3, 0] = G[nq + 4, 1] = tex.H ** 2 / 10.0
    A, G = xp.asarray(A), xp.asarray(G)

    def step(xs, us):
        return xs @ A.T + us @ G.T

    def jac(ts, xs, us):
        B = xs.shape[0]
        return (step(xs, us), xp.broadcast_to(A, (B, nx, nx)),
                xp.broadcast_to(G, (B, nx, nu)))

    return dict(dynamics_batched=lambda t, xs, us: step(xs, us),
                dynamics_jac_batched=jac, dynamics_batched_ws=None,
                dynamics_jac_batched_ws=None, ws_init_batched=None)


def test_phases_with_stage_constraints_match_jax():
    T, B = 6, 4
    jprob, x0, _, jopts = jex.build_deploy_problem(False, "translate",
                                                   dtype=jnp.float64)
    tprob, _, _, topts = tex.build_deploy_problem("cpu")
    assert (tprob.ncon, tprob.nconT) == (jprob.ncon, jprob.nconT) == (4, 6)
    jph = jax_make_phases(jprob._replace(T=T, **_linear_dynamics(jnp)),
                          jopts, B, jnp.float64)
    tph = make_phases(tprob._replace(T=T, **_linear_dynamics(torch)),
                      topts, B, F64, "cpu")
    rng = np.random.default_rng(0)
    x0s = np.asarray(x0) + 0.02 * rng.standard_normal((B, tex.NX))
    uss = np.array([1.0, 0.0]) + 3.0 * rng.standard_normal((B, T - 1, 2))
    assert (np.abs(uss) > tex.U_LIM).any()
    lams = rng.standard_normal((B, T - 1, 4))
    lamTs = rng.standard_normal((B, 6))
    rhos = np.array([1.0, 10.0, 100.0, 1.0])
    d = {k: jnp.asarray(v) for k, v in dict(
        x0s=x0s, uss=uss, lams=lams, lamTs=lamTs, rhos=rhos).items()}
    t = lambda *a: [torch.as_tensor(np.array(v)) for v in a]

    xss_j, wss_j = jph.rollout_open(d["x0s"], d["uss"])
    xss_t, wss_t = tph.rollout_open(*t(d["x0s"], d["uss"]))
    _close(xss_t, xss_j)
    args = (d["lams"], d["lamTs"], d["rhos"])
    _close(tph.traj_cost(xss_t, *t(d["uss"], *args)),
           jph.traj_cost(xss_j, d["uss"], *args))
    _close(tph.derivatives(xss_t, *t(d["uss"], *args), wss_t),
           jph.derivatives(xss_j, d["uss"], *args, wss_j))
    vio_t = tph.con_violation(xss_t, *t(d["uss"]))
    _close(vio_t, jph.con_violation(xss_j, d["uss"]))
    _close(tph.dual_update(xss_t, *t(d["uss"], *args)),
           jph.dual_update(xss_j, d["uss"], *args))
    assert float(vio_t.min()) > 0.0


def test_push_deploy_slice_matches_jax():
    B = 4
    jprob, _, us0, jopts = jex.build_deploy_problem(False, "translate",
                                                    dtype=jnp.float64)
    tprob, tx0, tus0, topts = tex.build_deploy_problem("cpu")
    # the warm-start policy: cold line-search rollouts, warm sweeps
    assert tprob.ws_linesearch is False and jprob.ws_linesearch is False
    assert tprob.dynamics_jac_batched_ws is not None
    assert convert.ilqr_options(jopts) == topts
    np.testing.assert_array_equal(tus0.numpy(), np.asarray(us0))
    jopts = dataclasses.replace(jopts, max_al_iter=1)
    topts = dataclasses.replace(topts, max_al_iter=1)

    x0s = tex.deploy_x0s(tx0, B, seed=0)
    js = jax_segmented_solver(jprob, jopts, B, dtype=jnp.float64,
                              compact=False, max_iter_schedule=[2])
    rj = js(jnp.asarray(x0s.numpy()), us0)
    ts = make_segmented_solver(tprob, topts, B, F64, "cpu", compact=False,
                               max_iter_schedule=[2])
    rt = ts(x0s, tus0)
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
    assert dict(ts.stats) == dict(js.stats)
    assert ts.stats["inner_iters"] == 2


def test_deploy_scenarios_and_unported_options():
    """deploy_x0s translates block and pusher of both configurations by
    one offset a lane, as the reference bench builds them; the gradient
    bundle option builds the problem with the bundle's Jacobians, each
    timestep's draws from ``gb_seed``."""
    x0 = torch.zeros(10, dtype=F64)
    x0s = tex.deploy_x0s(x0, 3, seed=4)
    shift = (x0s - x0).numpy()
    np.testing.assert_array_equal(shift[:, [0, 3, 5, 8]],
                                  np.repeat(shift[:, :1], 4, axis=1))
    np.testing.assert_array_equal(shift[:, [1, 4, 6, 9]],
                                  np.repeat(shift[:, 1:2], 4, axis=1))
    assert (shift[:, [2, 7]] == 0).all()
    delta = 0.02 * np.random.default_rng(4).standard_normal((3, 2))
    np.testing.assert_array_equal(shift[:, :2], delta)
    prob = tex.build_problem("translate", gradient_bundle=True,
                             device="cpu", gb_seed=3)[0]
    dyn = make_implicit_dynamics(tpp.model(), "cpu", F64, r_tol=1e-8,
                                 kappa_eval_tol=1e-4, kappa_grad_tol=1e-2)
    gb = make_gradient_bundle(dyn, tex.GB_SAMPLES, tex.GB_EPS)
    coords, mags = gb.sample(np.random.default_rng(3), (tex.T - 1,))
    q = torch.tensor([0.0, 0.0, 0.0, -tpp.R_DIM - 1e-8, 0.0], dtype=F64)
    x, u = torch.cat([q, q]), torch.tensor([1.0, 0.0], dtype=F64)
    got = prob.dynamics_jac(2, x, u)
    ref = gb.gb_jac(x, u, tpp.PlanarPushAux(h=tex.H), (coords[2], mags[2]))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.slow
def test_push_translate_golden():
    """The translate problem from rest (build_problem, batch 1) converges,
    moves the block to x = 1 within the box on the controls, and lands
    within 5% of the golden objective."""
    goldens = json.load(open(os.path.join(os.path.dirname(__file__),
                                          "goldens.json")))
    ref = goldens["planar_push_translate_objective"]
    prob, x0, us0, opts = tex.build_problem("translate", device="cpu")
    solve = make_segmented_solver(prob, opts, 1, F64, "cpu")
    res = solve(x0[None], us0)
    assert bool(res.converged[0])
    np.testing.assert_allclose(float(res.xs[0, -1, 5]), 1.0, atol=1e-2)
    assert float(res.us.abs().max()) <= tex.U_LIM + opts.con_tol
    obj = float(res.objective[0])
    assert abs(obj / ref - 1.0) <= 0.05, (obj, ref)
