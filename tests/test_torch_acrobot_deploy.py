"""Port parity: the acrobot deploy slice against the JAX package.

* The deploy slice: ``build_deploy_problem("cpu")`` (float64) and the
  reference's ``build_deploy_problem(on_tpu=False)`` cut to a horizon of
  T=16, at the CPU IP settings and at the accelerator IP settings (the
  one-stage kappa schedule), at B=4 with ``compact=False``, one AL round
  of two inner iterations. Both packages start from the port's numpy
  scenarios and initial controls. Objective to rtol 1e-6, controls to
  atol 1e-6 (the IP solves agree to ~1e-12: QR against LU), dispatch
  counters and iteration counts exactly.
* The warm-start policy, pinned on the port's phases: a line-search
  rollout is the same whatever solver variables it is handed (it starts
  every step cold), and the derivative sweep warm-starts from exactly
  the variables the rollout returned.
* A slow end-to-end check: the impact swing-up of ``build_problem`` at
  batch 1 converges, keeps the elbow within its limit and lands within
  5% of tests/goldens.json.
"""

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import acrobot as jex
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.examples import acrobot as tex
from optimization_dynamics_tpu_torch.solver.ilqr_batched import make_phases
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64
T_SHORT = 16


@pytest.mark.parametrize("ip", ["cpu", "accelerator",
                                "accelerator_plain_kappa"])
def test_acrobot_deploy_slice_matches_jax(ip, monkeypatch):
    """The deploy slice against the JAX segmented solver at each IP
    branch: the CPU's, the accelerator's with the one-stage kappa
    schedule, and the accelerator's without it (``one_stage_kappa=False``
    against the reference's ``ODX_ACROBOT_KSCHED=0``)."""
    B = 4
    if ip == "cpu":
        jprob, _, _, jopts = jex.build_deploy_problem(False,
                                                      dtype=jnp.float64)
        tprob, tx0, tus0, topts = tex.build_deploy_problem("cpu")
    else:
        one_stage = ip == "accelerator"
        monkeypatch.setenv("ODX_ACROBOT_KSCHED", "1" if one_stage else "0")
        jprob, _, _, jopts = jex.build_deploy_problem(
            True, dtype=jnp.float64, fused=False)
        tprob, tx0, tus0, topts = tex.build_deploy_problem(
            "cpu", dtype=F64, one_stage_kappa=one_stage,
            accelerator_ip=True)
    # the warm-start policy: cold line-search rollouts, warm sweeps
    assert tprob.ws_linesearch is False and jprob.ws_linesearch is False
    assert tprob.dynamics_jac_batched_ws is not None
    assert convert.ilqr_options(jopts) == topts
    assert (tprob.T, tprob.nconT) == (jprob.T, jprob.nconT) == (101, 4)
    jprob, tprob = jprob._replace(T=T_SHORT), tprob._replace(T=T_SHORT)
    jopts = dataclasses.replace(jopts, max_al_iter=1)
    topts = dataclasses.replace(topts, max_al_iter=1)

    x0s = tex.deploy_x0s(tx0, B, seed=0)
    us0 = tus0[:T_SHORT - 1]
    js = jax_segmented_solver(jprob, jopts, B, dtype=jnp.float64,
                              compact=False, max_iter_schedule=[2])
    rj = js(jnp.asarray(x0s.numpy()), jnp.asarray(us0.numpy()))
    ts = make_segmented_solver(tprob, topts, B, F64, "cpu", compact=False,
                               max_iter_schedule=[2])
    rt = ts(x0s, us0)
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
    # the controls moved off the initial guess
    assert float((rt.us - us0).abs().max()) > 1e-2


def test_warm_sweep_cold_rollout_policy():
    """Line-search rollouts start cold: handing them the accepted
    trajectory's solver variables, or NaNs, gives the same rollout. The
    derivative sweep warm-starts from the rollout's own variables."""
    B, T = 3, 8
    prob, x0, us0, opts = tex.build_deploy_problem("cpu")
    seen = []
    jac_ws = prob.dynamics_jac_batched_ws

    def spy(ts, xs, us, wss):
        seen.append(wss.clone())
        return jac_ws(ts, xs, us, wss)

    prob = prob._replace(T=T, dynamics_jac_batched_ws=spy)
    ph = make_phases(prob, opts, B, F64, "cpu")
    x0s = tex.deploy_x0s(x0, B, seed=1)
    uss = us0[None, :T - 1].expand(B, -1, -1).clone()
    xss, wss = ph.rollout_open(x0s, uss)
    lams = torch.zeros((B, T - 1, 0), dtype=F64)
    lamTs = torch.zeros((B, 4), dtype=F64)
    rhos = torch.ones(B, dtype=F64)
    rng = np.random.default_rng(2)
    Kss = torch.as_tensor(0.1 * rng.standard_normal((B, T - 1, 1, 4)))
    kss = torch.as_tensor(rng.standard_normal((B, T - 1, 1)))
    alphas = torch.tensor([1.0, 0.5, 0.25], dtype=F64)
    a = ph.closed_loop(xss, uss, Kss, kss, alphas, lams, lamTs, rhos, wss)
    b = ph.closed_loop(xss, uss, Kss, kss, alphas, lams, lamTs, rhos,
                       torch.full_like(wss, float("nan")))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert bool(torch.isfinite(a[0]).all())
    ph.derivatives(a[0], a[1], lams, lamTs, rhos, a[3])
    assert len(seen) == 1
    torch.testing.assert_close(seen[0], a[3].reshape(B * (T - 1), -1),
                               rtol=0, atol=0)


def test_deploy_problem_settings():
    """The deploy problem's settings, scenarios and initial controls."""
    assert tex.DEPLOY_IP_ACCEL == dict(r_tol=3.0e-5, kappa_tol=1.0e-3,
                                       max_iter=40, max_ls=8)
    assert tex.DEPLOY_KAPPA_SCHEDULE == dict(
        kappa_scale=0.01, kappa_init_max=0.3, center_frac=0.2)
    prob, x0, us0, opts = tex.build_deploy_problem("cpu")
    assert x0.dtype == F64 and tuple(us0.shape) == (tex.T - 1, 1)
    assert (opts.con_tol, opts.rho_max, opts.alpha_min, opts.grad_tol) \
        == (0.01, 1.0e6, 1.0e-2, 1.0e-3)
    x0s = tex.deploy_x0s(x0, 3, seed=4)
    noise = np.random.default_rng(4).standard_normal((3, 4))
    np.testing.assert_array_equal(x0s.numpy(), 0.01 * noise)
    np.testing.assert_array_equal(
        us0.numpy(), 1e-3 * np.random.default_rng(1).standard_normal(
            (tex.T - 1, 1)))


@pytest.mark.slow
def test_acrobot_impact_golden():
    """The impact swing-up from rest (build_problem, batch 1) converges to
    x = [pi, 0, pi, 0], keeps the elbow within its joint limit and lands
    within 5% of the golden objective."""
    goldens = json.load(open(os.path.join(os.path.dirname(__file__),
                                          "goldens.json")))
    ref = goldens["acrobot_impact_objective"]
    prob, x0, us0, opts = tex.build_problem("impact", device="cpu")
    solve = make_segmented_solver(prob, opts, 1, F64, "cpu")
    res = solve(x0[None], us0)
    assert bool(res.converged[0])
    np.testing.assert_allclose(res.xs[0, -1].numpy(),
                               [math.pi, 0.0, math.pi, 0.0], atol=2e-3)
    assert float(res.xs[0, :, 3].abs().max()) <= math.pi / 2 + 1e-4
    obj = float(res.objective[0])
    assert abs(obj / ref - 1.0) <= 0.05, (obj, ref)
