"""Port parity: the hopper deploy slice against the JAX package.

* The deploy dynamics: the unified first-step branch (``x8_eff =
  where(t == 0, u[2:10], x[0:8])`` and the per-row Jacobian blocks) at
  t=0, t=3 and a mixed-t sweep against the reference's
  ``build_deploy_problem(False)`` batched members: y within 1e-10, fx
  and fu within 1e-8 (both solve to r_tol 1e-8, Newton steps by QR
  against LU).
* The deploy problem's options, masks, initial state and controls and
  the cold line-search policy equal the reference's at both IP branches.
* The deploy slice: ``build_deploy_problem("cpu")`` (float64) against
  the reference's ``build_deploy_problem`` at the CPU IP settings and at
  the accelerator IP settings, at B=4 with ``compact=False``, one AL
  round of two inner iterations, both packages from the port's numpy
  scenarios and initial controls: objective to rtol 1e-6, controls to
  atol 1e-6, iterations, converged flags and dispatch counters exactly.
  With ``riccati_kernel`` (K3's plain version on the CPU) the slice
  gives the eager pass's result at the same tolerances.
* A slow end-to-end check: gait 1 from the reference's initial guess
  (``build_problem``, batch 1) converges, travels >= 0.48 with a
  periodicity error <= 1e-3, and lands within 5% of tests/goldens.json.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import hopper as jex
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.examples import hopper as tex
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64


def _xs_us(B=4):
    """Deploy states and controls around the initial guess (numpy seed
    0), as tests/test_hopper.py draws them."""
    _, x0, us0, _ = tex.build_deploy_problem("cpu")
    rng = np.random.RandomState(0)
    xs = x0.numpy()[None] + 0.01 * rng.randn(B, 16)
    us = us0.numpy()[0][None] + 0.01 * rng.randn(B, 10)
    return xs, us


def test_deploy_dynamics_match_jax():
    """dynamics_batched and dynamics_jac_batched at t=0 (theta from the
    controls, fx = 0), t=3 (theta copied, fx's identity block) and the
    mixed rows of a flattened sweep, against the reference's batched
    members."""
    jprob = jex.build_deploy_problem(False, dtype=jnp.float64)[0]
    tprob = tex.build_deploy_problem("cpu")[0]
    xs, us = _xs_us()
    xt, ut = torch.as_tensor(xs), torch.as_tensor(us)
    jdyn = jax.jit(jprob.dynamics_batched, static_argnums=0)
    jjac = jax.jit(jprob.dynamics_jac_batched)
    for t in (0, 3):
        np.testing.assert_allclose(
            tprob.dynamics_batched(t, xt, ut).numpy(),
            np.asarray(jdyn(t, xs, us)), atol=1e-10, err_msg="t=%d" % t)
    for ts in ([0] * 4, [3] * 4, [0, 1, 2, 0]):
        got = tprob.dynamics_jac_batched(torch.tensor(ts), xt, ut)
        ref = jjac(jnp.array(ts), xs, us)
        for g, r, tol in zip(got, ref, (1e-10, 1e-8, 1e-8)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol,
                                       err_msg="ts=%s" % ts)
    _, fxm, fum = tprob.dynamics_jac_batched(torch.tensor([0, 1, 2, 0]),
                                             xt, ut)
    assert float(fxm[0].abs().max()) == 0.0       # t=0: fx == 0
    assert float(fxm[1].abs().max()) > 0.1        # t=1: fx populated
    np.testing.assert_array_equal(fum[0, 8:16, 2:10].numpy(), np.eye(8))
    np.testing.assert_array_equal(fum[1, 8:16].numpy(), 0.0)


@pytest.mark.parametrize("accelerator_ip", [False, True])
def test_deploy_problem_settings_match_jax(accelerator_ip):
    """Options, masks, sizes, x0 and the initial controls equal the
    reference's at each IP branch; line-search rollouts start cold."""
    jprob, jx0, jus0, jopts = jex.build_deploy_problem(accelerator_ip,
                                                       dtype=jnp.float64)
    tprob, tx0, tus0, topts = tex.build_deploy_problem(
        "cpu", dtype=F64, accelerator_ip=accelerator_ip)
    assert convert.ilqr_options(jopts) == topts
    assert tprob.ws_linesearch is False and jprob.ws_linesearch is False
    assert tprob.dynamics_jac_batched_ws is not None
    for f in ("T", "nx", "nu", "ncon", "nconT"):
        assert getattr(tprob, f) == getattr(jprob, f), f
    for f in ("u_mask", "ineq_mask", "terminal_ineq_mask"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(),
                                      np.asarray(getattr(jprob, f)), f)
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    np.testing.assert_array_equal(tus0.numpy(), np.asarray(jus0))
    assert tex.DEPLOY_IP_ACCEL == dict(r_tol=3.0e-5, kappa_tol=1.0e-3,
                                       max_iter=40, max_ls=8)
    x0s = tex.deploy_x0s(tx0, 3, seed=4)
    noise = np.random.default_rng(4).standard_normal((3, 16))
    np.testing.assert_array_equal(x0s.numpy(), tx0.numpy() + 0.005 * noise)


def _slices(accelerator_ip, B=4):
    jprob, _, _, jopts = jex.build_deploy_problem(accelerator_ip,
                                                  dtype=jnp.float64)
    tprob, tx0, tus0, topts = tex.build_deploy_problem(
        "cpu", dtype=F64, accelerator_ip=accelerator_ip)
    jopts = dataclasses.replace(jopts, max_al_iter=1)
    topts = dataclasses.replace(topts, max_al_iter=1)
    x0s = tex.deploy_x0s(tx0, B, seed=0)
    return jprob, jopts, tprob, topts, x0s, tus0


def _port_slice(tprob, topts, x0s, us0):
    ts = make_segmented_solver(tprob, topts, x0s.shape[0], F64, "cpu",
                               compact=False, max_iter_schedule=[2])
    return ts(x0s, us0), dict(ts.stats)


@functools.lru_cache(maxsize=None)
def _eager_slice(accelerator_ip):
    """The port's slice with the eager backward pass, once per branch."""
    _, _, tprob, topts, x0s, us0 = _slices(accelerator_ip)
    return _port_slice(tprob, topts, x0s, us0)


def _assert_same(rt, st, ref, sref):
    np.testing.assert_allclose(rt.objective.numpy(),
                               np.asarray(ref.objective), rtol=1e-6)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(ref.us), atol=1e-6)
    np.testing.assert_allclose(rt.constraint_violation.numpy(),
                               np.asarray(ref.constraint_violation),
                               rtol=1e-6)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(ref.converged))
    assert st == sref


@pytest.mark.parametrize("ip", ["cpu", "accelerator"])
def test_hopper_deploy_slice_matches_jax(ip):
    """The deploy slice against the JAX segmented solver at each IP
    branch."""
    jprob, jopts, tprob, topts, x0s, us0 = _slices(ip == "accelerator")
    js = jax_segmented_solver(jprob, jopts, 4, dtype=jnp.float64,
                              compact=False, max_iter_schedule=[2])
    rj = js(jnp.asarray(x0s.numpy()), jnp.asarray(us0.numpy()))
    rt, st = _eager_slice(ip == "accelerator")
    _assert_same(rt, st, rj, dict(js.stats))
    assert st["inner_iters"] == 2
    # the controls moved off the initial guess, the first step's
    # configuration controls too
    assert float((rt.us - us0).abs().max()) > 1e-2
    assert float((rt.us[:, 0, 2:] - us0[0, 2:]).abs().max()) > 1e-4


def test_hopper_deploy_slice_riccati_kernel_matches_eager():
    """The same slice with the backward pass through K3's wrapper (its
    plain version on CPU tensors, at (16, 10) with the ragged mask) gives
    the eager pass's result."""
    _, _, tprob, topts, x0s, us0 = _slices(False)
    ref, sref = _eager_slice(False)
    rt, st = _port_slice(tprob, dataclasses.replace(topts,
                                                    riccati_kernel=True),
                         x0s, us0)
    _assert_same(rt, st, ref, sref)
    # masked controls stay at the initial guess after the first step
    np.testing.assert_array_equal(rt.us[:, 1:, 2:].numpy(),
                                  us0[1:, 2:].expand(4, -1, -1).numpy())


@pytest.mark.slow
def test_hopper_gait_golden():
    """Gait 1 from the reference's initial guess (build_problem, batch 1,
    the segmented executor) converges, travels at least 0.48 with a
    periodicity error of at most 1e-3, and lands within 5% of
    tests/goldens.json."""
    goldens = json.load(open(os.path.join(os.path.dirname(__file__),
                                          "goldens.json")))
    ref = goldens["hopper_gait1_objective"]
    prob, x0, us0, opts = tex.build_problem(1, device="cpu")
    solve = make_segmented_solver(prob, opts, 1, F64, "cpu")
    res = solve(x0[None], us0)
    assert bool(res.converged[0])
    travel, per = tex.gait_errors(res.xs[:, -1])
    assert float(travel[0]) >= 0.48 and float(per[0]) <= 1e-3
    obj = float(res.objective[0])
    assert abs(obj / ref - 1.0) <= 0.05, (obj, ref)
