"""Port end-to-end: the examples' scalar AL-iLQR solves reach the goldens.

Each test runs the port's ``solver.ilqr.solve`` on an example's
``build_problem`` in float64 on the CPU (the kernels' plain versions) and
holds it to the checks and the golden of the reference's
``tests/test_examples_e2e.py`` (rtol 5%), or of ``tests/goldens.json``
where that file pins no test (push rotate, the acrobot's two modes,
cartpole frictionless). The acrobot and the rocket start from the
reference's ``jax.random`` initial controls, whose solves the goldens
record (the port's ``build_problem`` draws them from numpy); push with
the gradient bundle takes the reference's draws and is also held to the
reference's solve; the direct-transcription hopper gait
(``examples/comparisons``) to the reference's
``tests/test_comparisons.py`` checks. All slow:
the scalar path solves one IP problem at a time, tens of minutes each on
the CPU.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

_GOLDENS = json.load(open(os.path.join(os.path.dirname(__file__),
                                       "goldens.json")))

torch.set_num_threads(1)


def _check_golden(name, value, rtol=0.05):
    """The objective is one of the golden's known optima (cartpole
    friction 0.35 has two), within ``rtol``."""
    refs = _GOLDENS[name]
    if not isinstance(refs, list):
        refs = [refs]
    assert any(abs(value - r) <= rtol * abs(r) for r in refs), (
        name, value, refs)


def _reference_us_init(example, *args):
    """The reference example's initial controls as a float64 tensor."""
    import importlib

    jex = importlib.import_module("optimization_dynamics_tpu.examples."
                                  + example)
    return torch.as_tensor(np.array(jex.build_problem(*args)[2]),
                           dtype=torch.float64)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["friction", "frictionless"])
def test_cartpole_swingup(mode):
    from optimization_dynamics_tpu_torch.examples import cartpole as ex
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    prob, x0, us0, opts = ex.build_problem(mode, device="cpu")
    res = solve(prob, x0, us0, opts)
    assert bool(res.converged)
    assert float(res.constraint_violation) < opts.con_tol
    np.testing.assert_allclose(res.xs[-1].numpy(),
                               [0.0, math.pi, 0.0, math.pi], atol=1e-2)
    _check_golden("cartpole_%s_objective" % mode, float(res.objective))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["translate", "rotate"])
def test_planar_push(mode):
    from optimization_dynamics_tpu_torch.examples import planar_push as ex
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    prob, x0, us0, opts = ex.build_problem(mode, device="cpu")
    res = solve(prob, x0, us0, opts)
    assert bool(res.converged)
    assert float(res.constraint_violation) < opts.con_tol
    if mode == "translate":
        # block translated to x ~ 1, control limits respected
        assert abs(float(res.xs[-1][5]) - 1.0) < 0.01
        assert float(res.us.abs().max()) <= ex.U_LIM + 1e-6
    _check_golden("planar_push_%s_objective" % mode, float(res.objective))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["impact", "nominal"])
def test_acrobot_swingup(mode):
    from optimization_dynamics_tpu_torch.examples import acrobot as ex
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    prob, x0, _, opts = ex.build_problem(mode, device="cpu")
    res = solve(prob, x0, _reference_us_init("acrobot", mode), opts)
    assert bool(res.converged)
    if mode == "impact":
        # the elbow never passes its limit
        assert float(res.xs[:, 3].abs().max()) <= 0.5 * math.pi + 1e-6
    _check_golden("acrobot_%s_objective" % mode, float(res.objective))


@pytest.mark.slow
def test_rocket_projection_landing():
    from optimization_dynamics_tpu_torch.examples import rocket as ex
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    prob, x1, _, opts, dyn = ex.build_problem("projection", device="cpu")
    res = solve(prob, x1, _reference_us_init("rocket", "projection"), opts)
    assert bool(res.converged)
    # thrust-cone feasibility of the projected controls
    us_eff = dyn.project_batched(res.us).numpy()
    assert np.all(np.linalg.norm(us_eff[:, :2], axis=1)
                  <= us_eff[:, 2] + 1e-6)
    # lands upright at the pad
    assert abs(float(res.xs[-1][2]) - 1.0) < 0.01
    _check_golden("rocket_projection_objective", float(res.objective))


@pytest.mark.slow
@pytest.mark.parametrize("gait", [1, 2, 3])
def test_hopper_gait(gait):
    from optimization_dynamics_tpu_torch.examples import hopper as ex
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    prob, x0, us0, opts = ex.build_problem(gait, device="cpu")
    res = solve(prob, x0, us0, opts)
    assert bool(res.converged)
    x = res.xs[-1].numpy()
    theta = x[8:16]
    assert x[0] - theta[0] >= 0.5 - 1e-3          # travel
    assert np.max(np.abs(np.concatenate(
        [x[1:4] - theta[1:4], x[5:8] - theta[5:8]]))) < 1e-2  # periodicity
    _check_golden("hopper_gait%d_objective" % gait, float(res.objective))


def _reference_gb_draws(T, n, n_in, eps):
    """The draws of the reference push problem's gradient bundle, per
    timestep t: ``fold_in(PRNGKey(0), t)`` split into ``randint`` and
    ``eps * normal``, as its ``gb_jac`` draws them. Returns ``(coords,
    mags)``, (T-1, n) each."""
    import jax
    import jax.numpy as jnp

    coords, mags = [], []
    for t in range(T - 1):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                     t))
        coords.append(np.asarray(jax.random.randint(k1, (n,), 0, n_in)))
        mags.append(np.asarray(eps * jax.random.normal(k2, (n,),
                                                       jnp.float64)))
    return np.stack(coords), np.stack(mags)


@pytest.mark.slow
def test_planar_push_gradient_bundle():
    """The translate problem with the gradient bundle's Jacobians from the
    reference's draws: converged, the block at x ~ 1, the controls in
    their box to the AL's constraint tolerance (this solve ends 3e-5 past
    it), the golden within 5%, and the reference's own bundle solve
    (objective rtol 1e-6, controls atol 1e-6)."""
    import jax

    from optimization_dynamics_tpu.examples import planar_push as jex
    from optimization_dynamics_tpu.solver.ilqr import solve as jax_solve
    from optimization_dynamics_tpu_torch.examples import planar_push as ex
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    draws = _reference_gb_draws(ex.T, ex.GB_SAMPLES, ex.NX + ex.NU, ex.GB_EPS)
    prob, x0, us0, opts = ex.build_problem("translate", gradient_bundle=True,
                                           device="cpu", gb_draws=draws)
    res = solve(prob, x0, us0, opts)
    assert bool(res.converged)
    assert abs(float(res.xs[-1][5]) - 1.0) < 0.01
    assert float(res.us.abs().max()) <= ex.U_LIM + opts.con_tol
    _check_golden("planar_push_gb_objective", float(res.objective))
    jprob, jx0, jus0, jopts = jex.build_problem("translate",
                                                gradient_bundle=True)
    ref = jax.jit(lambda x, u: jax_solve(jprob, x, u, jopts))(jx0, jus0)
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-6)
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us),
                               atol=1e-6)


@pytest.mark.slow
def test_hopper_direct_transcription_hops():
    """The reference test's checks on the port's direct-transcription
    hopper gait: converged, travel >= 0.5 - 1e-2, complementarity slack
    sum < 1e-2."""
    from optimization_dynamics_tpu_torch.examples.comparisons import (
        hopper_direct as ex)
    _, res = ex.run(device="cpu")
    assert res.converged
    w = res.w.reshape(ex.T - 1, ex.NW_STAGE).numpy()
    assert w[-1, 0] >= 0.5 - 1e-2
    assert np.sum(w[:, 20]) < 1e-2
