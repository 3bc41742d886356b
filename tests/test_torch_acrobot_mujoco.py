"""Port parity: ``examples/comparisons/acrobot_mujoco.py`` against the JAX
package's.

``mjData`` carries warm-start state from one ``mj_step`` to the next,
so each comparison gives each package a fresh ``MuJoCoAcrobot`` and the
same sequence of calls:

* a step and the central-difference Jacobians equal the reference's bit
  for bit, and match MuJoCo's own ``mjd_transitionFD`` (atol 5e-4,
  rtol 1e-3, as ``tests/test_comparisons.py``);
* a T=6 scalar solve from the reference's ``jax.random`` controls
  matches the reference's (objective rtol 1e-6, controls atol 1e-6,
  identical iteration counts and flag);
* the command line writes the study only to the path it is given.

Slow: the full T=101 study's outcome has the shape of the reference's
committed ``docs/mujoco_study.json`` (read only).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from optimization_dynamics_tpu.examples.comparisons import (  # noqa: E402
    acrobot_mujoco as jm)
from optimization_dynamics_tpu.solver.ilqr import (  # noqa: E402
    ILQROptions as JaxOptions, solve as jax_solve)
from optimization_dynamics_tpu_torch.examples.comparisons import (  # noqa: E402,E501
    acrobot_mujoco as tm)
from optimization_dynamics_tpu_torch.solver.ilqr import (  # noqa: E402
    ILQROptions, solve)

torch.set_num_threads(1)
F64 = torch.float64


def _states(n=4):
    rng = np.random.default_rng(0)
    return [(0.5 * rng.standard_normal(4), rng.standard_normal(1))
            for _ in range(n)]


def test_step_and_fd_jacobians_bitwise_equal_jax():
    js, ts = jm.MuJoCoAcrobot(), tm.MuJoCoAcrobot()
    for x, u in _states():
        y_j = np.asarray(js.step(jnp.asarray(x), jnp.asarray(u)))
        y_t = ts.step(torch.as_tensor(x), torch.as_tensor(u))
        assert y_t.dtype == F64
        np.testing.assert_array_equal(y_t.numpy(), y_j)
        jac_j = js.step_jac(jnp.asarray(x), jnp.asarray(u))
        jac_t = ts.step_jac(torch.as_tensor(x), torch.as_tensor(u))
        for a, b in zip(jac_t, jac_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the batched members run a batch's rows in order: the same calls
    xs = np.stack([x for x, _ in _states()])
    us = np.stack([u for _, u in _states()])
    js2, ts2 = jm.MuJoCoAcrobot(), tm.MuJoCoAcrobot()
    want = [js2._jac_np(x.copy(), u.copy()) for x, u in zip(xs, us)]
    got = ts2.step_jac_batched(torch.as_tensor(xs), torch.as_tensor(us))
    for i, w in enumerate(want):
        for a, b in zip(got, w):
            np.testing.assert_array_equal(a[i].numpy(), b)


def test_fd_jacobians_match_native_fd():
    sim = tm.MuJoCoAcrobot()
    for x, u in _states(3):
        _, fx, fu = sim.step_jac(torch.as_tensor(x), torch.as_tensor(u))
        d = sim.data
        d.qpos[:] = x[:2]
        d.qvel[:] = x[2:]
        d.ctrl[:] = u
        A = np.zeros((4, 4))
        Bm = np.zeros((4, 1))
        mujoco.mjd_transitionFD(sim.model, d, 1e-6, 1, A, Bm, None, None)
        np.testing.assert_allclose(fx.numpy(), A, atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(fu.numpy(), Bm, atol=5e-4, rtol=1e-3)


def test_short_solve_matches_jax():
    T = 6
    jprob, jx0, jus0, _ = jm.build_problem(T=T)
    jres = jax_solve(jprob, jx0, jus0,
                     JaxOptions(max_iter=5, max_al_iter=3, con_tol=1e-2))
    tprob, tx0, tus0, _ = tm.build_problem(T=T, device="cpu",
                                           us_init=np.asarray(jus0))
    tres = solve(tprob, tx0, tus0,
                 ILQROptions(max_iter=5, max_al_iter=3, con_tol=1e-2))
    np.testing.assert_allclose(float(tres.objective), float(jres.objective),
                               rtol=1e-6)
    np.testing.assert_allclose(tres.us.numpy(), np.asarray(jres.us),
                               atol=1e-6)
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.al_iterations) == int(jres.al_iterations)
    assert bool(tres.converged) == bool(jres.converged)
    assert bool(torch.isfinite(tres.xs).all())
    # the default controls: a numpy draw of the same scale
    _, _, us_np, _ = tm.build_problem(T=T, device="cpu")
    assert us_np.shape == (T - 1, 1) and float(us_np.abs().max()) < 1e-2


def test_study_writes_only_the_given_path(tmp_path, monkeypatch):
    """``--study --save PATH`` writes PATH (a cut solve stands in for the
    T=101 study); the reference's ``docs/mujoco_study.json`` is left as
    it is; ``--save`` needs ``--study``."""
    doc = os.path.join(os.path.dirname(__file__), "..", "docs",
                       "mujoco_study.json")
    before = open(doc).read()
    build = tm.build_problem
    monkeypatch.setattr(tm, "build_problem", lambda **k: build(
        T=4, **k)[:3] + (ILQROptions(max_iter=1, max_al_iter=1),))
    out = tmp_path / "study.json"
    rec = tm.main(["--study", "--save", str(out), "--device", "cpu"])
    art = json.loads(out.read_text())
    assert art["converged"] == rec["converged"]
    assert set(art) <= set(json.load(open(doc)))
    assert open(doc).read() == before
    with pytest.raises(SystemExit):
        tm.main(["--save", str(out), "--device", "cpu"])


@pytest.mark.slow
def test_full_study_outcome_shape_matches_artifact():
    """The T=101 study from the reference's controls is stuck, as the
    reference's committed outcome records (read only)."""
    doc = os.path.join(os.path.dirname(__file__), "..", "docs",
                       "mujoco_study.json")
    with open(doc) as f:
        art = json.load(f)
    us0 = np.asarray(1.0e-3 * jax.random.normal(
        jax.random.PRNGKey(1), (tm.T - 1, tm.NU), jnp.float64))
    out = tm.study(device="cpu", us_init=us0)
    assert out["converged"] is art["converged"] is False
    assert out["constraint_violation"] > 10 * out["con_tol"]
    assert out["max_abs_elbow"] > out["elbow_hard_limit"]
    assert out["al_iterations"] == art["al_iterations"] == 20
    assert set(out) <= set(art)
