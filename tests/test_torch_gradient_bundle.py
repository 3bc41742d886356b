"""Port parity: the gradient bundle (``solver/gradient_bundle.py``).

The port takes its draws ``(coords, mags)`` as data; these tests compute
the reference's draws exactly as its ``gb_jac`` does from a key
(``split``, then ``randint`` and ``eps * normal``) and pass them to the
port, so both packages perturb the same coordinates by the same amounts,
in float64 on the CPU (the port's fused IP solves run K1n's plain
version). Bounds: y within 1e-10, fx and fu within 1e-6 (a y difference
is magnified 1/eps = 1e4 in M), and the IP iteration counts of every
solve identical, read from the one fused IP call a bundle makes. Also:
the closed-form fit against ``jnp.linalg.lstsq`` on the reference's
rank-deficient draws (t = 13 and t = 22 of the push problem leave an
input coordinate unsampled), and the reference's smooth cases with the
Gauss-Newton fitter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_dynamics,
)
from optimization_dynamics_tpu.examples import planar_push as jex
from optimization_dynamics_tpu.models import acrobot as jac
from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu.models import planar_push as jpp
from optimization_dynamics_tpu.solver.gradient_bundle import (
    make_gradient_bundle as jax_bundle,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.examples import planar_push as tex
from optimization_dynamics_tpu_torch.models import acrobot as tac
from optimization_dynamics_tpu_torch.models import cartpole as tcp
from optimization_dynamics_tpu_torch.models import planar_push as tpp
from optimization_dynamics_tpu_torch.ops.kernels import fused_ip as fip
from optimization_dynamics_tpu_torch.solver.gradient_bundle import (
    bundle_inputs,
    fit_lstsq,
    make_gradient_bundle,
)

torch.set_num_threads(1)
fip_fused_ip = fip.fused_ip
F64 = torch.float64
Y_TOL, JAC_TOL = 1e-10, 1e-6
N_PUSH, EPS_PUSH = 50, 1e-4
N_IN_PUSH = 2 * tpp.NQ + tpp.NU


def _reference_draws(key, n, n_in, eps):
    """``(coords, mags)`` as the reference's ``gb_jac`` draws them."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (n,), 0, n_in)),
            np.asarray(eps * jax.random.normal(k2, (n,), jnp.float64)))


def _push_draws(t):
    """The reference push problem's draws at timestep ``t``."""
    return _reference_draws(jax.random.fold_in(jax.random.PRNGKey(0), t),
                            N_PUSH, N_IN_PUSH, EPS_PUSH)


def _record_ip_solves(monkeypatch):
    """A list that collects every ``IPSolution`` the port's fused IP
    wrapper returns from here on."""
    sols = []

    def recorded(*args, **kwargs):
        sols.append(fip_fused_ip(*args, **kwargs))
        return sols[-1]

    monkeypatch.setattr(fip, "fused_ip", recorded)
    return sols


def _reference_counts(xs, us, draws):
    """The IP iteration counts of the reference's solves of the bundle's
    lanes (its scalar ``step_info`` over them)."""
    xs_all, us_all, _ = bundle_inputs(torch.tensor(xs), torch.tensor(us),
                                      tuple(torch.tensor(d) for d in draws),
                                      tpp.NQ)
    jdyn = jax_dynamics(jpp.model(), kappa_eval_tol=1e-4,
                        kappa_grad_tol=1e-2)
    aux = jpp.PlanarPushAux(h=0.1)
    _, sols = jax.jit(jax.vmap(lambda x, u: jdyn.step_info(x, u, aux)))(
        jnp.asarray(xs_all.numpy()), jnp.asarray(us_all.numpy()))
    return np.asarray(sols.iterations)


def test_gb_jac_push_matches_jax(monkeypatch):
    """The reference test's contact state and key PRNGKey(1)."""
    q = np.array([0.0, 0.0, 0.0, -tpp.R_DIM - 1e-8, 0.0])
    x, u = np.concatenate([q, q]), np.array([1.0, 0.0])
    key = jax.random.PRNGKey(1)
    draws = _reference_draws(key, N_PUSH, N_IN_PUSH, EPS_PUSH)
    jdyn = jax_dynamics(jpp.model(), kappa_eval_tol=1e-4,
                        kappa_grad_tol=1e-2)
    ref = jax.jit(jax_bundle(jdyn, n_samples=N_PUSH, eps=EPS_PUSH))(
        jnp.asarray(x), jnp.asarray(u), jpp.PlanarPushAux(h=0.1), key)
    dyn = make_implicit_dynamics(tpp.model(), "cpu", F64, r_tol=1e-8,
                                 kappa_eval_tol=1e-4, kappa_grad_tol=1e-2)
    gb = make_gradient_bundle(dyn, n_samples=N_PUSH, eps=EPS_PUSH)
    sols = _record_ip_solves(monkeypatch)
    got = gb.gb_jac(torch.tensor(x), torch.tensor(u),
                    tpp.PlanarPushAux(h=0.1),
                    tuple(torch.tensor(d) for d in draws))
    assert got[1].shape == (10, 10) and got[2].shape == (10, 2)
    for g, r, tol in zip(got, ref, (Y_TOL, JAC_TOL, JAC_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=tol)
    # one solve of all 51 lanes, each in the reference's iteration count
    assert len(sols) == 1
    np.testing.assert_array_equal(
        sols[0].iterations.numpy(),
        _reference_counts(x[None], u[None], tuple(d[None] for d in draws)))


def test_gb_jac_batched_push_trajectory_matches_jax(monkeypatch):
    """The bundle sweep over the 25 states of the translate problem's
    initial trajectory, with the reference's per-timestep draws, against
    the reference's ``jax.vmap(dynamics_jac)``; the rank-deficient
    timesteps (t = 13: coordinate 9 unsampled; t = 22: coordinate 8) give
    exactly zero columns."""
    jprob, jx0, jus0, _ = jex.build_problem("translate",
                                            gradient_bundle=True)
    step = jax.jit(lambda t, x, u: jprob.dynamics(t, x, u))
    xs = [jx0]
    for t in range(jex.T - 1):
        xs.append(step(t, xs[-1], jus0[t]))
    xs = np.asarray(jnp.stack(xs[:-1]))
    us = np.asarray(jus0)
    ts = np.arange(jex.T - 1)
    ref = jax.jit(jax.vmap(jprob.dynamics_jac))(jnp.asarray(ts),
                                                jnp.asarray(xs),
                                                jnp.asarray(us))
    draws = tuple(np.stack(d) for d in zip(*map(_push_draws, ts)))
    prob = tex.build_problem("translate", gradient_bundle=True,
                             device="cpu", gb_draws=draws)[0]
    sols = _record_ip_solves(monkeypatch)
    got = prob.dynamics_jac_batched(torch.tensor(ts), torch.tensor(xs),
                                    torch.tensor(us))
    for g, r, tol in zip(got, ref, (Y_TOL, JAC_TOL, JAC_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=tol)
    fxu = torch.cat([got[1][:, tpp.NQ:], got[2][:, tpp.NQ:]], 2)
    for t, col in ((13, 9), (22, 8)):
        assert not np.any(draws[0][t] == col)
        assert bool((fxu[t, :, col] == 0).all())
    # one solve of all (T-1)(N+1) = 1,275 lanes
    assert len(sols) == 1
    assert sols[0].iterations.shape == ((jex.T - 1) * (N_PUSH + 1),)
    np.testing.assert_array_equal(sols[0].iterations.numpy(),
                                  _reference_counts(xs, us, draws))


@pytest.mark.parametrize("t,col", [(13, 9), (22, 8)])
def test_rank_deficient_fit_matches_jax_lstsq(t, col):
    """On the draws that leave an input unsampled, the closed form gives
    the minimum-norm fit ``jnp.linalg.lstsq`` gives: a zero column there
    (a synthetic dF, fitted entries of order 1e4)."""
    coords, mags = _push_draws(t)
    assert not np.any(coords == col)
    etas = np.zeros((N_PUSH, N_IN_PUSH))
    etas[np.arange(N_PUSH), coords] = mags
    dF = np.random.default_rng(t).standard_normal((N_PUSH, tpp.NQ))
    ref = np.asarray(jnp.linalg.lstsq(jnp.asarray(etas),
                                      jnp.asarray(dF))[0]).T
    got = fit_lstsq(torch.tensor(etas)[None], torch.tensor(dF)[None])[0]
    scale = float(np.abs(ref).max())
    assert scale > 1e3
    assert bool((got[:, col] == 0).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * scale)


def _smooth(name):
    """(reference dynamics, port dynamics, x, u, reference aux, port
    aux, n_samples, eps) of the reference's smooth cases."""
    if name == "acrobot":
        x, u = np.array([0.1, -0.2, 0.12, -0.18]), np.array([0.3])
        return (jax_dynamics(jac.nominal_model(), kappa_eval_tol=1.0,
                             kappa_grad_tol=1.0),
                make_implicit_dynamics(tac.nominal_model(), "cpu", F64,
                                       kappa_eval_tol=1.0,
                                       kappa_grad_tol=1.0),
                x, u, jac.AcrobotAux(h=0.05),
                tac.AcrobotAux(h=torch.tensor(0.05, dtype=F64)), 200, 1e-5)
    x, u = np.array([0.1, 0.2, 0.05, 0.22]), np.array([0.3])
    return (jax_dynamics(jcp.frictionless_model(), kappa_eval_tol=1.0,
                         kappa_grad_tol=1.0),
            make_implicit_dynamics(tcp.frictionless_model(), "cpu", F64,
                                   kappa_eval_tol=1.0, kappa_grad_tol=1.0),
            x, u, jcp.CartpoleAux(h=0.05, friction=None),
            tcp.CartpoleAux(h=0.05, friction=None), 50, 1e-4)


@pytest.mark.parametrize("name", ["acrobot", "cartpole_frictionless"])
def test_smooth_bundle_matches_jax_and_gauss_newton(name):
    """The reference's smooth cases: the port's lstsq bundle against the
    reference's on the same draws; the Gauss-Newton fitter against the
    lstsq one (the reference test's bounds, atol 1e-6 and rtol 1e-5);
    the bundle against the IFT Jacobians (atol 1e-3) on the acrobot."""
    jdyn, dyn, x, u, jaux, aux, n, eps = _smooth(name)
    key = jax.random.PRNGKey(0)
    n_in = 2 * dyn.model.nq + dyn.model.nu
    draws = tuple(torch.tensor(d)
                  for d in _reference_draws(key, n, n_in, eps))
    ref = jax.jit(jax_bundle(jdyn, n_samples=n, eps=eps))(
        jnp.asarray(x), jnp.asarray(u), jaux, key)
    xt, ut = torch.tensor(x), torch.tensor(u)
    got = make_gradient_bundle(dyn, n_samples=n, eps=eps).gb_jac(
        xt, ut, aux, draws)
    gn = make_gradient_bundle(dyn, n_samples=n, eps=eps,
                              fitter="gauss_newton").gb_jac(xt, ut, aux,
                                                            draws)
    for g, r, tol in zip(got, ref, (Y_TOL, JAC_TOL, JAC_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(gn[0].numpy(), got[0].numpy())
    for g, l in zip(gn[1:], got[1:]):
        np.testing.assert_allclose(g.numpy(), l.numpy(), atol=1e-6,
                                   rtol=1e-5)
    if name == "acrobot":
        ift = dyn.step_jac(xt, ut, aux)
        np.testing.assert_allclose(got[0].numpy(), ift[0].numpy(),
                                   atol=1e-8)
        for g, i in zip(got[1:], ift[1:]):
            np.testing.assert_allclose(g.numpy(), i.numpy(), atol=1e-3)


def test_sample_draws_and_unknown_fitter():
    """``sample`` draws coordinates in range and ``eps``-sized normals of
    the requested shape; an unknown fitter raises."""
    dyn = make_implicit_dynamics(tcp.frictionless_model(), "cpu", F64)
    gb = make_gradient_bundle(dyn, n_samples=7, eps=1e-3)
    coords, mags = gb.sample(np.random.default_rng(0), (3,))
    assert coords.shape == (3, 7) and mags.shape == (3, 7)
    assert coords.dtype == torch.int64 and mags.dtype == F64
    assert int(coords.min()) >= 0 and int(coords.max()) < 5
    assert 0 < float(mags.abs().max()) < 1e-2
    with pytest.raises(ValueError):
        make_gradient_bundle(dyn, fitter="qr")


def test_entry_point_needs_a_card(monkeypatch):
    """``--gradient-bundle`` solves on the card by default and stops
    without one; it solves the scalar translate problem only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tex.main(["--gradient-bundle"])
    for argv in (["--gradient-bundle", "--deploy"],
                 ["--gradient-bundle", "--mode", "rotate"]):
        with pytest.raises(SystemExit):
            tex.main(argv + ["--device", "cpu"])


def test_entry_point_takes_draws(tmp_path, monkeypatch):
    """``--gradient-bundle --gb-draws FILE`` hands the file's draws to the
    bundle problem (how the reference's ``jax.random`` draws reach a run
    on the card): its Jacobians at t = 13 are the bundle's on the file's
    draws of t = 13."""
    got = {}

    def fake_solve(prob, x0, us0, opts):
        got["prob"] = prob
        raise SystemExit(0)

    monkeypatch.setattr(tex, "scalar_solve", fake_solve)
    draws = tuple(np.stack(d)
                  for d in zip(*map(_push_draws, range(tex.T - 1))))
    np.savez(tmp_path / "d.npz", coords=draws[0], mags=draws[1])
    with pytest.raises(SystemExit):
        tex.main(["--gradient-bundle", "--device", "cpu", "--gb-draws",
                  str(tmp_path / "d.npz")])
    q = torch.tensor([0.0, 0.0, 0.0, -tpp.R_DIM - 1e-8, 0.0], dtype=F64)
    x, u = torch.cat([q, q]), torch.tensor([1.0, 0.0], dtype=F64)
    dyn = make_implicit_dynamics(tpp.model(), "cpu", F64, r_tol=1e-8,
                                 kappa_eval_tol=1e-4, kappa_grad_tol=1e-2)
    ref = make_gradient_bundle(dyn, N_PUSH, EPS_PUSH).gb_jac(
        x, u, tpp.PlanarPushAux(h=tex.H),
        (torch.tensor(draws[0][13]), torch.tensor(draws[1][13])))
    for g, r in zip(got["prob"].dynamics_jac(13, x, u), ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    with pytest.raises(SystemExit):
        tex.main(["--device", "cpu", "--gb-draws", str(tmp_path / "d.npz")])
