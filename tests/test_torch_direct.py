"""Port parity: the direct-transcription solver and the hopper comparison.

``solver/direct.py::solve_direct`` on the reference's four analytic
problems (``tests/test_direct.py``) in float64 on the CPU, both packages
from the same start and options: w within 1e-8, the same inner and AL
iteration counts and flag. On the double integrator the penalty reaches
1e5-1e6, where the inner loop's stopping test (max|g| < 1e-8) is decided
by rounding (the two packages' ``Jc^T (lam + rho c)`` differ by 1e-11
there): its inner counts are held equal over the first five AL rounds
(penalty up to 1e4), its whole solve to w, the AL count and the flag.
The hopper comparison's NLP (``examples/comparisons/hopper_direct.py``):
its objective, equality and inequality rows at the warm start and at a
perturbed w within 1e-12 (the objective, of order 2e3, relative), their
Jacobians within 1e-10, and one Gauss-Newton gradient and Hessian
within 1e-9; the hopper model's ``lagrangian`` against the reference's
and against the port's closed-form mass matrix and bias.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples.comparisons import (
    hopper_direct as jhd,
)
from optimization_dynamics_tpu.models import hopper as jhp
from optimization_dynamics_tpu.solver import direct as jdir
from optimization_dynamics_tpu_torch.examples.comparisons import (
    hopper_direct as thd,
)
from optimization_dynamics_tpu_torch.models import hopper as thp
from optimization_dynamics_tpu_torch.solver import direct as tdir
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)
F64 = torch.float64


def _quadratic(xp):
    Q = xp.asarray(np.diag([1.0, 2.0, 3.0]))
    b = xp.asarray(np.array([1.0, -2.0, 0.5]))
    return dict(n=3, objective=lambda w: 0.5 * w @ Q @ w - b @ w), {}, None


def _equality_qp(xp):
    # min 0.5 ||w||^2 s.t. w1 + w2 = 1  ->  w = (0.5, 0.5)
    return (dict(n=2, objective=lambda w: 0.5 * w @ w,
                 eq_con=lambda w: w[0:1] + w[1:2] - 1.0),
            dict(con_tol=1e-6, grad_tol=1e-8), None)


def _inequality(xp):
    # min 0.5 ||w - (2, 0)||^2 s.t. w1 <= 1  ->  w = (1, 0)
    return (dict(n=2,
                 objective=lambda w: 0.5 * ((w[0] - 2.0) ** 2 + w[1] ** 2),
                 ineq_con=lambda w: w[0:1] - 1.0),
            dict(con_tol=1e-6, grad_tol=1e-8), None)


def _double_integrator(xp):
    """Direct transcription of the reach problem (T=10, h=0.1)."""
    T, h, nx, nu = 10, 0.1, 2, 1
    A = xp.asarray(np.array([[1.0, h], [0.0, 1.0]]))
    B = xp.asarray(np.array([[0.5 * h * h], [h]]))
    goal = xp.asarray(np.array([1.0, 0.0]))
    cat = jnp.concatenate if xp is jnp else torch.cat

    def split(w):
        return (w[:(T - 1) * nx].reshape(T - 1, nx),
                w[(T - 1) * nx:].reshape(T - 1, nu))

    def objective(w):
        return 0.5 * xp.sum(split(w)[1] ** 2)

    def eq_con(w):
        xs, us = split(w)
        x_prev = cat([xp.zeros((1, nx), dtype=xs.dtype), xs[:-1]], 0)
        defects = xs - (x_prev @ A.T + us @ B.T)
        return cat([defects.reshape(-1), xs[-1] - goal], 0)

    return (dict(n=(T - 1) * (nx + nu), objective=objective,
                 eq_con=eq_con),
            dict(con_tol=1e-6, grad_tol=1e-8, max_al_iter=12), 5)


@pytest.mark.parametrize("problem", [_quadratic, _equality_qp, _inequality,
                                     _double_integrator])
def test_analytic_problem_matches_jax(problem):
    jprob_kw, okw, count_rounds = problem(jnp)
    jprob = jdir.DirectProblem(**jprob_kw)
    tprob = tdir.DirectProblem(**problem(torch)[0])

    def both(jopts):
        ref = jax.jit(lambda w0: jdir.solve_direct(jprob, w0, jopts))(
            jnp.zeros(jprob.n))
        got = tdir.solve_direct(tprob, torch.zeros(jprob.n, dtype=F64),
                                convert.direct_options(jopts))
        return ref, got

    jopts = jdir.DirectOptions(**okw)
    ref, got = both(jopts)
    assert bool(ref.converged) and got.converged
    assert got.al_iterations == int(ref.al_iterations)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(got.objective), float(ref.objective),
                               rtol=1e-10, atol=1e-12)
    assert abs(got.constraint_violation
               - float(ref.constraint_violation)) <= 1e-10
    if count_rounds is not None:
        ref, got = both(dataclasses.replace(jopts, max_al_iter=count_rounds))
        assert got.al_iterations == int(ref.al_iterations) == count_rounds
    assert got.iterations == int(ref.iterations)


def test_direct_options_carry_every_field():
    """``convert.direct_options`` carries every field of the reference's
    options, each set away from its default."""
    fields = dataclasses.fields(jdir.DirectOptions)
    src = jdir.DirectOptions(**{
        f.name: (f.default + 3 if isinstance(f.default, int)
                 else f.default * 1.5) for f in fields})
    got = convert.direct_options(src)
    assert ({f.name for f in dataclasses.fields(got)}
            == {f.name for f in fields})
    for f in fields:
        assert getattr(got, f.name) == getattr(src, f.name), f.name


def test_hopper_lagrangian_matches_jax_and_closed_form():
    """``lagrangian`` against the reference's at random states; its
    ``torch.func`` derivatives against the closed-form ``mass_matrix``
    (``d2L/dv = M v``) and ``dynamics_bias`` (``-dL/dq``)."""
    p = thp.HopperParams()
    rng = np.random.default_rng(5)
    q = np.array([0.1, 0.55, 0.2, 0.5]) + 0.2 * rng.standard_normal((8, 4))
    v = rng.standard_normal((8, 4))
    ref = np.array([float(jhp.lagrangian(jhp.HopperParams(), jnp.asarray(a),
                                         jnp.asarray(b)))
                    for a, b in zip(q, v)])
    qt, vt = torch.tensor(q), torch.tensor(v)
    np.testing.assert_allclose(thp.lagrangian(p, qt, vt).numpy(), ref,
                               rtol=0, atol=1e-12)
    lag = lambda a, b: thp.lagrangian(p, a, b).sum()
    d1l = torch.func.grad(lag, argnums=0)(qt, vt)
    d2l = torch.func.grad(lag, argnums=1)(qt, vt)
    np.testing.assert_allclose(
        d2l.numpy(), (thp.mass_matrix(p, qt) @ vt[..., None])[..., 0].numpy(),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(d1l.numpy(),
                               -thp.dynamics_bias(p, qt, vt).numpy(),
                               rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def hopper_direct():
    jprob, jw0, jopts = jhd.build_problem()
    tprob, tw0, topts = thd.build_problem(
        convert.hopper_params(jhp.HopperParams()), device="cpu")
    rng = np.random.default_rng(11)
    w1 = np.asarray(jw0) + 0.01 * rng.standard_normal(jw0.shape)
    return jprob, jw0, jopts, tprob, tw0, topts, w1


def test_hopper_direct_problem_matches_jax(hopper_direct):
    jprob, jw0, jopts, tprob, tw0, topts, w1 = hopper_direct
    assert tprob.n == jprob.n == (thd.T - 1) * thd.NW_STAGE == 420
    assert topts == convert.direct_options(jopts)
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(jw0))
    for w in (np.asarray(jw0), w1):
        wj, wt = jnp.asarray(w), torch.tensor(w)
        np.testing.assert_allclose(float(tprob.objective(wt)),
                                   float(jprob.objective(wj)), rtol=1e-12,
                                   atol=1e-12)
        for name, m in (("eq_con", 163), ("ineq_con", 621)):
            ref = np.asarray(getattr(jprob, name)(wj))
            got = getattr(tprob, name)(wt).numpy()
            assert got.shape == ref.shape == (m,)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
            np.testing.assert_allclose(
                torch.func.jacfwd(getattr(tprob, name))(wt).numpy(),
                np.asarray(jax.jacfwd(getattr(jprob, name))(wj)),
                rtol=0, atol=1e-10)


def test_hopper_direct_gauss_newton_step_matches_jax(hopper_direct):
    """One Gauss-Newton gradient and Hessian of the augmented Lagrangian
    at the perturbed w, with numpy-seeded multipliers (some inequality
    rows active), against the reference's formula evaluated by JAX."""
    jprob, _, _, tprob, _, _, w1 = hopper_direct
    rng = np.random.default_rng(12)
    lam_eq = rng.standard_normal(163)
    lam_in = np.maximum(rng.standard_normal(621), 0.0)
    rho = 10.0

    def jax_gn(w):
        g = jax.grad(jprob.objective)(w)
        H = jax.hessian(jprob.objective)(w)
        c, Jc = jprob.eq_con(w), jax.jacfwd(jprob.eq_con)(w)
        g = g + Jc.T @ (lam_eq + rho * c)
        H = H + rho * Jc.T @ Jc
        c, Jc = jprob.ineq_con(w), jax.jacfwd(jprob.ineq_con)(w)
        g = g + Jc.T @ jnp.maximum(0.0, lam_in + rho * c)
        H = H + rho * (Jc.T * ((lam_in + rho * c) > 0.0)) @ Jc
        return g, H

    g_ref, H_ref = jax_gn(jnp.asarray(w1))
    _, gn_grad_hess, _ = tdir.make_al(tprob)
    g, H = gn_grad_hess(torch.tensor(w1), torch.tensor(lam_eq),
                        torch.tensor(lam_in), rho)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=0,
                               atol=1e-9)


def test_hopper_direct_entry_point_needs_a_card(monkeypatch):
    """The comparison solves on the card by default and stops without
    one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        thd.main([])
