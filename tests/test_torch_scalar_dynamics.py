"""Port parity: the scalar implicit-dynamics members of the five models.

``step_info``, ``step``, ``step_jac``, ``step_carry`` and ``step_diff``
of the cartpole friction model, the acrobot with joint limits, planar
push, the hopper model, and the rocket's ``step``, ``step_jac``,
``project`` and ``project_jac``, against the reference's scalar members
on the same numpy-seeded states in float64. The port's scalar members are
its lane-batched ones on a batch of one (the fused IP kernel's plain
version on the CPU); the reference's run its scalar solver. Held to the
deploy files' tolerances: y within 1e-10, fx and fu within 1e-8, the IP
iteration counts and converged flags identical. ``simulate`` is held to
``tests/test_simulate.py``'s acrobot case and to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_dynamics,
)
from optimization_dynamics_tpu.dynamics import simulate as jax_simulate
from optimization_dynamics_tpu.models import acrobot as jac
from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu.models import hopper as jhp
from optimization_dynamics_tpu.models import planar_push as jpp
from optimization_dynamics_tpu.models import rocket as jro
from optimization_dynamics_tpu.solver import interior_point as jip
from optimization_dynamics_tpu_torch.dynamics import (
    make_implicit_dynamics,
    simulate,
    state_to_configuration,
)
from optimization_dynamics_tpu_torch.models import acrobot as tac
from optimization_dynamics_tpu_torch.models import cartpole as tcp
from optimization_dynamics_tpu_torch.models import hopper as thp
from optimization_dynamics_tpu_torch.models import planar_push as tpp
from optimization_dynamics_tpu_torch.models import rocket as tro
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)
F64 = torch.float64
Y_TOL = 1e-10
JAC_TOL = 1e-8


def _cartpole(rng, n):
    q1 = 0.3 * rng.standard_normal((n, 2))
    q0 = q1 - 0.02 * rng.standard_normal((n, 2))
    return np.concatenate([q0, q1], 1), 0.8 * rng.standard_normal((n, 1))


def _acrobot(rng, n):
    # elbow near and past its pi/2 limit, so the limit rows are active
    q1 = np.stack([rng.standard_normal(n), rng.uniform(1.3, 1.7, n)], 1)
    q0 = q1 - 0.05 * rng.standard_normal((n, 2))
    return np.concatenate([q0, q1], 1), 3.0 * rng.standard_normal((n, 1))


def _push(rng, n):
    q = np.array([0.0, 0.0, 0.0, -tpp.R_DIM - 1e-8, 0.0])
    q1 = q + 0.01 * rng.standard_normal((n, 5)) * [1, 1, 1, 0, 1]
    q0 = q1 - 0.005 * rng.standard_normal((n, 5)) * [1, 1, 1, 0, 1]
    return (np.concatenate([q0, q1], 1),
            np.abs(rng.standard_normal((n, 2))) * [1.0, 0.2])


def _hopper(rng, n):
    p = thp.HopperParams()
    q = np.array([0.0, 0.5 + p.foot_radius, 0.0, 0.5])
    q1 = q + 0.02 * rng.standard_normal((n, 4))
    q0 = q1 - 0.01 * rng.standard_normal((n, 4))
    u_stand = p.gravity * p.mass_body * 0.5 * 0.05
    return (np.concatenate([q0, q1], 1),
            [0.0, u_stand] + 0.1 * rng.standard_normal((n, 2)))


MODELS = {
    # name: (reference model and aux, port model and aux of the reference
    # aux, kappa_eval_tol, kappa_grad_tol, draws)
    "cartpole": (lambda: (jcp.friction_model(), jcp.CartpoleAux(
        h=0.05, friction=jnp.asarray([0.35, 0.35]))),
        lambda a: (tcp.friction_model(), convert.cartpole_aux(a, "cpu",
                                                              F64)),
        1e-4, 1e-3, _cartpole),
    "acrobot": (lambda: (jac.impact_model(), jac.AcrobotAux(h=0.05)),
                lambda a: (tac.impact_model(), convert.acrobot_aux(a, "cpu",
                                                                   F64)),
                1e-4, 1e-3, _acrobot),
    "planar_push": (lambda: (jpp.model(), jpp.PlanarPushAux(h=0.1)),
                    lambda a: (tpp.model(), convert.planar_push_aux(a)),
                    1e-4, 1e-2, _push),
    "hopper": (lambda: (jhp.model(), jhp.HopperAux(h=0.05)),
               lambda a: (thp.model(), convert.hopper_aux(a, "cpu", F64)),
               1e-4, 1e-3, _hopper),
}


def _pair(name):
    jmake, tmake, k_eval, k_grad, draws = MODELS[name]
    jmodel, jaux = jmake()
    tmodel, taux = tmake(jaux)
    kw = dict(r_tol=1e-8, kappa_eval_tol=k_eval, kappa_grad_tol=k_grad)
    return (jax_dynamics(jmodel, **kw), jaux,
            make_implicit_dynamics(tmodel, "cpu", F64, **kw), taux, draws)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_scalar_steps_match_jax(name):
    """Cold ``step_info`` / ``step`` / ``step_jac``, and ``step_carry``
    warm-started from the eval solution of a neighbouring state, on three
    states each."""
    jd, jaux, td, taux, draws = _pair(name)
    xs, us = draws(np.random.default_rng(70), 3)
    j_info = jax.jit(jd.step_info)
    j_jac = jax.jit(jd.step_jac)
    j_carry = jax.jit(jd.step_carry)
    for x, u in zip(xs, us):
        xt, ut = torch.tensor(x), torch.tensor(u)
        y_j, sol_j = j_info(x, u, jaux)
        y_t, sol_t = td.step_info(xt, ut, taux)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=Y_TOL,
                                   rtol=0)
        assert int(sol_t.iterations) == int(sol_j.iterations)
        assert bool(sol_t.converged) == bool(sol_j.converged)
        assert bool(sol_t.converged)
        np.testing.assert_array_equal(td.step(xt, ut, taux).numpy(),
                                      y_t.numpy())
        for got, ref, tol in zip(td.step_jac(xt, ut, taux),
                                 j_jac(x, u, jaux),
                                 (Y_TOL, JAC_TOL, JAC_TOL)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=tol, rtol=0)
        # warm start: the solver variables of a nearby state's step
        z_prev = td.step_info(xt * 0.99, ut, taux)[1].z
        y_c, z_c = td.step_carry(z_prev, xt, ut, taux)
        y_cj, z_cj = j_carry(jnp.asarray(z_prev.numpy()), x, u, jaux)
        np.testing.assert_allclose(y_c.numpy(), np.asarray(y_cj),
                                   atol=Y_TOL, rtol=0)
        np.testing.assert_allclose(z_c.numpy(), np.asarray(z_cj),
                                   atol=Y_TOL, rtol=0)
    np.testing.assert_array_equal(td.carry_init(xt).numpy(),
                                  np.asarray(jd.carry_init(x)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_diff_backward_is_the_ift_jacobian(name):
    """``step_diff``'s value is ``step``'s, and autograd through it gives
    ``step_jac``'s Jacobians (the reference differentiates its
    ``custom_vjp`` with ``jax.jacrev``, ``tests/test_acrobot.py``)."""
    _, _, td, taux, draws = _pair(name)
    xs, us = draws(np.random.default_rng(71), 1)
    x, u = torch.tensor(xs[0]), torch.tensor(us[0])
    np.testing.assert_array_equal(td.step_diff(x, u, taux).numpy(),
                                  td.step(x, u, taux).numpy())
    fx_ad, fu_ad = torch.autograd.functional.jacobian(
        lambda a, b: td.step_diff(a, b, taux), (x, u))
    _, fx, fu = td.step_jac(x, u, taux)
    np.testing.assert_array_equal(fx_ad.numpy(), fx.numpy())
    np.testing.assert_array_equal(fu_ad.numpy(), fu.numpy())
    xr = x.clone().requires_grad_(True)
    g = torch.arange(1.0, x.shape[0] + 1, dtype=F64)
    (td.step_diff(xr, u, taux) @ g).backward()
    np.testing.assert_allclose(xr.grad.numpy(), (fx.T @ g).numpy(),
                               atol=1e-14, rtol=0)


def test_rocket_scalar_members_match_jax():
    """The rocket's scalar ``project``, ``project_jac``, ``step`` and
    ``step_jac`` (projection mode) on three thrusts and states."""
    jdyn = jro.make_rocket_dynamics(jro.RocketParams(), u_max=12.5, h=0.05,
                                    projection=True)
    jdyn = jdyn._replace(**{f: jax.jit(getattr(jdyn, f)) for f in
                            ("project", "project_jac", "step", "step_jac")})
    tdyn = tro.make_rocket_dynamics(tro.RocketParams(), u_max=12.5, h=0.05,
                                    projection=True, device="cpu",
                                    dtype=F64)
    rng = np.random.default_rng(72)
    x1 = np.zeros(12)
    x1[0:3] = [2.5, 2.5, 10.0]
    x1[8] = -1.0
    for _ in range(3):
        x = x1 + 0.1 * rng.standard_normal(12)
        # outside the cone and past u_max on some draws
        u = np.array([3.0, 3.0, 9.0]) * rng.standard_normal(3)
        xt, ut = torch.tensor(x), torch.tensor(u)
        np.testing.assert_allclose(tdyn.project(ut).numpy(),
                                   np.asarray(jdyn.project(u)), atol=Y_TOL,
                                   rtol=0)
        for got, ref in zip(tdyn.project_jac(ut), jdyn.project_jac(u)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=JAC_TOL, rtol=0)
        np.testing.assert_allclose(tdyn.step(xt, ut).numpy(),
                                   np.asarray(jdyn.step(x, u)), atol=Y_TOL,
                                   rtol=0)
        for got, ref, tol in zip(tdyn.step_jac(xt, ut), jdyn.step_jac(x, u),
                                 (Y_TOL, JAC_TOL, JAC_TOL)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=tol, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS) + ["rocket_projection"])
def test_restart_kappa_floor_never_binds(name):
    """After a stall the solver resets the cone variables and restarts
    kappa at their bilinear-row violation, clipped below at
    ``kappa_final`` (the reference's scalar solver) or ``max(kappa_final,
    kappa_init_min)`` (its batched one and the port). That violation is
    at least 1 for every model (its bilinear rows are the cone products), so
    with ``kappa_init_min <= 1`` both floors give the same kappa."""
    rng = np.random.default_rng(73)
    if name == "rocket_projection":
        model = tro.projection_model()
        thetas = torch.tensor(rng.standard_normal((50, model.spec.ntheta)))
    else:
        _, _, td, taux, draws = _pair(name)
        model = td.model
        xs, us = (torch.tensor(a) for a in draws(rng, 50))
        thetas = model.theta_fn(xs[:, :model.nq], xs[:, model.nq:], us,
                                taux)
    mask, template = tip._cone_reset(model.spec, "cpu", F64)
    _, bil, _ = tip._row_masks(model.spec, "cpu", F64)
    z = torch.where(mask, template,
                    torch.tensor(rng.standard_normal((50, model.spec.nz))))
    kv = torch.amax(torch.abs(model.residual(z, thetas, 0.0)) * bil, dim=1)
    assert float(kv.min()) >= 1.0


def test_step_carry_through_a_stall_restart():
    """Warm starts from the solution at the mirrored state (the elbow
    limit on the other side, the torque reversed) wedge the acrobot's
    line search on some lanes, and the one-shot restart fires (the solve
    cut at that iteration ends on the reset cone variables). On every
    lane the port's eval solve (K1a's plain version, what ``step_carry``
    runs) converges exactly when the reference's scalar one does, and
    ``step_carry``'s y and z agree with the reference's within 1e-10.
    Iteration counts are held on the lanes without a restart only: after
    a stall the count follows the start's last bit (a one-ulp change of
    z_prev moves the reference's own count on a restarted lane and on no
    other), so the port's count may differ there by rounding."""
    jd, jaux, td, taux, draws = _pair("acrobot")
    model = td.model
    rng = np.random.default_rng(1)
    xs, us = (torch.tensor(a) for a in draws(rng, 40))
    xf, uf = (torch.tensor(a) for a in draws(rng, 40))
    xf[:, 1::2] *= -1.0
    _, z_prev = td.step_batched_ws(xf, -9.0 * uf, taux, td.carry_init(xf))
    thetas = model.theta_fn(xs[:, :2], xs[:, 2:], us, taux)
    jo = jip.IPOptions(r_tol=1e-8, kappa_tol=1e-4, kappa_init_min=1e-2)
    to = convert.ip_options(jo)
    cone = list(model.spec.ort_prim) + list(model.spec.ort_dual)
    restarted = np.zeros(len(xs), bool)
    for k in range(1, 31):
        z = tip.make_solver_batched(model.residual, model.spec,
                                    dataclasses.replace(to, max_iter=k),
                                    "cpu", F64)(z_prev, thetas).z
        restarted |= (z[:, cone] == 1.0).all(1).numpy()
    assert restarted.sum() >= 5

    sol = make_fused_ip_solver(model, to, "cpu", F64)(z_prev, thetas)
    js = jax.jit(jip.make_solver(jd.model.residual, jd.model.spec, jo))
    j_carry = jax.jit(jd.step_carry)
    moved = np.zeros(len(xs), bool)
    for i in list(np.nonzero(restarted)[0]) + list(range(12)):
        zj, th = z_prev[i].numpy(), jnp.asarray(thetas[i].numpy())
        ref = js(jnp.asarray(zj), th)
        assert bool(sol.converged[i]) == bool(ref.converged), i
        if not restarted[i]:
            assert int(sol.iterations[i]) == int(ref.iterations), i
        y, z = td.step_carry(z_prev[i], xs[i], us[i], taux)
        y_j, z_j = j_carry(jnp.asarray(zj), xs[i].numpy(), us[i].numpy(),
                           jaux)
        if bool(ref.converged):
            np.testing.assert_allclose(y.numpy(), np.asarray(y_j),
                                       atol=Y_TOL, rtol=0)
            np.testing.assert_allclose(z.numpy(), np.asarray(z_j),
                                       atol=Y_TOL, rtol=0)
        for j in range(len(zj)):
            for direction in (np.inf, -np.inf):
                zp = zj.copy()
                zp[j] = np.nextafter(zp[j], direction)
                moved[i] |= int(js(jnp.asarray(zp), th).iterations) != int(
                    ref.iterations)
    assert moved[restarted].any()
    assert not moved[:12][~restarted[:12]].any()


def test_simulate_collects_solver_variables():
    """``tests/test_simulate.py``'s acrobot case: 12 steps of torque 3
    into the elbow limit; every step converged, the limit impulse
    positive once the limit engages, the slacks the signed distances;
    states and solver variables as the reference's ``simulate``."""
    jd = jax_dynamics(jac.impact_model())
    td = make_implicit_dynamics(tac.impact_model(), "cpu", F64)
    jaux = jac.AcrobotAux(h=0.05)
    taux = convert.acrobot_aux(jaux, "cpu", F64)
    x0 = np.array([0.0, 1.4, 0.0, 1.45])
    us = np.full((12, 1), 3.0)
    xs, sols = simulate(td, torch.tensor(x0), torch.tensor(us), taux)
    assert xs.shape == (13, 4)
    assert sols.z.shape == (12, tac.NZ_IMPACT)
    assert bool(sols.converged.all())
    lam = sols.z[:, 2:4]
    assert float(lam.max()) > 1e-3
    phi = np.stack([np.asarray(jac.signed_distance(x[2:]))
                    for x in xs[1:].numpy()])
    np.testing.assert_allclose(sols.z[:, 4:6].numpy(), phi, atol=1e-3)
    xs_j, sols_j = jax.jit(lambda x, u: jax_simulate(jd, x, u, jaux))(x0, us)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), atol=Y_TOL,
                               rtol=0)
    np.testing.assert_allclose(sols.z.numpy(), np.asarray(sols_j.z),
                               atol=Y_TOL, rtol=0)
    np.testing.assert_array_equal(sols.iterations.numpy(),
                                  np.asarray(sols_j.iterations))
    qs = state_to_configuration(xs)
    assert qs.shape == (14, 2)
    np.testing.assert_array_equal(qs[0].numpy(), x0[:2])
    np.testing.assert_array_equal(qs[1:].numpy(), xs[:, 2:].numpy())
