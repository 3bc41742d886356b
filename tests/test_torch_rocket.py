"""Port parity: the rocket model, its two chained lane-batched IP solves,
and the SOC(3) cone algebra, against the JAX package.

Inputs are made with numpy from a seed. Tolerances:

* ``mrp_rotation``, ``ode``, both residuals and their Jacobians in z and
  theta (the port's ``batched_jacobian`` against ``jax.jacfwd``) are the
  same arithmetic in float64 up to summation order: 1e-12;
* the SOC(3) group of the thrust projection (permuted, axis first):
  ``step_to_boundary``, ``delta_products`` and ``interior_init`` against
  the reference's at 1e-12;
* the projection: cone-feasible, within 2e-2 of a dense search of the
  projection (tests/test_rocket.py's bound), equal to the reference's
  lane-batched solve and scalar ``project`` at 1e-10 (both solve to
  r_tol 1e-8), its Jacobian within 1e-4 of central differences;
* hover and free fall: exact to 1e-8 (tests/test_rocket.py's);
  ``step_jac_batched`` within 1e-5 (fx) and 1e-4 (fu) of central
  differences;
* every lane-batched member, projection on and off, against the
  reference's (both solve to r_tol 1e-8, the port's Newton steps by QR,
  the reference's by LU): y within 1e-10, fx and fu within 1e-8;
* ``step_batched`` in float32 against the reference's float32 at 2e-4
  (tests/test_fused_ip.py's float32 tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.models import rocket as jr
from optimization_dynamics_tpu.ops import cones as jcones
from optimization_dynamics_tpu.solver.interior_point import (
    IPOptions as JIPOptions,
    make_solver_batched as jax_solver_batched,
)
from optimization_dynamics_tpu_torch.models import rocket as tr
from optimization_dynamics_tpu_torch.ops import cones as tcones
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64
P = jr.RocketParams()
TP = convert.rocket_params(P)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


def _states(seed, B=8):
    """Descending states around the deploy's (attitude tilted, rates up
    to about 1) and thrusts inside, outside and above the cone."""
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((B, 12))
    x[:, 2] += 10.0
    x[:, 3:6] *= 2.0
    x[:, 9:12] *= 3.0
    u = rng.standard_normal((B, 3)) * np.array([3.0, 3.0, 4.0])
    u[:, 2] += 9.0
    return x, u


def test_mrp_rotation_matches_jax_and_axis_angle():
    """The rotation of MRPs tan(t/4) n is the rotation by t about n; at
    random MRPs the port's batch equals the reference's."""
    t = lambda a: _t(a)
    np.testing.assert_allclose(
        tr.mrp_rotation(t([0.0, 0.0, np.tan(0.7 / 4)])).numpy(), _rotz(0.7),
        atol=1e-12)
    np.testing.assert_allclose(
        tr.mrp_rotation(t([0.0, np.tan(-0.3 / 4), 0.0])).numpy(),
        _roty(-0.3), atol=1e-12)
    p = np.random.default_rng(0).standard_normal((16, 3))
    R = tr.mrp_rotation(t(p)).numpy()
    np.testing.assert_allclose(R, np.asarray(jax.vmap(jr.mrp_rotation)(p)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)


def test_ode_matches_jax():
    x, u = _states(1, 16)
    np.testing.assert_allclose(
        tr.ode(TP, _t(x), _t(u)).numpy(),
        np.asarray(jax.vmap(lambda a, b: jr.ode(P, a, b))(x, u)),
        rtol=1e-12, atol=1e-12)
    # one vector as a batch
    np.testing.assert_allclose(tr.ode(TP, _t(x[3]), _t(u[3])).numpy(),
                               np.asarray(jr.ode(P, x[3], u[3])),
                               rtol=1e-12, atol=1e-12)


def _dyn_points(seed, B=8):
    """z around y = x and theta = [x, u, h] for the midpoint residual."""
    x, u = _states(seed, B)
    rng = np.random.default_rng(seed + 100)
    z = x + 0.05 * rng.standard_normal((B, 12))
    th = np.concatenate([x, u, np.full((B, 1), 0.05)], axis=1)
    return z, th


def _proj_points(seed, B=8):
    """z around the cold start and theta = [u_bar, u_max]."""
    rng = np.random.default_rng(seed)
    z = (np.asarray(jr.init_z_proj()) + 0.3 * rng.standard_normal((B, 10)))
    th = np.concatenate([6.0 * rng.standard_normal((B, 3)),
                         np.full((B, 1), 12.5)], axis=1)
    return z, th


def _jax_res_and_jacs(res, z, th, kappa):
    return jax.jit(jax.vmap(lambda a, b: (
        res(a, b, kappa),
        jax.jacfwd(lambda v: res(v, b, 0.0))(a),
        jax.jacfwd(lambda v: res(a, v, 0.0))(b))))(z, th)


@pytest.mark.parametrize("kappa", [0.0, 3e-3])
@pytest.mark.parametrize("which", ["dyn", "proj"])
def test_residuals_and_jacobians_match_jax(which, kappa):
    """Both residuals at kappa 0 and > 0, and their Jacobians in z and in
    theta (theta's last column of the midpoint residual is h), through
    the port's ``batched_jacobian`` against ``jax.jacfwd``."""
    if which == "dyn":
        z, th = _dyn_points(2)
        jres = lambda a, b, k: jr.residual_dyn(P, a, b, k)
        tres = lambda a, b, k: tr.residual_dyn(TP, a, b, k)
        ntheta = tr.NTHETA_DYN
    else:
        z, th = _proj_points(3)
        jres, tres = jr.residual_proj, tr.residual_proj
        ntheta = tr.NTHETA_PROJ
    r_j, jz_j, jt_j = _jax_res_and_jacs(jres, z, th, kappa)
    np.testing.assert_allclose(tres(_t(z), _t(th), kappa).numpy(),
                               np.asarray(r_j), rtol=1e-12, atol=1e-12)
    for argnum, ref in ((0, jz_j), (1, jt_j)):
        jac = tip.batched_jacobian(tres, argnum)(_t(z), _t(th))
        assert jac.shape[2] == (z.shape[1] if argnum == 0 else ntheta)
        np.testing.assert_allclose(jac.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)
    if which == "dyn":
        # the midpoint residual's column in h is -f((x + y) / 2, u)
        assert float(np.abs(np.asarray(jt_j)[:, :, 15]).max()) > 1.0


def test_specs_and_init_match_jax():
    for name in ("cone_spec_dyn", "cone_spec_proj"):
        js, ts = getattr(jr, name)(), getattr(tr, name)()
        assert ts == tcones.ConeSpec(**js.__dict__), name
        ts.validate()
    assert tr.cone_spec_dyn().ort_prim == () == tr.cone_spec_dyn().soc_prim
    for dt, jdt in ((F64, jnp.float64), (torch.float32, jnp.float32)):
        np.testing.assert_array_equal(
            tr.init_z_proj("cpu", dt).numpy(),
            np.asarray(jr.init_z_proj(jdt)))
    for f in ("NX", "NU", "NZ_DYN", "NTHETA_DYN", "NZ_PROJ", "NTHETA_PROJ"):
        assert getattr(tr, f) == getattr(jr, f), f


def test_soc3_cone_algebra_matches_jax():
    """The projection's SOC(3) groups (primal (2, 0, 1), dual (9, 7, 8),
    axis first) through step_to_boundary (a 2-vector tail in the root
    step), delta_products and interior_init, against the reference."""
    spec = tr.cone_spec_proj()
    jspec = jr.cone_spec_proj()
    rng = np.random.default_rng(4)
    B = 64
    z = np.asarray(jr.init_z_proj()) + 0.02 * rng.standard_normal((B, 10))
    d = rng.standard_normal((B, 10))
    d[::4] *= 0.01               # some steps stay inside: alpha = 1
    d[1::4, [2, 9]] = 0.0        # axis steps of 0: the tail alone binds
    for tau in (1.0, 0.99):
        ref = jax.vmap(lambda a, b: jcones.step_to_boundary(jspec, a, b,
                                                            tau))(z, d)
        got = tcones.step_to_boundary(spec, _t(z), _t(d), tau=tau)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    assert 0.0 < float(got.min()) and float(got.max()) == 1.0
    assert float((got < 0.99).float().mean()) > 0.25
    for grp in ((2, 0, 1), (9, 7, 8)):
        np.testing.assert_allclose(
            tcones.soc_step_to_boundary(_t(z[:, grp]), _t(d[:, grp]))
            .numpy(),
            np.asarray(jax.vmap(jcones.soc_step_to_boundary)(z[:, grp],
                                                             d[:, grp])),
            rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tcones.delta_products(spec, _t(d)).numpy(),
        np.asarray(jax.vmap(lambda a: jcones.delta_products(jspec, a))(d)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        tcones.interior_init(spec, _t(z)).numpy(),
        np.asarray(jax.vmap(lambda a: jcones.interior_init(jspec, a))(z)))


def _analytic_project(u, u_max):
    """The projection onto {||u_xy|| <= u_z <= u_max} by a dense search
    over u_z (tests/test_rocket.py's)."""
    best, best_d = None, np.inf
    for uz in np.linspace(0.0, u_max, 2001):
        n = np.linalg.norm(u[:2])
        r = min(n, uz)
        cand = np.array([*(u[:2] * (r / n if n > 0 else 0.0)), uz])
        dist = np.linalg.norm(cand - u)
        if dist < best_d:
            best, best_d = cand, dist
    return best


@functools.lru_cache(maxsize=None)
def _dyn(projection=True, dtype=F64):
    return tr.make_rocket_dynamics(TP, projection=projection, device="cpu",
                                   dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jdyn(projection=True):
    return jr.make_rocket_dynamics(P, projection=projection)


def test_projection_is_feasible_and_matches_jax():
    """Interior thrust unchanged, above u_max clipped, outside the cone
    projected onto it (the dense search's answer), far below it near the
    apex; over a random batch cone-feasible and equal to the reference's
    lane-batched projection solve and its scalar ``project``."""
    dyn = _dyn()
    cases = np.array([[1.0, -2.0, 5.0], [1.0, 1.0, 20.0], [3.0, 0.0, 1.0],
                      [0.1, 0.0, -5.0]])
    out = dyn.project_batched(_t(cases)).numpy()
    np.testing.assert_allclose(out[0], cases[0], atol=1e-3)
    np.testing.assert_allclose(out[1], [1.0, 1.0, 12.5], atol=1e-3)
    np.testing.assert_allclose(out[2], _analytic_project(cases[2], 12.5),
                               atol=2e-2)
    assert (np.linalg.norm(out[:, :2], axis=1) <= out[:, 2] + 1e-6).all()

    u = 6.0 * np.random.default_rng(5).standard_normal((24, 3))
    got = dyn.project_batched(_t(u)).numpy()
    assert (np.linalg.norm(got[:, :2], axis=1) <= got[:, 2] + 1e-6).all()
    thetas = np.concatenate([u, np.full((24, 1), 12.5)], axis=1)
    z0s = np.tile(np.asarray(jr.init_z_proj()), (24, 1))
    ref = jax_solver_batched(jr.residual_proj, jr.cone_spec_proj(),
                             JIPOptions(r_tol=1e-8, kappa_tol=1e-4))(
        z0s, thetas)
    assert bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(got, np.asarray(ref.z)[:, 0:3], atol=1e-10)
    np.testing.assert_allclose(
        got, np.asarray(jax.vmap(_jdyn().project)(u)), atol=1e-10)


def test_projection_jacobian_matches_central_differences_and_jax():
    dyn = _dyn()
    u = np.array([[1.0, -2.0, 5.0], [3.0, 0.5, 1.0]])
    _, J = dyn.project_jac_batched(_t(u))
    eps = 1e-6
    for j in range(3):
        du = np.zeros_like(u)
        du[:, j] = eps
        fd = (dyn.project_batched(_t(u + du))
              - dyn.project_batched(_t(u - du))).numpy() / (2 * eps)
        np.testing.assert_allclose(J[:, :, j].numpy(), fd, atol=1e-4)
    Jj = jax.vmap(lambda a: _jdyn().project_jac(a)[1])(u)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-8)


def test_hover_and_free_fall():
    """Thrust = weight, upright: the rocket stays put; no thrust: free
    fall, which the implicit midpoint integrates exactly."""
    dyn = _dyn(projection=False)
    x = torch.zeros((2, 12), dtype=F64)
    x[:, 2] = torch.tensor([5.0, 10.0], dtype=F64)
    u = torch.zeros((2, 3), dtype=F64)
    u[0, 2] = TP.mass * TP.gravity
    y = dyn.step_batched(x, u)
    np.testing.assert_allclose(y[0].numpy(), x[0].numpy(), atol=1e-8)
    h = 0.05
    np.testing.assert_allclose(float(y[1, 2]), 10.0 - 0.5 * 9.81 * h * h,
                               atol=1e-8)
    np.testing.assert_allclose(float(y[1, 8]), -9.81 * h, atol=1e-8)


def test_step_jacobian_matches_central_differences():
    dyn = _dyn()
    x = torch.zeros((1, 12), dtype=F64)
    x[0, 2], x[0, 3], x[0, 8] = 10.0, 0.1, -1.0
    u = _t([[0.3, -0.2, 9.0]])
    _, fx, fu = dyn.step_jac_batched(x, u)
    eps = 1e-6
    for a, jac, tol in ((x, fx, 1e-5), (u, fu, 1e-4)):
        for j in range(a.shape[1]):
            da = torch.zeros_like(a)
            da[0, j] = eps
            args_p = (x + da, u) if a is x else (x, u + da)
            args_m = (x - da, u) if a is x else (x, u - da)
            fd = (dyn.step_batched(*args_p)
                  - dyn.step_batched(*args_m))[0] / (2 * eps)
            np.testing.assert_allclose(jac[0, :, j].numpy(), fd.numpy(),
                                       atol=tol)


def _xs_us(seed=6, B=6):
    """tests/test_rocket.py's batch: states about 10 m up, thrust around
    hover."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(B, 12) * 0.3
    xs[:, 2] += 10.0
    us = rng.randn(B, 3)
    us[:, 2] += 9.0
    return xs, us


@pytest.mark.parametrize("projection", [True, False])
def test_batched_members_match_jax(projection):
    """step_batched, step_jac_batched, ws_init_batched and the
    warm-started members (the re-solve from the solution gives the same
    y and hands y on as the next ws) against the reference's lane-batched
    members."""
    xs, us = _xs_us()
    us[0] = [3.0, 0.5, 1.0]      # outside the cone
    td, jd = _dyn(projection), _jdyn(projection)
    xt, ut = _t(xs), _t(us)
    ys = td.step_batched(xt, ut)
    np.testing.assert_allclose(ys.numpy(),
                               np.asarray(jax.jit(jd.step_batched)(xs, us)),
                               atol=1e-10)
    got = td.step_jac_batched(xt, ut)
    ref = jax.jit(jd.step_jac_batched)(xs, us)
    for g, r, tol in zip(got, ref, (1e-10, 1e-8, 1e-8)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)
    np.testing.assert_array_equal(td.ws_init_batched(xt).numpy(), xs)
    yw, zw = td.step_batched_ws(xt, ut, ys)
    assert zw is yw
    np.testing.assert_allclose(yw.numpy(), ys.numpy(), atol=1e-10)
    jyw, _ = jax.jit(jd.step_batched_ws)(xs, us, ys.numpy())
    np.testing.assert_allclose(yw.numpy(), np.asarray(jyw), atol=1e-10)
    got = td.step_jac_batched_ws(xt, ut, ys)
    ref = jax.jit(jd.step_jac_batched_ws)(xs, us, ys.numpy())
    assert got[3] is got[0]
    for g, r, tol in zip(got, ref, (1e-10, 1e-8, 1e-8, 1e-10)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)
    if projection:
        # a thrust outside the cone: the chain rule through the
        # projection changes fu
        fu_raw = _dyn(False).step_jac_batched(xt, ut)[2]
        assert float((got[2] - fu_raw).abs().max()) > 1e-3


def test_step_batched_f32_matches_jax_f32():
    """The float32 two-IP step at the deploy's accelerator r_tol against
    the reference's float32 step (the yaw-rate equation's rounding is
    divided by an inertia of 1e-5 in both)."""
    xs, us = _xs_us(7, 16)
    td = tr.make_rocket_dynamics(TP, r_tol=3e-5, device="cpu",
                                 dtype=torch.float32)
    got = td.step_batched(_t(xs, torch.float32), _t(us, torch.float32))
    # the reference's constants are float32 only with 64-bit types off
    with jax.enable_x64(False):
        jd = jr.make_rocket_dynamics(P, r_tol=3e-5)
        ref = np.asarray(jax.jit(jd.step_batched)(
            jnp.asarray(xs, jnp.float32), jnp.asarray(us, jnp.float32)))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    np.testing.assert_allclose(got.double().numpy(),
                               _dyn().step_batched(_t(xs), _t(us)).numpy(),
                               atol=2e-4)


def test_convert_rocket_params():
    p = jr.RocketParams(mass=1.5, inertia=(0.1, 0.2, 3e-5))
    tp = convert.rocket_params(p)
    assert isinstance(tp, tr.RocketParams)
    assert tuple(tp) == tuple(p) and tp.inertia == (0.1, 0.2, 3e-5)
    assert convert.rocket_params(jr.RocketParams()) == tr.RocketParams()


@pytest.mark.parametrize("which", ["stage", "terminal"])
def test_costs_equal_their_dot_product_forms(which):
    """``examples/rocket.py``'s costs (explicit sums) against the dot
    products they were written with, on the deploy problem. The terminal
    cost is one sum of 12 nonnegative terms: two orders of such a sum
    differ by at most 2 (12 - 1) 2**-53 relative (each is within (n - 1)
    2**-53 of the exact sum), and these lanes reach 4.9e-16, above the
    4e-16 the other costs are held to; it is held to that bound."""
    import inspect

    from optimization_dynamics_tpu_torch.examples import rocket as ex

    from tests.test_torch_cartpole import check_cost_forms

    prob, x0, _, _ = ex.build_deploy_problem("cpu")
    c = inspect.getclosurevars(prob.stage_cost).nonlocals
    qw, rw, xT = c["qw"], c["rw"], c["xT"]
    qwT = inspect.getclosurevars(prob.terminal_cost).nonlocals["qwT"]

    def stage(t, x, u):
        dx = x - xT
        return 0.5 * dx @ (qw * dx) + 0.5 * u @ (rw * u)

    def terminal(x):
        dx = x - xT
        return 0.5 * dx @ (qwT * dx)

    old = {"stage": stage, "terminal": terminal}[which]
    tol = 4e-16 if which == "stage" else 2 * (12 - 1) * 2.0 ** -53
    check_cost_forms(prob, which, old, x0, seed=167, tol=tol)
