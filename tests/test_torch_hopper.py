"""Port parity: the hopper model, its lane-batched step, and K2 and K3 at
the hopper's shapes, against the JAX package.

Inputs are made with numpy from a seed and go through each package's own
packing. Tolerances:

* the mechanics (mass matrix and bias, written in closed form in the
  port) against ``torch.func`` derivatives of the same Lagrangian and
  against the reference's autodiff, and the residual and its Jacobians in
  z and theta, are the same arithmetic in float64 up to summation order:
  1e-12 (entries reach about 1e2);
* the physical gates of tests/test_hopper.py on the port's lane-batched
  step: signed distances > -1e-5, friction dissipates, ``fu`` within
  1e-5 of central differences;
* ``step_batched`` and the warm ``step_jac_batched_ws`` against the
  reference's (both solve to r_tol 1e-8, the port's Newton steps by QR,
  the reference's by LU): y within 1e-10, fx and fu within 1e-8;
* K2's plain version at (20, 1) and (20, 13) on the hopper's own Newton
  and IFT systems: against the Pallas QR kernel in interpret mode in
  float32 (rtol and atol 1e-3, tests/test_pallas_solve.py's), against
  LU in float64 (1e-10 of max|x|);
* K3's plain version at (16, 10) with the hopper's ragged ``u_mask``:
  against the Pallas kernel in interpret mode in float32 (rtol and atol
  2e-5, as tests/test_torch_riccati.py) and against the reference's XLA
  pass in float64 (rtol 1e-10); masked gains exactly 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd, jvp

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_dynamics,
)
from optimization_dynamics_tpu.models import hopper as jh
from optimization_dynamics_tpu.ops.pallas.batched_solve import (
    batched_solve as jax_batched_solve,
)
from optimization_dynamics_tpu.ops.pallas.riccati import (
    make_riccati_backward as jax_make_riccati_backward,
)
from optimization_dynamics_tpu.solver.ilqr import ILQROptions as JOptions
from optimization_dynamics_tpu.solver.ilqr import ILQRProblem as JProblem
from optimization_dynamics_tpu.solver.ilqr_batched import (
    make_phases as jax_make_phases,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import hopper as th
from optimization_dynamics_tpu_torch.ops import cones as tcones
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
    batched_solve_plain,
)
from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
    make_riccati_backward,
    riccati_backward,
)
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64
H = 0.05
P = jh.HopperParams()
TP = convert.hopper_params(P)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _states(seed):
    """A dozen (q0, q1, q2) over the contact modes: standing on the foot,
    in flight, the leg at its longest and shortest, sliding sideways
    (three each of the last four kinds after the first, from a numpy
    seed)."""
    rng = np.random.default_rng(seed)
    fr = P.foot_radius
    base = [
        [0.0, 0.5 + fr, 0.0, 0.5],          # standing on the foot
        [0.1, 1.0, 0.1, 0.5],               # in flight
        [0.0, 1.0 + fr, 0.0, P.leg_len_max],  # leg at its longest
        [0.0, 0.1 + fr + 0.02, 0.0, P.leg_len_min],  # leg at its shortest
    ]
    q1 = np.array([base[i % 4] for i in range(12)])
    q1[4:] += 0.01 * rng.standard_normal((8, 4))
    q0 = q1 - 0.005 * rng.standard_normal((12, 4))
    q0[9:, 0] -= 0.05                       # sliding: lateral velocity 1
    q2 = q1 + 0.01 * rng.standard_normal((12, 4))
    u = rng.standard_normal((12, 2))
    return q0, q1, q2, u


def _thetas(q0, q1, u):
    """(jax thetas, torch thetas) through each package's packing."""
    jm = jh.model(P)
    jaux = jh.HopperAux(h=H)
    th_j = jax.vmap(lambda a, b, c: jm.theta_fn(a, b, c, jaux))(
        *(jnp.asarray(v) for v in (q0, q1, u)))
    th_t = th.model(TP).theta_fn(_t(q0), _t(q1), _t(u),
                                 convert.hopper_aux(jaux, "cpu", F64))
    return th_j, th_t


def _lagrangian(q, v):
    """The reference's Lagrangian, written in torch: the foot's velocity
    by a Jacobian-vector product of its kinematics."""
    pf_dot = jvp(lambda a: th.kinematics_foot(TP, a), (q,), (v,))[1]
    ke = (0.5 * TP.mass_body * (v[0] ** 2 + v[1] ** 2)
          + 0.5 * TP.inertia_body * v[2] ** 2
          + 0.5 * TP.mass_foot * torch.dot(pf_dot, pf_dot))
    pe = (TP.mass_body * TP.gravity * q[1]
          + TP.mass_foot * TP.gravity * th.kinematics_foot(TP, q)[1])
    return ke - pe


def test_mechanics_match_lagrangian_and_jax():
    """M(q) and the bias -D1L in closed form against torch.func's grad and
    Hessian of the Lagrangian and against the reference's jax.grad, at
    random (q, v)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 4))
    v = 3.0 * rng.standard_normal((16, 4))
    M = th.mass_matrix(TP, _t(q))
    bias = th.dynamics_bias(TP, _t(q), _t(v))
    d1l_j = jax.vmap(jax.grad(lambda a, b: jh.lagrangian(P, a, b), 0))(q, v)
    d2l_j = jax.vmap(jax.grad(lambda a, b: jh.lagrangian(P, a, b), 1))(q, v)
    for i in range(16):
        qi, vi = _t(q[i]), _t(v[i])
        d1l = grad(_lagrangian, argnums=0)(qi, vi)
        Mi = jacfwd(grad(_lagrangian, argnums=1), argnums=1)(qi, vi)
        np.testing.assert_allclose(M[i].numpy(), Mi.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(bias[i].numpy(), -d1l.numpy(),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bias.numpy(), -np.asarray(d1l_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        torch.sum(M * _t(v)[:, None, :], dim=-1).numpy(), np.asarray(d2l_j),
        rtol=1e-12, atol=1e-12)


def test_kinematics_distance_contact_maps_match_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((10, 4))
    gam = rng.standard_normal((10, 4))
    b = rng.standard_normal((10, 2))
    u = rng.standard_normal((10, 2))
    ref = jax.vmap(lambda a: (jh.kinematics_foot(P, a),
                              jh.signed_distance(P, a),
                              jh.contact_jacobian(P, a)))(q)
    got = (th.kinematics_foot(TP, _t(q)), th.signed_distance(TP, _t(q)),
           th.contact_jacobian(TP, _t(q)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)

    def lam_ref(a, g_, b_):
        J = jh.contact_jacobian(P, a)
        lam = (J[0:2].T @ jnp.stack([b_[0], g_[0]])
               + J[2:4].T @ jnp.stack([b_[1], g_[1]])
               + J[4] * g_[2] + J[5] * g_[3])
        return lam.at[2].add(P.body_radius * b_[0])

    np.testing.assert_allclose(
        th.contact_force(TP, _t(q), _t(gam), _t(b)).numpy(),
        np.asarray(jax.vmap(lam_ref)(q, gam, b)), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.array(th.input_matrix()),
                                  np.asarray(jh.input_matrix()))
    np.testing.assert_allclose(th.control_force(_t(u)).numpy(),
                               u @ np.asarray(jh.input_matrix()).T,
                               rtol=1e-15, atol=0)


def test_residual_and_jacobians_match_jax():
    """The residual and its Jacobians in z and theta at a dozen states
    over the contact modes, z around init_z(q2)."""
    q0, q1, q2, u = _states(2)
    th_j, th_t = _thetas(q0, q1, u)
    rng = np.random.default_rng(3)
    z = (np.asarray(jax.vmap(jh.init_z)(q2))
         + 0.05 * rng.standard_normal((12, th.NZ)))
    kappa = 3e-3
    r_j, jz_j, jt_j = jax.jit(jax.vmap(lambda a, b: (
        jh.residual(P, a, b, kappa),
        jax.jacfwd(lambda x: jh.residual(P, x, b, 0.0))(a),
        jax.jacfwd(lambda y: jh.residual(P, a, y, 0.0))(b))))(z, th_j)
    np.testing.assert_allclose(th.residual(TP, _t(z), th_t, kappa).numpy(),
                               np.asarray(r_j), rtol=1e-12, atol=1e-12)
    res = th.model(TP).residual
    for argnum, ref in ((0, jz_j), (1, jt_j)):
        jac = tip.batched_jacobian(res, argnum)(_t(z), th_t)
        np.testing.assert_allclose(jac.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    # one lane through torch.func.jacfwd (a vector, not a batch)
    for i in (0, 11):
        zi, ti = _t(z[i]), th_t[i]
        np.testing.assert_allclose(
            jacfwd(lambda a: res(a, ti, 0.0))(zi).numpy(),
            np.asarray(jz_j[i]), rtol=1e-12, atol=1e-12)


def test_specs_init_z_and_theta_packing_match_jax():
    q0, q1, q2, u = _states(4)
    th_j, th_t = _thetas(q0, q1, u)
    np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))
    jm, tm = jh.model(P), th.model(TP)
    assert tm.spec == tcones.ConeSpec(**jm.spec.__dict__)
    tm.spec.validate()
    for f in ("nq", "nu", "nz", "ntheta", "q_sel", "th_q0", "th_q1", "th_u"):
        assert getattr(tm, f) == getattr(jm, f), f
    # the CUDA functor of K1 and its constants, the params
    assert tm.kernel == "hopper"
    assert tm.kernel_params == tuple(TP) == tuple(P)
    np.testing.assert_array_equal(tm.init_z(_t(q2)).numpy(),
                                  np.asarray(jax.vmap(jm.init_z)(q2)))
    # one vector packs as a batch does; friction from the aux
    fr = np.array([0.3, 0.7])
    jaux = jh.HopperAux(h=H, friction=jnp.asarray(fr))
    taux = convert.hopper_aux(jaux, "cpu", F64)
    ref = jm.theta_fn(jnp.asarray(q0[0]), jnp.asarray(q1[0]),
                      jnp.asarray(u[0]), jaux)
    got = tm.theta_fn(_t(q0[0]), _t(q1[0]), _t(u[0]), taux)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        th.pack_theta(_t(q0), _t(q1), _t(u), _t(fr), _t(H))[:, 10:].numpy(),
        np.tile([0.3, 0.7, H], (12, 1)))


def _dyn(kappa_eval=1e-4, kappa_grad=1e-3):
    return make_implicit_dynamics(th.model(TP), "cpu", F64,
                                  kappa_eval_tol=kappa_eval,
                                  kappa_grad_tol=kappa_grad)


AUX = th.HopperAux(h=H)


def test_drop_lands_without_penetration():
    """Three drops from rest (heights 1.0, 0.8, 0.7) on the lane-batched
    step: no signed distance below -1e-5 on any step, the foot at rest on
    the ground at the end."""
    dyn = _dyn()
    q = _t([[0.0, z, 0.0, 0.5] for z in (1.0, 0.8, 0.7)])
    x = torch.cat([q, q], dim=1)
    for _ in range(25):
        x = dyn.step_batched(x, torch.zeros((3, 2), dtype=F64), AUX)
        assert bool(torch.isfinite(x).all())
        assert float(th.signed_distance(TP, x[:, 4:]).min()) > -1e-5
    assert bool((th.signed_distance(TP, x[:, 4:])[:, 1] < 1e-3).all())


def test_friction_resists_slide():
    """Standing on the foot with a lateral velocity of 1: friction slows
    the body."""
    dyn = _dyn()
    q1 = _t([0.0, 0.5 + P.foot_radius, 0.0, 0.5])
    q0 = q1 - _t([0.05, 0.0, 0.0, 0.0])
    u = _t([[0.0, P.gravity * P.mass_body * 0.05]])
    y = dyn.step_batched(torch.cat([q0, q1])[None], u, AUX)[0]
    assert float((y[4] - y[0]) / 0.05) < 1.0


def test_step_jacobian_matches_central_differences():
    dyn = _dyn(1e-3, 1e-3)
    q1 = _t([0.0, 0.9, 0.05, 0.5])
    x = torch.cat([q1 - 0.01, q1])[None]
    u = _t([[0.1, 0.2]])
    _, _, fu = dyn.step_jac_batched(x, u, AUX)
    eps = 1e-6
    fd = torch.zeros((8, 2), dtype=F64)
    for j in range(2):
        du = torch.zeros_like(u)
        du[0, j] = eps
        fd[:, j] = (dyn.step_batched(x, u + du, AUX)
                    - dyn.step_batched(x, u - du, AUX))[0] / (2 * eps)
    np.testing.assert_allclose(fu[0].numpy(), fd.numpy(), atol=1e-5)


def _pair_dyn():
    """The reference's dynamics at its default (CPU) tolerances, not
    fused, and the port's at the same options."""
    jd = jax_dynamics(jh.model(P))
    return jd, _dyn()


def _xs_us(seed, B=8):
    q0, q1, _, u = _states(seed)
    return np.concatenate([q0, q1], axis=1)[:B], u[:B]


def test_step_batched_and_warm_jacobian_sweep_match_jax():
    """step_batched (cold) and step_jac_batched_ws warm-started from the
    eval solution of the same step, as the deploy's derivative sweep is,
    handed to both packages."""
    xs, us = _xs_us(5)
    jd, td = _pair_dyn()
    jaux = jh.HopperAux(h=H)
    taux = convert.hopper_aux(jaux, "cpu", F64)
    xt, ut = _t(xs), _t(us)
    np.testing.assert_allclose(td.step_batched(xt, ut, taux).numpy(),
                               np.asarray(jd.step_batched(xs, us, jaux)),
                               atol=1e-10)
    np.testing.assert_array_equal(
        td.carry_init(xt).numpy(), np.asarray(jax.vmap(jd.carry_init)(xs)))
    _, zw = td.step_batched_ws(xt, ut, taux, td.carry_init(xt))
    got = td.step_jac_batched_ws(xt, ut, taux, zw)
    ref = jd.step_jac_batched_ws(xs, us, jaux, zw.numpy())
    for g, r, tol in zip(got, ref, (1e-10, 1e-8, 1e-8, 1e-8)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


@functools.lru_cache(maxsize=None)
def _hopper_systems():
    """The hopper's Newton systems (dr/dz, r - kappa e) at cold starts and
    IFT systems (dr/dz, dr/dtheta) at solutions of the port's solver
    (float64), 24 lanes over the contact modes."""
    q0, q1, _, u = _states(6)
    q0, q1, u = (np.concatenate([a, a + 1e-3]) for a in (q0, q1, u))
    _, th_t = _thetas(q0, q1, u)
    model = th.model(TP)
    opts = tip.IPOptions(r_tol=1e-8, kappa_tol=1e-3)
    zs = tip.make_solver_batched(model.residual, model.spec, opts, "cpu",
                                 F64)(model.init_z(_t(q1)), th_t).z
    z0 = model.init_z(_t(q1))
    A0 = tip.batched_jacobian(model.residual, 0)(z0, th_t)
    r0 = model.residual(z0, th_t, 0.1)[..., None]
    Az = tip.batched_jacobian(model.residual, 0)(zs, th_t)
    Ath = tip.batched_jacobian(model.residual, 1)(zs, th_t)
    return {"newton": (A0, r0), "ift": (Az, Ath)}


@pytest.mark.parametrize("case", ["newton", "ift"])
def test_k2_plain_at_hopper_shapes(case):
    """K2's plain version at (20, 1) and (20, 13): in float32 against the
    Pallas QR kernel in interpret mode, in float64 against LU."""
    A, b = _hopper_systems()[case]
    assert tuple(b.shape[1:]) == ((20, 1) if case == "newton" else (20, 13))
    before = batched_solve.launches
    x = batched_solve(A, b)
    assert batched_solve.launches == before
    xr = np.linalg.solve(A.numpy(), b.numpy())
    assert np.abs(x.numpy() - xr).max() <= 1e-10 * np.abs(xr).max()
    A32, b32 = A.float(), b.float()
    ref = np.asarray(jax_batched_solve(jnp.asarray(A32.numpy()),
                                       jnp.asarray(b32.numpy()),
                                       interpret=True))
    np.testing.assert_allclose(batched_solve_plain(A32, b32).numpy(), ref,
                               rtol=1e-3, atol=1e-3)


def _hopper_mask(T):
    mask = np.zeros((T - 1, 10), bool)
    mask[:, 0:2] = True
    mask[0] = True
    return mask


def _rand_lqr(seed, B, T, nx, nu):
    """fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs (numpy), drawn
    as tests/test_torch_riccati.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)

    def spd(m):
        A = n(B, T - 1, m, m)
        return np.einsum("btij,btkj->btik", A, A) + 0.5 * np.eye(m)

    A = n(B, nx, nx)
    return [0.5 * n(B, T - 1, nx, nx), 0.5 * n(B, T - 1, nx, nu),
            n(B, T - 1, nx), n(B, T - 1, nu), spd(nx), spd(nu),
            0.3 * n(B, T - 1, nu, nx), n(B, nx),
            np.einsum("bij,bkj->bik", A, A) + np.eye(nx), np.full(B, 1e-6)]


def test_k3_plain_at_hopper_shape_with_ragged_mask():
    """K3's plain version at (nx, nu) = (16, 10) with the hopper's mask
    (every control on the first step, two after) against the Pallas
    kernel in interpret mode (float32) and the reference's XLA pass
    (float64); masked gains exactly 0, and the wrapper launches nothing
    on CPU tensors."""
    nx, nu, T, B = 16, 10, 5, 4
    mask = _hopper_mask(T)
    data = _rand_lqr(7, B, T, nx, nu)
    names = ["Ks", "ks", "dV1", "dV2", "qu_inf", "ok"]
    before = riccati_backward.launches
    got32 = make_riccati_backward(T, nx, nu, mask, "cpu", torch.float32)(
        *(torch.as_tensor(a, dtype=torch.float32) for a in data))
    assert riccati_backward.launches == before
    ref32 = jax_make_riccati_backward(T, nx, nu, mask, interpret=True)(
        *(jnp.asarray(a, jnp.float32) for a in data))
    for name, g, r in zip(names, got32, ref32):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(r, np.float64), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    prob = JProblem(
        T=T, nx=nx, nu=nu, ncon=0, nconT=0,
        dynamics=lambda t, x, u: x,
        dynamics_jac=lambda t, x, u: (x, jnp.eye(nx), jnp.zeros((nx, nu))),
        dynamics_batched=lambda t, xs, us: xs,
        stage_cost=lambda t, x, u: jnp.sum(u * u),
        terminal_cost=lambda x: jnp.sum(x * x),
        u_mask=jnp.asarray(mask))
    ph = jax_make_phases(prob, JOptions(), B=B, dtype=jnp.float64)
    ref64 = ph.backward_xla(*(jnp.asarray(a, jnp.float64) for a in data))
    got64 = make_riccati_backward(T, nx, nu, mask, "cpu", F64)(
        *(torch.as_tensor(a) for a in data))
    for name, g, r in zip(names, got64, ref64):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(r, np.float64), rtol=1e-10,
                                   atol=1e-13, err_msg=name)
    for Ks, ks in ((got32[0], got32[1]), (got64[0], got64[1])):
        assert (Ks[:, 1:, 2:] == 0).all() and (ks[:, 1:, 2:] == 0).all()
        assert (Ks[:, 0] != 0).all()


def test_convert_hopper_params_and_aux():
    p = jh.HopperParams(mass_foot=0.3, leg_len_min=0.15)
    tp = convert.hopper_params(p)
    assert tuple(tp) == tuple(p) and isinstance(tp, th.HopperParams)
    aux = convert.hopper_aux(jh.HopperAux(h=jnp.float32(0.05)), "cpu",
                             torch.float32)
    assert isinstance(aux, th.HopperAux) and aux.friction is None
    assert aux.h.dtype == torch.float32 and aux.h.shape == ()
    assert float(aux.h) == pytest.approx(0.05)
    aux = convert.hopper_aux(
        jh.HopperAux(h=0.05, friction=jnp.array([0.2, 0.4])), "cpu", F64)
    assert aux.friction.dtype == F64
    assert aux.friction.tolist() == [0.2, 0.4]
