"""Port parity: the planar-push model, its CUDA functor's tables, K1n's
plain version, K2 at the push IFT shape and the lane-batched dynamics,
against the JAX package.

Inputs are made with numpy from a seed, around the nominal pose the
reference's fused-kernel test uses (pusher touching the box's left face,
u = [1, 0.1]), and go through each package's own packing. Tolerances:

* the residual and its Jacobians in z and theta are the same arithmetic
  in float64 (the port writes the contact normal and the corner Jacobian
  in closed form where the reference takes them by autodiff), so they
  agree to 1e-10 (entries reach 1e2);
* K1n's plain version against ``make_solver_batched`` in float64:
  identical converged flags, iteration counts identical on all lanes but
  at most one (QR against LU can move one line-search tie), z within 1e-9
  where the counts agree;
* K1n's plain version in float32 against the Pallas kernel in interpret
  mode (whose narrow-lane call at nz=35 is K1n itself), at the tolerances
  of tests/test_fused_ip.py: all but one reference-converged lane also
  converge, configurations within 2e-4;
* K2's plain version at (35, 13) against the reference's QR solve: 1e-10
  on well-conditioned systems; on the IFT systems at IP solutions,
  relative residual 1e-12 and the two solutions within 1e-8 of max|x|;
* the warm Jacobian sweep (ys, fxs, fus, zs) within 1e-9 of max|ref|
  (both solve to r_tol 1e-8).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_dynamics,
)
from optimization_dynamics_tpu.models import planar_push as jpp
from optimization_dynamics_tpu.ops import cones as jcones
from optimization_dynamics_tpu.ops.pallas.batched_solve import (
    batched_solve_reference,
)
from optimization_dynamics_tpu.ops.pallas.fused_ip import (
    make_fused_ip_solver as jax_fused_solver,
)
from optimization_dynamics_tpu.solver.interior_point import (
    IPOptions as JaxIPOptions,
    make_solver_batched as jax_solver_batched,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import planar_push as tpp
from optimization_dynamics_tpu_torch.ops import cones as tcones
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
    batched_solve_plain,
)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    fused_ip,
    make_fused_ip_plain,
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64
# the deploy IP options of the reference's fused-kernel test
JOPTS = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40, max_ls=8)
Q_NOM = np.array([0.0, 0.0, 0.0, -jpp.R_DIM - 1e-6, 0.0])
U_NOM = np.array([1.0, 0.1])


def _nominal(B, seed, dq=0.005, du=0.1):
    """(q0, q1, u) around the nominal pose, the distribution of
    tests/test_fused_ip.py::_nominal_batch, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q0 = Q_NOM + dq * rng.standard_normal((B, 5))
    q1 = q0 + 0.2 * dq * rng.standard_normal((B, 5))
    u = U_NOM + du * rng.standard_normal((B, 2))
    return q0, q1, u


def _inputs(q0, q1, u, np_dtype):
    """(jax z0s, jax thetas, torch z0s, torch thetas) through each
    package's own packing."""
    jm = jpp.model()
    jaux = jpp.PlanarPushAux(h=np_dtype(0.1))
    th_j = jax.vmap(lambda a, b, c: jm.theta_fn(a, b, c, jaux))(
        *(jnp.asarray(v, np_dtype) for v in (q0, q1, u)))
    z_j = jax.vmap(jm.init_z)(jnp.asarray(q1, np_dtype))
    tm = tpp.model()
    taux = convert.planar_push_aux(jaux)
    t = lambda a: torch.as_tensor(np.asarray(a, np_dtype))
    return z_j, th_j, tm.init_z(t(q1)), tm.theta_fn(t(q0), t(q1), t(u), taux)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def test_geometry_matches_jax_autodiff():
    """phi, the closed-form normal and corner Jacobian, and P against the
    reference's jax.grad / jax.jacfwd."""
    q0, q1, _ = _nominal(32, 0, dq=0.02)
    q = np.concatenate([q1, q0[:4]])
    ref = jax.jit(jax.vmap(lambda a: (
        jpp.phi(a), jpp.normal(a), jax.jacfwd(jpp.corner_positions)(a),
        jpp.corner_positions(a), jpp.tangential_jacobian(a))))(q)
    got = (tpp.phi(_t(q)), tpp.normal(_t(q)), tpp.corner_jacobian(_t(q)),
           tpp.corner_positions(_t(q)), tpp.tangential_jacobian(_t(q)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-13)


def test_residual_and_jacobians_match_jax():
    q0, q1, u = _nominal(16, 1)
    z_j, th_j, _, _ = _inputs(q0, q1, u, np.float64)
    rng = np.random.default_rng(2)
    z = np.asarray(z_j) + 0.01 * rng.standard_normal((16, tpp.NZ))
    th = np.asarray(th_j)
    p = jpp.PlanarPushParams()
    tp = convert.planar_push_params(p)
    kappa = 3e-3
    r_j, jz_j, jt_j = jax.jit(jax.vmap(lambda a, b: (
        jpp.residual(p, a, b, kappa),
        jax.jacfwd(lambda x: jpp.residual(p, x, b, 0.0))(a),
        jax.jacfwd(lambda y: jpp.residual(p, a, y, 0.0))(b))))(z, th)
    np.testing.assert_allclose(tpp.residual(tp, _t(z), _t(th), kappa).numpy(),
                               np.asarray(r_j), atol=1e-10)
    res = lambda a, b, k: tpp.residual(tp, a, b, k)
    for argnum, ref in ((0, jz_j), (1, jt_j)):
        jac = tip.batched_jacobian(res, argnum)(_t(z), _t(th))
        np.testing.assert_allclose(jac.numpy(), np.asarray(ref), atol=1e-10)
    # one lane through torch.func.jacfwd (a vector, not a batch)
    for i in (0, 7):
        zi, ti = _t(z[i]), _t(th[i])
        np.testing.assert_allclose(
            jacfwd(lambda a: res(a, ti, 0.0))(zi).numpy(),
            np.asarray(jz_j[i]), atol=1e-10)
        np.testing.assert_allclose(
            jacfwd(lambda b: res(zi, b, 0.0))(ti).numpy(),
            np.asarray(jt_j[i]), atol=1e-10)


def test_theta_packing_init_z_and_spec_match_jax():
    q0, q1, u = _nominal(5, 3)
    z_j, th_j, z_t, th_t = _inputs(q0, q1, u, np.float64)
    np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    jm, tm = jpp.model(), tpp.model()
    assert tm.spec == tcones.ConeSpec(**jm.spec.__dict__)
    for f in ("nq", "nu", "nz", "ntheta", "q_sel", "th_q0", "th_q1",
              "th_u"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.kernel == "planar_push"
    assert tm.kernel_params == tuple(jpp.PlanarPushParams())


def test_step_to_boundary_on_push_spec_matches_jax():
    """The fraction-to-boundary step over the orthant pair and the ragged
    SOC(3)/SOC(2) groups, including no-crossing lanes."""
    rng = np.random.default_rng(4)
    z = np.abs(rng.standard_normal((256, tpp.NZ))) + 0.1
    d = rng.standard_normal((256, tpp.NZ))
    jspec, tspec = jpp.cone_spec(), tpp.cone_spec()
    ref = jax.vmap(lambda a, b: jcones.step_to_boundary(jspec, a, b, 0.9))(
        z, d)
    got = tcones.step_to_boundary(tspec, _t(z), _t(d), tau=0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    # the 2-dim pusher group alone
    g = list(jspec.soc_prim[4])
    ref2 = jax.vmap(jcones.soc_step_to_boundary)(z[:, g], d[:, g])
    got2 = tcones.soc_step_to_boundary(_t(z[:, g]), _t(d[:, g]))
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), rtol=1e-12)


def _cuh_tables(path):
    """name -> values of the constexpr lookup tables in a functor header."""
    text = Path(path).read_text()
    out = {}
    for name, body in re.findall(
            r"(\w+)\(int [^)]*\) \{\s*constexpr \w+ t[^=]*= \{(.*?)\};",
            text, re.S):
        out[name] = [float(v) for v in re.findall(r"[-\d.]+", body)]
    return out


def test_cuda_functor_tables_match_cone_spec():
    """The constexpr tables of the CUDA push functor are the Python
    ConeSpec's masks, reset template, orthant pair and ragged SOC groups,
    and init_z's cold start."""
    from optimization_dynamics_tpu_torch.ops.kernels import _build

    tables = _cuh_tables(_build.CSRC / "planar_push.cuh")
    spec = tpp.cone_spec()
    eq, bil, head = tip._row_masks(spec, "cpu", F64)
    rmask, rtmpl = tip._cone_reset(spec, "cpu", F64)
    assert tables["eq_mask"] == eq.tolist()
    assert tables["bil_mask"] == bil.tolist()
    assert tables["head_mask"] == head.tolist()
    assert tables["reset_mask"] == rmask.double().tolist()
    assert tables["reset_tmpl"] == rtmpl.tolist()
    assert tables["ort_idx"] == [float(i) for i in
                                 spec.ort_prim + spec.ort_dual]
    groups = [list(g) for g in list(spec.soc_prim) + list(spec.soc_dual)]
    assert tables["soc_dim"] == [float(len(g)) for g in groups]
    soc_max = max(len(g) for g in groups)
    assert tables["soc_idx"] == [float(i) for g in groups
                                 for i in g + [-1] * (soc_max - len(g))]
    z = tpp.init_z(torch.tensor([[0.3, -1.2, 0.1, 0.5, 0.2]], dtype=F64))
    assert tables["init_tail"] == z[0, tpp.NQ:].tolist()
    assert tables["q_sel"] == [float(i) for i in tpp.model().q_sel]
    sizes = dict(re.findall(r"static constexpr int (\w+) = (\d+);",
                            (_build.CSRC / "planar_push.cuh").read_text()))
    assert (int(sizes["NZ"]), int(sizes["NTH"])) \
        == _build.FUSED_IP_FUNCTORS["planar_push"]
    assert int(sizes["N_ORT"]) == 2 and int(sizes["SOC_MAX"]) == soc_max
    assert int(sizes["N_SOC"]) == len(groups)


@functools.lru_cache(maxsize=None)
def _jax_batched_f64():
    return jax.jit(jax_solver_batched(jpp.model().residual, jpp.cone_spec(),
                                      JOPTS))


@pytest.mark.parametrize("spread", ["nominal", "wide"])
def test_k1n_plain_matches_jax_batched_f64(spread):
    draws = _nominal(16, 5) if spread == "nominal" else _nominal(
        16, 6, dq=0.02, du=0.5)
    z_j, th_j, z_t, th_t = _inputs(*draws, np.float64)
    ref = _jax_batched_f64()(z_j, th_j)
    sol = make_fused_ip_plain(tpp.model(), convert.ip_options(JOPTS), "cpu",
                              F64)(z_t, th_t)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    assert sol.converged.numpy().sum() >= 12
    same_it = sol.iterations.numpy() == np.asarray(ref.iterations)
    assert (~same_it).sum() <= 1, (sol.iterations, ref.iterations)
    np.testing.assert_allclose(sol.z.numpy()[same_it],
                               np.asarray(ref.z)[same_it], atol=1e-9)


def test_k1n_plain_matches_pallas_interpret_f32():
    """The reference's narrow-lane Pallas call (32-lane blocks at nz=35)
    in interpret mode against K1n's wrapper on CPU tensors, which runs
    the plain version and launches nothing."""
    z_j, th_j, z_t, th_t = _inputs(*_nominal(8, 7), np.float32)
    ref = jax_fused_solver(jpp.model().residual, jpp.cone_spec(), JOPTS,
                           interpret=True)(z_j, th_j)
    before = fused_ip.launches
    sol = make_fused_ip_solver(tpp.model(), convert.ip_options(JOPTS), "cpu",
                               torch.float32)(z_t, th_t)
    assert fused_ip.launches == before
    cr, cs = np.asarray(ref.converged), sol.converged.numpy()
    both = cr & cs
    assert both.sum() >= cr.sum() - 1
    assert both.sum() >= 6
    np.testing.assert_allclose(sol.z.numpy()[both][:, :tpp.NQ],
                               np.asarray(ref.z)[both][:, :tpp.NQ],
                               atol=2e-4)


def test_k2_plain_at_push_shape_matches_jax():
    """K2's plain version at (n, k) = (35, 13): random systems, and the
    IFT systems dr/dz, dr/dtheta at K1n's solutions."""
    rng = np.random.default_rng(8)
    A = rng.standard_normal((12, 35, 35)) + 6.0 * np.eye(35)
    b = rng.standard_normal((12, 35, 13))
    ref = np.asarray(batched_solve_reference(jnp.asarray(A), jnp.asarray(b)))
    got = batched_solve(_t(A), _t(b))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)

    _, _, z_t, th_t = _inputs(*_nominal(12, 9), np.float64)
    model = tpp.model()
    zs = make_fused_ip_plain(model, convert.ip_options(JOPTS), "cpu",
                             F64)(z_t, th_t).z
    Az = tip.batched_jacobian(model.residual, 0)(zs, th_t)
    Ath = tip.batched_jacobian(model.residual, 1)(zs, th_t)
    x = batched_solve_plain(Az, Ath)
    xr = np.asarray(batched_solve_reference(jnp.asarray(Az.numpy()),
                                            jnp.asarray(Ath.numpy())))
    scale = np.abs(xr).max()
    assert np.abs(x.numpy() - xr).max() <= 1e-8 * scale
    r = torch.abs(Az @ x - Ath).amax(dim=(1, 2))
    den = (Az.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=(1, 2))
           + Ath.abs().amax(dim=(1, 2)))
    assert float((r / den).max()) <= 1e-12


def test_warm_jacobian_sweep_matches_jax():
    """step_jac_batched_ws at the deploy tier's float64 CPU IP settings,
    warm-started from the eval solution of the same step (the deploy
    policy's derivative sweep), handed to both packages."""
    q0, q1, us = _nominal(6, 10)
    xs = np.concatenate([q0, q1], axis=1)
    jo = JaxIPOptions(r_tol=1e-8, kappa_tol=1e-3, max_iter=40, max_ls=8)
    jd = jax_dynamics(jpp.model(), eval_opts=jo, grad_opts=jo, fused=False)
    to = convert.ip_options(jo)
    td = make_implicit_dynamics(tpp.model(), "cpu", F64, eval_opts=to,
                                grad_opts=to)
    jaux = jpp.PlanarPushAux(h=0.1)
    taux = convert.planar_push_aux(jaux)
    xt, ut = _t(xs), _t(us)
    np.testing.assert_array_equal(
        td.carry_init(xt).numpy(), np.asarray(jax.vmap(jd.carry_init)(xs)))
    _, zw = td.step_batched_ws(xt, ut, taux, td.carry_init(xt))
    for got, ref in zip(td.step_jac_batched_ws(xt, ut, taux, zw),
                        jd.step_jac_batched_ws(xs, us, jaux, zw.numpy())):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-9 * max(np.abs(ref).max(), 1.0))


def test_convert_planar_push_params():
    p = jpp.PlanarPushParams(mass_block=2.0, mu_pusher=0.3)
    tp = convert.planar_push_params(p)
    assert tuple(tp) == tuple(p) and isinstance(tp, tpp.PlanarPushParams)
    assert convert.planar_push_aux(
        jpp.PlanarPushAux(h=jnp.float32(0.1))).h == pytest.approx(0.1)


@pytest.mark.parametrize("which", ["stage", "terminal"])
@pytest.mark.parametrize("mode", ["translate", "rotate"])
def test_costs_equal_their_dot_product_forms(mode, which):
    """``examples/planar_push.py``'s costs (explicit sums) against the dot
    products they were written with, on the deploy problem."""
    import inspect

    from optimization_dynamics_tpu_torch.examples import planar_push as ex

    from tests.test_torch_cartpole import check_cost_forms

    prob, x0, _, _ = ex.build_deploy_problem("cpu", mode=mode)
    c = inspect.getclosurevars(prob.stage_cost).nonlocals
    vw, xw, uw, xT = c["vw"], c["xw"], c["uw"], c["xT"]

    def terminal(x):
        v1 = (x[5:] - x[:5]) / ex.H
        dx = x - xT
        return 0.5 * v1 @ (vw * v1) + 0.5 * dx @ (xw * dx)

    def stage(t, x, u):
        v1 = (x[5:] - x[:5]) / ex.H
        dx = x - xT
        return (0.5 * v1 @ (vw * v1) + 0.5 * dx @ (xw * dx)
                + 0.5 * uw * u @ u)

    old = {"stage": stage, "terminal": terminal}[which]
    check_cost_forms(prob, which, old, x0, seed=164, scale=0.05)


@pytest.mark.parametrize("helper", ["sd_2d_box", "mass_matrix",
                                    "control_matrix", "rotation_matrix"])
def test_dropped_helpers_match_jax(helper):
    """The reference's module-level helpers of ``models/planar_push.py``
    and ``models/base.py::rotation_matrix``, at 1e-12 on seeded inputs."""
    from optimization_dynamics_tpu.models import base as jbase
    from optimization_dynamics_tpu_torch.models import base as tbase

    rng = np.random.default_rng(165)
    if helper == "sd_2d_box":
        ps = 0.2 * rng.standard_normal((16, 2))
        poses = 0.1 * rng.standard_normal((16, 3))
        got = tpp.sd_2d_box(torch.as_tensor(ps), torch.as_tensor(poses))
        want = np.stack([np.asarray(jpp.sd_2d_box(jnp.asarray(p),
                                                 jnp.asarray(q)))
                         for p, q in zip(ps, poses)])
    elif helper == "mass_matrix":
        got = tpp.mass_matrix(tpp.PlanarPushParams())
        want = np.asarray(jpp.mass_matrix(jpp.PlanarPushParams()))
    elif helper == "control_matrix":
        got = tpp.control_matrix()
        want = np.asarray(jpp.control_matrix())
    else:
        assert "rotation_matrix" in tbase.__all__
        angles = 3.0 * rng.standard_normal(16)
        got = tbase.rotation_matrix(torch.as_tensor(angles))
        want = np.stack([np.asarray(jbase.rotation_matrix(a))
                         for a in angles])
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
