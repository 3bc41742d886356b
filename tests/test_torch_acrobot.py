"""Port parity: the acrobot model, its CUDA functor's tables, K1a's plain
version, K2 at the acrobot IFT shape and the lane-batched dynamics,
against the JAX package.

Inputs are made with numpy from a seed and go through each package's own
packing. Tolerances:

* the residuals (impact and nominal), the mechanics pieces and the
  Jacobians in z and theta are the same arithmetic in float64, so they
  agree to 1e-12 (the Jacobians' entries reach 1e2: 1e-12 relative);
* K1a's plain version against ``make_solver_batched`` in float64:
  identical converged flags and iteration counts, z within 1e-10;
* K1a's plain version in float32 against the Pallas kernel in interpret
  mode (its wide-lane call at nz=6), at the tolerances of
  tests/test_fused_ip.py: equal converged counts, configurations within
  1e-4;
* K2's plain version at (6, 6) against the Pallas QR kernel in interpret
  mode in float32 (1e-3, the reference's float32 bound), and on the IFT
  systems at K1a's solutions in float64 against the reference's QR
  solve: relative residual 1e-12, the two solutions within 1e-10 of
  max|x|;
* the warm Jacobian sweep and the nominal model's step within 1e-9 of
  max|ref| (both solve to r_tol 1e-8).
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
from optimization_dynamics_tpu.models import acrobot as ja
from optimization_dynamics_tpu.ops.pallas.batched_solve import (
    batched_solve as jax_batched_solve,
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
from optimization_dynamics_tpu_torch.examples.acrobot import envelope_draws
from optimization_dynamics_tpu_torch.models import acrobot as ta
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
H = 0.05
# the deploy eval options of tests/test_fused_ip.py
JOPTS = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40, max_ls=8,
                     kappa_init_min=1e-2)
# the accelerator branch of the deploy tier (one-stage kappa schedule)
DEPLOY_OPTS = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40,
                           max_ls=8, kappa_scale=0.01, kappa_init_max=0.3,
                           center_frac=0.2)


def _near_rest(B, seed):
    """The distribution of tests/test_fused_ip.py::_batch."""
    rng = np.random.default_rng(seed)
    q0 = 0.2 * rng.standard_normal((B, 2))
    q1 = q0 + 0.02 * rng.standard_normal((B, 2))
    u = 0.5 * rng.standard_normal((B, 1))
    return q0, q1, u


def _inputs(q0, q1, u, np_dtype):
    """(jax z0s, jax thetas, torch z0s, torch thetas) through each
    package's own packing."""
    jm = ja.impact_model()
    jaux = ja.AcrobotAux(h=np_dtype(H))
    th_j = jax.vmap(lambda a, b, c: jm.theta_fn(a, b, c, jaux))(
        *(jnp.asarray(v, np_dtype) for v in (q0, q1, u)))
    z_j = jax.vmap(jm.init_z)(jnp.asarray(q1, np_dtype))
    tdt = F64 if np_dtype == np.float64 else torch.float32
    tm = ta.impact_model()
    taux = convert.acrobot_aux(jaux, "cpu", tdt)
    t = lambda a: torch.as_tensor(np.asarray(a, np_dtype))
    return z_j, th_j, tm.init_z(t(q1)), tm.theta_fn(t(q0), t(q1), t(u), taux)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def test_mechanics_match_jax():
    """Kinematics, mass matrix, bias, joint limits and the control and
    limit forces at random (q, v)."""
    rng = np.random.default_rng(0)
    q = 2.0 * rng.standard_normal((32, 2))
    v = 3.0 * rng.standard_normal((32, 2))
    lam = rng.standard_normal((32, 2))
    u = rng.standard_normal((32, 1))
    p = ja.AcrobotParams(m1=1.2, lc2=0.4)
    tp = convert.acrobot_params(p)
    ref = jax.vmap(lambda a, b, c, d: (
        ja.kinematics(p, a), ja.mass_matrix(p, a), ja.dynamics_bias(p, a, b),
        ja.signed_distance(a), ja.control_force(d),
        jnp.sum(ja.limit_jacobian().T * c[None, :], axis=1)))(q, v, lam, u)
    got = (ta.kinematics(tp, _t(q)), ta.mass_matrix(tp, _t(q)),
           ta.dynamics_bias(tp, _t(q), _t(v)), ta.signed_distance(_t(q)),
           ta.control_force(_t(u)), ta.limit_force(_t(lam)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_array_equal(np.array(ta.limit_jacobian()),
                                  np.asarray(ja.limit_jacobian()))


@pytest.mark.parametrize("mode", ["impact", "nominal"])
def test_residual_and_jacobians_match_jax(mode):
    z_j, th_j, _, _ = _inputs(*envelope_draws(16, 1), np.float64)
    nz = ta.NZ_IMPACT if mode == "impact" else ta.NZ_NOMINAL
    rng = np.random.default_rng(2)
    z = np.asarray(z_j)[:, :nz] + 0.05 * rng.standard_normal((16, nz))
    th = np.asarray(th_j)
    p = ja.AcrobotParams()
    tp = convert.acrobot_params(p)
    jres = ja.residual_impact if mode == "impact" else ja.residual_nominal
    tres = ta.residual_impact if mode == "impact" else ta.residual_nominal
    kappa = 3e-3
    r_j, jz_j, jt_j = jax.jit(jax.vmap(lambda a, b: (
        jres(p, a, b, kappa),
        jax.jacfwd(lambda x: jres(p, x, b, 0.0))(a),
        jax.jacfwd(lambda y: jres(p, a, y, 0.0))(b))))(z, th)
    np.testing.assert_allclose(tres(tp, _t(z), _t(th), kappa).numpy(),
                               np.asarray(r_j), rtol=1e-12, atol=1e-12)
    res = lambda a, b, k: tres(tp, a, b, k)
    for argnum, ref in ((0, jz_j), (1, jt_j)):
        jac = tip.batched_jacobian(res, argnum)(_t(z), _t(th))
        np.testing.assert_allclose(jac.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    # one lane through torch.func.jacfwd (a vector, not a batch)
    for i in (0, 9):
        zi, ti = _t(z[i]), _t(th[i])
        np.testing.assert_allclose(
            jacfwd(lambda a: res(a, ti, 0.0))(zi).numpy(),
            np.asarray(jz_j[i]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            jacfwd(lambda b: res(zi, b, 0.0))(ti).numpy(),
            np.asarray(jt_j[i]), rtol=1e-12, atol=1e-12)


def test_theta_packing_init_z_and_specs_match_jax():
    q0, q1, u = _near_rest(5, 3)
    z_j, th_j, z_t, th_t = _inputs(q0, q1, u, np.float64)
    np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    # a Python-float timestep packs the same
    th_f = ta.impact_model().theta_fn(_t(q0), _t(q1), _t(u),
                                      ta.AcrobotAux(h=H))
    np.testing.assert_array_equal(th_f.numpy(), np.asarray(th_j))
    for jm, tm in ((ja.impact_model(), ta.impact_model()),
                   (ja.nominal_model(), ta.nominal_model())):
        assert tm.spec == tcones.ConeSpec(**jm.spec.__dict__)
        for f in ("nq", "nu", "nz", "ntheta", "q_sel", "th_q0", "th_q1",
                  "th_u"):
            assert getattr(tm, f) == getattr(jm, f), f
        np.testing.assert_array_equal(
            tm.init_z(_t(q1)).numpy(), np.asarray(jax.vmap(jm.init_z)(q1)))
    assert ta.impact_model().kernel == "acrobot_impact"
    assert ta.impact_model().kernel_params == tuple(ja.AcrobotParams())
    assert ta.nominal_model().kernel is None


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
    """The constexpr tables of the CUDA acrobot functor are the Python
    ConeSpec's masks, reset template and orthant pairs, and init_z's cold
    start; with no SOC group the SOC tables are one-entry sentinels."""
    from optimization_dynamics_tpu_torch.ops.kernels import _build

    path = _build.CSRC / "acrobot_impact.cuh"
    tables = _cuh_tables(path)
    spec = ta.cone_spec_impact()
    eq, bil, head = tip._row_masks(spec, "cpu", F64)
    rmask, rtmpl = tip._cone_reset(spec, "cpu", F64)
    assert tables["eq_mask"] == eq.tolist()
    assert tables["bil_mask"] == bil.tolist()
    assert tables["head_mask"] == head.tolist()
    assert tables["reset_mask"] == rmask.double().tolist()
    assert tables["reset_tmpl"] == rtmpl.tolist()
    assert tables["ort_idx"] == [float(i) for i in
                                 spec.ort_prim + spec.ort_dual]
    assert not spec.soc_prim and not spec.soc_dual
    assert tables["soc_dim"] == [0.0] and tables["soc_idx"] == [-1.0]
    z = ta.init_z_impact(torch.tensor([[0.3, -1.2]], dtype=F64))
    assert tables["init_tail"] == z[0, ta.NQ:].tolist()
    assert tables["q_sel"] == [float(i) for i in ta.impact_model().q_sel]
    sizes = dict(re.findall(r"static constexpr int (\w+) = (\d+);",
                            path.read_text()))
    assert (int(sizes["NZ"]), int(sizes["NTH"])) \
        == _build.FUSED_IP_FUNCTORS["acrobot_impact"]
    assert int(sizes["N_ORT"]) == len(spec.ort_prim + spec.ort_dual)
    assert int(sizes["N_SOC"]) == 0 and int(sizes["SOC_MAX"]) == 1
    assert (int(sizes["NQ"]), int(sizes["NU"])) == (ta.NQ, ta.NU)


@functools.lru_cache(maxsize=None)
def _jax_batched_f64(opts):
    return jax.jit(jax_solver_batched(ja.impact_model().residual,
                                      ja.cone_spec_impact(), opts))


@pytest.mark.parametrize("batch,opts", [("near_rest", JOPTS),
                                        ("swing", DEPLOY_OPTS)])
def test_k1a_plain_matches_jax_batched_f64(batch, opts):
    draws = (_near_rest(16, 5) if batch == "near_rest"
             else envelope_draws(32, 6))
    z_j, th_j, z_t, th_t = _inputs(*draws, np.float64)
    ref = _jax_batched_f64(opts)(z_j, th_j)
    sol = make_fused_ip_plain(ta.impact_model(), convert.ip_options(opts),
                              "cpu", F64)(z_t, th_t)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    assert sol.converged.numpy().mean() >= 0.9
    np.testing.assert_array_equal(sol.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(ref.z), atol=1e-10)
    if batch == "swing":
        # the limit rows are active on some lanes: a multiplier is up
        assert (sol.z.numpy()[:, 2:4] > 1e-2).any()


def test_k1a_plain_matches_pallas_interpret_f32():
    """The reference's wide-lane Pallas call at nz=6 in interpret mode
    against K1a's wrapper on CPU tensors, which runs the plain version
    and launches nothing."""
    z_j, th_j, z_t, th_t = _inputs(*_near_rest(16, 7), np.float32)
    ref = jax_fused_solver(ja.impact_model().residual, ja.cone_spec_impact(),
                           JOPTS, interpret=True)(z_j, th_j)
    before = fused_ip.launches
    sol = make_fused_ip_solver(ta.impact_model(), convert.ip_options(JOPTS),
                               "cpu", torch.float32)(z_t, th_t)
    assert fused_ip.launches == before
    cr, cs = np.asarray(ref.converged), sol.converged.numpy()
    assert int(cr.sum()) == int(cs.sum())
    both = cr & cs
    assert both.sum() >= 12
    np.testing.assert_allclose(sol.z.numpy()[both][:, :ta.NQ],
                               np.asarray(ref.z)[both][:, :ta.NQ],
                               atol=1e-4)


def test_ragged_batch():
    """B=5: no padding is involved, every lane converges, and the result
    matches the JAX batched solver."""
    z_j, th_j, z_t, th_t = _inputs(*_near_rest(5, 8), np.float64)
    sol = make_fused_ip_solver(ta.impact_model(), convert.ip_options(JOPTS),
                               "cpu", F64)(z_t, th_t)
    assert tuple(sol.z.shape) == (5, 6)
    assert bool(sol.converged.all())
    ref = _jax_batched_f64(JOPTS)(z_j, th_j)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(ref.z), atol=1e-10)


def test_k2_plain_at_acrobot_shape_matches_jax():
    """K2's plain version at (n, k) = (6, 6): random systems against the
    Pallas QR kernel in interpret mode (float32), and the IFT systems
    dr/dz, dr/dtheta at K1a's solutions against the reference's QR solve
    (float64)."""
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((130, 6, 6)) + 4.0 * np.eye(6)).astype(
        np.float32)
    b = rng.standard_normal((130, 6, 6)).astype(np.float32)
    ref = np.asarray(jax_batched_solve(jnp.asarray(A), jnp.asarray(b),
                                       interpret=True))
    got = batched_solve(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)

    _, _, z_t, th_t = _inputs(*envelope_draws(24, 10), np.float64)
    model = ta.impact_model()
    zs = make_fused_ip_plain(model, convert.ip_options(DEPLOY_OPTS), "cpu",
                             F64)(z_t, th_t).z
    Az = tip.batched_jacobian(model.residual, 0)(zs, th_t)
    Ath = tip.batched_jacobian(model.residual, 1)(zs, th_t)
    x = batched_solve_plain(Az, Ath)
    xr = np.asarray(batched_solve_reference(jnp.asarray(Az.numpy()),
                                            jnp.asarray(Ath.numpy())))
    assert np.abs(x.numpy() - xr).max() <= 1e-10 * np.abs(xr).max()
    r = torch.abs(Az @ x - Ath).amax(dim=(1, 2))
    den = (Az.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=(1, 2))
           + Ath.abs().amax(dim=(1, 2)))
    assert float((r / den).max()) <= 1e-12


def _jax_dyn(model):
    jo = JaxIPOptions(r_tol=1e-8, kappa_tol=1e-3, max_iter=40, max_ls=8)
    return jo, jax_dynamics(model, eval_opts=jo, grad_opts=jo, fused=False)


def test_warm_jacobian_sweep_matches_jax():
    """step_jac_batched_ws at the deploy tier's float64 CPU IP settings,
    warm-started from the eval solution of the same step (the deploy
    policy's derivative sweep), handed to both packages."""
    q0, q1, us = envelope_draws(8, 11)
    xs = np.concatenate([q0, q1], axis=1)
    jo, jd = _jax_dyn(ja.impact_model())
    to = convert.ip_options(jo)
    td = make_implicit_dynamics(ta.impact_model(), "cpu", F64, eval_opts=to,
                                grad_opts=to)
    jaux = ja.AcrobotAux(h=H)
    taux = convert.acrobot_aux(jaux, "cpu", F64)
    xt, ut = _t(xs), _t(us)
    np.testing.assert_array_equal(
        td.carry_init(xt).numpy(), np.asarray(jax.vmap(jd.carry_init)(xs)))
    _, zw = td.step_batched_ws(xt, ut, taux, td.carry_init(xt))
    for got, ref in zip(td.step_jac_batched_ws(xt, ut, taux, zw),
                        jd.step_jac_batched_ws(xs, us, jaux, zw.numpy())):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-9 * max(np.abs(ref).max(), 1.0))


def test_nominal_step_matches_jax():
    """The model without joint limits has no device functor: its step
    runs ``make_solver_batched`` (Newton solves through K2's plain version
    at (2, 1), IFT at (2, 6)) and matches the reference's step and
    Jacobians."""
    q0, q1, us = _near_rest(6, 12)
    xs = np.concatenate([q0, q1], axis=1)
    jo, jd = _jax_dyn(ja.nominal_model())
    to = convert.ip_options(jo)
    td = make_implicit_dynamics(ta.nominal_model(), "cpu", F64,
                                eval_opts=to, grad_opts=to)
    jaux = ja.AcrobotAux(h=H)
    taux = convert.acrobot_aux(jaux, "cpu", F64)
    for got, ref in zip(td.step_jac_batched(_t(xs), _t(us), taux),
                        jd.step_jac_batched(xs, us, jaux)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-9 * max(np.abs(ref).max(), 1.0))


def test_convert_acrobot_params_and_aux():
    p = ja.AcrobotParams(m2=1.5, lc1=0.45)
    tp = convert.acrobot_params(p)
    assert tuple(tp) == tuple(p) and isinstance(tp, ta.AcrobotParams)
    aux = convert.acrobot_aux(ja.AcrobotAux(h=jnp.float32(0.05)), "cpu",
                              torch.float32)
    assert isinstance(aux, ta.AcrobotAux)
    assert aux.h.dtype == torch.float32 and aux.h.shape == ()
    assert float(aux.h) == pytest.approx(0.05)
