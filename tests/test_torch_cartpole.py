"""Port parity: cones and the cartpole model against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the residual and its Jacobian are the same arithmetic in
float64, so they agree to round-off (atol 1e-12); the cone step lengths
are checked at the reference tests' own tolerance (1e-10).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu.ops import cones as jcones
from optimization_dynamics_tpu.solver import interior_point as jip
from optimization_dynamics_tpu_torch.models import cartpole as tcp
from optimization_dynamics_tpu_torch.ops import cones as tcones
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

# one thread per test worker: tier-1 runs six workers on the host's cores
torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _points(n, nz, nth, seed):
    """Random (z, theta) points with positive timesteps (theta[-1])."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, nz))
    th = rng.standard_normal((n, nth))
    th[:, -1] = 0.02 + 0.08 * rng.random(n)
    return z, th


@pytest.mark.parametrize("variant", ["friction", "frictionless"])
def test_residual_and_jacobian_match_jax(variant):
    p = jcp.CartpoleParams()
    if variant == "friction":
        jres, nz, nth = jcp.residual_friction, 10, 8
        tres = tcp.residual_friction
    else:
        jres, nz, nth = jcp.residual_frictionless, 2, 6
        tres = tcp.residual_frictionless
    tp = convert.cartpole_params(p)
    z, th = _points(64, nz, nth, seed=0)
    kappa = 3e-3
    r_j = jax.vmap(lambda a, b: jres(p, a, b, kappa))(z, th)
    jz_j = jax.vmap(jax.jacfwd(lambda a, b: jres(p, a, b, 0.0)))(z, th)
    jt_j = jax.vmap(jax.jacfwd(lambda a, b: jres(p, a, b, 0.0),
                               argnums=1))(z, th)
    for i in range(len(z)):
        zi, ti = _t(z[i]), _t(th[i])
        np.testing.assert_allclose(tres(tp, zi, ti, kappa).numpy(),
                                   np.asarray(r_j[i]), atol=1e-12)
        np.testing.assert_allclose(
            jacfwd(lambda a: tres(tp, a, ti, 0.0))(zi).numpy(),
            np.asarray(jz_j[i]), atol=1e-12)
        np.testing.assert_allclose(
            jacfwd(lambda b: tres(tp, zi, b, 0.0))(ti).numpy(),
            np.asarray(jt_j[i]), atol=1e-12)
    # batch-native: one call on the whole batch gives the same rows, and
    # the solver's one-pass batched Jacobians give the same columns
    np.testing.assert_allclose(tres(tp, _t(z), _t(th), kappa).numpy(),
                               np.asarray(r_j), atol=1e-12)
    for argnum, ref in ((0, jz_j), (1, jt_j)):
        jac = tip.batched_jacobian(lambda a, b, k: tres(tp, a, b, k),
                                   argnum)
        np.testing.assert_allclose(jac(_t(z), _t(th)).numpy(),
                                   np.asarray(ref), atol=1e-12)


def test_theta_packing_and_init_z_match_jax():
    rng = np.random.default_rng(1)
    q0, q1 = rng.standard_normal((2, 5, 2))
    u = rng.standard_normal((5, 1))
    jaux = jcp.CartpoleAux(h=0.05, friction=jnp.asarray([0.35, 0.2]))
    taux = convert.cartpole_aux(jaux, "cpu", F64)
    for jm, tm in ((jcp.friction_model(), tcp.friction_model()),
                   (jcp.frictionless_model(), tcp.frictionless_model())):
        th_j = jax.vmap(lambda a, b, c: jm.theta_fn(a, b, c, jaux))(q0, q1,
                                                                   u)
        th_t = tm.theta_fn(_t(q0), _t(q1), _t(u), taux)
        np.testing.assert_array_equal(th_t.numpy(), np.asarray(th_j))
        np.testing.assert_array_equal(tm.init_z(_t(q1)).numpy(),
                                      np.asarray(jax.vmap(jm.init_z)(q1)))
        assert tm.spec == tcones.ConeSpec(**jm.spec.__dict__)
        for f in ("nq", "nu", "nz", "ntheta", "q_sel", "th_q0", "th_q1",
                  "th_u"):
            assert getattr(tm, f) == getattr(jm, f), f


def test_cone_product_and_interior_init():
    a = _t([2.0, 1.0, 0.5])
    b = _t([3.0, -1.0, 0.25])
    np.testing.assert_allclose(tcones.cone_product(a, b).numpy(),
                               np.asarray(jcones.cone_product(
                                   jnp.asarray(a.numpy()),
                                   jnp.asarray(b.numpy()))))
    spec = tcones.ConeSpec(nz=6, ntheta=1, ort_prim=(0,), ort_dual=(1,),
                           soc_prim=((2, 3),), soc_dual=((4, 5),))
    np.testing.assert_allclose(
        tcones.interior_init(spec, torch.zeros(6, dtype=F64)).numpy(),
        [1.0, 1.0, 1.0, 0.1, 1.0, 0.1])


def test_step_to_boundary_cases():
    """The reference's tests/test_cones.py step-length cases."""
    assert float(tcones.orthant_step_to_boundary(_t([1.0, 2.0]),
                                                 _t([0.5, -1.0]))) == 2.0
    assert float(tcones.soc_step_to_boundary(_t([2.0, 0.0, 0.0]),
                                             _t([-1.0, 0.0, 0.0]))) > 1e6
    z, d = _t([1.0, 0.0]), _t([0.0, -2.0])
    a = float(tcones.soc_step_to_boundary(z, d))
    np.testing.assert_allclose(a, 0.5, atol=1e-10)
    zb = z - a * d
    np.testing.assert_allclose(float(zb[0]), abs(float(zb[1])), atol=1e-10)
    spec = tcones.ConeSpec(
        nz=6, ntheta=1, eq_rows=(0, 1),
        ort_prim=(0,), ort_dual=(1,), ort_rows=(2,),
        soc_prim=((2, 3),), soc_dual=((4, 5),), soc_rows=((3, 4),))
    np.testing.assert_allclose(
        float(tcones.step_to_boundary(spec, _t([1, 1, 1, 0, 1, 0]),
                                      _t([2, 0, 0, -4, 0, 0]), tau=1.0)),
        0.25, atol=1e-10)


def test_step_to_boundary_batched_matches_jax():
    """Random directions through the cartpole spec: the batched port
    against the JAX per-vector function, including no-crossing lanes."""
    jspec = jcp.cone_spec_friction()
    tspec = tcp.cone_spec_friction()
    rng = np.random.default_rng(2)
    z = np.abs(rng.standard_normal((256, 10))) + 0.1
    d = rng.standard_normal((256, 10))
    ref = jax.vmap(lambda a, b: jcones.step_to_boundary(jspec, a, b, 0.9))(
        z, d)
    got = tcones.step_to_boundary(tspec, _t(z), _t(d), tau=0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    dp = jax.vmap(lambda b: jcones.delta_products(jspec, b))(d)
    np.testing.assert_allclose(tcones.delta_products(tspec, _t(d)).numpy(),
                               np.asarray(dp), atol=1e-12)


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
    """The constexpr tables of the CUDA cartpole functor are the Python
    ConeSpec's masks, reset template and SOC groups."""
    from optimization_dynamics_tpu_torch.ops.kernels import _build

    tables = _cuh_tables(_build.CSRC / "cartpole_friction.cuh")
    spec = tcp.cone_spec_friction()
    eq, bil, head = tip._row_masks(spec, "cpu", F64)
    rmask, rtmpl = tip._cone_reset(spec, "cpu", F64)
    assert tables["eq_mask"] == eq.tolist()
    assert tables["bil_mask"] == bil.tolist()
    assert tables["head_mask"] == head.tolist()
    assert tables["reset_mask"] == rmask.double().tolist()
    assert tables["reset_tmpl"] == rtmpl.tolist()
    groups = [list(g) for g in list(spec.soc_prim) + list(spec.soc_dual)]
    assert tables["soc_idx"] == [float(i) for g in groups for i in g]
    assert not spec.ort_prim
    # init_z's cold start (K4's per-step start) and the next configuration
    q = torch.tensor([[0.3, -1.2]], dtype=F64)
    z = tcp.init_z_friction(q)
    assert tables["init_tail"] == z[0, 2:].tolist()
    assert tables["q_sel"] == [float(i) for i in tcp.friction_model().q_sel]


def test_convert_options_round_trip():
    jo = jip.IPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40, max_ls=8,
                       kappa_scale=0.01)
    to = convert.ip_options(jo)
    assert to.r_tol == 3e-5 and to.max_ls == 8 and to.kappa_scale == 0.01
    with pytest.raises(ValueError):
        convert.ip_options(jip.IPOptions(verbose=True))
    from optimization_dynamics_tpu.solver.ilqr import ILQROptions
    assert convert.ilqr_options(ILQROptions(rho_max=1e6)).rho_max == 1e6
    # the reference's Pallas Riccati pass maps to the port's K3
    to = convert.ilqr_options(ILQROptions(pallas_riccati=True))
    assert to.riccati_kernel is True
    assert convert.ilqr_options(ILQROptions()).riccati_kernel is False
    # the scalar solver's options carry across
    to = convert.ilqr_options(ILQROptions(parallel_riccati=True,
                                          parallel_linesearch=True,
                                          verbose=True))
    assert to.parallel_riccati and to.parallel_linesearch and to.verbose
