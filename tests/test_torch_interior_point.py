"""Port parity: the scalar IP solver, Mehrotra and the IFT sensitivities.

The cases of ``tests/test_interior_point.py`` (a nonnegative and a
second-order-cone projection, their sensitivities, the Mehrotra
predictor-corrector against the geometric schedule, Mehrotra batched
against single) run through the port's ``make_solver``,
``make_solver_batched`` and ``make_sensitivity`` and the reference's
solvers on the same inputs in float64: identical iteration counts and
converged flags, z within 1e-12 (the port's Newton solve is K2's plain
QR, the reference's an LU, so they differ by rounding), the IFT
sensitivities within 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.ops import cones as jcones
from optimization_dynamics_tpu.solver import interior_point as jip
from optimization_dynamics_tpu_torch.ops import cones as tcones
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)
F64 = torch.float64
Z_TOL = 1e-12


def _nn_residual(cat):
    """KKT of min 0.5||x - theta||^2 s.t. x >= 0 (n=2):
    z = [x (2), lam (2), s (2)]; rows x - theta - lam; s - x; lam s - kappa.
    ``cat`` concatenates over the last dimension in either package."""
    def residual(z, theta, kappa):
        x, lam, s = z[..., 0:2], z[..., 2:4], z[..., 4:6]
        return cat([x - theta - lam, s - x, lam * s - kappa])
    return residual


def _soc_residual(cat, cone_product, e):
    """KKT of min 0.5||x - theta||^2 s.t. x in SOC(3): z = [x (3), v (3)];
    rows x - theta - v; x o v - kappa e."""
    def residual(z, theta, kappa):
        x, v = z[..., 0:3], z[..., 3:6]
        return cat([x - theta - v, cone_product(x, v) - kappa * e(z)])
    return residual


J_NN = _nn_residual(lambda a: jnp.concatenate(a, axis=-1))
T_NN = _nn_residual(lambda a: torch.cat(a, dim=-1))
J_SOC = _soc_residual(lambda a: jnp.concatenate(a, axis=-1),
                      jcones.cone_product,
                      lambda z: jnp.array([1.0, 0.0, 0.0], z.dtype))
T_SOC = _soc_residual(lambda a: torch.cat(a, dim=-1), tcones.cone_product,
                      lambda z: torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype))
NN_SPEC = dict(nz=6, ntheta=2, eq_rows=(0, 1, 2, 3), ort_prim=(2, 3),
               ort_dual=(4, 5), ort_rows=(4, 5))
SOC_SPEC = dict(nz=6, ntheta=3, eq_rows=(0, 1, 2), soc_prim=((0, 1, 2),),
                soc_dual=((3, 4, 5),), soc_rows=((3, 4, 5),))
NN_Z0 = [0.0, 0.0, 1.0, 1.0, 1.0, 1.0]
SOC_Z0 = [1.0, 0.1, 0.1, 1.0, 0.1, 0.1]
NN_TARGETS = ([0.7, -1.3], [2.0, 0.1], [-0.5, -0.5], [0.0, 3.0],
              [0.5, -0.2])
SOC_TARGETS = ([0.1, 1.0, -0.5], [2.0, 0.3, 0.1], [-2.0, 0.1, 0.0],
               [1.0, 1.0, 0.0])


def _problem(kind):
    if kind == "nn":
        return (J_NN, T_NN, jcones.ConeSpec(**NN_SPEC),
                tcones.ConeSpec(**NN_SPEC), NN_Z0, NN_TARGETS)
    return (J_SOC, T_SOC, jcones.ConeSpec(**SOC_SPEC),
            tcones.ConeSpec(**SOC_SPEC), SOC_Z0, SOC_TARGETS)


def _soc_project(y):
    """Analytic projection onto the second-order cone (axis first)."""
    y0, y1 = y[0], y[1:]
    n = np.linalg.norm(y1)
    if n <= y0:
        return y
    if n <= -y0:
        return np.zeros_like(y)
    a = 0.5 * (1.0 + y0 / n)
    return np.concatenate([[a * n], a * y1])


def _same(got, ref, what):
    assert int(got.iterations) == int(ref.iterations), what
    assert bool(got.converged) == bool(ref.converged), what
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), atol=Z_TOL,
                               rtol=0, err_msg=str(what))


@pytest.mark.parametrize("kind", ["nn", "soc"])
@pytest.mark.parametrize("mehrotra", [False, True])
def test_scalar_solver_matches_jax(kind, mehrotra):
    """``make_solver`` against the reference's scalar solver on every
    target of the projections, geometric and Mehrotra, with the analytic
    projections as the reference's tests check them."""
    jres, tres, jspec, tspec, z0, targets = _problem(kind)
    jo = jip.IPOptions(r_tol=1e-10, kappa_tol=1e-8, mehrotra=mehrotra)
    js = jax.jit(jip.make_solver(jres, jspec, jo))
    ts = tip.make_solver(tres, tspec, convert.ip_options(jo), "cpu", F64)
    for target in targets:
        ref = js(jnp.asarray(z0), jnp.asarray(target))
        got = ts(torch.tensor(z0, dtype=F64), torch.tensor(target,
                                                           dtype=F64))
        assert got.z.shape == (6,) and got.iterations.shape == ()
        _same(got, ref, target)
        assert bool(got.converged), target
        want = (np.maximum(target, 0.0) if kind == "nn"
                else _soc_project(np.asarray(target)))
        np.testing.assert_allclose(got.z[0:len(target)].numpy(), want,
                                   atol=1e-4)


def test_mehrotra_saves_iterations():
    """The predictor-corrector reaches the same projections in no more
    Newton iterations than the geometric schedule (degenerate target
    theta = 0 included)."""
    base = tip.IPOptions(r_tol=1e-10, kappa_tol=1e-8)
    meh = dataclasses.replace(base, mehrotra=True)
    s0 = tip.make_solver(T_NN, tcones.ConeSpec(**NN_SPEC), base, "cpu", F64)
    s1 = tip.make_solver(T_NN, tcones.ConeSpec(**NN_SPEC), meh, "cpu", F64)
    z0 = torch.tensor(NN_Z0, dtype=F64)
    for target in NN_TARGETS[:4]:
        th = torch.tensor(target, dtype=F64)
        a, b = s0(z0, th), s1(z0, th)
        assert bool(b.converged), target
        assert int(b.iterations) <= int(a.iterations), target


@pytest.mark.parametrize("mehrotra", [False, True])
def test_batched_solver_matches_jax_and_single(mehrotra):
    """``make_solver_batched`` (Mehrotra too) against the reference's
    batched solver lane by lane, and against the port's single solves
    (the reference's ``test_mehrotra_batched_matches_single`` and
    ``test_vmapped_solve``)."""
    jo = jip.IPOptions(r_tol=1e-10, kappa_tol=1e-8, mehrotra=mehrotra)
    to = convert.ip_options(jo)
    spec = tcones.ConeSpec(**NN_SPEC)
    thetas = np.array(NN_TARGETS)
    z0s = np.tile(NN_Z0, (len(thetas), 1))
    ref = jax.jit(jip.make_solver_batched(J_NN, jcones.ConeSpec(**NN_SPEC),
                                          jo))(z0s, thetas)
    got = tip.make_solver_batched(T_NN, spec, to, "cpu", F64)(
        torch.tensor(z0s), torch.tensor(thetas))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), atol=Z_TOL,
                               rtol=0)
    assert bool(got.converged.all())
    np.testing.assert_allclose(got.z[:, 0:2].numpy(),
                               np.maximum(thetas, 0.0), atol=1e-4)
    single = tip.make_solver(T_NN, spec, to, "cpu", F64)
    for i in range(len(thetas)):
        s = single(torch.tensor(z0s[i]), torch.tensor(thetas[i]))
        assert int(s.iterations) == int(got.iterations[i])
        np.testing.assert_allclose(s.z.numpy(), got.z[i].numpy(),
                                   atol=Z_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["nn", "soc"])
def test_sensitivity_matches_jax_and_finite_differences(kind):
    """``make_sensitivity`` at the kappa_tol=1e-3 relaxed solution against
    the reference's, and against central differences of warm-started
    re-solves (``test_nonnegative_projection_sensitivity``)."""
    jres, tres, jspec, tspec, z0, targets = _problem(kind)
    jo = jip.IPOptions(r_tol=1e-10, kappa_tol=1e-3)
    solve = tip.make_solver(tres, tspec, convert.ip_options(jo), "cpu", F64)
    sens = tip.make_sensitivity(tres, tspec)
    jsolve = jax.jit(jip.make_solver(jres, jspec, jo))
    jsens = jax.jit(jip.make_sensitivity(jres, jspec))
    theta = torch.tensor(targets[-1] if kind == "nn" else targets[0],
                         dtype=F64)
    sol = solve(torch.tensor(z0, dtype=F64), theta)
    jsol = jsolve(jnp.asarray(z0), jnp.asarray(theta.numpy()))
    _same(sol, jsol, theta)
    assert bool(sol.converged)
    dz = sens(sol.z, theta)
    np.testing.assert_allclose(
        dz.numpy(), np.asarray(jsens(jsol.z, jnp.asarray(theta.numpy()))),
        atol=1e-10, rtol=0)
    eps = 1e-6
    for j in range(theta.shape[0]):
        step = torch.zeros_like(theta)
        step[j] = eps
        fd = (solve(sol.z, theta + step).z
              - solve(sol.z, theta - step).z) / (2 * eps)
        np.testing.assert_allclose(dz[:, j].numpy(), fd.numpy(), atol=1e-4)


def test_fused_ip_kernel_refuses_mehrotra():
    """K1 implements the geometric schedule only: asking its solver (and
    its plain version) for Mehrotra raises, while ``make_solver_batched``
    runs it."""
    from optimization_dynamics_tpu_torch.models import cartpole as tcp
    meh = tip.IPOptions(mehrotra=True)
    with pytest.raises(NotImplementedError):
        make_fused_ip_solver(tcp.friction_model(), meh, "cpu", F64)
    model = tcp.friction_model()
    solve = tip.make_solver_batched(model.residual, model.spec, meh, "cpu",
                                    F64)
    q = torch.zeros((1, 2), dtype=F64)
    aux = tcp.CartpoleAux(h=0.05, friction=torch.tensor([0.35, 0.35],
                                                        dtype=F64))
    sol = solve(model.init_z(q), model.theta_fn(q, q, torch.zeros(
        (1, 1), dtype=F64), aux))
    assert bool(sol.converged.all())


def _cone_template(spec):
    """(indices, values) of the cone variables after the stall restart:
    orthant 1, SOC (1, 0.1, ...)."""
    idx, tmpl = [], []
    for i in list(spec.ort_prim) + list(spec.ort_dual):
        idx.append(i)
        tmpl.append(1.0)
    for grp in list(spec.soc_prim) + list(spec.soc_dual):
        idx += list(grp)
        tmpl += [1.0] + [0.1] * (len(grp) - 1)
    return idx, np.array(tmpl)


def restarted_at(solve_k, z0, theta, spec, k):
    """Whether the solver cut to ``k`` iterations (``solve_k(k)``) ends on
    the restart's cone variables, that is restarted in iteration k."""
    idx, tmpl = _cone_template(spec)
    return np.array_equal(np.asarray(solve_k(k)(z0, theta).z)[..., idx],
                          np.broadcast_to(tmpl, np.shape(z0)[:-1] + tmpl.shape))


def restart_iteration(solve_k, z0, theta, spec, max_iter):
    """The iteration in which the solver restarted after a stall, or
    None."""
    for k in range(1, max_iter + 1):
        if restarted_at(solve_k, z0, theta, spec, k):
            return k
    return None


# starts whose line search stalls at a wrong active set, from a seeded
# search among those whose counts the two packages share: after a stall
# the count can follow the start's last bit (see
# tests/test_torch_scalar_dynamics.py::test_step_carry_through_a_stall_restart)
NN_WEDGE = [-2.0, -0.25, 1e-9, 1.0, 1e-9, 0.5]
SOC_WEDGES = (([np.hypot(2.0, 0.6) * 1.001, -2.0, 0.6,
                np.hypot(0.4, 1.5) * 1.01, -0.4, -1.5], [-0.2, -0.8, -0.9]),)


@pytest.mark.parametrize("kappa_init_min", [0.0, 1e-2])
@pytest.mark.parametrize("kind", ["nn", "soc"])
def test_stall_restart_matches_jax_scalar_and_batched(kind, kappa_init_min):
    """Starts that wedge the line search: the one-shot restart fires in
    both packages at the same iteration, and ``make_solver`` (the batched
    solver on a batch of one) matches the reference's scalar solver and
    its batched one in iterations, flags and z. Those two floor the
    restart's kappa differently (``kappa_final``, ``max(kappa_final,
    kappa_init_min)``), but the reset cone variables' violation is at
    least 1, so with ``kappa_init_min`` 1e-2 (the implicit dynamics'
    setting) neither floor binds."""
    jres, tres, jspec, tspec, _, _ = _problem(kind)
    cases = (tuple((NN_WEDGE, t) for t in NN_TARGETS) if kind == "nn"
             else SOC_WEDGES)
    jo = jip.IPOptions(r_tol=1e-10, kappa_tol=1e-8,
                       kappa_init_min=kappa_init_min)
    to = convert.ip_options(jo)
    js = jax.jit(jip.make_solver(jres, jspec, jo))
    jb = jax.jit(jip.make_solver_batched(jres, jspec, jo))
    ts = tip.make_solver(tres, tspec, to, "cpu", F64)
    for z0, target in cases:
        z0t, tht = torch.tensor(z0, dtype=F64), torch.tensor(target,
                                                            dtype=F64)
        got = ts(z0t, tht)
        ref = js(jnp.asarray(z0), jnp.asarray(target))
        _same(got, ref, target)
        refb = jb(jnp.asarray([z0]), jnp.asarray([target]))
        _same(got, jip.IPSolution(*(a[0] for a in refb)), target)
        assert bool(got.converged), target
        k = restart_iteration(
            lambda m: tip.make_solver(
                tres, tspec, dataclasses.replace(to, max_iter=m), "cpu", F64),
            z0t, tht, tspec, int(got.iterations))
        assert k is not None, target
        def j_k(m):
            return jax.jit(jip.make_solver(
                jres, jspec, dataclasses.replace(jo, max_iter=m)))

        z0j, thj = jnp.asarray(z0), jnp.asarray(target)
        assert restarted_at(j_k, z0j, thj, jspec, k), target
        assert not restarted_at(j_k, z0j, thj, jspec, k - 1), target
