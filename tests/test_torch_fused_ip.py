"""Port parity: K1's plain version (the port of ``make_solver_batched``,
geometric schedule, Newton solve through the plain QR) against the JAX
package.

* float64 against JAX ``make_solver_batched``: identical converged flags;
  iteration counts identical on all lanes but at most one, because the
  port factors the Newton system by QR where JAX uses LU, and a rounding
  difference can move one line-search tie; z within 1e-10 where the
  iteration counts agree.
* float32 against the JAX Pallas kernel in interpret mode, at the
  tolerances of tests/test_fused_ip.py: converged count within one,
  configurations within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu.ops.pallas.fused_ip import (
    make_fused_ip_solver as jax_fused_solver,
)
from optimization_dynamics_tpu.solver.interior_point import (
    IPOptions as JaxIPOptions,
    make_solver_batched as jax_solver_batched,
)
from optimization_dynamics_tpu_torch.models import cartpole as tcp
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    fused_ip,
    make_fused_ip_plain,
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver.interior_point import (
    make_solver_batched,
)
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

# the deploy eval options of tests/test_fused_ip.py
JOPTS = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40, max_ls=8,
                     kappa_init_min=1e-2)
ENVELOPE_OPTS = JaxIPOptions(r_tol=3.0e-5, kappa_tol=1.0e-3, max_iter=40,
                             max_ls=8)
FRICTION = (0.35, 0.35)


def _near_rest_batch(B, seed):
    """The distribution of tests/test_fused_ip.py::_batch."""
    rng = np.random.default_rng(seed)
    q0 = 0.2 * rng.standard_normal((B, 2))
    q1 = q0 + 0.02 * rng.standard_normal((B, 2))
    u = 0.5 * rng.standard_normal((B, 1))
    return q0, q1, u


def _envelope_batch(B, seed):
    """The swing-up envelope of tests/test_fused_ip.py:151-193."""
    rng = np.random.default_rng(seed)
    q1 = np.stack([2.0 * rng.standard_normal(B),
                   np.pi * rng.standard_normal(B)], axis=1)
    q0 = q1 - 0.05 * rng.standard_normal((B, 2))
    u = 3.0 * rng.standard_normal((B, 1))
    return q0, q1, u


def _inputs(q0, q1, u, np_dtype):
    """(jax z0s, jax thetas, torch z0s, torch thetas) from the same
    numpy draws, through each package's own packing."""
    jm = jcp.friction_model()
    jaux = jcp.CartpoleAux(h=0.05, friction=jnp.asarray(FRICTION, np_dtype))
    th_j = jax.vmap(lambda a, b, c: jm.theta_fn(a, b, c, jaux))(
        *(jnp.asarray(v, np_dtype) for v in (q0, q1, u)))
    z_j = jax.vmap(jm.init_z)(jnp.asarray(q1, np_dtype))
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    tm = tcp.friction_model()
    taux = convert.cartpole_aux(jaux, "cpu", tdt)
    t = lambda a: torch.as_tensor(np.asarray(a, np_dtype))
    th_t = tm.theta_fn(t(q0), t(q1), t(u), taux)
    z_t = tm.init_z(t(q1))
    return z_j, th_j, z_t, th_t


@pytest.mark.parametrize("batch,opts", [("near_rest", JOPTS),
                                        ("envelope", ENVELOPE_OPTS)])
def test_plain_matches_jax_batched_f64(batch, opts):
    draws = (_near_rest_batch(16, 0) if batch == "near_rest"
             else _envelope_batch(32, 0))
    z_j, th_j, z_t, th_t = _inputs(*draws, np.float64)
    ref = jax.jit(jax_solver_batched(jcp.friction_model().residual,
                                     jcp.cone_spec_friction(), opts))(
        z_j, th_j)
    model = tcp.friction_model()
    sol = make_fused_ip_plain(model, convert.ip_options(opts), "cpu",
                              torch.float64)(z_t, th_t)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    same_it = sol.iterations.numpy() == np.asarray(ref.iterations)
    assert (~same_it).sum() <= 1, (sol.iterations, ref.iterations)
    np.testing.assert_allclose(sol.z.numpy()[same_it],
                               np.asarray(ref.z)[same_it], atol=1e-10)
    np.testing.assert_allclose(sol.r_vio.numpy()[same_it],
                               np.asarray(ref.r_vio)[same_it], atol=1e-10)


def test_plain_matches_pallas_interpret_f32():
    q0, q1, u = _envelope_batch(32, 1)
    z_j, th_j, z_t, th_t = _inputs(q0, q1, u, np.float32)
    ref = jax_fused_solver(jcp.friction_model().residual,
                           jcp.cone_spec_friction(), ENVELOPE_OPTS,
                           interpret=True)(z_j, th_j)
    sol = make_fused_ip_solver(tcp.friction_model(),
                               convert.ip_options(ENVELOPE_OPTS), "cpu",
                               torch.float32)(z_t, th_t)
    cr, cs = np.asarray(ref.converged), sol.converged.numpy()
    assert abs(int(cr.sum()) - int(cs.sum())) <= 1
    both = cr & cs
    assert both.sum() >= len(cr) // 2
    np.testing.assert_allclose(sol.z.numpy()[both][:, :2],
                               np.asarray(ref.z)[both][:, :2], atol=1e-4)


def test_ragged_batch():
    """B=5: no padding is involved, every lane converges, and the result
    matches the JAX batched solver."""
    q0, q1, u = _near_rest_batch(5, 2)
    z_j, th_j, z_t, th_t = _inputs(q0, q1, u, np.float64)
    sol = make_fused_ip_solver(tcp.friction_model(),
                               convert.ip_options(JOPTS), "cpu",
                               torch.float64)(z_t, th_t)
    assert tuple(sol.z.shape) == (5, 10)
    assert bool(sol.converged.all())
    ref = jax_solver_batched(jcp.friction_model().residual,
                             jcp.cone_spec_friction(), JOPTS)(z_j, th_j)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(ref.z), atol=1e-10)


def test_wrapper_refuses_non_cpu_tensors_and_mehrotra():
    """The CPU path is the plain version and launches nothing; any other
    device goes to the kernel or raises; the kernel implements the
    geometric schedule only, so the predictor-corrector raises in K1,
    while ``make_solver_batched`` runs it as the reference's batched
    solver does."""
    q0, q1, u = _near_rest_batch(4, 3)
    _, _, z_t, th_t = _inputs(q0, q1, u, np.float64)
    opts = convert.ip_options(JOPTS)
    solve = make_fused_ip_solver(tcp.friction_model(), opts, "cpu",
                                 torch.float64)
    before = fused_ip.launches
    a = solve(z_t, th_t)
    b = make_solver_batched(tcp.friction_model().residual,
                            tcp.cone_spec_friction(), opts, "cpu",
                            torch.float64)(z_t, th_t)
    assert fused_ip.launches == before
    np.testing.assert_array_equal(a.z.numpy(), b.z.numpy())
    with pytest.raises(ValueError):
        solve(z_t.to("meta"), th_t.to("meta"))
    import dataclasses
    meh = dataclasses.replace(opts, mehrotra=True)
    with pytest.raises(NotImplementedError):
        make_fused_ip_solver(tcp.friction_model(), meh, "cpu", torch.float64)
    got = make_solver_batched(tcp.friction_model().residual,
                              tcp.cone_spec_friction(), meh, "cpu",
                              torch.float64)(z_t, th_t)
    ref = jax.jit(jax_solver_batched(
        jcp.friction_model().residual, jcp.cone_spec_friction(),
        dataclasses.replace(JOPTS, mehrotra=True)))(
            z_t.numpy(), th_t.numpy())
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), atol=1e-10,
                               rtol=0)
