"""Port parity: the lane-batched implicit dynamics against the JAX package.

``step_batched``, ``step_batched_ws``, ``step_jac_batched`` and
``step_jac_batched_ws`` of the cartpole friction model at B=8 in float64.
Both packages solve to r_tol 1e-8 with the same schedule; the port's QR
and the reference's LU differ by round-off, so states, solver variables
and the IFT Jacobians agree to atol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_dynamics,
)
from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import cartpole as tcp
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

ATOL = 1e-9


def _states(B=8, seed=0):
    rng = np.random.default_rng(seed)
    q1 = 0.3 * rng.standard_normal((B, 2))
    q0 = q1 - 0.02 * rng.standard_normal((B, 2))
    us = 0.8 * rng.standard_normal((B, 1))
    return np.concatenate([q0, q1], axis=1), us


@pytest.mark.parametrize("with_functor", [False, True])
def test_batched_steps_match_jax(with_functor):
    """A model with a device functor solves through the fused kernel's
    wrapper (its plain version on CPU tensors), one without through
    ``make_solver_batched``: both routes must match the reference."""
    xs, us = _states()
    jaux = jcp.CartpoleAux(h=0.05, friction=jnp.asarray([0.35, 0.35]))
    jd = jax_dynamics(jcp.friction_model())
    model = tcp.friction_model()
    if not with_functor:
        model = model._replace(kernel=None)
    td = make_implicit_dynamics(model, "cpu", torch.float64)
    taux = convert.cartpole_aux(jaux, "cpu", torch.float64)
    xt, ut = torch.as_tensor(xs), torch.as_tensor(us)

    np.testing.assert_allclose(td.step_batched(xt, ut, taux).numpy(),
                               np.asarray(jd.step_batched(xs, us, jaux)),
                               atol=ATOL)

    ys_j, fx_j, fu_j = jd.step_jac_batched(xs, us, jaux)
    ys_t, fx_t, fu_t = td.step_jac_batched(xt, ut, taux)
    for got, ref in ((ys_t, ys_j), (fx_t, fx_j), (fu_t, fu_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    # warm starts: the eval solution of the same step seeds both sweeps
    z0_j = jax.vmap(jd.carry_init)(xs)
    np.testing.assert_array_equal(td.carry_init(xt).numpy(),
                                  np.asarray(z0_j))
    y_j, zw_j = jd.step_batched_ws(xs, us, jaux, z0_j)
    y_t, zw_t = td.step_batched_ws(xt, ut, taux, td.carry_init(xt))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(zw_t.numpy(), np.asarray(zw_j), atol=ATOL)
    out_j = jd.step_jac_batched_ws(xs, us, jaux, zw_j)
    out_t = td.step_jac_batched_ws(xt, ut, taux, zw_t)
    for got, ref in zip(out_t, out_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
