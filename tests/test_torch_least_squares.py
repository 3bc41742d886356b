"""Port parity: the Gauss-Newton least-squares fitter.

The reference's three fits of ``tests/test_least_squares.py`` (recover
the linear system ``[A B]`` from +/- eps single-coordinate samples; fit
``y = a exp(b t)`` with a little damping; the gradient bundle's linear
model ``dF ~ M eta`` on single-coordinate samples of size 1e-4, without
damping) through ``solver/least_squares.fit`` of both packages on the
same numpy-seeded samples in float64: theta within 1e-10, the same
iteration count and flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.solver import least_squares as jls
from optimization_dynamics_tpu_torch.solver import least_squares as tls

torch.set_num_threads(1)


def _linear_system():
    # the reference's system: A = [1 1; 0 1], B = [0; 1]
    AB = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]])
    eps = 0.1
    etas = np.concatenate([eps * np.eye(3), -eps * np.eye(3)])
    z0 = np.random.default_rng(3).uniform(size=3)
    dF = (z0 + etas) @ AB.T - z0 @ AB.T

    def resid(xp):
        return lambda theta, s: s[1] - theta.reshape(2, 3) @ s[0]

    return resid, np.zeros(6), (etas, dF), 0.0


def _exponential():
    ts = np.linspace(0.0, 1.0, 20)
    ys = 2.0 * np.exp(-1.3 * ts)

    def resid(xp):
        return lambda theta, s: xp.stack(
            [s[1] - theta[0] * xp.exp(theta[1] * s[0])])

    return resid, np.array([1.0, 0.0]), (ts, ys), 1e-10


def _bundle_fit():
    # the gradient bundle's model: 50 single-coordinate samples of size
    # 1e-4 N(0, 1) over 5 inputs, dF = M eta + noise, 2 outputs
    rng = np.random.default_rng(7)
    n, n_in, nq = 50, 5, 2
    etas = np.zeros((n, n_in))
    etas[np.arange(n), rng.integers(0, n_in, n)] = (
        1e-4 * rng.standard_normal(n))
    M = rng.standard_normal((nq, n_in))
    dF = etas @ M.T + 1e-9 * rng.standard_normal((n, nq))

    def resid(xp):
        return lambda theta, s: s[1] - theta.reshape(nq, n_in) @ s[0]

    return resid, np.zeros(nq * n_in), (etas, dF), 0.0


@pytest.mark.parametrize("problem", [_linear_system, _exponential,
                                     _bundle_fit])
def test_fit_matches_jax(problem):
    resid, theta0, samples, damping = problem()
    ref = jls.fit(resid(jnp), jnp.asarray(theta0),
                  tuple(jnp.asarray(s) for s in samples), damping=damping)
    got = tls.fit(resid(torch), torch.tensor(theta0),
                  tuple(torch.tensor(s) for s in samples), damping=damping)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=0, atol=1e-10)
    assert float(got.grad_norm) <= 1e-8


def test_fit_stops_at_max_iter():
    """A budget of one Newton step on the nonlinear fit: one iteration,
    not converged, as the reference."""
    resid, theta0, samples, damping = _exponential()
    ref = jls.fit(resid(jnp), jnp.asarray(theta0),
                  tuple(jnp.asarray(s) for s in samples), max_iter=1,
                  damping=damping)
    got = tls.fit(resid(torch), torch.tensor(theta0),
                  tuple(torch.tensor(s) for s in samples), max_iter=1,
                  damping=damping)
    assert got.iterations == int(ref.iterations) == 1
    assert not got.converged and not bool(ref.converged)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=0, atol=1e-10)
