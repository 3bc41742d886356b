"""Port parity: K3 at (2, 1) and (4, 2), the shapes the reference's
kernel tests run beyond the deploys', and ``solve_batched`` with K3.

* K3's plain version (what its wrapper runs on CPU tensors) against the
  reference's Pallas kernel in interpret mode, float32, rtol/atol 2e-5,
  at the reference's test sizes: (4, 2) at T=4 on four lanes and (2, 1)
  at the double integrator's T=11 on three, lane 1 with an indefinite
  Quu at t=0, whose ``ok`` must be False while the other lanes' are
  True; in float64 against the reference's XLA backward pass, rtol
  1e-10 on the positive definite lanes and the same ``ok`` flags.
* ``solve_batched`` on the reference's double integrator (T=11, B=3,
  ``max_iter=30``, float32) with ``riccati_kernel=True`` against the
  reference's ``solve_batched`` with ``pallas_riccati=True``: xs within
  rtol 1e-4 / atol 1e-5, the reference test's bounds; and in float64
  the port's K3 path against its eager backward pass, xs within 1e-10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.solver.ilqr import (
    ILQROptions as JaxILQROptions,
    ILQRProblem as JaxILQRProblem,
)
from optimization_dynamics_tpu.solver.ilqr_batched import (
    solve_batched as jax_solve_batched,
)
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
)
from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
    solve_batched,
)

from tests.test_torch_riccati import (
    _assert_close, _jax_kernel, _jax_xla, _port, _rand_lqr)

torch.set_num_threads(1)

CASES = {(4, 2): (4, 4), (2, 1): (11, 3)}       # (nx, nu) -> (T, B)


def _indefinite_data(nx, nu, seed):
    T, B = CASES[nx, nu]
    data = _rand_lqr(seed, B, T, nx, nu)
    data[5][1, 0] = -5.0 * np.eye(nu)
    return data, T, np.ones((T - 1, nu), bool)


@pytest.mark.parametrize("nx,nu", sorted(CASES))
def test_plain_matches_jax_kernel_f32(nx, nu):
    data, T, mask = _indefinite_data(nx, nu, seed=20 + nx)
    got = _port(data, T, nx, nu, mask, torch.float32)
    ref = _jax_kernel(data, T, nx, nu, mask)
    assert got[5].tolist() == [i != 1 for i in range(len(got[5]))]
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
    # the indefinite lane's gains are about 1e30 (pivots floored at
    # 1e-15) and may overflow float32, as the reference's do, and its dV2
    # overflows in both, so its gains and flag are compared; the other
    # lanes whole
    _assert_close(got[:2], ref[:2], 2e-5, 2e-5, "gains")
    keep = [i for i in range(len(got[5])) if i != 1]
    _assert_close([a[keep] for a in got],
                  [np.asarray(a)[keep] for a in ref], 2e-5, 2e-5,
                  "nx=%d nu=%d" % (nx, nu))


@pytest.mark.parametrize("nx,nu", sorted(CASES))
def test_plain_matches_jax_xla_f64(nx, nu):
    data, T, mask = _indefinite_data(nx, nu, seed=30 + nx)
    got = _port(data, T, nx, nu, mask, torch.float64)
    ref = _jax_xla(data, T, nx, nu, mask)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
    assert not bool(got[5][1]) and int(got[5].sum()) == len(got[5]) - 1
    keep = [i for i in range(len(got[5])) if i != 1]
    _assert_close([a[keep] for a in got],
                  [np.asarray(a)[keep] for a in ref], 1e-10, 1e-13,
                  "f64 nx=%d nu=%d" % (nx, nu))


T_DI, B_DI, H_DI = 11, 3, 0.1


def _jax_double_integrator():
    A = jnp.array([[1.0, H_DI], [0.0, 1.0]], jnp.float32)
    Bm = jnp.array([[0.0], [H_DI]], jnp.float32)
    xT = jnp.array([1.0, 0.0], jnp.float32)
    return JaxILQRProblem(
        T=T_DI, nx=2, nu=1, ncon=0, nconT=0,
        dynamics=lambda t, x, u: A @ x + Bm @ u,
        dynamics_jac=lambda t, x, u: (A @ x + Bm @ u, A, Bm),
        dynamics_batched=lambda t, xs, us: xs @ A.T + us @ Bm.T,
        dynamics_jac_batched=lambda ts, xs, us: (
            xs @ A.T + us @ Bm.T,
            jnp.broadcast_to(A, (xs.shape[0], 2, 2)),
            jnp.broadcast_to(Bm, (xs.shape[0], 2, 1))),
        stage_cost=lambda t, x, u: 0.1 * jnp.sum(u * u),
        terminal_cost=lambda x: 100.0 * jnp.sum((x - xT) ** 2))


def double_integrator(dtype, device="cpu"):
    """The reference test's double integrator (T=11, nx=2, nu=1, no
    constraints) as a port problem."""
    A = torch.tensor([[1.0, H_DI], [0.0, 1.0]], dtype=dtype, device=device)
    Bm = torch.tensor([[0.0], [H_DI]], dtype=dtype, device=device)
    xT = torch.tensor([1.0, 0.0], dtype=dtype, device=device)
    return ILQRProblem(
        T=T_DI, nx=2, nu=1, ncon=0, nconT=0,
        dynamics_batched=lambda t, xs, us: xs @ A.T + us @ Bm.T,
        dynamics_jac_batched=lambda ts, xs, us: (
            xs @ A.T + us @ Bm.T, A.expand(xs.shape[0], 2, 2),
            Bm.expand(xs.shape[0], 2, 1)),
        stage_cost=lambda t, x, u: 0.1 * torch.sum(u * u),
        terminal_cost=lambda x: 100.0 * torch.sum((x - xT) ** 2))


def double_integrator_x0s(seed=4):
    return 0.1 * np.random.default_rng(seed).standard_normal((B_DI, 2))


def test_solve_batched_with_k3_matches_jax_pallas_riccati():
    x0s = double_integrator_x0s().astype(np.float32)
    rj = jax_solve_batched(
        _jax_double_integrator(), jnp.asarray(x0s),
        jnp.zeros((T_DI - 1, 1), jnp.float32),
        JaxILQROptions(max_iter=30, pallas_riccati=True))
    rt = solve_batched(double_integrator(torch.float32),
                       torch.as_tensor(x0s),
                       torch.zeros((T_DI - 1, 1), dtype=torch.float32),
                       ILQROptions(max_iter=30, riccati_kernel=True))
    assert rt.xs.dtype == torch.float32
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))


def test_solve_batched_k3_against_eager_f64():
    x0s = torch.as_tensor(double_integrator_x0s())
    us0 = torch.zeros((T_DI - 1, 1), dtype=torch.float64)
    prob = double_integrator(torch.float64)
    opts = ILQROptions(max_iter=30)
    r0 = solve_batched(prob, x0s, us0, opts)
    r1 = solve_batched(prob, x0s, us0,
                       dataclasses.replace(opts, riccati_kernel=True))
    np.testing.assert_allclose(r1.xs.numpy(), r0.xs.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(r1.iterations.numpy(),
                                  r0.iterations.numpy())
    # the terminal cost pulls every lane from about 1 to near the goal
    assert float((r1.xs[:, -1] - torch.tensor([1.0, 0.0],
                                              dtype=torch.float64))
                 .abs().max()) < 0.2
