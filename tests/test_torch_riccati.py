"""Port parity: K3, the Riccati backward pass, against the JAX package.

The port's wrapper on CPU tensors runs its plain version
(``riccati_backward_plain``). It is held to the reference's Pallas kernel
in interpret mode in float32 (rtol/atol 2e-5, the tolerance of the
reference's own kernel-against-XLA test) and to the reference's XLA
backward pass in float64 (rtol 1e-10: the same recursion in another
summation order). Random LQR data from numpy seeds, as the reference's
``_rand_lqr`` draws it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optimization_dynamics_tpu.ops.pallas.riccati import (
    make_riccati_backward as jax_make_riccati_backward,
)
from optimization_dynamics_tpu.solver.ilqr import ILQROptions as JOptions
from optimization_dynamics_tpu.solver.ilqr import ILQRProblem as JProblem
from optimization_dynamics_tpu.solver.ilqr_batched import (
    make_phases as jax_make_phases,
)
from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
    make_riccati_backward,
    riccati_backward,
)

torch.set_num_threads(1)

NAMES = ["Ks", "ks", "dV1", "dV2", "qu_inf", "ok"]


def _rand_lqr(seed, B, T, nx, nu):
    """fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs (numpy)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)

    def spd(n_):
        A = n(B, T - 1, n_, n_)
        return np.einsum("btij,btkj->btik", A, A) + 0.5 * np.eye(n_)

    fxs = 0.5 * n(B, T - 1, nx, nx)
    fus = 0.5 * n(B, T - 1, nx, nu)
    lxs, lus = n(B, T - 1, nx), n(B, T - 1, nu)
    lxxs, luus = spd(nx), spd(nu)
    luxs = 0.3 * n(B, T - 1, nu, nx)
    gTs = n(B, nx)
    A = n(B, nx, nx)
    HTs = np.einsum("bij,bkj->bik", A, A) + np.eye(nx)
    regs = np.full(B, 1.0e-6)
    return [fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs]


def _port(data, T, nx, nu, u_mask, dtype):
    bwd = make_riccati_backward(T, nx, nu, u_mask, "cpu", dtype)
    return bwd(*(torch.as_tensor(a, dtype=dtype) for a in data))


def _jax_kernel(data, T, nx, nu, u_mask):
    bwd = jax_make_riccati_backward(T, nx, nu, u_mask, interpret=True)
    return bwd(*(jnp.asarray(a, jnp.float32) for a in data))


def _jax_xla(data, T, nx, nu, u_mask):
    """The reference's XLA backward pass in float64, from make_phases on
    a dummy problem with the given u_mask."""
    prob = JProblem(
        T=T, nx=nx, nu=nu, ncon=0, nconT=0,
        dynamics=lambda t, x, u: x,
        dynamics_jac=lambda t, x, u: (x, jnp.eye(nx), jnp.zeros((nx, nu))),
        dynamics_batched=lambda t, xs, us: xs,
        stage_cost=lambda t, x, u: jnp.sum(u * u),
        terminal_cost=lambda x: jnp.sum(x * x),
        u_mask=jnp.asarray(u_mask))
    ph = jax_make_phases(prob, JOptions(), B=4, dtype=jnp.float64)
    return ph.backward_xla(*(jnp.asarray(a, jnp.float64) for a in data))


def _assert_close(got, ref, rtol, atol, what):
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(
            g.numpy().astype(np.float64), np.asarray(r, np.float64),
            rtol=rtol, atol=atol, err_msg="%s %s" % (what, name))


@pytest.mark.parametrize("nx,nu,T", [(4, 1, 8), (6, 3, 6), (10, 4, 5)])
def test_plain_matches_jax_kernel_f32(nx, nu, T):
    data = _rand_lqr(0, 4, T, nx, nu)
    mask = np.ones((T - 1, nu), bool)
    _assert_close(_port(data, T, nx, nu, mask, torch.float32),
                  _jax_kernel(data, T, nx, nu, mask), 2e-5, 2e-5,
                  "nx=%d nu=%d T=%d" % (nx, nu, T))


@pytest.mark.parametrize("nx,nu,T", [(4, 1, 8), (10, 4, 5)])
def test_plain_matches_jax_xla_f64(nx, nu, T):
    data = _rand_lqr(1, 4, T, nx, nu)
    mask = np.ones((T - 1, nu), bool)
    got = _port(data, T, nx, nu, mask, torch.float64)
    ref = _jax_xla(data, T, nx, nu, mask)
    _assert_close(got, ref, 1e-10, 1e-13, "f64 nx=%d nu=%d" % (nx, nu))
    assert bool(got[5].all())


def test_ragged_u_mask():
    """Masked control dims get gains of exactly 0 (the hopper's ragged
    stages), against both references."""
    nx, nu, T, B = 4, 3, 6, 4
    mask = np.ones((T - 1, nu), bool)
    mask[:, 2] = False            # third control inactive everywhere
    mask[0, 1] = False            # second inactive at t=0
    data = _rand_lqr(2, B, T, nx, nu)
    got32 = _port(data, T, nx, nu, mask, torch.float32)
    _assert_close(got32, _jax_kernel(data, T, nx, nu, mask), 2e-5, 2e-5,
                  "ragged f32")
    got64 = _port(data, T, nx, nu, mask, torch.float64)
    _assert_close(got64, _jax_xla(data, T, nx, nu, mask), 1e-10, 1e-13,
                  "ragged f64")
    for Ks, ks in ((got32[0], got32[1]), (got64[0], got64[1])):
        assert (Ks[:, :, 2] == 0).all() and (ks[:, :, 2] == 0).all()
        assert (Ks[:, 0, 1] == 0).all() and (ks[:, 0, 1] == 0).all()


def test_indefinite_quu_flags_with_finite_gains():
    """A Quu that is not positive definite clears ``ok`` for its lane
    only; as in the reference's kernel (and unlike its XLA pass), the
    gains stay finite (about 1e30 here: pivots floored at 1e-15) and
    equal the kernel's. That lane's dV2 overflows float32 in both, to
    inf or NaN by the order of the sum, so only its gains and flag are
    compared; the other lanes are compared whole."""
    nx, nu, T, B = 4, 2, 4, 4
    data = _rand_lqr(3, B, T, nx, nu)
    data[5][1, 0] = -5.0 * np.eye(nu)
    mask = np.ones((T - 1, nu), bool)
    got = _port(data, T, nx, nu, mask, torch.float32)
    ref = _jax_kernel(data, T, nx, nu, mask)
    assert got[5].tolist() == [True, False, True, True]
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
    assert bool(torch.isfinite(got[0]).all() & torch.isfinite(got[1]).all())
    _assert_close(got[:2], ref[:2], 2e-5, 2e-5, "indefinite gains")
    keep = [0, 2, 3]
    _assert_close([a[keep] for a in got], [np.asarray(a)[keep] for a in ref],
                  2e-5, 2e-5, "indefinite, other lanes")


def test_batch_of_three():
    """B=3: the reference pads to its 128-lane block; the port's lanes
    are independent of the batch size."""
    nx, nu, T = 4, 1, 5
    data = _rand_lqr(4, 3, T, nx, nu)
    mask = np.ones((T - 1, nu), bool)
    got = _port(data, T, nx, nu, mask, torch.float32)
    assert tuple(got[0].shape) == (3, T - 1, nu, nx)
    _assert_close(got, _jax_kernel(data, T, nx, nu, mask), 2e-5, 2e-5,
                  "B=3")


def test_wrapper_rejects_mixed_devices_and_counts_no_cpu_launch():
    """The wrapper's plain path is for CPU tensors only; it launches
    nothing there."""
    nx, nu, T = 4, 1, 4
    data = [torch.as_tensor(a) for a in _rand_lqr(5, 2, T, nx, nu)]
    mask = torch.ones((T - 1, nu))
    before = riccati_backward.launches
    riccati_backward(*data, mask)
    assert riccati_backward.launches == before
    with pytest.raises(ValueError):
        riccati_backward(*data, mask.to("meta"))
