"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one. This file imports no JAX, so it also runs where JAX is not
installed (``--noconftest`` skips the JAX-on-CPU conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: in float64 the kernels and the plain versions run the same
steps and differ only in summation order (K1: z within 1e-10 where both
converge in the same iteration count; K2: relative difference 1e-10);
in float32, K1's configurations within 1e-4 (the reference's fused-kernel
tolerance) and K2's relative difference 1e-3.
"""

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.examples.cartpole import (
    DEPLOY_IP_ACCEL,
)
from optimization_dynamics_tpu_torch.models import cartpole
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
    batched_solve_plain,
)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    fused_ip,
    make_fused_ip_plain,
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions

pytestmark = pytest.mark.cuda

OPTS = IPOptions(**DEPLOY_IP_ACCEL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _envelope(B, seed, device, dtype):
    rng = np.random.default_rng(seed)
    q1 = np.stack([2.0 * rng.standard_normal(B),
                   np.pi * rng.standard_normal(B)], axis=1)
    q0 = q1 - 0.05 * rng.standard_normal((B, 2))
    u = 3.0 * rng.standard_normal((B, 1))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    model = cartpole.friction_model()
    aux = cartpole.CartpoleAux(h=0.05, friction=t([0.35, 0.35]))
    return model, model.init_z(t(q1)), model.theta_fn(t(q0), t(q1), t(u),
                                                      aux)


def _warm(solve, model, z0s, ths, seed):
    """z0s: the kernel's solutions one iterate earlier, the control moved
    by 0.05 N(0, 1), as the derivative sweep warm-starts."""
    rng = np.random.default_rng(seed)
    prev = ths.clone()
    prev[:, list(model.th_u)] += torch.as_tensor(
        0.05 * rng.standard_normal((ths.shape[0], 1)), dtype=ths.dtype,
        device=ths.device)
    return solve(z0s, prev).z


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_ip_kernel_matches_plain(card, dtype, start):
    model, z0s, ths = _envelope(1000, 0, card, dtype)
    kern = make_fused_ip_solver(model, OPTS, card, dtype)
    if start == "warm":
        z0s = _warm(kern, model, z0s, ths, 5)
    before = fused_ip.launches
    sk = kern(z0s, ths)
    assert fused_ip.launches == before + 1
    sp = make_fused_ip_plain(model, OPTS, card, dtype)(z0s, ths)
    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    assert both.sum() > 0.9 * len(ck)
    if dtype == torch.float64:
        assert (ck == cp).mean() >= 0.995
        same = both & (sk.iterations == sp.iterations).cpu().numpy()
        assert same.mean() >= 0.99 * both.mean()
        dz = (sk.z - sp.z).abs().cpu().numpy()[same]
        assert dz.max() <= 1e-10
    else:
        assert abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck)
        dq = (sk.z - sp.z)[:, :2].abs().cpu().numpy()[both]
        assert dq.max() <= 1e-4


def test_fused_ip_kernel_ragged_batch(card):
    """Batches that are not a multiple of the block: every lane solved."""
    for B in (1, 5, 129):
        model, z0s, ths = _envelope(B, 1, card, torch.float64)
        sk = make_fused_ip_solver(model, OPTS, card, torch.float64)(z0s,
                                                                   ths)
        sp = make_fused_ip_plain(model, OPTS, card, torch.float64)(z0s,
                                                                  ths)
        assert tuple(sk.z.shape) == (B, 10)
        np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                      sp.converged.cpu().numpy())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("k", [1, 8])
def test_batched_solve_kernel_matches_plain(card, dtype, tol, k):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((1000, 10, 10)) + 10.0 * np.eye(10)
    b = rng.standard_normal((1000, 10, k))
    At = torch.as_tensor(A, dtype=dtype, device=card)
    bt = torch.as_tensor(b, dtype=dtype, device=card)
    before = batched_solve.launches
    x = batched_solve(At, bt)
    assert batched_solve.launches == before + 1
    xp = batched_solve_plain(At, bt)
    rel = float((x - xp).abs().amax() / xp.abs().amax())
    assert rel <= tol


def test_kernel_wrappers_raise_on_unsupported_input(card):
    A = torch.zeros((4, 9, 9), device=card)
    with pytest.raises(ValueError):
        batched_solve(A, torch.zeros((4, 9, 1), device=card))
    with pytest.raises(TypeError):
        batched_solve(A[:, :, :].half(), torch.zeros((4, 9, 1),
                                                     device=card).half())
