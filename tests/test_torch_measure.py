"""The shared measurement inputs and timers of ``utils/measure.py``, on
the CPU: the kernel inputs are the same for the same seed, and the
relative residual reads an exact solve as exact."""

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.utils.measure import (
    envelope_batch,
    push_batch,
    rel_residual,
    warm_batch,
)

CPU = torch.device("cpu")


@pytest.mark.parametrize("make, nz, nth", [(envelope_batch, 10, 8),
                                           (push_batch, 35, 13)])
def test_batches_follow_their_seed(make, nz, nth):
    _, z0, th = make(5, 0, CPU, torch.float64)
    _, z0b, thb = make(5, 0, CPU, torch.float64)
    _, _, thc = make(5, 1, CPU, torch.float64)
    assert z0.shape == (5, nz) and th.shape == (5, nth)
    assert torch.equal(z0, z0b) and torch.equal(th, thb)
    assert not torch.equal(th, thc)
    assert torch.isfinite(z0).all() and torch.isfinite(th).all()


def test_warm_batch_starts_from_the_earlier_solution():
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        make_fused_ip_solver)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    model, z0s, ths = envelope_batch(4, 2, CPU, torch.float64)
    kern = make_fused_ip_solver(model, IPOptions(**DEPLOY_IP_ACCEL), CPU,
                                torch.float64)
    zw, thw = warm_batch(kern, model, z0s, ths, 3)
    assert thw is ths and zw.shape == z0s.shape
    cold, warm = kern(z0s, ths), kern(zw, ths)
    assert bool(cold.converged.all()) and bool(warm.converged.all())
    assert int(warm.iterations.sum()) < int(cold.iterations.sum())


def test_rel_residual_of_exact_and_perturbed_solves():
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((3, 6, 6)) + 6 * np.eye(6))
    b = torch.as_tensor(rng.standard_normal((3, 6, 2)))
    x = torch.linalg.solve(A, b)
    assert rel_residual(A, x, b) < 1e-14
    x[1, 2, 0] += 1e-3
    assert rel_residual(A, x, b) > 1e-5
