"""The shared measurement inputs and timers of ``utils/measure.py``, on
the CPU: the kernel inputs are the same for the same seed, the relative
residual reads an exact solve as exact, and ``kernel_route`` and
``routed`` set and restore the wrappers' width cuts."""

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    FUSED_IP_TILE_MAX_B,
)
from optimization_dynamics_tpu_torch.utils.measure import (
    envelope_batch,
    kernel_route,
    push_batch,
    rel_residual,
    rollout_batch,
    routed,
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


def test_rollout_batch_follows_its_seed():
    """K4's inputs at the deploy's shapes (T=51, nx=4, nu=1)."""
    x0s, uss, Kss, kss, alphas = rollout_batch(9, 0, CPU, torch.float64)
    again = rollout_batch(9, 0, CPU, torch.float64)
    other = rollout_batch(9, 1, CPU, torch.float64)
    assert [tuple(a.shape) for a in (x0s, uss, Kss, kss, alphas)] == [
        (9, 4), (9, 50, 1), (9, 50, 1, 4), (9, 50, 1), (9,)]
    assert all(torch.equal(a, b) for a, b in zip(again, (x0s, uss, Kss, kss,
                                                         alphas)))
    assert not torch.equal(other[2], Kss)
    assert alphas.tolist() == [0.5 ** (i % 8) for i in range(9)]


@pytest.mark.parametrize("tile", [True, False])
def test_kernel_route_sets_and_restores_the_cuts(tile):
    """Every entry of the functor (K1's and K4's) is set for the block and
    restored after it, also when the block raises; other functors'
    entries stay."""
    before = dict(FUSED_IP_TILE_MAX_B)
    with pytest.raises(RuntimeError):
        with kernel_route("cartpole_friction", tile):
            for (wrapper, functor), cut in FUSED_IP_TILE_MAX_B.items():
                if functor == "cartpole_friction":
                    assert cut == (2 ** 31 if tile else 0)
                else:
                    assert cut == before[wrapper, functor]
            raise RuntimeError
    assert FUSED_IP_TILE_MAX_B == before
    seen = routed("acrobot_impact", tile,
                  lambda key: FUSED_IP_TILE_MAX_B[key])(
        ("fused_ip", "acrobot_impact"))
    assert seen == (2 ** 31 if tile else 0)
    assert FUSED_IP_TILE_MAX_B == before
