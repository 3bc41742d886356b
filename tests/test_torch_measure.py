"""The shared measurement inputs and timers of ``utils/measure.py``, on
the CPU: the kernel inputs are the same for the same seed, the relative
residual reads an exact solve as exact, and ``kernel_route`` and
``routed`` set and restore the wrappers' width cuts; the measuring tools
take the rocket and the hopper model."""

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    FUSED_IP_TILE_MAX_B,
)
from optimization_dynamics_tpu_torch.utils.measure import (
    envelope_batch,
    hopper_batch,
    hopper_deploy_batch,
    hopper_systems,
    rocket_projection_batch,
    rocket_systems,
    kernel_route,
    push_batch,
    rel_residual,
    rollout_batch,
    routed,
    warm_batch,
)

CPU = torch.device("cpu")


@pytest.mark.parametrize("make, nz, nth", [(envelope_batch, 10, 8),
                                           (push_batch, 35, 13),
                                           (rocket_projection_batch, 10, 4),
                                           (hopper_batch, 20, 13),
                                           (hopper_deploy_batch, 20, 13)])
def test_batches_follow_their_seed(make, nz, nth):
    _, z0, th = make(5, 0, CPU, torch.float64)
    _, z0b, thb = make(5, 0, CPU, torch.float64)
    _, _, thc = make(5, 1, CPU, torch.float64)
    assert z0.shape == (5, nz) and th.shape == (5, nth)
    assert torch.equal(z0, z0b) and torch.equal(th, thb)
    assert not torch.equal(th, thc)
    assert torch.isfinite(z0).all() and torch.isfinite(th).all()


def test_hopper_systems_follow_their_seed_and_layout():
    """The hopper's Newton (20, 1) and IFT (20, 13) systems: the same for
    the same seed, row-interleaved as ``batched_jacobian`` gives them,
    finite and solvable."""
    (An, bn), (Ai, bi) = hopper_systems(6, 0, CPU, torch.float64)
    (An2, bn2), (Ai2, bi2) = hopper_systems(6, 0, CPU, torch.float64)
    _, (Ai3, _) = hopper_systems(6, 1, CPU, torch.float64)
    assert (tuple(An.shape), tuple(bn.shape)) == ((6, 20, 20), (6, 20, 1))
    assert (tuple(Ai.shape), tuple(bi.shape)) == ((6, 20, 20), (6, 20, 13))
    assert An.stride() == Ai.stride() == (20, 120, 1)
    assert bi.stride() == (13, 78, 1)
    for a, b in ((An, An2), (bn, bn2), (Ai, Ai2), (bi, bi2)):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert not torch.equal(Ai, Ai3)
    for A, b in ((An, bn), (Ai, bi)):
        assert rel_residual(A, torch.linalg.solve(A, b), b) <= 1e-13


def test_rocket_systems_follow_their_seed_and_layout():
    """The rocket's projection (10, 1), (10, 4) and midpoint (12, 1), (12,
    16) systems: the same for the same seed, the Jacobians
    row-interleaved and the Newton right-hand sides contiguous, as the
    solver and the sweep pass them, finite and solvable."""
    sys_a = rocket_systems(6, 0, CPU, torch.float64)
    sys_b = rocket_systems(6, 0, CPU, torch.float64)
    sys_c = rocket_systems(6, 1, CPU, torch.float64)
    assert sorted(sys_a) == [(10, 1), (10, 4), (12, 1), (12, 16)]
    for (n, k), (A, b) in sys_a.items():
        assert tuple(A.shape) == (6, n, n) and tuple(b.shape) == (6, n, k)
        assert A.stride() == (n, 6 * n, 1)
        assert b.stride() == ((n, 1, 1) if k == 1 else (k, 6 * k, 1))
        assert torch.equal(A, sys_b[n, k][0]) and torch.equal(b,
                                                              sys_b[n, k][1])
        assert bool(torch.isfinite(A).all() & torch.isfinite(b).all())
        assert rel_residual(A, torch.linalg.solve(A, b), b) <= 1e-13
    assert not torch.equal(sys_a[12, 16][0], sys_c[12, 16][0])


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / "tools" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [["deploy", "--model", "rocket"],
                                  ["profile", "--model", "rocket"]])
def test_torch_measure_takes_the_rocket(argv, monkeypatch):
    """``--model rocket`` parses for ``deploy`` and ``profile`` (then the
    tool stops for want of a card); the rocket has no K3 cell."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = _tool("torch_measure")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        tm.main(argv)
    with pytest.raises(SystemExit) as err:
        tm.main(argv + ["--riccati-kernel"])
    assert err.value.code == 2
    assert tm._example(argparse.Namespace(model="rocket", batch=None))[1] \
        == 256


def test_kernel_times_takes_the_rocket(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        _tool("kernel_times").main(["--model", "rocket",
                                    "--linalg-widths", "512,15360"])


def test_kernel_times_takes_the_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        _tool("kernel_times").main(["--model", "hopper",
                                    "--widths", "512,5120"])


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
