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
tolerance) and K2's relative difference 1e-3. K3 (Riccati backward pass)
within 1e-10 relative in float64 and 1e-4 in float32, ``ok`` identical;
K4 (fused rollout) in float64 with identical per-step converged flags on
>= 99.5% of lane-steps and states within 1e-10 where every step of both
converged, in float32 states within 2e-4 (the reference's fused-rollout
tolerance). K1n (the fused IP solve at nz=35, planar push) as K1, with
float32 configurations within 2e-4 (the reference's tolerance for push),
and z compared in float64 where both converge in the same iteration
count; K2 at (35, 13) within 1e-10 relative in float64 and 1e-3 in
float32. K1a (the fused IP solve at nz=6, acrobot) as K1 in float64 with
identical flags and iteration counts; K2 at (6, 6), (2, 1) and (2, 6) as
at (10, 8). K5 (the loop-overhead probe) within float32 atol 1e-4 of its
plain version in every variant (it rounds each product and sum as the
plain loop does, so it is expected to agree bit for bit).
"""

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.examples.cartpole import (
    DEPLOY_IP_ACCEL,
)
from optimization_dynamics_tpu_torch.examples import acrobot as acrobot_ex
from optimization_dynamics_tpu_torch.examples import planar_push as push_ex
from optimization_dynamics_tpu_torch.models import cartpole
from optimization_dynamics_tpu_torch.models import planar_push
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
    batched_solve_plain,
)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    fused_ip,
    make_fused_ip_plain,
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.ops.kernels.loop_overhead import (
    VARIANTS,
    loop_overhead,
    loop_overhead_plain,
)
from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
    fused_rollout,
    make_fused_rollout,
    make_fused_rollout_plain,
)
from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
    riccati_backward,
    riccati_backward_plain,
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


def _rand_lqr(seed, B, T, nx, nu, device, dtype):
    """Random LQR data (fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs,
    regs) as the reference's Riccati kernel test draws it."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)

    def spd(n_):
        A = n(B, T - 1, n_, n_)
        return np.einsum("btij,btkj->btik", A, A) + 0.5 * np.eye(n_)

    A = n(B, nx, nx)
    data = [0.5 * n(B, T - 1, nx, nx), 0.5 * n(B, T - 1, nx, nu),
            n(B, T - 1, nx), n(B, T - 1, nu), spd(nx), spd(nu),
            0.3 * n(B, T - 1, nu, nx), n(B, nx),
            np.einsum("bij,bkj->bik", A, A) + np.eye(nx), np.full(B, 1e-6)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in data]


def _riccati_rel(got, ref):
    """Largest relative difference over the five float outputs."""
    return max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
               for g, r in zip(got[:5], ref[:5]))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("nx,nu,T,ragged", [(4, 1, 51, False),
                                            (4, 3, 6, True),
                                            (10, 4, 5, False)])
def test_riccati_kernel_matches_plain(card, dtype, tol, nx, nu, T, ragged):
    data = _rand_lqr(6, 100, T, nx, nu, card, dtype)
    mask = torch.ones((T - 1, nu), dtype=dtype, device=card)
    if ragged:
        mask[:, nu - 1] = 0
        mask[0, 0] = 0
    before = riccati_backward.launches
    got = riccati_backward(*data, mask)
    assert riccati_backward.launches == before + 1
    ref = riccati_backward_plain(*data, mask)
    assert _riccati_rel(got, ref) <= tol
    assert torch.equal(got[5], ref[5]) and bool(got[5].all())
    if ragged:
        assert (got[0][:, :, nu - 1] == 0).all()
        assert (got[1][:, 0, 0] == 0).all()


def test_riccati_kernel_flags_indefinite(card):
    """A Quu that is not positive definite at t=0 clears ``ok`` on its
    lane only; the gains stay finite and equal the plain version's."""
    nx, nu, T = 4, 3, 6
    data = _rand_lqr(7, 8, T, nx, nu, card, torch.float64)
    data[5][3, 0] = -5.0 * torch.eye(nu, dtype=torch.float64)
    mask = torch.ones((T - 1, nu), dtype=torch.float64, device=card)
    got = riccati_backward(*data, mask)
    ref = riccati_backward_plain(*data, mask)
    assert got[5].tolist() == [True] * 3 + [False] + [True] * 4
    assert torch.equal(got[5], ref[5])
    assert bool(torch.isfinite(got[0]).all() & torch.isfinite(got[1]).all())
    assert _riccati_rel(got, ref) <= 1e-10


def _rollout_inputs(B, T, seed, device, dtype):
    """x0s near the deploy start, a reference from its open-loop rollout
    under random controls, random gains, alphas over the Armijo grid."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x0s = t(0.01 * rng.standard_normal((B, 4)))
    uss = t(rng.standard_normal((B, T - 1, 1)))
    Kss = t(0.1 * rng.standard_normal((B, T - 1, 1, 4)))
    kss = t(0.2 * rng.standard_normal((B, T - 1, 1)))
    alphas = t(0.5 ** (np.arange(B) % 8))
    return x0s, uss, Kss, kss, alphas


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_rollout_kernel_matches_plain(card, dtype, ragged):
    T, B = 21, 256
    model = cartpole.friction_model()
    aux = cartpole.CartpoleAux(h=0.05, friction=torch.tensor(
        [0.35, 0.35], dtype=dtype, device=card))
    mask = np.ones((T - 1, 1), bool)
    if ragged:
        mask[5:9] = False
    x0s, uss, Kss, kss, alphas = _rollout_inputs(B, T, 8, card, dtype)
    kern = make_fused_rollout(model, OPTS, aux, T, mask, card, dtype)
    plain = make_fused_rollout_plain(model, OPTS, aux, T, mask, card, dtype)
    zero = torch.zeros_like(alphas)
    xss_ref = kern(x0s, torch.zeros((B, T, 4), dtype=dtype, device=card),
                   uss, 0 * Kss, 0 * kss, zero)[0]
    before = fused_rollout.launches
    xk, uk, wk, sk = kern(x0s, xss_ref, uss, Kss, kss, alphas,
                          return_stats=True)
    assert fused_rollout.launches == before + 1
    xp, up, wp, sp = plain(x0s, xss_ref, uss, Kss, kss, alphas)
    assert bool(torch.isfinite(xk).all() & torch.isfinite(wk).all())
    ck, cp = sk[..., 1] > 0.5, sp[..., 1] > 0.5
    every = (ck.all(dim=1) & cp.all(dim=1)).cpu()
    assert every.float().mean() >= 0.9
    dx = (xk - xp).abs().amax(dim=(1, 2)).cpu()[every]
    if dtype == torch.float64:
        assert float((ck == cp).float().mean()) >= 0.995
        assert float(dx.max()) <= 1e-10
    else:
        assert float(dx.max()) <= 2e-4
    if ragged:
        assert torch.equal(uk[:, 5:9], uss[:, 5:9])


def test_k3_k4_wrappers_raise_on_unsupported_input(card):
    data = _rand_lqr(9, 2, 4, 5, 2, card, torch.float32)
    with pytest.raises(ValueError):
        riccati_backward(*data, torch.ones((3, 2), device=card))
    model = cartpole.friction_model()
    aux = cartpole.CartpoleAux(h=0.05, friction=torch.tensor(
        [0.35, 0.35], device=card))
    roll = make_fused_rollout(model, OPTS, aux, 4, None, card,
                              torch.float32)
    x0s, uss, Kss, kss, alphas = _rollout_inputs(2, 4, 1, card,
                                                 torch.float32)
    with pytest.raises(TypeError):
        roll(x0s.half(), torch.zeros((2, 4, 4), device=card).half(),
             uss.half(), Kss.half(), kss.half(), alphas.half())


PUSH_OPTS = IPOptions(**push_ex.DEPLOY_IP_ACCEL)


def _push(B, seed, device, dtype):
    """Cold planar-push solves around the nominal pose (pusher touching the
    box's left face, u = [1, 0.1])."""
    rng = np.random.default_rng(seed)
    q0 = (np.array([0.0, 0.0, 0.0, -planar_push.R_DIM - 1e-6, 0.0])
          + 0.005 * rng.standard_normal((B, 5)))
    q1 = q0 + 0.001 * rng.standard_normal((B, 5))
    u = np.array([1.0, 0.1]) + 0.1 * rng.standard_normal((B, 2))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    model = planar_push.model()
    return model, model.init_z(t(q1)), model.theta_fn(
        t(q0), t(q1), t(u), planar_push.PlanarPushAux(h=0.1))


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_ip_push_kernel_matches_plain(card, dtype, start):
    model, z0s, ths = _push(640, 11, card, dtype)
    kern = make_fused_ip_solver(model, PUSH_OPTS, card, dtype)
    if start == "warm":
        rng = np.random.default_rng(12)
        prev = ths.clone()
        prev[:, list(model.th_u)] += torch.as_tensor(
            0.05 * rng.standard_normal((ths.shape[0], 2)), dtype=dtype,
            device=card)
        z0s = kern(z0s, prev).z
    before = fused_ip.launches
    sk = kern(z0s, ths)
    assert fused_ip.launches == before + 1
    sp = make_fused_ip_plain(model, PUSH_OPTS, card, dtype)(z0s, ths)
    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    assert both.sum() > 0.9 * len(ck)
    if dtype == torch.float64:
        assert (ck == cp).mean() >= 0.995
        same = both & (sk.iterations == sp.iterations).cpu().numpy()
        assert same.sum() > 0.5 * len(ck)
        dz = (sk.z - sp.z).abs().cpu().numpy()[same]
        assert dz.max() <= 1e-10
    else:
        assert abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck)
        dq = (sk.z - sp.z)[:, :5].abs().cpu().numpy()[both]
        assert dq.max() <= 2e-4


def test_fused_ip_push_kernel_ragged_batch(card):
    """Batches that are not a multiple of the 32-thread block."""
    for B in (1, 5, 33):
        model, z0s, ths = _push(B, 13, card, torch.float64)
        sk = make_fused_ip_solver(model, PUSH_OPTS, card, torch.float64)(
            z0s, ths)
        sp = make_fused_ip_plain(model, PUSH_OPTS, card, torch.float64)(
            z0s, ths)
        assert tuple(sk.z.shape) == (B, 35)
        np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                      sp.converged.cpu().numpy())
        assert bool(sk.converged.all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-10)])
def test_batched_solve_push_shape_matches_plain(card, dtype, tol):
    rng = np.random.default_rng(14)
    A = rng.standard_normal((500, 35, 35)) + 12.0 * np.eye(35)
    b = rng.standard_normal((500, 35, 13))
    At = torch.as_tensor(A, dtype=dtype, device=card)
    bt = torch.as_tensor(b, dtype=dtype, device=card)
    before = batched_solve.launches
    x = batched_solve(At, bt)
    assert batched_solve.launches == before + 1
    xp = batched_solve_plain(At, bt)
    assert float((x - xp).abs().amax() / xp.abs().amax()) <= tol


def test_push_wrappers_raise_on_wrong_functor_or_shape(card):
    model, z0s, ths = _push(4, 15, card, torch.float32)
    cart = np.asarray(cartpole.friction_model().kernel_params, np.float64)
    push = np.asarray(model.kernel_params, np.float64)
    ip = np.zeros(11)
    plain = lambda *a: None
    with pytest.raises(ValueError):
        fused_ip(z0s, ths, "cartpole_friction", cart, ip, plain)
    with pytest.raises(ValueError):
        fused_ip(z0s[:, :34], ths, "planar_push", push, ip, plain)
    with pytest.raises(ValueError):
        fused_ip(z0s, ths[:, :12], "planar_push", push, ip, plain)
    with pytest.raises(ValueError):
        batched_solve(torch.zeros((4, 35, 35), device=card),
                      torch.zeros((4, 35, 12), device=card))


ACROBOT_OPTS = IPOptions(**acrobot_ex.DEPLOY_IP_ACCEL,
                         **acrobot_ex.DEPLOY_KAPPA_SCHEDULE)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_ip_acrobot_kernel_matches_plain(card, dtype, start):
    model, z0s, ths = acrobot_ex.envelope_batch(2000, 21, card, dtype)
    kern = make_fused_ip_solver(model, ACROBOT_OPTS, card, dtype)
    if start == "warm":
        z0s = _warm(kern, model, z0s, ths, 22)
    before = fused_ip.launches
    sk = kern(z0s, ths)
    assert fused_ip.launches == before + 1
    sp = make_fused_ip_plain(model, ACROBOT_OPTS, card, dtype)(z0s, ths)
    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    assert both.sum() > 0.9 * len(ck)
    if dtype == torch.float64:
        np.testing.assert_array_equal(ck, cp)
        assert torch.equal(sk.iterations, sp.iterations)
        assert float((sk.z - sp.z).abs().max()) <= 1e-12
    else:
        assert abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck)
        dq = (sk.z - sp.z)[:, :2].abs().cpu().numpy()[both]
        assert dq.max() <= 2e-4


def test_fused_ip_acrobot_kernel_ragged_batch(card):
    """Batches that are not a multiple of the 128-thread block."""
    for B in (1, 5, 129):
        model, z0s, ths = acrobot_ex.envelope_batch(
            B, 23, card, torch.float64)
        sk = make_fused_ip_solver(model, ACROBOT_OPTS, card, torch.float64)(
            z0s, ths)
        sp = make_fused_ip_plain(model, ACROBOT_OPTS, card, torch.float64)(
            z0s, ths)
        assert tuple(sk.z.shape) == (B, 6)
        np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                      sp.converged.cpu().numpy())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("n,k", [(6, 6), (2, 1), (2, 6)])
def test_batched_solve_acrobot_shapes_match_plain(card, dtype, tol, n, k):
    rng = np.random.default_rng(24)
    A = rng.standard_normal((1000, n, n)) + 4.0 * np.eye(n)
    b = rng.standard_normal((1000, n, k))
    At = torch.as_tensor(A, dtype=dtype, device=card)
    bt = torch.as_tensor(b, dtype=dtype, device=card)
    before = batched_solve.launches
    x = batched_solve(At, bt)
    assert batched_solve.launches == before + 1
    xp = batched_solve_plain(At, bt)
    assert float((x - xp).abs().amax() / xp.abs().amax()) <= tol


@pytest.mark.parametrize("variant", VARIANTS)
def test_loop_overhead_kernel_matches_plain(card, variant):
    x = torch.as_tensor(np.random.RandomState(0).rand(10, 128),
                        dtype=torch.float32, device=card)
    before = loop_overhead.launches
    got = loop_overhead(x, variant)
    assert loop_overhead.launches == before + 1
    ref = loop_overhead_plain(x, variant)
    assert float((got - ref).abs().max()) <= 1e-4
    # the while loop's runtime trip count
    short = loop_overhead(x, "while", n_iter=7)
    assert float((short - loop_overhead_plain(x, "while", 7)).abs().max()) \
        <= 1e-4


def test_loop_overhead_wrapper_raises_on_unsupported_input(card):
    with pytest.raises(ValueError):
        loop_overhead(torch.zeros((10, 64), device=card), "plain")
    with pytest.raises(ValueError):
        loop_overhead(torch.zeros((10, 128), dtype=torch.float64,
                                  device=card), "plain")
    with pytest.raises(ValueError):
        loop_overhead(torch.zeros((10, 128), device=card), "unrolled")
