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
at (10, 8); at the hopper's (20, 1) and (20, 13) on its own Newton and
IFT systems. K5 (the loop-overhead probe) within float32 atol 1e-4 of its
plain version in every variant (it rounds each product and sum as the
plain loop does, so it is expected to agree bit for bit). K1's tile
kernel (a 16-thread tile a scenario, launches up to 16,384 scenarios) in
float64 with flags and iteration counts identical to the plain version's
(with ``max_ls`` = 20 too, two line-search chunks); K1a's tile kernel (an
8-thread tile) and its per-thread kernel as K1a, each forced by the
wrapper's width cut, on ragged tiles and with ``max_ls`` = 20 (three
chunks) too; K4's tile kernel (a 16-thread tile a scenario) and its
per-thread kernel as K4, each forced by the cut, at 1,024 scenarios and
T=51, and on ragged batches with every step's flags and iteration counts
identical; K2 at (35, 13) (a 64-thread block a system) with float64
relative residual <= 1e-12 on ragged batches and KKT-like saddle
systems. K1n's group kernel (a 64-thread group a scenario) and its
per-thread kernel, each forced by the wrapper's width cut, as K1n at
the main path's widths (512 cold, 6,400 warm), on ragged batches, with
line searches that pick past the first candidate (one and two chunks of
warp 0), and against each other: the two run the same arithmetic in the
same order, so they agree bit for bit. K2's tile kernel at n <= 16 (a
tile of threads a system) and K3's tile kernel (a tile of threads a
scenario) as their per-thread kernels against the plain versions, each
forced by the wrapper's cut, on ragged batches and around the cut; K3's
with an indefinite Quu and a ragged ``u_mask`` too. K3's tile kernel
runs its per-thread kernel's expressions in the same order, so in
float64 the two are compared bit for bit. K2's do not agree bit for bit:
nvcc computes some of the per-thread kernel's squares once and adds them
where the tile kernel fuses each into an FMA (PERF.md section 6), so in
float64 the two are held within 1e-10 of each other, relative, as each
is to the plain version. K3 at the hopper's (16, 10), whose tile kernel
factors Quu once in shared memory, with the hopper's ragged mask and an
indefinite Quu on every fifth lane, as at the other shapes. K2 at the
rocket's (12, 1), (12, 16), (10, 4) and (10, 1) on its own Newton and
IFT systems through both kernels, as at the hopper's shapes. K1 at the
rocket's thrust projection (nz=10, a 16-thread tile) and the hopper model
(nz=20, a 32-thread tile): each of its two kernels, forced by the cut,
against the plain version as K1n (float64 flags on >= 99.5% of lanes,
iteration counts on >= 99%, z within 1e-10 where both converge in the
same count), in float32 the rocket's thrusts within 1e-4 and in the cone,
the hopper model's configurations within 2e-4; ragged batches, the route
by width, and the wrapper raising on a wrong functor or shape; the
rocket's and the hopper model's deploys launch K1 and no K2 at (10, 1)
or (20, 1).
"""

import numpy as np
import pytest
import torch

from optimization_dynamics_tpu_torch.examples.cartpole import (
    DEPLOY_IP_ACCEL,
)
from optimization_dynamics_tpu_torch.examples import acrobot as acrobot_ex
from optimization_dynamics_tpu_torch.examples import hopper as hopper_ex
from optimization_dynamics_tpu_torch.examples import planar_push as push_ex
from optimization_dynamics_tpu_torch.models import cartpole
from optimization_dynamics_tpu_torch.models import planar_push
from optimization_dynamics_tpu_torch.ops.kernels._build import (
    BATCHED_SOLVE_SHAPES,
    BATCHED_SOLVE_TILE_MAX_B,
    FUSED_IP_TILE_MAX_B,
    RICCATI_TILE_MAX_B,
    UNROLL_MAX_N,
)
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
from optimization_dynamics_tpu_torch.utils.measure import (
    cut_routed,
    grow_batch,
    hopper_batch,
    hopper_deploy_batch,
    interleave_rows,
    lqr_batch,
    push_batch,
    rel_residual,
    rocket_projection_batch,
    rocket_systems,
    rollout_batch,
    routed,
    warm_batch,
)

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


def _rollout_case(B, T, seed, device, dtype, mask=None, deploy=False):
    """K4 through its wrapper, its plain version, and their inputs
    (``_rollout_inputs``, or with ``deploy`` ``rollout_batch``, the
    deploy's T=51 shapes and distribution, as ``chip_smoke.py`` phase 5
    takes them): the reference states the wrapper's zero-gain rollout of
    the controls."""
    model = cartpole.friction_model()
    aux = cartpole.CartpoleAux(h=0.05, friction=torch.tensor(
        [0.35, 0.35], dtype=dtype, device=device))
    x0s, uss, Kss, kss, alphas = (
        rollout_batch(B, seed, device, dtype) if deploy
        else _rollout_inputs(B, T, seed, device, dtype))
    kern = make_fused_rollout(model, OPTS, aux, T, mask, device, dtype)
    plain = make_fused_rollout_plain(model, OPTS, aux, T, mask, device,
                                     dtype)
    xss_ref = kern(x0s, torch.zeros((B, T, 4), dtype=dtype, device=device),
                   uss, 0 * Kss, 0 * kss, 0 * alphas)[0]
    return kern, plain, (x0s, xss_ref, uss, Kss, kss, alphas)


def _assert_rollout_close(got, ref, dtype, min_every=0.9):
    """K4's (xss, uss, wss, stats) against the plain version's at the
    module's tolerances: float64 per-step flags on >= 99.5% of lane-steps
    and states within 1e-10 where every step of both converged, float32
    states within 2e-4 there."""
    xk, _, wk, sk = got
    xp, _, _, sp = ref
    assert bool(torch.isfinite(xk).all() & torch.isfinite(wk).all())
    ck, cp = sk[..., 1] > 0.5, sp[..., 1] > 0.5
    every = (ck.all(dim=1) & cp.all(dim=1)).cpu()
    assert every.float().mean() >= min_every
    dx = (xk - xp).abs().amax(dim=(1, 2)).cpu()[every]
    if dtype == torch.float64:
        assert float((ck == cp).float().mean()) >= 0.995
        assert float(dx.max()) <= 1e-10
    else:
        assert float(dx.max()) <= 2e-4


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_rollout_kernel_matches_plain(card, dtype, ragged):
    T, B = 21, 256
    mask = np.ones((T - 1, 1), bool)
    if ragged:
        mask[5:9] = False
    kern, plain, args = _rollout_case(B, T, 8, card, dtype, mask)
    before = fused_rollout.launches
    got = kern(*args, return_stats=True)
    assert fused_rollout.launches == before + 1
    _assert_rollout_close(got, plain(*args), dtype)
    if ragged:
        assert torch.equal(got[1][:, 5:9], args[2][:, 5:9])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_rollout_kernels_match_plain_at_rollout_width(
        card, monkeypatch, dtype, ragged):
    """Each of K4's two kernels, forced by the wrapper's width cut, at a
    line-search rung's width (B x 2 alphas = 1,024 scenarios at B=512,
    T=51, on phase 5's inputs) against the plain version."""
    T, B = 51, 1024
    mask = np.ones((T - 1, 1), bool)
    if ragged:
        mask[10:20] = False
    kern, plain, args = _rollout_case(B, T, 20, card, dtype, mask,
                                      deploy=True)
    ref = plain(*args)
    for tile in (1, 0):
        monkeypatch.setitem(FUSED_IP_TILE_MAX_B,
                            ("fused_rollout", "cartpole_friction"),
                            B if tile else 0)
        tiles = fused_rollout.tile_launches
        got = kern(*args, return_stats=True)
        assert fused_rollout.tile_launches == tiles + tile
        _assert_rollout_close(got, ref, dtype)
        if ragged:
            assert torch.equal(got[1][:, 10:20], args[2][:, 10:20])


@pytest.mark.parametrize("B", [1, 3, 5, 65])
def test_fused_rollout_tile_kernel_ragged_batch(card, B):
    """Batches that cut the tile kernel's block (4 scenarios) and a warp's
    tile pair: every step's float64 flags and iteration counts as the
    plain version's, states within 1e-10 where every step converged."""
    kern, plain, args = _rollout_case(B, 21, 11, card, torch.float64)
    tiles = fused_rollout.tile_launches
    got = kern(*args, return_stats=True)
    assert fused_rollout.tile_launches == tiles + 1
    ref = plain(*args)
    assert tuple(got[0].shape) == (B, 21, 4)
    assert tuple(got[2].shape) == (B, 20, 10)
    np.testing.assert_array_equal(got[3][..., :2].cpu().numpy(),
                                  ref[3][..., :2].cpu().numpy())
    _assert_rollout_close(got, ref, torch.float64, min_every=0.0)


def test_fused_rollout_kernels_route_by_width(card):
    """Up to K4's cut in FUSED_IP_TILE_MAX_B the tile kernel runs, above
    it the per-thread kernel; both give the plain version's float64
    flags."""
    limit = FUSED_IP_TILE_MAX_B["fused_rollout", "cartpole_friction"]
    kern, plain, args = _rollout_case(limit + 1, 3, 12, card, torch.float64)
    for B, tile in ((limit, 1), (limit + 1, 0)):
        sub = tuple(a[:B] for a in args)
        launches = fused_rollout.launches
        tiles = fused_rollout.tile_launches
        width = fused_rollout.widths["tile" if tile else "thread", B]
        got = kern(*sub, return_stats=True)
        assert fused_rollout.launches == launches + 1
        assert fused_rollout.tile_launches == tiles + tile
        assert fused_rollout.widths["tile" if tile else "thread",
                                    B] == width + 1
        ref = plain(*sub)
        assert float(((got[3][..., 1] > 0.5) == (ref[3][..., 1] > 0.5))
                     .float().mean()) >= 0.995


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


def test_fused_ip_push_kernel_ragged_batch(card, monkeypatch):
    """K1n's per-thread kernel, forced by the wrapper's width cut, on
    batches that are not a multiple of its 32-thread block."""
    monkeypatch.setitem(FUSED_IP_TILE_MAX_B, ("fused_ip", "planar_push"), 0)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_ip_tile_kernel_rollout_width(card, dtype):
    """K1 (a 16-thread tile a scenario) at a rollout step's width, B x 2
    alphas = 1,024 cold lanes at B=512: float64 flags identical to the
    plain version's on every lane, float32 converged counts within 1%."""
    model, z0s, ths = _envelope(1024, 16, card, dtype)
    before = fused_ip.tile_launches
    sk = make_fused_ip_solver(model, OPTS, card, dtype)(z0s, ths)
    assert fused_ip.tile_launches == before + 1
    sp = make_fused_ip_plain(model, OPTS, card, dtype)(z0s, ths)
    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    assert bool(torch.isfinite(sk.z).all())
    if dtype == torch.float64:
        np.testing.assert_array_equal(ck, cp)
    else:
        assert abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck)


def test_fused_ip_tile_kernel_ragged_tiles(card):
    """Batches that cut a tile kernel's block (4 scenarios) and the warps'
    tile pairs: every lane solved, float64 flags and counts as the plain
    version's."""
    for B in (1, 7, 9, 1023):
        model, z0s, ths = _envelope(B, 17, card, torch.float64)
        sk = make_fused_ip_solver(model, OPTS, card, torch.float64)(z0s,
                                                                   ths)
        sp = make_fused_ip_plain(model, OPTS, card, torch.float64)(z0s,
                                                                  ths)
        assert tuple(sk.z.shape) == (B, 10)
        assert tuple(sk.iterations.shape) == (B,)
        assert bool(torch.isfinite(sk.z).all())
        np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                      sp.converged.cpu().numpy())
        np.testing.assert_array_equal(sk.iterations.cpu().numpy(),
                                      sp.iterations.cpu().numpy())


def test_fused_ip_tile_kernel_line_search_in_chunks(card):
    """max_ls = 20 candidates on a 16-thread tile: the sweep runs in two
    chunks; float64 flags and iteration counts as the plain version's."""
    opts = IPOptions(**{**DEPLOY_IP_ACCEL, "max_ls": 20})
    model, z0s, ths = _envelope(1024, 18, card, torch.float64)
    sk = make_fused_ip_solver(model, opts, card, torch.float64)(z0s, ths)
    sp = make_fused_ip_plain(model, opts, card, torch.float64)(z0s, ths)
    np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                  sp.converged.cpu().numpy())
    np.testing.assert_array_equal(sk.iterations.cpu().numpy(),
                                  sp.iterations.cpu().numpy())


def test_fused_ip_kernels_route_by_width(card):
    """Up to FUSED_IP_TILE_MAX_B scenarios the tile kernel runs, above it
    the per-thread kernel; both give the plain version's float64 flags."""
    limit = FUSED_IP_TILE_MAX_B["fused_ip", "cartpole_friction"]
    model, z0s, ths = _envelope(limit + 1, 19, card, torch.float64)
    solve = make_fused_ip_solver(model, OPTS, card, torch.float64)
    plain = make_fused_ip_plain(model, OPTS, card, torch.float64)
    for B, tile in ((limit, 1), (limit + 1, 0)):
        launches, tiles = fused_ip.launches, fused_ip.tile_launches
        sk = solve(z0s[:B], ths[:B])
        assert fused_ip.launches == launches + 1
        assert fused_ip.tile_launches == tiles + tile
        np.testing.assert_array_equal(
            sk.converged.cpu().numpy(),
            plain(z0s[:B], ths[:B]).converged.cpu().numpy())


@pytest.mark.parametrize("B", [1, 63, 65])
def test_batched_solve_group_kernel_ragged_batch(card, B):
    """K2 at (35, 13), one 64-thread block a system, on batches around
    the warp pair: float64 relative residual <= 1e-12, and the plain
    version's x within 1e-10 relative."""
    rng = np.random.default_rng(25 + B)
    A = torch.as_tensor(rng.standard_normal((B, 35, 35)) + 12.0 * np.eye(35),
                        device=card)
    b = torch.as_tensor(rng.standard_normal((B, 35, 13)), device=card)
    x = batched_solve(A, b)
    assert rel_residual(A, x, b) <= 1e-12
    xp = batched_solve_plain(A, b)
    assert float((x - xp).abs().amax() / xp.abs().amax()) <= 1e-10


def test_batched_solve_group_kernel_saddle_systems(card):
    """K2 at (35, 13) on KKT-like [[H, C^T], [C, 0]] systems, H 20x20
    positive definite, C 15x20 (the zero block puts zeros on the
    diagonal): float64 relative residual <= 1e-12."""
    rng = np.random.default_rng(28)
    B, m, c = 500, 20, 15
    A = np.zeros((B, m + c, m + c))
    H = rng.standard_normal((B, m, m))
    A[:, :m, :m] = H @ H.transpose(0, 2, 1) + 0.5 * np.eye(m)
    C = rng.standard_normal((B, c, m))
    A[:, :m, m:] = C.transpose(0, 2, 1)
    A[:, m:, :m] = C
    At = torch.as_tensor(A, device=card)
    bt = torch.as_tensor(rng.standard_normal((B, m + c, 13)), device=card)
    before = batched_solve.launches
    x = batched_solve(At, bt)
    assert batched_solve.launches == before + 1
    assert bool(torch.isfinite(x).all())
    assert rel_residual(At, x, bt) <= 1e-12


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


def _push_cases(dtype, card):
    """(name, z0s, thetas) of K1n's main-path widths: 512 cold lanes (a
    rollout step, B x 2 alphas at B=256) and 6,400 warm-started ones (the
    sweep, B x (T-1), warm-started one iterate earlier), as chip_smoke.py
    phase 7 makes them."""
    model, z0c, thc = push_batch(6400, 30, card, dtype)
    kern = make_fused_ip_solver(model, PUSH_OPTS, card, dtype)
    z0w, thw = warm_batch(kern, model, z0c, thc, 31)
    _, z0s, ths = push_batch(512, 32, card, dtype)
    return model, {"cold_512": (z0s, ths), "warm_6400": (z0w, thw)}


def _assert_push_agrees(sk, sp, dtype):
    """K1n against its plain version, phase 7's gate: float64 flags equal
    on >= 99.5% of lanes and z within 1e-10 where both converge in the same
    iteration count; float32 converged counts within 1% and max|dq| <=
    2e-4 where both converge."""
    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    assert bool(torch.isfinite(sk.z).all())
    assert both.sum() > 0.9 * len(ck)
    if dtype == torch.float64:
        assert (ck == cp).mean() >= 0.995
        same = both & (sk.iterations == sp.iterations).cpu().numpy()
        assert same.sum() > 0.9 * len(ck)
        assert (sk.z - sp.z).abs().cpu().numpy()[same].max() <= 1e-10
    else:
        assert abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck)
        assert (sk.z - sp.z)[:, :5].abs().cpu().numpy()[both].max() <= 2e-4


@pytest.mark.parametrize("case", ["cold_512", "warm_6400"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_ip_push_group_kernel_matches_plain(card, dtype, case):
    """K1n's group kernel (a 64-thread group a scenario) at the main
    path's widths, through the wrapper's route."""
    model, cases = _push_cases(dtype, card)
    z0s, ths = cases[case]
    tiles, widths = fused_ip.tile_launches, dict(fused_ip.widths)
    sk = make_fused_ip_solver(model, PUSH_OPTS, card, dtype)(z0s, ths)
    assert fused_ip.tile_launches == tiles + 1
    B = z0s.shape[0]
    assert fused_ip.widths["group", B] == widths.get(("group", B), 0) + 1
    _assert_push_agrees(sk, make_fused_ip_plain(model, PUSH_OPTS, card,
                                                dtype)(z0s, ths), dtype)


@pytest.mark.parametrize("case", ["cold_512", "warm_6400"])
def test_fused_ip_push_thread_kernel_matches_plain(card, monkeypatch, case):
    """K1n's per-thread kernel, forced by the wrapper's width cut, at the
    main path's widths in float64."""
    monkeypatch.setitem(FUSED_IP_TILE_MAX_B, ("fused_ip", "planar_push"), 0)
    model, cases = _push_cases(torch.float64, card)
    z0s, ths = cases[case]
    tiles = fused_ip.tile_launches
    sk = make_fused_ip_solver(model, PUSH_OPTS, card, torch.float64)(z0s,
                                                                     ths)
    assert fused_ip.tile_launches == tiles
    _assert_push_agrees(sk, make_fused_ip_plain(
        model, PUSH_OPTS, card, torch.float64)(z0s, ths), torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_ip_push_group_kernel_matches_thread_kernel(card, dtype):
    """K1n's group and per-thread kernels on the 512 cold and 6,400 warm
    lanes: z, iteration counts and flags equal bit for bit."""
    model, cases = _push_cases(dtype, card)
    kern = make_fused_ip_solver(model, PUSH_OPTS, card, dtype)
    for z0s, ths in cases.values():
        sg = routed("planar_push", True, kern)(z0s, ths)
        st = routed("planar_push", False, kern)(z0s, ths)
        assert torch.equal(sg.z, st.z)
        assert torch.equal(sg.iterations, st.iterations)
        assert torch.equal(sg.converged, st.converged)


@pytest.mark.parametrize("B", [1, 2, 3, 65, 129])
def test_fused_ip_push_group_kernel_ragged_batch(card, B):
    """K1n's group kernel on batches that cut its blocks: every lane
    solved, float64 flags as the plain version's."""
    model, z0s, ths = push_batch(B, 33, card, torch.float64)
    tiles = fused_ip.tile_launches
    sk = make_fused_ip_solver(model, PUSH_OPTS, card, torch.float64)(z0s,
                                                                     ths)
    assert fused_ip.tile_launches == tiles + 1
    assert tuple(sk.z.shape) == (B, 35)
    assert tuple(sk.iterations.shape) == (B,)
    assert bool(torch.isfinite(sk.z).all())
    sp = make_fused_ip_plain(model, PUSH_OPTS, card, torch.float64)(z0s, ths)
    np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                  sp.converged.cpu().numpy())
    assert bool(sk.converged.all())


@pytest.mark.parametrize("max_ls", [8, 40])
def test_fused_ip_push_group_kernel_line_search_past_first(card, max_ls):
    """Scenarios whose line search picks past the first candidate (push
    scenarios with the controls moved by N(0, 1)): the plain version's
    iteration counts with ``max_ls`` candidates differ from those with one
    candidate on some lanes (a pick at j > 0). The
    group kernel gives the plain version's float64 flags there, with 8
    candidates (one chunk of warp 0) and with 40 (two chunks)."""
    model, z0s, ths = push_batch(512, 34, card, torch.float64)
    ths = ths.clone()
    ths[:, list(model.th_u)] += torch.as_tensor(
        np.random.default_rng(35).standard_normal((512, 2)), device=card)
    one = IPOptions(**{**push_ex.DEPLOY_IP_ACCEL, "max_ls": 1})
    opts = IPOptions(**{**push_ex.DEPLOY_IP_ACCEL, "max_ls": max_ls})
    sp = make_fused_ip_plain(model, opts, card, torch.float64)(z0s, ths)
    sp1 = make_fused_ip_plain(model, one, card, torch.float64)(z0s, ths)
    assert bool((sp.iterations != sp1.iterations).any())
    sk = make_fused_ip_solver(model, opts, card, torch.float64)(z0s, ths)
    _assert_push_agrees(sk, sp, torch.float64)


def test_fused_ip_push_kernels_route_by_width(card):
    """Up to FUSED_IP_TILE_MAX_B["fused_ip", "planar_push"] scenarios the
    group kernel runs, above it the per-thread kernel; both give the plain
    version's float64 flags on >= 99.5% of lanes."""
    limit = FUSED_IP_TILE_MAX_B["fused_ip", "planar_push"]
    model, z0s, ths = push_batch(limit + 1, 36, card, torch.float64)
    solve = make_fused_ip_solver(model, PUSH_OPTS, card, torch.float64)
    plain = make_fused_ip_plain(model, PUSH_OPTS, card, torch.float64)
    for B, route in ((limit, "group"), (limit + 1, "thread")):
        n = fused_ip.widths[route, B]
        sk = solve(z0s[:B], ths[:B])
        assert fused_ip.widths[route, B] == n + 1
        ck = sk.converged.cpu().numpy()
        cp = plain(z0s[:B], ths[:B]).converged.cpu().numpy()
        assert (ck == cp).mean() >= 0.995


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


def _assert_acrobot_exact(sk, sp):
    """float64 K1a against its plain version: flags and iteration counts
    identical on every lane, max|dz| <= 1e-12."""
    np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                  sp.converged.cpu().numpy())
    np.testing.assert_array_equal(sk.iterations.cpu().numpy(),
                                  sp.iterations.cpu().numpy())
    assert float((sk.z - sp.z).abs().max()) <= 1e-12


@pytest.mark.parametrize("B", [1, 3, 5, 9, 129])
def test_fused_ip_acrobot_tile_kernel_ragged_tiles(card, B):
    """K1a's tile kernel (an 8-thread tile a scenario, four tiles a warp,
    eight a block) on batches that cut a warp's or a block's tiles."""
    model, z0s, ths = acrobot_ex.envelope_batch(B, 24, card, torch.float64)
    tiles = fused_ip.tile_launches
    sk = make_fused_ip_solver(model, ACROBOT_OPTS, card, torch.float64)(
        z0s, ths)
    assert fused_ip.tile_launches == tiles + 1
    assert tuple(sk.z.shape) == (B, 6)
    assert bool(torch.isfinite(sk.z).all())
    _assert_acrobot_exact(sk, make_fused_ip_plain(
        model, ACROBOT_OPTS, card, torch.float64)(z0s, ths))


def test_fused_ip_acrobot_tile_kernel_line_search_in_chunks(card):
    """max_ls = 20 candidates on an 8-thread tile: the sweep runs in three
    chunks; float64 flags and iteration counts as the plain version's."""
    opts = IPOptions(**{**acrobot_ex.DEPLOY_IP_ACCEL,
                        **acrobot_ex.DEPLOY_KAPPA_SCHEDULE, "max_ls": 20})
    model, z0s, ths = acrobot_ex.envelope_batch(1024, 25, card,
                                                torch.float64)
    tiles = fused_ip.tile_launches
    sk = make_fused_ip_solver(model, opts, card, torch.float64)(z0s, ths)
    assert fused_ip.tile_launches == tiles + 1
    _assert_acrobot_exact(sk, make_fused_ip_plain(
        model, opts, card, torch.float64)(z0s, ths))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fused_ip_acrobot_thread_kernel_matches_plain(card, monkeypatch,
                                                       start):
    """K1a's per-thread kernel, forced by the wrapper's width cut."""
    monkeypatch.setitem(FUSED_IP_TILE_MAX_B, ("fused_ip", "acrobot_impact"),
                        0)
    model, z0s, ths = acrobot_ex.envelope_batch(2000, 26, card,
                                                torch.float64)
    kern = make_fused_ip_solver(model, ACROBOT_OPTS, card, torch.float64)
    if start == "warm":
        z0s = _warm(kern, model, z0s, ths, 27)
    tiles = fused_ip.tile_launches
    sk = kern(z0s, ths)
    assert fused_ip.tile_launches == tiles
    _assert_acrobot_exact(sk, make_fused_ip_plain(
        model, ACROBOT_OPTS, card, torch.float64)(z0s, ths))


def test_fused_ip_acrobot_kernels_route_by_width(card):
    """Up to FUSED_IP_TILE_MAX_B["fused_ip", "acrobot_impact"] (204,800)
    scenarios the tile kernel runs, above it the per-thread kernel; both
    give the plain version's float64 flags and iteration counts on every
    lane and its z within 1e-12 on the converged lanes. (At this width a
    few of the ~650 unconverged lanes end up to 5e-8 apart through either
    kernel: their last iterates are not at a solution.)"""
    limit = FUSED_IP_TILE_MAX_B["fused_ip", "acrobot_impact"]
    model, z0s, ths = acrobot_ex.envelope_batch(limit + 1, 28, card,
                                                torch.float64)
    solve = make_fused_ip_solver(model, ACROBOT_OPTS, card, torch.float64)
    plain = make_fused_ip_plain(model, ACROBOT_OPTS, card, torch.float64)
    for B, tile in ((limit, 1), (limit + 1, 0)):
        launches, tiles = fused_ip.launches, fused_ip.tile_launches
        sk = solve(z0s[:B], ths[:B])
        assert fused_ip.launches == launches + 1
        assert fused_ip.tile_launches == tiles + tile
        sp = plain(z0s[:B], ths[:B])
        np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                      sp.converged.cpu().numpy())
        np.testing.assert_array_equal(sk.iterations.cpu().numpy(),
                                      sp.iterations.cpu().numpy())
        conv = sp.converged
        assert float((sk.z - sp.z)[conv].abs().max()) <= 1e-12


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


def _small_system(B, n, k, seed, device, dtype):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((B, n, n)) + 2.0 * n * np.eye(n),
                        dtype=dtype, device=device)
    b = torch.as_tensor(rng.standard_normal((B, n, k)), dtype=dtype,
                        device=device)
    return A, b


def _rel(x, ref):
    return float((x - ref).abs().amax() / ref.abs().amax())


def _solve_routes(A, b):
    """x from K2's tile and per-thread kernels, each forced by the cut."""
    key = (A.shape[1], b.shape[2])
    out = {}
    for route in ("tile", "thread"):
        tiles = batched_solve.tile_launches
        out[route] = cut_routed(BATCHED_SOLVE_TILE_MAX_B, key,
                                route == "tile", batched_solve)(A, b)
        assert batched_solve.tile_launches == tiles + (route == "tile")
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("shape", sorted(s for s in BATCHED_SOLVE_SHAPES
                                         if s[0] <= UNROLL_MAX_N))
def test_batched_solve_tile_kernel_matches_plain(card, dtype, tol, shape):
    """K2's tile and per-thread kernels against the plain version and
    against each other at every shape they serve."""
    A, b = _small_system(1000, *shape, 30, card, dtype)
    xs = _solve_routes(A, b)
    xp = batched_solve_plain(A, b)
    for route in ("tile", "thread"):
        assert _rel(xs[route], xp) <= tol
    assert _rel(xs["tile"], xs["thread"]) <= tol


@pytest.mark.parametrize("B", [1, 3, 5, 4093])
def test_batched_solve_tile_kernel_ragged_batch(card, B):
    """Batches that are not a whole number of tiles a block (4 at (10, 8),
    8 at (6, 6)): every system solved, float64 relative residual <= 1e-12,
    x within 1e-10 of the per-thread kernel's, relative."""
    for shape in ((10, 8), (6, 6)):
        A, b = _small_system(B, *shape, 31 + B, card, torch.float64)
        xs = _solve_routes(A, b)
        assert tuple(xs["tile"].shape) == (B,) + (shape[0], shape[1])
        assert rel_residual(A, xs["tile"], b) <= 1e-12
        assert _rel(xs["tile"], xs["thread"]) <= 1e-10


def test_batched_solve_tile_kernel_saddle_systems(card):
    """KKT-like [[H, C^T], [C, 0]] systems at (10, 8), zeros on the
    diagonal: the tile kernel's float64 relative residual <= 1e-12, x
    within 1e-10 of the per-thread kernel's, relative."""
    rng = np.random.default_rng(33)
    B, m = 500, 5
    A = np.zeros((B, 2 * m, 2 * m))
    H = rng.standard_normal((B, m, m))
    A[:, :m, :m] = H @ H.transpose(0, 2, 1) + 0.5 * np.eye(m)
    C = rng.standard_normal((B, m, m))
    A[:, :m, m:] = C.transpose(0, 2, 1)
    A[:, m:, :m] = C
    At = torch.as_tensor(A, device=card)
    bt = torch.as_tensor(rng.standard_normal((B, 2 * m, 8)), device=card)
    xs = _solve_routes(At, bt)
    assert rel_residual(At, xs["tile"], bt) <= 1e-12
    assert _rel(xs["tile"], xs["thread"]) <= 1e-10


@pytest.mark.parametrize("shape", [(10, 8), (6, 6)])
def test_batched_solve_kernels_route_by_width(card, shape):
    """Up to the shape's cut in BATCHED_SOLVE_TILE_MAX_B the tile kernel
    runs, one system past it the per-thread kernel, each counted in
    ``widths`` under its kernel and width; the shared systems' x within
    1e-10 of each other, relative. A cut of 0 sends every width to the
    per-thread kernel: one system, and 64."""
    limit = BATCHED_SOLVE_TILE_MAX_B[shape]
    sides = (((limit, "tile"), (limit + 1, "thread")) if limit > 0
             else ((1, "thread"), (64, "thread")))
    A, b = grow_batch(_small_system(64, *shape, 34, card, torch.float64),
                      sides[1][0])
    xs = {}
    for B, route in sides:
        launches = batched_solve.launches
        width = batched_solve.widths[route, B]
        xs[B] = batched_solve(A[:B], b[:B])
        assert batched_solve.launches == launches + 1
        assert batched_solve.widths[route, B] == width + 1
    (n0, _), (n1, _) = sides
    assert _rel(xs[n0], xs[n1][:n0]) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(BATCHED_SOLVE_SHAPES))
def test_batched_solve_kernels_read_strides(card, dtype, shape):
    """Each K2 kernel (tile and per-thread at up to 16 unknowns, the group
    kernel above) reads A and b where they lie: x is bit for bit the same
    from contiguous systems, from systems interleaved row by row as
    ``batched_jacobian`` gives them, and from a slice of such (a storage
    offset; the row stride is the wider batch's); 133 systems, not a
    whole number of tiles a block; relative residual <= 1e-12 in float64,
    1e-5 in float32."""
    n, k = shape
    A, b = _small_system(135, n, k, 35, card, dtype)
    wide = interleave_rows([A, b])
    layouts = {"contiguous": (A[1:134].contiguous(), b[1:134].contiguous()),
               "interleaved": tuple(interleave_rows([A[1:134], b[1:134]])),
               "interleaved_slice": (wide[0][1:134], wide[1][1:134])}
    routes = ("tile", "thread") if n <= UNROLL_MAX_N else ("group",)
    for route in routes:
        run = batched_solve if route == "group" else cut_routed(
            BATCHED_SOLVE_TILE_MAX_B, shape, route == "tile", batched_solve)
        xs = {name: run(*ab) for name, ab in layouts.items()}
        for name, x in xs.items():
            assert x.is_contiguous() and tuple(x.shape) == (133, n, k)
            assert torch.equal(x, xs["contiguous"]), (route, name)
        Ac, bc = layouts["contiguous"]
        assert rel_residual(Ac, xs["contiguous"], bc) <= (
            1e-12 if dtype == torch.float64 else 1e-5)


def _riccati_routes(data, mask, nx, nu):
    """K3's tile and per-thread kernels, each forced by the cut."""
    out = {}
    for route in ("tile", "thread"):
        tiles = riccati_backward.tile_launches
        out[route] = cut_routed(RICCATI_TILE_MAX_B, (nx, nu),
                                route == "tile", riccati_backward)(*data,
                                                                   mask)
        assert riccati_backward.tile_launches == tiles + (route == "tile")
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("nx,nu,T,ragged", [(4, 1, 51, False),
                                            (4, 3, 6, True),
                                            (6, 3, 7, True),
                                            (10, 4, 5, False),
                                            (16, 10, 4, True)])
def test_riccati_tile_kernel_matches_plain(card, dtype, tol, nx, nu, T,
                                           ragged):
    """K3's tile and per-thread kernels against the plain version at every
    shape, all controls active or a ragged ``u_mask`` (masked gains
    exactly 0); in float64 the two kernels agree bit for bit."""
    data = _rand_lqr(16, 100, T, nx, nu, card, dtype)
    mask = torch.ones((T - 1, nu), dtype=dtype, device=card)
    if ragged:
        mask[:, nu - 1] = 0
        mask[0, 0] = 0
    got = _riccati_routes(data, mask, nx, nu)
    ref = riccati_backward_plain(*data, mask)
    for g in got.values():
        assert _riccati_rel(g, ref) <= tol
        assert torch.equal(g[5], ref[5]) and bool(g[5].all())
        if ragged:
            assert (g[0][:, :, nu - 1] == 0).all()
            assert (g[1][:, 0, 0] == 0).all()
    if dtype == torch.float64:
        assert all(torch.equal(a, b) for a, b in zip(got["tile"],
                                                     got["thread"]))


def test_riccati_tile_kernel_flags_indefinite(card):
    """A Quu that is not positive definite at t=0 clears the tile kernel's
    ``ok`` on its lane only; the gains stay finite and equal the per-thread
    kernel's bit for bit."""
    nx, nu, T = 4, 3, 6
    data = _rand_lqr(17, 8, T, nx, nu, card, torch.float64)
    data[5][3, 0] = -5.0 * torch.eye(nu, dtype=torch.float64)
    mask = torch.ones((T - 1, nu), dtype=torch.float64, device=card)
    got = _riccati_routes(data, mask, nx, nu)
    ref = riccati_backward_plain(*data, mask)
    assert got["tile"][5].tolist() == [True] * 3 + [False] + [True] * 4
    assert bool(torch.isfinite(got["tile"][0]).all()
                & torch.isfinite(got["tile"][1]).all())
    assert _riccati_rel(got["tile"], ref) <= 1e-10
    assert all(torch.equal(a, b) for a, b in zip(got["tile"],
                                                 got["thread"]))


@pytest.mark.parametrize("B", [1, 3, 17, 509])
def test_riccati_tile_kernel_ragged_batch(card, B):
    """Batches that are not a whole number of tiles a block (4 at nx=4,
    2 at nx=10): every lane as the per-thread kernel's, bit for bit."""
    for nx, nu, T in ((4, 1, 51), (10, 4, 4)):
        data = _rand_lqr(18 + B, B, T, nx, nu, card, torch.float64)
        mask = torch.ones((T - 1, nu), dtype=torch.float64, device=card)
        got = _riccati_routes(data, mask, nx, nu)
        assert tuple(got["tile"][0].shape) == (B, T - 1, nu, nx)
        assert bool(got["tile"][5].all())
        assert all(torch.equal(a, b) for a, b in zip(got["tile"],
                                                     got["thread"]))


def test_riccati_kernels_route_by_width(card):
    """Up to RICCATI_TILE_MAX_B[(4, 1)] lanes the tile kernel runs, one
    lane past it the per-thread kernel, each counted in ``widths``; the
    shared lanes' outputs agree bit for bit."""
    limit = RICCATI_TILE_MAX_B[4, 1]
    data = grow_batch(_rand_lqr(19, 64, 3, 4, 1, card, torch.float64),
                      limit + 1)
    mask = torch.ones((2, 1), dtype=torch.float64, device=card)
    got = {}
    for B, route in ((limit, "tile"), (limit + 1, "thread")):
        launches = riccati_backward.launches
        width = riccati_backward.widths[route, B]
        got[B] = riccati_backward(*(a[:B] for a in data), mask)
        assert riccati_backward.launches == launches + 1
        assert riccati_backward.widths[route, B] == width + 1
    assert all(torch.equal(a, b[:limit]) for a, b in zip(got[limit],
                                                         got[limit + 1]))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B", [256, 253])
def test_riccati_hopper_shape_matches_plain(card, dtype, tol, B):
    """K3 at (16, 10), T=21, with the hopper's mask and, on every fifth
    lane, a Quu at t=0 whose last pivot is negative: each kernel (the
    tile's Quu factored once in its slab) against the plain version,
    ``ok`` identical, masked gains exactly 0; in float64 the two kernels
    agree bit for bit. The data is ``lqr_batch``'s, whose fx keeps a
    spectral radius of about 1 (``_rand_lqr``'s 0.5 N(0, 1) has about 2
    at nx=16, so Vxx grows some 4^20-fold over the horizon)."""
    nx, nu, T = 16, 10, 21
    data = lqr_batch(40, B, T, nx, nu, card, dtype)
    bad = torch.zeros(B, dtype=torch.bool, device=card)
    bad[::5] = True
    data[5][bad, 0, nu - 1, nu - 1] = -1.0e4
    mask = hopper_ex.control_mask(card).to(dtype)
    got = _riccati_routes(data, mask, nx, nu)
    ref = riccati_backward_plain(*data, mask)
    for g in got.values():
        assert torch.equal(g[5], ref[5]) and torch.equal(g[5], ~bad)
        assert bool(torch.isfinite(g[0]).all() & torch.isfinite(g[1]).all())
        good = ~bad
        assert _riccati_rel([a[good] for a in g],
                            [a[good] for a in ref]) <= tol
        assert (g[0][:, 1:, 2:] == 0).all() and (g[1][:, 1:, 2:] == 0).all()
    if dtype == torch.float64:
        assert all(torch.equal(a, b) for a, b in zip(got["tile"],
                                                     got["thread"]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [1, 13])
def test_batched_solve_hopper_shapes_match_plain(card, dtype, k):
    """K2 at (20, 1) and (20, 13) (a 64-thread block a system) on the
    hopper's own systems, dr/dz at IP solutions of hopper states with the
    residual or dr/dtheta, row-interleaved as the sweep passes them:
    relative residual <= 1e-12 in float64 (x within 1e-10 of the plain
    version's, relative) and <= 1e-5 in float32."""
    from optimization_dynamics_tpu_torch.models import hopper
    from optimization_dynamics_tpu_torch.solver import interior_point as tip

    rng = np.random.default_rng(41)
    B = 300
    q1 = np.array([0.0, 0.55, 0.0, 0.5]) + 0.05 * rng.standard_normal(
        (B, 4))
    q0 = q1 - 0.01 * rng.standard_normal((B, 4))
    u = rng.standard_normal((B, 2))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=card)
    model = hopper.model()
    ths = model.theta_fn(t(q0), t(q1), t(u), hopper.HopperAux(h=0.05))
    zs = tip.make_solver_batched(model.residual, model.spec,
                                 IPOptions(**hopper_ex.DEPLOY_IP_ACCEL),
                                 card, dtype)(model.init_z(t(q1)), ths).z
    A = tip.batched_jacobian(model.residual, 0)(zs, ths)
    b = (tip.batched_jacobian(model.residual, 1)(zs, ths) if k == 13
         else model.residual(zs, ths, 1e-3)[..., None])
    assert A.stride()[:2] == (20, B * 20)
    before = batched_solve.shapes[20, k]
    x = batched_solve(A, b)
    assert batched_solve.shapes[20, k] == before + 1
    xp = batched_solve_plain(A, b)
    if dtype == torch.float64:
        assert rel_residual(A, x, b) <= 1e-12
        assert _rel(x, xp) <= 1e-10
    else:
        assert rel_residual(A, x, b) <= 1e-5


def test_hopper_deploy_launches_k2_and_k3(card):
    """One inner iteration of the hopper deploy (float32, B=8) with K3:
    every IP solve runs in K1 on the ``hopper`` functor (its tile kernel
    at these widths), so K2 runs its group kernel at (20, 13) only, the
    IFT solves, and none at (20, 1); K3 its tile kernel at (16, 10); the
    outputs are finite."""
    import dataclasses

    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver,
    )

    ex = hopper_ex
    prob, x0, us0, opts = ex.build_deploy_problem(card)
    opts = dataclasses.replace(opts, max_al_iter=1, riccati_kernel=True)
    solve = make_segmented_solver(prob, opts, 8, x0.dtype, card,
                                  max_iter_schedule=[1])
    shapes = dict(batched_solve.shapes)
    tiles = riccati_backward.tile_launches
    k1_tiles = fused_ip.widths.copy()
    res = solve(ex.deploy_x0s(x0, 8, seed=0), us0)
    assert bool(torch.isfinite(res.xs).all() & torch.isfinite(res.us).all())
    assert batched_solve.shapes[20, 13] > shapes.get((20, 13), 0)
    assert batched_solve.shapes[20, 1] == shapes.get((20, 1), 0)
    assert riccati_backward.tile_launches == tiles + 1
    new = fused_ip.widths - k1_tiles
    assert sum(new.values()) > 0 and {k for k, _ in new} == {"tile"}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nk", [(12, 1), (12, 16), (10, 4), (10, 1)])
def test_batched_solve_rocket_shapes_match_plain(card, dtype, nk):
    """K2 at the rocket's (12, 1), (12, 16), (10, 4) and (10, 1) on its own
    Newton and IFT systems (``rocket_systems``: the deploy's scenarios,
    row-interleaved as the solver and the sweep pass them), through the
    tile and the per-thread kernel, each forced by the wrapper's cut, on
    a batch that is not a whole number of tiles a block: relative
    residual <= 1e-12 in float64 (x within 1e-10 of the plain version's,
    relative) and <= 1e-5 in float32; each counted at its shape."""
    A, b = rocket_systems(301, 60, card, dtype)[nk]
    xp = batched_solve_plain(A, b)
    got = _solve_routes(A, b)
    for route, x in got.items():
        if dtype == torch.float64:
            assert rel_residual(A, x, b) <= 1e-12, route
            assert _rel(x, xp) <= 1e-10, route
        else:
            assert rel_residual(A, x, b) <= 1e-5, route
    if dtype == torch.float64:
        assert _rel(got["tile"], got["thread"]) <= 1e-10
    before = batched_solve.shape_widths.copy()
    batched_solve(A, b)
    route = "tile" if A.shape[0] <= BATCHED_SOLVE_TILE_MAX_B[nk] else \
        "thread"
    assert batched_solve.shape_widths[(*nk, route, A.shape[0])] == \
        before[(*nk, route, A.shape[0])] + 1


def test_rocket_deploy_launches_k2_at_its_shapes(card):
    """One inner iteration of the rocket deploy (float32, B=8): every
    thrust projection runs in K1 on the ``rocket_projection`` functor, so
    K2 runs at (10, 4) (the projection's IFT solves), (12, 1) and (12, 16)
    (the midpoint solve's) and nowhere else, not at (10, 1); the outputs
    are finite and every lane's thrust is in the cone."""
    import dataclasses

    from optimization_dynamics_tpu_torch.examples import rocket as ex
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver,
    )

    prob, x0, us0, opts = ex.build_deploy_problem(card)
    assert x0.dtype == torch.float32
    opts = dataclasses.replace(opts, max_al_iter=1)
    solve = make_segmented_solver(prob, opts, 8, x0.dtype, card,
                                  max_iter_schedule=[1])
    batched_solve.shapes.clear()
    launches = fused_ip.launches
    res = solve(ex.deploy_x0s(x0, 8, seed=0), us0)
    assert fused_ip.launches > launches
    assert bool(torch.isfinite(res.xs).all() & torch.isfinite(res.us).all())
    assert set(batched_solve.shapes) == {(10, 4), (12, 1), (12, 16)}
    assert bool(ex.thrust_cone_ok(res.us).all())


# K1 at the rocket's thrust projection (nz=10) and the hopper model
# (nz=20): each of its two kernels against the plain version

def _rocket_proj_opts():
    from optimization_dynamics_tpu_torch.examples import rocket as ex

    return IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL, kappa_tol=ex.PROJ_KAPPA_TOL)


def _model_case(name, case, card, dtype):
    """(model, IP options, z0s, thetas): the rocket's cold projections
    (u_bar = 6 N(0, 1)); the hopper model's solves about its standing
    pose (``hopper_batch``), cold or warm-started one iterate earlier, and
    along its deploy's rollouts (``hopper_deploy_batch``)."""
    if name == "rocket_projection":
        model, z0s, ths = rocket_projection_batch(2000, 61, card, dtype)
        return model, _rocket_proj_opts(), z0s, ths
    opts = IPOptions(**hopper_ex.DEPLOY_IP_ACCEL)
    if case == "deploy":
        model, z0s, ths = hopper_deploy_batch(600, 62, card, dtype)
        return model, opts, z0s, ths
    model, z0s, ths = hopper_batch(2000, 63, card, dtype)
    if case == "warm":
        z0s, ths = warm_batch(make_fused_ip_plain(model, opts, card, dtype),
                              model, z0s, ths, 64)
    return model, opts, z0s, ths


def _assert_model_agrees(name, sk, sp, dtype):
    """float64: flags on >= 99.5% of lanes and iteration counts on >= 99%
    as the plain version's, z within 1e-10 where both converge in the
    same count; float32: converged counts within 1%, the rocket's thrusts
    within 1e-4 and in the cone (1e-4), the hopper model's configurations
    within 2e-4, where both converge."""
    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    assert bool(torch.isfinite(sk.z).all())
    assert both.sum() > 0.9 * len(ck)
    if dtype == torch.float64:
        assert (ck == cp).mean() >= 0.995
        same_it = (sk.iterations == sp.iterations).cpu().numpy()
        assert same_it.mean() >= 0.99
        assert (sk.z - sp.z).abs().cpu().numpy()[both & same_it].max() \
            <= 1e-10
    else:
        assert abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck)
        if name == "rocket_projection":
            u = sk.z[:, 0:3].cpu().numpy()[both]
            assert (np.linalg.norm(u[:, 0:2], axis=1)
                    <= u[:, 2] + 1e-4).all()
            assert (sk.z - sp.z)[:, 0:3].abs().cpu().numpy()[both].max() \
                <= 1e-4
        else:
            assert (sk.z - sp.z)[:, 0:4].abs().cpu().numpy()[both].max() \
                <= 2e-4


MODEL_CASES = [("rocket_projection", "cold"), ("hopper", "cold"),
               ("hopper", "warm"), ("hopper", "deploy")]


@pytest.mark.parametrize("route", ["tile", "thread"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,case", MODEL_CASES)
def test_fused_ip_model_kernels_match_plain(card, name, case, dtype, route):
    """K1 on ``rocket_projection`` and ``hopper``: the tile kernel (16 and
    32 threads a scenario) and the per-thread kernel, each forced by the
    wrapper's cut, against the plain version."""
    model, opts, z0s, ths = _model_case(name, case, card, dtype)
    kern = routed(name, route == "tile",
                  make_fused_ip_solver(model, opts, card, dtype))
    launches, tiles = fused_ip.launches, fused_ip.tile_launches
    sk = kern(z0s, ths)
    assert fused_ip.launches == launches + 1
    assert fused_ip.tile_launches == tiles + (route == "tile")
    sp = make_fused_ip_plain(model, opts, card, dtype)(z0s, ths)
    _assert_model_agrees(name, sk, sp, dtype)


@pytest.mark.parametrize("name", ["rocket_projection", "hopper"])
@pytest.mark.parametrize("B", [1, 3, 5, 65])
def test_fused_ip_model_tile_kernel_ragged_batch(card, name, B):
    """The tile kernels (four 16-thread tiles a 64-thread block for the
    rocket's projection, two 32-thread tiles for the hopper model) on
    batches that are not a whole number of tiles a block: every lane
    solved, float64 flags and iteration counts as the plain version's."""
    model, opts, z0s, ths = _model_case(name, "cold", card, torch.float64)
    z0s, ths = z0s[:B], ths[:B]
    tiles = fused_ip.tile_launches
    sk = make_fused_ip_solver(model, opts, card, torch.float64)(z0s, ths)
    assert fused_ip.tile_launches == tiles + 1
    sp = make_fused_ip_plain(model, opts, card, torch.float64)(z0s, ths)
    assert tuple(sk.z.shape) == tuple(z0s.shape)
    np.testing.assert_array_equal(sk.converged.cpu().numpy(),
                                  sp.converged.cpu().numpy())
    np.testing.assert_array_equal(sk.iterations.cpu().numpy(),
                                  sp.iterations.cpu().numpy())
    assert float((sk.z - sp.z).abs().max()) <= 1e-10


@pytest.mark.parametrize("name", ["rocket_projection", "hopper"])
def test_fused_ip_model_kernels_route_by_width(card, name):
    """Up to FUSED_IP_TILE_MAX_B["fused_ip", name] scenarios the tile
    kernel runs, one past it the per-thread kernel (the inputs repeated to
    the width), each counted by kernel and width."""
    limit = FUSED_IP_TILE_MAX_B["fused_ip", name]
    model, opts, z0s, ths = _model_case(name, "cold", card, torch.float32)
    z0s, ths = grow_batch([z0s, ths], limit + 1)
    solve = make_fused_ip_solver(model, opts, card, torch.float32)
    for B, route in ((limit, "tile"), (limit + 1, "thread")):
        width = fused_ip.widths[route, B]
        tiles = fused_ip.tile_launches
        sol = solve(z0s[:B], ths[:B])
        assert fused_ip.widths[route, B] == width + 1
        assert fused_ip.tile_launches == tiles + (route == "tile")
        assert bool(torch.isfinite(sol.z).all())


def test_fused_ip_model_wrappers_raise_on_wrong_functor_or_shape(card):
    """K1's wrapper raises on CUDA tensors whose widths are not the
    functor's, and on a functor it was not compiled for."""
    _, _, z0r, thr = _model_case("rocket_projection", "cold", card,
                                 torch.float32)
    hop, _, z0h, thh = _model_case("hopper", "cold", card, torch.float32)
    hp = np.asarray(hop.kernel_params, np.float64)
    none = np.zeros(0)
    ip = np.zeros(11)
    plain = lambda *a: None
    with pytest.raises(ValueError):
        fused_ip(z0r, thr, "hopper", hp, ip, plain)
    with pytest.raises(ValueError):
        fused_ip(z0h, thh, "rocket_projection", none, ip, plain)
    with pytest.raises(ValueError):
        fused_ip(z0r, thr[:, :3], "rocket_projection", none, ip, plain)
    with pytest.raises(ValueError):
        fused_ip(z0h[:, :19], thh, "hopper", hp, ip, plain)
    with pytest.raises(ValueError):
        fused_ip(z0r, thr, "rocket_midpoint", none, ip, plain)
