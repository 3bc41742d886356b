"""Port parity: the scalar AL-iLQR ``solve`` and ``rollout``.

The six cases of ``tests/test_ilqr.py`` and the three of
``tests/test_parallel_opts.py`` run through the port's ``solve`` and the
reference's on the same closed-form problems in float64: objective rtol
1e-6, controls and states atol 1e-6, identical inner and AL iteration
counts and converged flags, besides the reference tests' own checks
(the analytic LQR gains, the goals reached, the box limit, the warm AL
start, the parallel options against the sequential solve to 1e-7).
One short-horizon implicit-dynamics solve (the cartpole friction model,
wired as ``examples/cartpole.py`` wires it: the IP solves of its rollouts
and sweeps through the fused IP kernel's plain version) is held to the
reference at the same tolerances.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.solver import ilqr as J
from optimization_dynamics_tpu_torch.solver import ilqr as P
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)
F64 = torch.float64
H = 0.1


class _Lib:
    """The array namespace of one package, for problems written once."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.ilqr = J if jax_side else P

    def arr(self, v, dtype=None):
        if self.jax:
            return jnp.asarray(v, dtype)
        return torch.as_tensor(np.asarray(v), dtype=dtype or F64)

    def cat(self, parts):
        return jnp.concatenate(parts) if self.jax else torch.cat(parts)

    def sum(self, a):
        return jnp.sum(a) if self.jax else torch.sum(a)


JL, TL = _Lib(True), _Lib(False)


def _double_integrator(L, nu=1):
    A = L.arr([[1.0, H], [0.0, 1.0]])
    B = L.arr([[0.5 * H * H] + [0.0] * (nu - 1), [H] + [0.0] * (nu - 1)])
    return A, B, (lambda t, x, u: A @ x + B @ u), (
        lambda t, x, u: (A @ x + B @ u, A, B))


def _lqr(L, T):
    A, B, dyn, jac = _double_integrator(L)
    Q, R, QT = L.arr(np.eye(2)), L.arr(0.1 * np.eye(1)), L.arr(10 * np.eye(2))
    return L.ilqr.ILQRProblem(
        T=T, nx=2, nu=1, ncon=0, nconT=0, dynamics=dyn, dynamics_jac=jac,
        stage_cost=lambda t, x, u: 0.5 * (x @ Q @ x + u @ R @ u),
        terminal_cost=lambda x: 0.5 * x @ QT @ x)


def _terminal_goal(L, T, goal, stage=None):
    _, _, dyn, jac = _double_integrator(L)
    g = L.arr(goal)
    return L.ilqr.ILQRProblem(
        T=T, nx=2, nu=1, ncon=0, nconT=2, dynamics=dyn, dynamics_jac=jac,
        stage_cost=stage or (lambda t, x, u: 0.5 * L.sum(u * u)),
        terminal_cost=lambda x: 0.0 * L.sum(x),
        terminal_con=lambda x: x - g)


def _box(L, T, u_lim=0.3):
    _, _, dyn, jac = _double_integrator(L)
    g = L.arr([0.4, 0.0])
    mask = np.ones((T - 1, 2), bool)
    return L.ilqr.ILQRProblem(
        T=T, nx=2, nu=1, ncon=2, nconT=2, dynamics=dyn, dynamics_jac=jac,
        stage_cost=lambda t, x, u: 0.5 * 1e-2 * L.sum(u * u),
        terminal_cost=lambda x: 0.0 * L.sum(x),
        stage_con=lambda t, x, u: L.cat([u - u_lim, -u - u_lim]),
        terminal_con=lambda x: x - g,
        ineq_mask=jnp.asarray(mask) if L.jax else torch.as_tensor(mask))


def _nonquadratic(L, T=20):
    """``tests/test_parallel_opts.py``'s problem: a state-dependent
    control weight, so the line search and regularisation matter."""
    prob = _terminal_goal(L, T, [1.0, 0.0], stage=lambda t, x, u: (
        0.5 * L.sum(u * u) + 0.01 * L.sum(x * x) * u[0] ** 2))
    return prob._replace(terminal_cost=lambda x: 0.1 * L.sum(x * x))


def _masked(L, T=15):
    """Padded control dims (the hopper's pattern): the second control is
    inert and masked."""
    _, B, _, _ = _double_integrator(L, nu=2)
    A = L.arr([[1.0, H], [0.0, 1.0]])
    g = L.arr([0.5, 0.0])
    mask = np.zeros((T - 1, 2), bool)
    mask[:, 0] = True
    return L.ilqr.ILQRProblem(
        T=T, nx=2, nu=2, ncon=0, nconT=2,
        dynamics=lambda t, x, u: A @ x + B @ u,
        dynamics_jac=lambda t, x, u: (A @ x + B @ u, A, B),
        stage_cost=lambda t, x, u: 0.5 * L.sum(u * u),
        terminal_cost=lambda x: 0.0 * L.sum(x),
        terminal_con=lambda x: x - g,
        u_mask=jnp.asarray(mask) if L.jax else torch.as_tensor(mask))


def _solve_both(make, T, nu=1, x0=(0.0, 0.0), jopts=J.ILQROptions(),
                us0=None, **warm):
    """The same problem solved by both packages -> (reference, port)."""
    us0 = np.zeros((T - 1, nu)) if us0 is None else np.asarray(us0)
    jprob, tprob = make(JL), make(TL)
    ref = jax.jit(lambda x, u: J.solve(jprob, x, u, jopts, **{
        k: jnp.asarray(v) for k, v in warm.items()}))(jnp.asarray(x0), us0)
    got = P.solve(tprob, torch.tensor(x0, dtype=F64), torch.tensor(us0),
                  convert.ilqr_options(jopts),
                  **{k: torch.as_tensor(np.asarray(v)) for k, v in
                     warm.items()})
    return ref, got


def _agree(ref, got):
    """The port's result is the reference's."""
    assert int(got.iterations) == int(ref.iterations)
    assert int(got.al_iterations) == int(ref.al_iterations)
    assert bool(got.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(got.objective), float(ref.objective),
                               rtol=1e-6)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), atol=1e-6)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(ref.xs), atol=1e-6)


def _riccati_gains(A, B, Q, R, QT, T):
    P_ = QT
    Ks = []
    for _ in range(T - 1):
        K = np.linalg.solve(R + B.T @ P_ @ B, B.T @ P_ @ A)
        P_ = Q + A.T @ P_ @ (A - B @ K)
        Ks.append(K)
    return Ks[::-1]


def test_lqr_matches_analytic():
    T = 20
    ref, got = _solve_both(lambda L: _lqr(L, T), T, x0=(1.0, 0.0))
    _agree(ref, got)
    A = np.array([[1.0, H], [0.0, 1.0]])
    B = np.array([[0.5 * H * H], [H]])
    x = np.array([1.0, 0.0])
    xs, us = [x], []
    for K in _riccati_gains(A, B, np.eye(2), 0.1 * np.eye(1),
                            10 * np.eye(2), T):
        us.append(-K @ x)
        x = A @ x + B @ us[-1]
        xs.append(x)
    np.testing.assert_allclose(got.us.numpy(), np.array(us), atol=1e-5)
    np.testing.assert_allclose(got.xs.numpy(), np.array(xs), atol=1e-5)


def test_terminal_equality_constraint():
    """Reach a goal state exactly via the AL loop."""
    T = 20
    ref, got = _solve_both(
        lambda L: _terminal_goal(L, T, [1.0, 0.0]), T,
        jopts=J.ILQROptions(con_tol=1e-4, obj_tol=1e-8, grad_tol=1e-8))
    _agree(ref, got)
    assert bool(got.converged)
    np.testing.assert_allclose(got.xs[-1].numpy(), [1.0, 0.0], atol=1e-3)


def test_control_inequality_constraint():
    """Box-limited controls |u| <= 0.3 via AL inequality rows."""
    T = 25
    ref, got = _solve_both(lambda L: _box(L, T), T, jopts=J.ILQROptions(
        con_tol=1e-3, obj_tol=1e-8, grad_tol=1e-6))
    _agree(ref, got)
    assert bool(got.converged)
    np.testing.assert_allclose(got.xs[-1].numpy(), [0.4, 0.0], atol=5e-3)
    assert float(got.us.abs().max()) <= 0.3 + 2e-3


def test_rollout_shapes():
    T = 10
    prob = _lqr(TL, T)
    us = torch.ones((T - 1, 1), dtype=F64)
    xs = P.rollout(prob, torch.zeros(2, dtype=F64), us)
    assert xs.shape == (T, 2)
    ref = J.rollout(_lqr(JL, T), jnp.zeros(2), jnp.ones((T - 1, 1)))
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref), atol=1e-15)


def test_batch_of_goals_matches_vmapped_reference():
    """The reference vmaps its whole solve over goals; the port solves
    each goal with the scalar ``solve`` and matches every lane."""
    T = 15
    goals = np.array([[1.0, 0.0], [-0.5, 0.0], [0.3, 0.1], [2.0, -0.2]])
    jopts = J.ILQROptions(con_tol=1e-4)

    def jsolve(goal):
        prob = _terminal_goal(JL, T, [0.0, 0.0])._replace(
            terminal_con=lambda x: x - goal)
        return J.solve(prob, jnp.zeros(2), jnp.zeros((T - 1, 1)), jopts)

    ref = jax.jit(jax.vmap(jsolve))(jnp.asarray(goals))
    for i, goal in enumerate(goals):
        got = P.solve(_terminal_goal(TL, T, goal), torch.zeros(2, dtype=F64),
                      torch.zeros((T - 1, 1), dtype=F64),
                      convert.ilqr_options(jopts))
        _agree(jax.tree_util.tree_map(lambda a: a[i], ref), got)
        assert bool(got.converged)
        np.testing.assert_allclose(got.xs[-1].numpy(), goal, atol=1e-3)


def test_dual_warm_start_resolve():
    """Re-solving a nearby problem from the previous duals and penalty
    (``ILQRResult.lam/lamT/rho``) converges in fewer AL rounds than cold."""
    T = 25
    jopts = J.ILQROptions(con_tol=1e-3, obj_tol=1e-8, grad_tol=1e-6)
    ref, res = _solve_both(lambda L: _box(L, T), T, jopts=jopts)
    _agree(ref, res)
    assert res.lam.shape == (T - 1, 2) and res.lamT.shape == (2,)
    np.testing.assert_allclose(res.lam.numpy(), np.asarray(ref.lam),
                               atol=1e-6)
    x0p = (0.005, 0.0)
    warm = dict(lam_init=res.lam.numpy(), lamT_init=res.lamT.numpy(),
                rho_init=res.rho.numpy())
    ref_w, res_w = _solve_both(lambda L: _box(L, T), T, x0=x0p, jopts=jopts,
                               us0=res.us.numpy(), **warm)
    _agree(ref_w, res_w)
    _, res_c = _solve_both(lambda L: _box(L, T), T, x0=x0p, jopts=jopts,
                           us0=res.us.numpy())
    assert bool(res_w.converged) and bool(res_c.converged)
    assert int(res_w.al_iterations) <= int(res_c.al_iterations)
    assert int(res_w.al_iterations) <= 2
    np.testing.assert_allclose(res_w.xs[-1].numpy(), [0.4, 0.0], atol=5e-3)


@pytest.mark.parametrize("case", ["riccati", "linesearch", "masked"])
def test_parallel_options_match_sequential(case):
    """``parallel_riccati`` (the doubling scan) and ``parallel_linesearch``
    (the step-size grid as one lane-batched rollout) give the sequential
    solve's controls to 1e-7, and the reference's parallel solve; the
    masked case never actuates its inert control."""
    make, T, nu = ((_masked, 15, 2) if case == "masked"
                   else (_nonquadratic, 20, 1))
    kw = {"linesearch": dict(parallel_linesearch=True)}.get(
        case, dict(parallel_riccati=True))
    jseq = J.ILQROptions(con_tol=1e-5)
    jpar = dataclasses.replace(jseq, **kw)
    _, seq = _solve_both(make, T, nu=nu, jopts=jseq)
    ref, par = _solve_both(make, T, nu=nu, jopts=jpar)
    _agree(ref, par)
    if case != "linesearch":
        assert bool(seq.converged) and bool(par.converged)
    np.testing.assert_allclose(par.us.numpy(), seq.us.numpy(), atol=1e-7)
    if case == "masked":
        assert float(par.us[:, 1].abs().max()) == 0.0


def test_short_horizon_cartpole_solve_matches_jax():
    """An implicit-dynamics solve: the cartpole friction model over T=6,
    from rest to the state that controls of 0.5 reach, wired as the
    example wires it (open-loop carry, cold line-search steps, the
    derivative sweep in one batched grad solve); objective rtol 1e-6,
    controls atol 1e-6, identical iterations and convergence."""
    from optimization_dynamics_tpu.dynamics import (
        make_implicit_dynamics as jax_dynamics)
    from optimization_dynamics_tpu.models import cartpole as jcp
    from optimization_dynamics_tpu_torch.dynamics import (
        make_implicit_dynamics)
    from optimization_dynamics_tpu_torch.models import cartpole as tcp
    T = 6
    jaux = jcp.CartpoleAux(h=0.05, friction=jnp.asarray([0.35, 0.35]))
    taux = convert.cartpole_aux(jaux, "cpu", F64)
    kw = dict(r_tol=1e-8, kappa_eval_tol=1e-4, kappa_grad_tol=1e-3)
    jd = jax_dynamics(jcp.friction_model(), **kw)
    td = make_implicit_dynamics(tcp.friction_model(), "cpu", F64, **kw)
    x = np.zeros(4)
    for _ in range(T - 1):
        x = np.asarray(jd.step(x, np.array([0.5]), jaux))
    goal = x

    def make(L):
        d, aux = (jd, jaux) if L.jax else (td, taux)
        g = L.arr(goal)
        prob = L.ilqr.ILQRProblem(
            T=T, nx=4, nu=1, ncon=0, nconT=4,
            dynamics=lambda t, x, u: d.step(x, u, aux),
            dynamics_jac=lambda t, x, u: d.step_jac(x, u, aux),
            dynamics_carry=lambda t, x, u, z: d.step_carry(z, x, u, aux),
            carry_init=d.carry_init,
            stage_cost=lambda t, x, u: u @ u,
            terminal_cost=lambda x: (x - g) @ (x - g),
            terminal_con=lambda x: x - g)
        return prob._replace(
            dynamics_jac_batched=lambda ts, xs, us: d.step_jac_batched(
                xs, us, aux))

    ref, got = _solve_both(make, T, x0=(0.0, 0.0, 0.0, 0.0),
                           jopts=J.ILQROptions(con_tol=1e-3, obj_tol=1e-3))
    _agree(ref, got)
    assert bool(got.converged)
    assert math.isfinite(float(got.gradient_norm))


def test_acrobot_main_takes_initial_controls(tmp_path, monkeypatch):
    """``examples/acrobot.py --us-init FILE`` hands the file's controls to
    the scalar solve (how the reference's ``jax.random`` controls reach a
    run on the card), in the problem's dtype and device."""
    from optimization_dynamics_tpu_torch.examples import acrobot as ex

    got = {}

    def fake_solve(prob, x0, us0, opts):
        got["us0"] = us0
        raise SystemExit(0)

    monkeypatch.setattr(ex, "scalar_solve", fake_solve)
    us = np.random.default_rng(74).standard_normal((ex.T - 1, 1))
    np.save(tmp_path / "us.npy", us)
    with pytest.raises(SystemExit):
        ex.main(["--device", "cpu", "--us-init", str(tmp_path / "us.npy")])
    assert got["us0"].dtype == torch.float64
    np.testing.assert_array_equal(got["us0"].numpy(), us)


def test_profile_scalar_needs_a_card(monkeypatch):
    """The scalar profile parses its models and stops without a card."""
    from optimization_dynamics_tpu_torch.scripts import profile_scalar

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_scalar.main(["--model", "rocket"])
    with pytest.raises(SystemExit):
        profile_scalar.main(["--model", "pendulum"])
