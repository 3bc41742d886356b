"""Port parity: the lockstep ``solve_batched`` and ``solve_segmented``
against the JAX package.

The reference's own problems (``tests/test_ilqr_batched.py``): the
double-integrator LQR with a terminal equality constraint (B=6), the
acrobot contact regulation near the joint limit (T=8, B=4, no
constraints) and the same with same-timestep warm starts. Both packages
start from the same numpy-seeded scenarios; the reference's solves are
built once per module. ``solve_batched`` against the reference's
``solve_batched``: objective to rtol 1e-6, controls to atol 1e-6,
iterations, AL iterations and converged flags identical. The port's
``solve_segmented`` against the port's ``solve_batched`` on the same
problems, as the reference's ``test_segmented_*_matches_fused`` do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_make_implicit_dynamics,
)
from optimization_dynamics_tpu.models import acrobot as jax_acrobot
from optimization_dynamics_tpu.solver.ilqr import (
    ILQROptions as JaxILQROptions,
    ILQRProblem as JaxILQRProblem,
)
from optimization_dynamics_tpu.solver.ilqr_batched import (
    solve_batched as jax_solve_batched,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import acrobot
from optimization_dynamics_tpu_torch.solver.ilqr import ILQRProblem
from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
    solve_batched,
)
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
    solve_segmented,
)
from optimization_dynamics_tpu_torch.utils import convert

from tests.test_ilqr_batched import _lqr_problem

torch.set_num_threads(1)

F64 = torch.float64
T_AC, B_AC = 8, 4
GOAL_AC = np.array([0.2, 1.2, 0.2, 1.2])


def _compare(rt, rj, tol=1e-6):
    np.testing.assert_allclose(rt.objective.numpy(),
                               np.asarray(rj.objective), rtol=tol)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=tol)
    for f in ("iterations", "al_iterations", "converged"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)


def _torch_lqr_problem(T=15, h=0.1):
    A = torch.tensor([[1.0, h], [0.0, 1.0]], dtype=F64)
    Bm = torch.tensor([[0.5 * h * h], [h]], dtype=F64)
    goal = torch.tensor([1.0, 0.0], dtype=F64)

    def jac(ts, xs, us):
        n = xs.shape[0]
        return (xs @ A.T + us @ Bm.T, A.expand(n, 2, 2), Bm.expand(n, 2, 1))

    return ILQRProblem(
        T=T, nx=2, nu=1, ncon=0, nconT=2,
        dynamics_batched=lambda t, xs, us: xs @ A.T + us @ Bm.T,
        dynamics_jac_batched=jac,
        stage_cost=lambda t, x, u: 0.5 * torch.sum(u * u),
        terminal_cost=lambda x: torch.zeros((), dtype=F64),
        terminal_con=lambda x: x - goal)


def _jax_acrobot(warm: bool):
    dyn = jax_make_implicit_dynamics(jax_acrobot.impact_model())
    aux = jax_acrobot.AcrobotAux(h=0.05)
    goal = jnp.asarray(GOAL_AC)
    prob = JaxILQRProblem(
        T=T_AC, nx=4, nu=1, ncon=0, nconT=4,
        dynamics=lambda t, x, u: dyn.step(x, u, aux),
        dynamics_jac=lambda t, x, u: dyn.step_jac(x, u, aux),
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        stage_cost=lambda t, x, u: 0.5 * jnp.sum(u * u)
        + 0.5 * jnp.sum((x - goal) ** 2),
        terminal_cost=lambda x: 5.0 * jnp.sum((x - goal) ** 2))
    if warm:
        prob = prob._replace(
            dynamics_batched_ws=lambda t, xs, us, w: dyn.step_batched_ws(
                xs, us, aux, w),
            dynamics_jac_batched_ws=lambda ts, xs, us, w:
                dyn.step_jac_batched_ws(xs, us, aux, w),
            ws_init_batched=lambda t, xs, us: jax.vmap(dyn.carry_init)(xs))
    return prob


def _torch_acrobot(warm: bool):
    dyn = make_implicit_dynamics(acrobot.impact_model(), "cpu", F64)
    aux = acrobot.AcrobotAux(h=0.05)
    goal = torch.as_tensor(GOAL_AC)
    prob = ILQRProblem(
        T=T_AC, nx=4, nu=1, ncon=0, nconT=4,
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        stage_cost=lambda t, x, u: 0.5 * torch.sum(u * u)
        + 0.5 * torch.sum((x - goal) ** 2),
        terminal_cost=lambda x: 5.0 * torch.sum((x - goal) ** 2))
    if warm:
        prob = prob._replace(
            dynamics_batched_ws=lambda t, xs, us, w: dyn.step_batched_ws(
                xs, us, aux, w),
            dynamics_jac_batched_ws=lambda ts, xs, us, w:
                dyn.step_jac_batched_ws(xs, us, aux, w),
            ws_init_batched=lambda t, xs, us: dyn.carry_init(xs))
    return prob


def _acrobot_x0s(seed=1):
    rng = np.random.default_rng(seed)
    return (np.tile([0.1, 1.0, 0.1, 1.0], (B_AC, 1))
            + 0.05 * rng.standard_normal((B_AC, 4)))


AC_OPTS = JaxILQROptions(max_iter=15, obj_tol=1e-6, grad_tol=1e-6)
LQR_OPTS = JaxILQROptions(con_tol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """The reference's solve_batched on each problem, once."""
    out = {}
    lqr_x0s = 0.2 * np.random.default_rng(0).standard_normal((6, 2))
    prob = _lqr_problem()
    us0 = jnp.zeros((prob.T - 1, 1))
    out["lqr"] = (lqr_x0s, jax.jit(lambda x: jax_solve_batched(
        prob, x, us0, LQR_OPTS))(jnp.asarray(lqr_x0s)))
    x0s = _acrobot_x0s()
    us0 = jnp.zeros((T_AC - 1, 1))
    for warm in (False, True):
        p = _jax_acrobot(warm)
        out["acrobot_warm" if warm else "acrobot"] = (
            x0s, jax.jit(lambda x: jax_solve_batched(p, x, us0, AC_OPTS))(
                jnp.asarray(x0s)))
    return out


def test_lqr_matches_jax(ref):
    x0s, rj = ref["lqr"]
    prob = _torch_lqr_problem()
    opts = convert.ilqr_options(LQR_OPTS)
    us0 = torch.zeros((prob.T - 1, 1), dtype=F64)
    rt = solve_batched(prob, torch.as_tensor(x0s), us0, opts)
    _compare(rt, rj)
    assert bool(rt.converged.all())
    assert rt.al_iterations[0] > 1
    # the segmented executor on the same problem, as the reference's
    # test_segmented_lqr_matches_fused
    rs = solve_segmented(prob, torch.as_tensor(x0s), us0, opts)
    assert bool(rs.converged.all())
    np.testing.assert_allclose(rs.us.numpy(), rt.us.numpy(), atol=1e-5)
    np.testing.assert_allclose(rs.constraint_violation.numpy(),
                               rt.constraint_violation.numpy(), atol=1e-6)


@pytest.mark.parametrize("warm", [False, True])
def test_acrobot_contact_matches_jax(ref, warm):
    """The contact regulation without constraints: one inner solve,
    ``al_iterations`` 1, violation 0."""
    x0s, rj = ref["acrobot_warm" if warm else "acrobot"]
    prob = _torch_acrobot(warm)
    opts = convert.ilqr_options(AC_OPTS)
    us0 = torch.zeros((T_AC - 1, 1), dtype=F64)
    rt = solve_batched(prob, torch.as_tensor(x0s), us0, opts)
    _compare(rt, rj)
    assert bool(torch.isfinite(rt.xs).all())
    assert (rt.al_iterations == 1).all() and (rt.constraint_violation
                                              == 0).all()
    # segmented == lockstep on the same phases (the reference's
    # test_segmented_contact_matches_fused), and the solver is reusable
    solver = make_segmented_solver(prob, opts, B_AC, F64, "cpu")
    rs = solver(torch.as_tensor(x0s), us0)
    np.testing.assert_allclose(rs.objective.numpy(), rt.objective.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(rs.us.numpy(), rt.us.numpy(), atol=1e-6)
    r2 = solver(torch.as_tensor(x0s) + 0.01, us0)
    assert bool(torch.isfinite(r2.xs).all())


def test_warm_start_equals_cold(ref):
    """Same-timestep warm starts give the cold solve's objectives (the
    reference's test_batched_warm_start_matches_cold, on the port)."""
    x0s = torch.as_tensor(ref["acrobot"][0])
    opts = convert.ilqr_options(AC_OPTS)
    us0 = torch.zeros((T_AC - 1, 1), dtype=F64)
    rc = solve_batched(_torch_acrobot(False), x0s, us0, opts)
    rw = solve_batched(_torch_acrobot(True), x0s, us0, opts)
    np.testing.assert_allclose(rw.objective.numpy(), rc.objective.numpy(),
                               rtol=2e-2)


def test_shared_us_init_and_device_from_x0s():
    """``us_init`` (T-1, nu) is broadcast to the batch; a (B, T-1, nu)
    copy gives the same solve; the result lies on ``x0s``'s device and
    dtype."""
    prob = _torch_lqr_problem()
    opts = convert.ilqr_options(LQR_OPTS)
    x0s = torch.as_tensor(0.2 * np.random.default_rng(3)
                          .standard_normal((3, 2)))
    us0 = torch.zeros((prob.T - 1, 1), dtype=F64)
    r1 = solve_batched(prob, x0s, us0, opts)
    r2 = solve_batched(prob, x0s, us0[None].expand(3, -1, -1).clone(), opts)
    for f in r1._fields:
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    assert r1.xs.device == x0s.device and r1.xs.dtype == F64
