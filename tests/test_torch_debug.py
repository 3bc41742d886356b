"""Port parity: ``utils/debug.py`` and the determinism checks of
``tests/test_debug_determinism.py``.

* ``nan_guard`` raises ``FloatingPointError`` naming the first operator
  that made a NaN, only inside its block, and restores the modes before
  it on exit.
* ``check_finite`` gives the reference's per-lane flags on the same
  trees (integer fields ignored); ``assert_finite`` names the fields,
  as ``jax.tree_util.keystr`` writes them.
* Determinism, because converged trajectories are goldens: the acrobot
  ``step_jac`` and a small segmented contact solve give bit-identical
  results over two runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.utils import debug as jdebug
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import acrobot
from optimization_dynamics_tpu_torch.solver.ilqr import (ILQROptions,
                                                         ILQRProblem,
                                                         ILQRResult)
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver)
from optimization_dynamics_tpu_torch.utils.debug import (assert_finite,
                                                         check_finite,
                                                         nan_guard)
from torch.utils._python_dispatch import _get_current_dispatch_mode

torch.set_num_threads(1)
F64 = torch.float64
NAN, INF = float("nan"), float("inf")


def test_nan_guard_raises_at_source_and_restores():
    with pytest.raises(FloatingPointError, match="aten.log"):
        with nan_guard():
            torch.log(torch.zeros(3) - 1.0)
    assert _get_current_dispatch_mode() is None
    y = torch.log(torch.zeros(3) - 1.0)
    assert bool(torch.isnan(y).all())
    # clean work passes, uninitialised buffers are not results, inf is
    # not NaN, and enable=False checks nothing
    with nan_guard():
        torch.empty(64)
        z = torch.linalg.solve(torch.eye(3, dtype=F64),
                               torch.ones(3, dtype=F64))
        torch.full((2,), INF)
    assert torch.equal(z, torch.ones(3, dtype=F64))
    with nan_guard(enable=False):
        torch.log(torch.zeros(3) - 1.0)
    # nested inside another guard, the outer one is active again after
    with nan_guard():
        with nan_guard():
            pass
        with pytest.raises(FloatingPointError):
            torch.sqrt(-torch.ones(1))
    assert _get_current_dispatch_mode() is None


def _trees():
    rows = [[1.0, 2.0], [NAN, 0.0], [3.0, 4.0], [5.0, 6.0]]
    return [
        {"xs": np.array(rows), "obj": np.array([1.0, 2.0, INF, 0.5]),
         "its": np.array([1, 2, 3, 4])},
        {"xs": np.array(rows)[:, None, :].repeat(3, 1),
         "scalar": np.array(1.0), "other": np.array([1.0, 2.0])},
        {"xs": np.array(rows), "scalar": np.array(NAN)},
    ]


@pytest.mark.parametrize("case", range(3))
def test_check_finite_matches_jax(case):
    tree = _trees()[case]
    want = np.asarray(jdebug.check_finite(
        {k: jnp.asarray(v) for k, v in tree.items()}))
    got = check_finite({k: torch.as_tensor(v) for k, v in tree.items()})
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_check_finite_over_a_result():
    B = 4
    xs = torch.zeros(B, 3, 2, dtype=F64)
    xs[2, 1, 0] = NAN
    res = ILQRResult(xs=xs, us=torch.zeros(B, 2, 1, dtype=F64),
                     objective=torch.tensor([0.0, INF, 0.0, 0.0], dtype=F64),
                     al_objective=torch.zeros(B, dtype=F64),
                     iterations=torch.zeros(B, dtype=torch.int32),
                     al_iterations=torch.zeros(B, dtype=torch.int32),
                     constraint_violation=torch.zeros(B, dtype=F64),
                     gradient_norm=torch.zeros(B, dtype=F64),
                     converged=torch.ones(B, dtype=torch.bool))
    assert check_finite(res).tolist() == [True, False, False, True]
    with pytest.raises(ValueError):
        check_finite({"its": torch.arange(3)})


def test_assert_finite_names_fields_as_jax():
    tree = {"good": np.ones(2), "bad": np.array([NAN]),
            "also": np.array([INF, 1.0]), "n": np.array([1, 2])}
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite({k: jnp.asarray(v) for k, v in tree.items()})
    with pytest.raises(FloatingPointError) as got:
        assert_finite({k: torch.as_tensor(v) for k, v in tree.items()})
    assert str(got.value) == str(want.value)
    assert "['bad']" in str(got.value) and "['good']" not in str(got.value)
    with pytest.raises(FloatingPointError, match=r"\.xs"):
        assert_finite(ILQRResult(
            xs=torch.tensor([NAN]), us=torch.zeros(1), objective=torch.zeros(1),
            al_objective=torch.zeros(1), iterations=torch.zeros(1),
            al_iterations=torch.zeros(1), constraint_violation=torch.zeros(1),
            gradient_norm=torch.zeros(1), converged=torch.ones(1, dtype=bool)))
    assert_finite({"ok": torch.ones(3)})


def _impact():
    dyn = make_implicit_dynamics(acrobot.impact_model(), "cpu", F64)
    return dyn, acrobot.AcrobotAux(h=torch.tensor(0.05, dtype=F64))


def test_step_jac_deterministic():
    """Same inputs, bit-identical outputs over two calls."""
    dyn, aux = _impact()
    x = torch.tensor([0.1, -0.3, 0.15, -0.25], dtype=F64)
    u = torch.tensor([0.7], dtype=F64)
    a, b = dyn.step_jac(x, u, aux), dyn.step_jac(x, u, aux)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_segmented_solve_deterministic():
    """A small segmented contact solve (acrobot regulation, as the
    reference's determinism test): two runs, bit-identical results."""
    dyn, aux = _impact()
    T = 6
    goal = torch.tensor([0.2, 1.2, 0.2, 1.2], dtype=F64)
    prob = ILQRProblem(
        T=T, nx=4, nu=1, ncon=0, nconT=4,
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
        stage_cost=lambda t, x, u: 0.5 * torch.sum(u * u)
        + 0.5 * torch.sum((x - goal) ** 2),
        terminal_cost=lambda x: 5.0 * torch.sum((x - goal) ** 2),
        terminal_con=lambda x: x - goal)
    opts = ILQROptions(max_iter=4, max_al_iter=2, con_tol=1e-3)
    B = 4
    x0s = (torch.tensor([0.1, 1.0, 0.1, 1.0], dtype=F64)
           + 0.05 * torch.as_tensor(
               np.random.default_rng(1).standard_normal((B, 4))))
    us0 = torch.zeros(T - 1, 1, dtype=F64)
    run = make_segmented_solver(prob, opts, B, F64, "cpu")
    r1 = run(x0s, us0)
    stats1 = dict(run.stats)
    r2 = run(x0s, us0)
    assert stats1 == dict(run.stats)
    for f in r1._fields:
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    assert bool(check_finite(r1).all())
