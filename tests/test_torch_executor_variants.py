"""Port parity: the segmented executor's options against the JAX
package's same options, part 1: the full-grid line search and k inner
iterations a call.

The problem is the reference tests' acrobot regulation near the joint
limit with a terminal equality constraint (``_acrobot_con_problem``,
``tests/test_ilqr_segmented.py``: T=8, h=0.05), B=4 scenarios from a
numpy seed, float64, a budget of two AL rounds of at most 6 inner
iterations (the port's CPU acrobot solves take about a second an inner
iteration). The other options are in ``test_torch_executor_kscan.py``,
``test_torch_executor_lane_alpha.py`` and
``test_torch_executor_compaction.py``, which share this file's helpers.
Each option is held to the reference's same option: flags,
iterations and ``solve.stats`` identical, controls within 1e-10. The
decision-identical options are also held to the port's own line-search
cascade: flags and counts identical, controls within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.solver.ilqr import (
    ILQROptions as JaxILQROptions,
)
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import acrobot
from optimization_dynamics_tpu_torch.solver.ilqr import ILQRProblem
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

from tests.test_ilqr_segmented import _acrobot_con_problem

torch.set_num_threads(1)

F64 = torch.float64
T_AC = 8
OPTS = JaxILQROptions(max_iter=6, max_al_iter=2, con_tol=1e-2)

def torch_acrobot_con_problem(T=T_AC):
    """The port's twin of the reference's ``_acrobot_con_problem``."""
    dyn = make_implicit_dynamics(acrobot.impact_model(), "cpu", F64)
    aux = acrobot.AcrobotAux(h=0.05)
    goal = torch.tensor([0.2, 1.2, 0.2, 1.2], dtype=F64)
    return ILQRProblem(
        T=T, nx=4, nu=1, ncon=0, nconT=4,
        dynamics_jac_batched=lambda ts, xs, us: dyn.step_jac_batched(
            xs, us, aux),
        dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux),
        stage_cost=lambda t, x, u: 0.5 * torch.sum(u * u)
        + 0.5 * torch.sum((x - goal) ** 2),
        terminal_cost=lambda x: 5.0 * torch.sum((x - goal) ** 2),
        terminal_con=lambda x: x - goal)

def acrobot_x0s(B, seed, scale):
    rng = np.random.default_rng(seed)
    return (np.tile([0.1, 1.0, 0.1, 1.0], (B, 1))
            + scale * rng.standard_normal((B, 4)))

def port_solve(x0s, opts=OPTS, **kw):
    """The port's segmented solver with the options ``kw``: (result,
    stats, log lines, solver)."""
    logs = []
    ts = make_segmented_solver(torch_acrobot_con_problem(),
                               convert.ilqr_options(opts), x0s.shape[0],
                               F64, "cpu", log=logs.append, **kw)
    rt = ts(torch.as_tensor(x0s), torch.zeros((T_AC - 1, 1), dtype=F64))
    return rt, dict(ts.stats), logs, ts

def run_both(x0s, opts=OPTS, **kw):
    """The reference's and the port's segmented solvers with the options
    ``kw`` on the same scenarios: (port result, port stats, port log,
    reference result, reference stats)."""
    B = x0s.shape[0]
    us0 = np.zeros((T_AC - 1, 1))
    js = jax_segmented_solver(_acrobot_con_problem(T_AC)[0], opts, B,
                              dtype=jnp.float64, **kw)
    rj = js(jnp.asarray(x0s), jnp.asarray(us0))
    rt, st, logs, ts = port_solve(x0s, opts, **kw)
    return rt, st, logs, rj, dict(js.stats), ts

def assert_matches_jax(rt, st, rj, sj, tol=1e-10):
    for f in ("converged", "iterations", "al_iterations"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert st == sj
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=tol)
    np.testing.assert_allclose(rt.objective.numpy(),
                               np.asarray(rj.objective), rtol=1e-8)

def assert_same_decisions(ra, rb, tol=1e-12):
    for f in ("converged", "iterations"):
        np.testing.assert_array_equal(getattr(ra, f).numpy(),
                                      getattr(rb, f).numpy(), err_msg=f)
    np.testing.assert_allclose(ra.us.numpy(), rb.us.numpy(), atol=tol)

def depths(logs):
    """The first entry of each inner line's ``depth=[...]``: iterations
    whose line search ended at its first rung."""
    import re
    return [int(m.group(1)) for m in
            (re.search(r"depth=\[(\d+)", s) for s in logs if "inner" in s)
            if m]

X0S = acrobot_x0s(4, seed=0, scale=0.05)

@pytest.fixture(scope="module")
def cascade():
    """The port's default executor (the line-search cascade) on X0S,
    against the reference's."""
    rt, st, logs, rj, sj, _ = run_both(X0S)
    assert_matches_jax(rt, st, rj, sj)
    return rt, logs

def test_cascade_matches_jax_and_logs_depth(cascade):
    rt, logs = cascade
    # the cheap first rung fires, and the log names the depths
    assert any(d > 0 for d in depths(logs)), logs
    assert bool(torch.isfinite(rt.xs).all())

def test_single_stage_ls_matches_jax_and_cascade(cascade):
    """``two_stage_ls=False``: the full grid in one call an iteration."""
    rt, st, logs, rj, sj, _ = run_both(X0S, two_stage_ls=False)
    assert_matches_jax(rt, st, rj, sj)
    assert_same_decisions(rt, cascade[0])
    n_alpha = int(np.ceil(np.log2(1.0 / OPTS.alpha_min))) + 1
    assert st["roll_lanes"] == 4 + n_alpha * st["sweep_lanes"]
    assert all("depth=None" in s for s in logs if "inner" in s)

def test_iters_per_dispatch_matches_jax_and_cascade(cascade):
    """k=4 inner iterations a call with the two-stage choice in each;
    the budget of 6 straddles a chunk (4 + 2). The reference records no
    sweep or rollout lanes on this path, and neither does the port."""
    rt, st, logs, rj, sj, _ = run_both(X0S, iters_per_dispatch=4)
    assert_matches_jax(rt, st, rj, sj)
    assert st == {"roll_lanes": 4}
    assert_same_decisions(rt, cascade[0])
    np.testing.assert_allclose(rt.gradient_norm.numpy(),
                               cascade[0].gradient_norm.numpy(), rtol=1e-9)
    assert any("inner chunk=1 (k=4)" in s for s in logs), logs
