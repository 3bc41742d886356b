"""Port parity: the segmented executor's options against the JAX
package's same options, part 3: one alpha a lane a rung
(``per_lane_alpha=True``), with ``alpha_memory``, and the option
combination the reference refuses. The problem, scenarios and checks are
``test_torch_executor_variants.py``'s.
"""

import pytest
import torch

from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)
from optimization_dynamics_tpu_torch.utils import convert

from tests.test_torch_executor_variants import (
    OPTS, X0S, assert_matches_jax, assert_same_decisions, depths,
    port_solve, run_both, torch_acrobot_con_problem)

torch.set_num_threads(1)


def test_per_lane_alpha_matches_jax_and_cascade():
    """Rung r at grid index r: the full grid's pick, one alpha a lane a
    rung; most iterations end at the first rung."""
    cascade = port_solve(X0S)[0]
    rt, st, logs, rj, sj, ts = run_both(X0S, per_lane_alpha=True)
    assert_matches_jax(rt, st, rj, sj)
    assert_same_decisions(rt, cascade)
    assert any(d > 0 for d in depths(logs)), logs
    # the solver is reusable: fresh per-solve line-search state
    r2 = ts(torch.as_tensor(X0S) + 0.01,
            torch.zeros((7, 1), dtype=torch.float64))
    assert bool(torch.isfinite(r2.xs).all())


def test_alpha_memory_matches_jax():
    """Each lane starts where it accepted last: not decision-identical
    to the grid, but the reference's same decisions."""
    rt, st, _, rj, sj, _ = run_both(X0S, per_lane_alpha=True,
                                    alpha_memory=True)
    assert_matches_jax(rt, st, rj, sj)
    assert bool(torch.isfinite(rt.xs).all())


@pytest.mark.parametrize("kw", [dict(iters_per_dispatch=2),
                                dict(two_stage_ls=False)])
def test_per_lane_alpha_needs_the_cascade(kw):
    with pytest.raises(ValueError):
        make_segmented_solver(torch_acrobot_con_problem(),
                              convert.ilqr_options(OPTS), 4,
                              torch.float64, "cpu", per_lane_alpha=True,
                              **kw)
