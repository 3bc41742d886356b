"""Port parity: the segmented executor's options against the JAX
package's same options, part 2: k inner iterations a call with the full
grid alone, a per-round schedule that straddles the chunks, and the AL
straggler policy's ``al_stall_improve``. The problem, scenarios and
checks are ``test_torch_executor_variants.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_executor_variants import (
    OPTS, X0S, assert_matches_jax, assert_same_decisions, port_solve,
    run_both)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cascade():
    """The port's line-search cascade on X0S (held to the reference's in
    ``test_torch_executor_variants.py``)."""
    return port_solve(X0S)[0]


def test_iters_per_dispatch_full_grid_matches_jax_and_cascade(cascade):
    """k=4 with ``two_stage_ls=False``: the full grid every iteration,
    the same decisions."""
    rt, st, _, rj, sj, _ = run_both(X0S, iters_per_dispatch=4,
                                    two_stage_ls=False)
    assert_matches_jax(rt, st, rj, sj)
    assert st == {"roll_lanes": 4}
    assert_same_decisions(rt, cascade)


def test_iters_per_dispatch_honours_the_schedule():
    """A per-round schedule whose budgets straddle the chunks (3, then
    5 with k=4): the same counts as the reference's k-scan, and no lane
    past 3 + 5 inner iterations."""
    opts = dataclasses.replace(OPTS, max_iter=10)
    rt, st, _, rj, sj, _ = run_both(X0S, opts=opts, iters_per_dispatch=4,
                                    max_iter_schedule=[3, 5])
    assert_matches_jax(rt, st, rj, sj)
    assert int(rt.iterations.max()) <= 8
    assert int(rt.iterations.max()) > 3


def test_al_stall_improve_matches_jax():
    """An unreachable con_tol with the penalty capped after one round
    and a budget of 20 rounds: with ``al_stall_improve=0.1`` a lane whose
    violation falls by less than 10x in round 2 counts as not improving
    and is dropped there, in both packages alike."""
    opts = dataclasses.replace(OPTS, max_iter=3, max_al_iter=20,
                               con_tol=1e-9, rho_max=10.0)
    rt, st, logs, rj, sj, _ = run_both(X0S, opts=opts, al_stall_rounds=1,
                                       al_stall_improve=0.1)
    assert_matches_jax(rt, st, rj, sj)
    assert any(s.startswith("al round 2: dropping") for s in logs), logs
    assert not bool(rt.converged.any())
    np.testing.assert_allclose(rt.constraint_violation.numpy(),
                               np.asarray(rj.constraint_violation),
                               rtol=1e-8)
