"""Port parity: ``ILQRProblem.ws_carry`` against the JAX package.

The cartpole deploy problem (float64, the CPU IP settings, cold
line-search rollouts as the deploy sets them) cut to T=11, with
``ws_carry=True`` on both sides: each rollout step warm-starts from the
same rollout's previous step. The open-loop rollout's states and solver
variables against the reference's phase; then the segmented executor at
B=4 (``compact=False``, one AL round of three inner iterations):
objective to rtol 1e-6, controls to atol 1e-6, ``solve.stats`` and
counts identical. The carry changes the rollouts (the solver variables
differ from the cold start's), and ``rollout_fused`` refuses it, as the
reference asserts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import cartpole as jex
from optimization_dynamics_tpu.solver.ilqr_batched import (
    make_phases as jax_make_phases,
)
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver,
)
from optimization_dynamics_tpu_torch.examples import cartpole as tex
from optimization_dynamics_tpu_torch.solver.ilqr_batched import make_phases
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)

torch.set_num_threads(1)

F64 = torch.float64
T_SHORT, B = 11, 4


@pytest.fixture(scope="module")
def problems():
    jprob, _, jus0, jopts = jex.build_deploy_problem(False,
                                                     dtype=jnp.float64)
    tprob, tx0, tus0, topts = tex.build_deploy_problem("cpu")
    assert jprob.ws_linesearch is False and tprob.ws_linesearch is False
    jprob = jprob._replace(T=T_SHORT, ws_carry=True)
    tprob = tprob._replace(T=T_SHORT, ws_carry=True)
    x0s = tex.deploy_x0s(tx0, B, seed=0)
    return jprob, tprob, jopts, topts, x0s, tus0[:T_SHORT - 1]


def test_open_rollout_carries_matches_jax(problems):
    jprob, tprob, jopts, topts, x0s, us0 = problems
    uss = us0[None].expand(B, -1, -1).contiguous()
    xt, wt = make_phases(tprob, topts, B, F64, "cpu").rollout_open(x0s, uss)
    xj, wj = jax_make_phases(jprob, jopts, B, jnp.float64).rollout_open(
        jnp.asarray(x0s.numpy()), jnp.asarray(uss.numpy()))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-8)
    # the carry is read: a cold-started rollout ends on other variables
    _, w_cold = make_phases(tprob._replace(ws_carry=False), topts, B, F64,
                            "cpu").rollout_open(x0s, uss)
    assert float((w_cold - wt).abs().max()) > 0


def test_segmented_solve_with_carry_matches_jax(problems):
    jprob, tprob, jopts, topts, x0s, us0 = problems
    jopts = dataclasses.replace(jopts, max_al_iter=1)
    topts = dataclasses.replace(topts, max_al_iter=1)
    js = jax_segmented_solver(jprob, jopts, B, dtype=jnp.float64,
                              compact=False, max_iter_schedule=[3])
    rj = js(jnp.asarray(x0s.numpy()), jnp.asarray(us0.numpy()))
    ts = make_segmented_solver(tprob, topts, B, F64, "cpu", compact=False,
                               max_iter_schedule=[3])
    rt = ts(x0s, us0)
    np.testing.assert_allclose(rt.objective.numpy(),
                               np.asarray(rj.objective), rtol=1e-6)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-6)
    for f in ("iterations", "al_iterations", "converged"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert dict(ts.stats) == dict(js.stats)
    assert ts.stats["inner_iters"] == 3


def test_fused_rollout_refuses_the_carry(problems):
    tprob, topts = problems[1], problems[3]
    with pytest.raises(ValueError, match="ws_carry"):
        make_phases(tprob._replace(rollout_fused=lambda *a: None), topts,
                    B, F64, "cpu")
