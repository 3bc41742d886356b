"""Port parity: ``utils/profiling.py`` and the executor's phase timers.

The port's counterpart of ``tests/test_ilqr_segmented.py::
test_phase_timers``: the same LQR problem and lanes, ``PhaseTimer``
threaded through ``make_segmented_solver``; every phase the reference
names is timed, the calls of the phases that run once an iteration or a
round equal the reference's executor's on the same problem (which deeper
rungs run follows Armijo ties at the solution), and
``host_and_dispatch_s`` is the given total less the timed phases. A compacted solve names its narrow phases ``@<W>`` as
the reference does. With ``timers=None`` the executor's result and
counters equal a timed run's. ``trace`` writes a Chrome trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optimization_dynamics_tpu.solver.ilqr import ILQROptions as JaxOptions
from optimization_dynamics_tpu.solver.ilqr_segmented import (
    make_segmented_solver as jax_segmented_solver)
from optimization_dynamics_tpu.utils.profiling import PhaseTimer as JaxTimer
from optimization_dynamics_tpu_torch.solver.ilqr import (ILQROptions,
                                                         ILQRProblem)
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver)
from optimization_dynamics_tpu_torch.utils.profiling import (
    PhaseTimer, annotate, block_until_ready, trace)

from tests.test_ilqr_batched import _lqr_problem

torch.set_num_threads(1)
F64 = torch.float64


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
        terminal_con=lambda x: x - goal,
    )


def _lanes(B, scale=0.2):
    x0s = scale * jax.random.normal(jax.random.PRNGKey(4), (B, 2))
    return x0s, torch.as_tensor(np.array(x0s))


def test_phase_timers_match_jax():
    B = 4
    jx0s, tx0s = _lanes(B)
    jt, tt = JaxTimer(), PhaseTimer()
    jrun = jax_segmented_solver(_lqr_problem(), JaxOptions(con_tol=1e-5), B,
                                dtype=jx0s.dtype, timers=jt)
    jres = jrun(jx0s, jnp.zeros((14, 1)))
    trun = make_segmented_solver(_torch_lqr_problem(),
                                 ILQROptions(con_tol=1e-5), B, F64, "cpu",
                                 timers=tt)
    tres = trun(tx0s, torch.zeros(14, 1, dtype=F64))
    assert bool(tres.converged.all()) and bool(jnp.all(jres.converged))
    np.testing.assert_allclose(tres.us.numpy(), np.asarray(jres.us),
                               atol=1e-8)

    rep = tt.report(total_s=sum(tt.times.values()) + 0.5)
    for phase in ("rollout_open", "traj_cost", "ls_prep+slice0",
                  "ls_apply", "al_round", "finish"):
        assert phase in rep["phases_s"], rep
        assert rep["phase_calls"][phase] >= 1
    assert abs(rep["host_and_dispatch_s"] - 0.5) < 1e-6
    assert rep["total_wall_s"] == round(sum(tt.times.values()) + 0.5, 3)
    assert list(rep["phases_s"].values()) == sorted(
        rep["phases_s"].values(), reverse=True)
    # the same report keys and phase names as the reference's (which
    # deeper rungs run follows Armijo ties at the solution, so the calls
    # per rung are not compared)
    jrep = jt.report(total_s=sum(jt.times.values()) + 0.5)
    assert set(rep) == set(jrep)
    assert abs(jrep["host_and_dispatch_s"] - 0.5) < 1e-6
    rungs = lambda t: {k for k in _names(t) if k.startswith("ls_rung")}
    assert _names(tt) - rungs(tt) == _names(jt) - rungs(jt)
    assert rungs(tt) <= {"ls_rung1", "ls_rung2", "ls_rung3"} >= rungs(jt)
    for phase in ("rollout_open", "traj_cost", "ls_prep+slice0",
                  "ls_apply", "al_round", "finish"):
        assert rep["phase_calls"][phase] == jrep["phase_calls"][phase]


def _names(timer):
    """A timer's phase names without their widths."""
    return {k.split("@")[0] for k in timer.counts}


def test_timers_off_changes_nothing_and_compacted_names():
    """B=32: the active lanes compact to width 8; its phases carry
    ``@8``, as the reference's. The untimed solve gives the timed one's
    result bit for bit and the same counters."""
    B = 32
    jx0s, tx0s = _lanes(B, scale=0.5)
    opts = ILQROptions(con_tol=1e-5)
    tt = PhaseTimer()
    timed = make_segmented_solver(_torch_lqr_problem(), opts, B, F64, "cpu",
                                  timers=tt)
    plain = make_segmented_solver(_torch_lqr_problem(), opts, B, F64, "cpu")
    us0 = torch.zeros(14, 1, dtype=F64)
    r1, r2 = timed(tx0s, us0), plain(tx0s, us0)
    for f in r1._fields:
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    assert dict(timed.stats) == dict(plain.stats)

    jt = JaxTimer()
    jrun = jax_segmented_solver(_lqr_problem(), JaxOptions(con_tol=1e-5), B,
                                dtype=jx0s.dtype, timers=jt)
    jrun(jx0s, jnp.zeros((14, 1)))
    vocab = {"rollout_open", "traj_cost", "ls_prep+slice0", "ls_apply",
             "al_round", "finish"} | {"ls_rung%d" % i for i in (1, 2, 3)}
    assert _names(tt) <= vocab and _names(jt) <= vocab
    at8 = lambda t: {k for k in t.counts if k.endswith("@8")}
    assert at8(tt) and at8(jt)
    assert all(k.split("@")[0].startswith("ls_") for k in at8(tt))


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(8, 8, dtype=F64)
    with trace(str(tmp_path)):
        with annotate("odt_region"):
            block_until_ready(x @ x)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "odt_region" for e in events)
