"""Port parity: the batched AL-iLQR phase functions against the JAX
package, on the cartpole deploy problem cut to T=6, B=4, in float64.

Both packages run the same phase arithmetic on the same inputs; the IP
solves inside agree to ~1e-12 (QR against LU), so the rollouts,
expansions, gains and line-search candidates agree to atol 1e-8. A
backward pass whose Quu is not positive definite must report
``ok=False`` for that lane (NaN gains, as the reference's Cholesky
gives), not raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optimization_dynamics_tpu.examples import cartpole as jex
from optimization_dynamics_tpu.solver.ilqr_batched import (
    make_phases as jax_make_phases,
)
from optimization_dynamics_tpu_torch.examples import cartpole as tex
from optimization_dynamics_tpu_torch.solver.ilqr_batched import make_phases

torch.set_num_threads(1)

T, B = 6, 4
ATOL = 1e-8


@pytest.fixture(scope="module")
def both():
    jprob, x0, us0, jopts = jex.build_deploy_problem(False,
                                                     dtype=jnp.float64)
    tprob, _, _, topts = tex.build_deploy_problem("cpu")
    jph = jax_make_phases(jprob._replace(T=T), jopts, B, jnp.float64)
    tph = make_phases(tprob._replace(T=T), topts, B, torch.float64, "cpu")
    rng = np.random.default_rng(0)
    x0s = np.asarray(x0) + 0.05 * rng.standard_normal((B, 4))
    uss = 0.5 * rng.standard_normal((B, T - 1, 1))
    lams = np.zeros((B, T - 1, 1))
    lamTs = rng.standard_normal((B, 4))
    rhos = np.array([1.0, 10.0, 100.0, 1.0])
    # the JAX phases index with traced time steps: hand them jnp arrays
    return jph, tph, {k: jnp.asarray(v) for k, v in dict(
        x0s=x0s, uss=uss, lams=lams, lamTs=lamTs, rhos=rhos).items()}


def _close(got, ref, atol=ATOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, atol)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(ref), atol=atol, rtol=1e-8)


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def test_rollout_costs_and_derivatives(both):
    jph, tph, d = both
    xss_j, wss_j = jph.rollout_open(d["x0s"], d["uss"])
    xss_t, wss_t = tph.rollout_open(*_t(d["x0s"], d["uss"]))
    _close((xss_t, wss_t), (xss_j, wss_j))
    args = (d["lams"], d["lamTs"], d["rhos"])
    _close(tph.traj_cost(xss_t, *_t(d["uss"], *args)),
           jph.traj_cost(xss_j, d["uss"], *args))
    _close(tph.smooth_cost(xss_t, *_t(d["uss"])),
           jph.smooth_cost(xss_j, d["uss"]))
    _close(tph.derivatives(xss_t, *_t(d["uss"], *args), wss_t),
           jph.derivatives(xss_j, d["uss"], *args, wss_j))


def test_backward_and_line_search_prep(both):
    jph, tph, d = both
    xss_j, wss_j = jph.rollout_open(d["x0s"], d["uss"])
    xss_t, wss_t = tph.rollout_open(*_t(d["x0s"], d["uss"]))
    args = (d["lams"], d["lamTs"], d["rhos"])
    der_j = jph.derivatives(xss_j, d["uss"], *args, wss_j)
    der_t = tph.derivatives(xss_t, *_t(d["uss"], *args), wss_t)
    regs = jnp.full(B, 1e-6)
    bj = jph.backward_xla(*der_j, regs)
    bt = tph.backward_xla(*der_t, *_t(regs))
    _close(bt, bj)
    assert bool(bt[5].all())

    Js_j = jph.traj_cost(xss_j, d["uss"], *args)
    Js_t = tph.traj_cost(xss_t, *_t(d["uss"], *args))
    active = jnp.asarray([True, True, False, True])
    pj = jph.ls_prep(xss_j, d["uss"], Js_j, regs, *args, active, wss_j)
    pt = tph.ls_prep(xss_t, *_t(d["uss"]), Js_t, *_t(regs, *args, active),
                     wss_t)
    _close(pt[:6], pj[:6])
    _close(pt[6], pj[6])
    assert bool(pt[7]) == bool(pj[7])
    for rj, rt in zip(jph.ls_rungs, tph.ls_rungs):
        cj, covj = rj(xss_j, d["uss"], pj[0], pj[1], Js_j, pj[2], pj[3],
                      *args, wss_j, pj[6], active)
        ct, covt = rt(xss_t, *_t(d["uss"]), pt[0], pt[1], Js_t, pt[2],
                      pt[3], *_t(*args), wss_t, pt[6],
                      *_t(active))
        _close(ct, cj)
        assert bool(covt) == bool(covj)
    aj = jph.ls_apply(xss_j, d["uss"], Js_j, regs, wss_j, active, pj[6],
                      pj[4], pj[5])
    at = tph.ls_apply(xss_t, *_t(d["uss"]), Js_t, *_t(regs), wss_t,
                      *_t(active), pt[6], pt[4], pt[5])
    _close(at, aj)


def test_backward_flags_indefinite_quu(both):
    """A lane whose Quu is negative definite at one step gets ok=False
    and non-finite gains from that step back, in both packages; the
    other lanes are untouched."""
    jph, tph, d = both
    xss_j, wss_j = jph.rollout_open(d["x0s"], d["uss"])
    args = (d["lams"], d["lamTs"], d["rhos"])
    der = list(jph.derivatives(xss_j, d["uss"], *args, wss_j))
    der[5] = der[5].at[2, 3].set(-100.0)    # luus of lane 2 at t=3
    regs = jnp.full(B, 1e-6)
    bj = jph.backward_xla(*der, regs)
    bt = tph.backward_xla(*_t(*der), *_t(regs))
    np.testing.assert_array_equal(bt[5].numpy(), np.asarray(bj[5]))
    assert bt[5].tolist() == [True, True, False, True]
    assert not np.isfinite(bt[1].numpy()[2, :4]).any()
    _close(bt, bj)


def test_dual_update_and_violation(both):
    jph, tph, d = both
    xss_j, _ = jph.rollout_open(d["x0s"], d["uss"])
    xss_t, _ = tph.rollout_open(*_t(d["x0s"], d["uss"]))
    args = (d["lams"], d["lamTs"], d["rhos"])
    _close(tph.dual_update(xss_t, *_t(d["uss"], *args)),
           jph.dual_update(xss_j, d["uss"], *args))
    _close(tph.con_violation(xss_t, *_t(d["uss"])),
           jph.con_violation(xss_j, d["uss"]))
