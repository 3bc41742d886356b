"""Port parity: K4, the fused closed-loop rollout, against the JAX package.

The port's wrapper on CPU tensors runs its plain version
(``fused_rollout_plain``: the rollout step by step through K1's plain
IP solve). It is held to

* the reference's Pallas kernel in interpret mode, float32, with the
  tolerances of the reference's own kernel test (us and xs atol 2e-4,
  ws atol 5e-3);
* the reference's scan rollout (``make_phases(...).closed_loop``, cold
  per-step starts) in float64, atol 1e-10, with every control active and
  with a ragged ``u_mask`` (a masked step keeps ``u_ref`` exactly);
* and, in a phase integration, the reference's phases with its fused
  rollout and Pallas Riccati pass on one line-search cascade, float32,
  with the reference test's tolerances (xs atol 5e-3, Js rtol 1e-3).

Inputs come from numpy seeds. T=6, B=4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_make_implicit_dynamics,
)
from optimization_dynamics_tpu.examples import cartpole as jex
from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu.ops.pallas.fused_rollout import (
    make_fused_rollout as jax_make_fused_rollout,
)
from optimization_dynamics_tpu.solver.ilqr import ILQROptions as JOptions
from optimization_dynamics_tpu.solver.ilqr import ILQRProblem as JProblem
from optimization_dynamics_tpu.solver.ilqr_batched import (
    make_phases as jax_make_phases,
)
from optimization_dynamics_tpu.solver.interior_point import (
    IPOptions as JIPOptions,
)
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.examples import cartpole as tex
from optimization_dynamics_tpu_torch.models import cartpole as tcp
from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
    fused_rollout,
    make_fused_rollout,
)
from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
    riccati_backward,
)
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
)
from optimization_dynamics_tpu_torch.solver.ilqr_batched import make_phases
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions

torch.set_num_threads(1)

T, B = 6, 4
NQ, NU = 2, 1
NX = 2 * NQ
NZ = 10
OPTS = dict(r_tol=3.0e-5, kappa_tol=1.0e-3, max_iter=40, max_ls=8)
F32, F64 = torch.float32, torch.float64


def _inputs(seed=0):
    """x0s, xss_ref, uss_ref, Kss, kss, alphas (numpy), as the reference's
    kernel test draws them."""
    rng = np.random.RandomState(seed)
    x0s = 0.1 * rng.randn(B, NX)
    uss = 0.5 * rng.randn(B, T - 1, NU)
    xss_ref = 0.1 * rng.randn(B, T, NX)
    Kss = 0.1 * rng.randn(B, T - 1, NU, NX)
    kss = 0.2 * rng.randn(B, T - 1, NU)
    alphas = rng.rand(B)
    return x0s, xss_ref, uss, Kss, kss, alphas


def _port_rollout(dtype, ip, u_mask=None):
    model = tcp.friction_model()
    aux = tcp.CartpoleAux(h=0.05, friction=torch.tensor([0.35, 0.35],
                                                        dtype=dtype))
    return make_fused_rollout(model, IPOptions(**ip), aux, T, u_mask, "cpu",
                              dtype)


def _t(arrays, dtype):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _close(got, ref, atol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(r, np.float64), atol=atol,
                                   rtol=0)


def test_plain_matches_jax_kernel_f32():
    args = _inputs()
    jroll = jax_make_fused_rollout(
        jcp.friction_model(), JIPOptions(**OPTS),
        jcp.CartpoleAux(h=0.05, friction=jnp.asarray([0.35, 0.35],
                                                     jnp.float32)),
        T, interpret=True)
    xs_j, us_j, ws_j = jroll(*(jnp.asarray(a, jnp.float32) for a in args))
    xs_t, us_t, ws_t = _port_rollout(F32, OPTS)(*_t(args, F32))
    assert tuple(xs_t.shape) == (B, T, NX)
    assert tuple(us_t.shape) == (B, T - 1, NU)
    assert tuple(ws_t.shape) == (B, T - 1, NZ)
    _close((us_t, xs_t), (us_j, xs_j), 2e-4)
    _close((ws_t,), (ws_j,), 5e-3)


@pytest.fixture(scope="module")
def jax_deploy():
    """The reference's deploy problem on the CPU (float64, cold
    line-search policy), cut to T=6."""
    jprob, _, _, jopts = jex.build_deploy_problem(False, dtype=jnp.float64)
    return jprob._replace(T=T), jopts


def _jax_closed_loop(jax_deploy, args, u_mask=None):
    jprob, jopts = jax_deploy
    if u_mask is not None:
        jprob = jprob._replace(u_mask=jnp.asarray(u_mask))
    ph = jax_make_phases(jprob, jopts, B, jnp.float64)
    x0s, xss_ref, uss, Kss, kss, alphas = (jnp.asarray(a) for a in args)
    xs, us, _, ws = ph.closed_loop(
        xss_ref.at[:, 0].set(x0s), uss, Kss, kss, alphas,
        jnp.zeros((B, T - 1, 1)), jnp.zeros((B, NX)), jnp.ones(B),
        jnp.zeros((B, T - 1, NZ)))
    return xs, us, ws


def test_plain_matches_jax_scan_rollout_f64(jax_deploy):
    args = _inputs(1)
    ref = _jax_closed_loop(jax_deploy, args)
    x0s, xss_ref, *rest = _t(args, F64)
    xss_ref[:, 0] = x0s
    got = _port_rollout(F64, tex.DEPLOY_IP_CPU)(x0s, xss_ref, *rest)
    _close(got, ref, 1e-10)


def test_open_loop_is_the_zero_gain_case(jax_deploy):
    """Zero gains and references: the controls pass through untouched and
    the states are the reference's open-loop rollout."""
    jprob, jopts = jax_deploy
    x0s, _, uss, _, _, _ = _inputs(2)
    ph = jax_make_phases(jprob, jopts, B, jnp.float64)
    xs_j, ws_j = ph.rollout_open(jnp.asarray(x0s), jnp.asarray(uss))
    z = lambda *s: torch.zeros((B,) + s, dtype=F64)
    xs_t, us_t, ws_t = _port_rollout(F64, tex.DEPLOY_IP_CPU)(
        *_t((x0s,), F64), z(T, NX), *_t((uss,), F64), z(T - 1, NU, NX),
        z(T - 1, NU), z())
    assert torch.equal(us_t, torch.as_tensor(uss))
    _close((xs_t, ws_t), (xs_j, ws_j), 1e-10)


def test_ragged_u_mask_matches_jax_scan_rollout(jax_deploy):
    """A step whose control is masked keeps u_ref exactly, in the port
    and in the reference's scan rollout (the reference's deploy problem
    builds its fused kernel without the mask; the port passes it)."""
    args = _inputs(3)
    mask = np.ones((T - 1, NU), bool)
    mask[2] = False
    ref = _jax_closed_loop(jax_deploy, args, mask)
    x0s, xss_ref, *rest = _t(args, F64)
    xss_ref[:, 0] = x0s
    got = _port_rollout(F64, tex.DEPLOY_IP_CPU, mask)(x0s, xss_ref, *rest)
    _close(got, ref, 1e-10)
    uss = torch.as_tensor(args[2])
    assert torch.equal(got[1][:, 2], uss[:, 2])
    assert float((got[1][:, 1] - uss[:, 1]).abs().max()) > 1e-4


def _stage_cost(xT):
    return (lambda t, x, u: (u * u).sum(), lambda x: ((x - xT) ** 2).sum(),
            lambda x: x - xT)


def _phases_pair():
    """The reference's phases with its fused rollout (interpret) and
    Pallas Riccati pass, and the port's with K4 and K3, on the same
    cartpole problem (float32, cold line-search policy)."""
    jmodel = jcp.friction_model()
    jaux = jcp.CartpoleAux(h=0.05, friction=jnp.asarray([0.35, 0.35],
                                                        jnp.float32))
    jdyn = jax_make_implicit_dynamics(jmodel, eval_opts=JIPOptions(**OPTS),
                                      grad_opts=JIPOptions(**OPTS))
    jxT = jnp.array([0.0, jnp.pi, 0.0, jnp.pi], jnp.float32)
    jsc, jtc, jcon = _stage_cost(jxT)
    jprob = JProblem(
        T=T, nx=NX, nu=NU, ncon=0, nconT=NX,
        dynamics=lambda t, x, u: jdyn.step(x, u, jaux),
        dynamics_jac=lambda t, x, u: jdyn.step_jac(x, u, jaux),
        dynamics_jac_batched=lambda ts, xs, us: jdyn.step_jac_batched(
            xs, us, jaux),
        dynamics_batched=lambda t, xs, us: jdyn.step_batched(xs, us, jaux),
        dynamics_batched_ws=lambda t, xs, us, ws: jdyn.step_batched_ws(
            xs, us, jaux, ws),
        dynamics_jac_batched_ws=lambda ts, xs, us, wss:
            jdyn.step_jac_batched_ws(xs, us, jaux, wss),
        ws_init_batched=lambda t, xs, us: jax.vmap(jdyn.carry_init)(xs),
        ws_linesearch=False, stage_cost=jsc, terminal_cost=jtc,
        terminal_con=jcon,
        rollout_fused=jax_make_fused_rollout(jmodel, JIPOptions(**OPTS),
                                             jaux, T, interpret=True))
    kw = dict(alpha_min=1e-2, max_iter=3, max_al_iter=2, con_tol=0.01,
              rho_max=1e6)
    jph = jax_make_phases(jprob, JOptions(pallas_riccati=True, **kw), B,
                          jnp.float32)

    tmodel = tcp.friction_model()
    taux = tcp.CartpoleAux(h=0.05, friction=torch.tensor([0.35, 0.35]))
    ip = IPOptions(**OPTS)
    tdyn = make_implicit_dynamics(tmodel, "cpu", F32, eval_opts=ip,
                                  grad_opts=ip)
    tsc, ttc, tcon = _stage_cost(torch.tensor([0.0, np.pi, 0.0, np.pi]))
    tprob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=0, nconT=NX,
        stage_cost=tsc, terminal_cost=ttc, terminal_con=tcon,
        dynamics_batched=lambda t, xs, us: tdyn.step_batched(xs, us, taux),
        dynamics_jac_batched=lambda ts, xs, us: tdyn.step_jac_batched(
            xs, us, taux),
        dynamics_batched_ws=lambda t, xs, us, ws: tdyn.step_batched_ws(
            xs, us, taux, ws),
        dynamics_jac_batched_ws=lambda ts, xs, us, wss:
            tdyn.step_jac_batched_ws(xs, us, taux, wss),
        ws_init_batched=lambda t, xs, us: tdyn.carry_init(xs),
        ws_linesearch=False,
        rollout_fused=make_fused_rollout(tmodel, ip, taux, T, None, "cpu",
                                         F32))
    tph = make_phases(tprob, ILQROptions(riccati_kernel=True, **kw), B, F32,
                      "cpu")
    return jph, tph


def _cascade(ph, xss, uss, Js, regs, lams, lamTs, rhos, active, wss):
    """ls_prep, every rung, ls_apply: the full grid's first accepts."""
    prep = ph.ls_prep(xss, uss, Js, regs, lams, lamTs, rhos, active, wss)
    Kss, kss, dV1, dV2, qu_inf, bp_ok, cand, _ = prep
    for rung in ph.ls_rungs:
        cand, _ = rung(xss, uss, Kss, kss, Js, dV1, dV2, lams, lamTs, rhos,
                       wss, cand, active)
    return prep, ph.ls_apply(xss, uss, Js, regs, wss, active, cand, qu_inf,
                             bp_ok)


def test_phases_with_both_kernels_match_jax():
    """make_phases with rollout_fused and riccati_kernel against the
    reference's make_phases with its fused rollout and pallas_riccati:
    the open-loop rollout, the gains and one cascade iteration agree."""
    with jax.enable_x64(False):
        jph, tph = _phases_pair()
        rng = np.random.RandomState(1)
        x0s = 0.05 * rng.randn(B, NX)
        us0 = 0.1 * rng.randn(B, T - 1, NU)
        j = lambda a: jnp.asarray(a, jnp.float32)
        xss_j, wss_j = jph.rollout_open(j(x0s), j(us0))
        x0t, us0t = _t((x0s, us0), F32)
        xss_t, wss_t = tph.rollout_open(x0t, us0t)
        _close((xss_t,), (xss_j,), 2e-4)

        state = dict(lams=np.zeros((B, T - 1, 1)), lamTs=np.zeros((B, NX)),
                     rhos=np.ones(B))
        js = {k: j(v) for k, v in state.items()}
        ts = dict(zip(state, _t(state.values(), F32)))
        regs = np.full(B, 1e-6)
        Js_j = jph.traj_cost(xss_j, j(us0), js["lams"], js["lamTs"],
                             js["rhos"])
        Js_t = tph.traj_cost(xss_t, us0t, ts["lams"], ts["lamTs"],
                             ts["rhos"])
        before = (fused_rollout.launches, riccati_backward.launches)
        prep_j, out_j = _cascade(jph, xss_j, j(us0), Js_j, j(regs),
                                 js["lams"], js["lamTs"], js["rhos"],
                                 jnp.ones(B, bool), wss_j)
        prep_t, out_t = _cascade(tph, xss_t, us0t, Js_t, *_t((regs,), F32),
                                 ts["lams"], ts["lamTs"], ts["rhos"],
                                 torch.ones(B, dtype=torch.bool), wss_t)
    # CPU tensors take the plain versions: no launch
    assert (fused_rollout.launches, riccati_backward.launches) == before
    _close(prep_t[:2], prep_j[:2], 5e-3)
    np.testing.assert_array_equal(prep_t[5].numpy(), np.asarray(prep_j[5]))
    _close((out_t[0],), (out_j[0],), 5e-3)
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]),
                               rtol=1e-3)


def test_fused_rollout_needs_the_cold_line_search_policy():
    prob, _, _, opts = tex.build_deploy_problem("cpu", fused_rollout=True)
    make_phases(prob._replace(T=T, rollout_fused=_port_rollout(
        F64, tex.DEPLOY_IP_CPU)), opts, B, F64, "cpu")
    with pytest.raises(ValueError):
        make_phases(prob._replace(ws_linesearch=True), opts, B, F64, "cpu")
