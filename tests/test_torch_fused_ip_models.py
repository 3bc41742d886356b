"""Port parity: K1 at the rocket's thrust projection (nz=10) and at the
hopper model (nz=20), their CUDA functors' tables and their plain
versions, against the JAX package.

Inputs are made with numpy from a seed and go through each package's own
packing (the rocket's projection: u_bar = 6 N(0, 1), u_max = 12.5, cold;
the hopper model: perturbations about its standing pose, the
distributions of tests/test_fused_ip.py). Tolerances:

* the functors' constexpr tables are the Python ConeSpec's masks, reset
  template and cone groups, exactly;
* K1's plain version in float64 against the reference's
  ``make_solver_batched`` in float64: converged flags and iteration
  counts identical, z within 1e-10;
* K1's plain version in float32 (the wrapper on CPU tensors, which
  launches nothing) against the reference's Pallas kernel in interpret
  mode, at tests/test_fused_ip.py's bounds: the rocket at least 14 of 16
  lanes converged in both, thrusts within 2e-4 and in the cone to 1e-4;
  the hopper model all but one reference-converged lane and at least 6
  of 8, configurations within 2e-4;
* on the CPU the K1 wrapper is the solver the models ran before they had
  a functor: the rocket's projection and the hopper model's step give
  ``make_solver_batched``'s results bit for bit.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.models import hopper as jh
from optimization_dynamics_tpu.models import rocket as jr
from optimization_dynamics_tpu.ops.pallas.fused_ip import (
    make_fused_ip_solver as jax_fused_solver,
)
from optimization_dynamics_tpu.solver.interior_point import (
    IPOptions as JaxIPOptions,
    make_solver_batched as jax_solver_batched,
)
from optimization_dynamics_tpu_torch.dynamics import (
    ImplicitModel,
    make_implicit_dynamics,
)
from optimization_dynamics_tpu_torch.models import hopper as th
from optimization_dynamics_tpu_torch.models import rocket as tr
from optimization_dynamics_tpu_torch.ops.kernels import _build
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    fused_ip,
    make_fused_ip_plain,
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver import interior_point as tip
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)

F64 = torch.float64
# the options of tests/test_fused_ip.py
JOPTS = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40, max_ls=8,
                     kappa_init_min=1e-2)
# the rocket deploy's projection on the card (r_tol 3e-5, kappa_tol 1e-4,
# the default line search of 25 candidates) and the hopper deploy's
# accelerator IP options
ROCKET_DEPLOY = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-4)
HOPPER_DEPLOY = JaxIPOptions(r_tol=3e-5, kappa_tol=1e-3, max_iter=40,
                             max_ls=8)


def _rocket_inputs(B, seed, np_dtype):
    """(jax z0s, jax thetas, port model, port z0s, port thetas)."""
    rng = np.random.default_rng(seed)
    ths = np.concatenate([6.0 * rng.standard_normal((B, 3)),
                          np.full((B, 1), 12.5)], axis=1).astype(np_dtype)
    z_j = jnp.tile(jr.init_z_proj(np_dtype), (B, 1))
    tdt = F64 if np_dtype == np.float64 else torch.float32
    z_t = tr.init_z_proj("cpu", tdt).expand(B, tr.NZ_PROJ).contiguous()
    return (z_j, jnp.asarray(ths), tr.projection_model(), z_t,
            torch.as_tensor(ths))


def _hopper_inputs(B, seed, np_dtype, params=jh.HopperParams()):
    """About the standing pose: q0 = q_nom + 0.005 N(0, 1), q1 = q0 +
    0.001 N(0, 1), u = 0.1 N(0, 1), friction 0.5 and 0.5, h = 0.05."""
    rng = np.random.default_rng(seed)
    q_nom = np.array([0.0, 0.5 + params.foot_radius, 0.0, 0.5])
    q0 = q_nom + 0.005 * rng.standard_normal((B, 4))
    q1 = q0 + 0.001 * rng.standard_normal((B, 4))
    u = 0.1 * rng.standard_normal((B, 2))
    q0, q1, u = (a.astype(np_dtype) for a in (q0, q1, u))
    jm = jh.model(params)
    jaux = jh.HopperAux(h=np_dtype(0.05),
                        friction=jnp.asarray([0.5, 0.5], np_dtype))
    th_j = jax.vmap(lambda a, b, c: jm.theta_fn(a, b, c, jaux))(
        *(jnp.asarray(v) for v in (q0, q1, u)))
    z_j = jax.vmap(jm.init_z)(jnp.asarray(q1))
    tdt = F64 if np_dtype == np.float64 else torch.float32
    tm = th.model(convert.hopper_params(params))
    taux = convert.hopper_aux(jaux, "cpu", tdt)
    t = lambda a: torch.as_tensor(a)
    return (z_j, th_j, tm, tm.init_z(t(q1)),
            tm.theta_fn(t(q0), t(q1), t(u), taux))


def _jax_model(name, params=jh.HopperParams()):
    """(residual, spec) of the reference."""
    if name == "rocket_projection":
        return jr.residual_proj, jr.cone_spec_proj()
    m = jh.model(params)
    return m.residual, m.spec


def _cuh_tables(path):
    """name -> values of the constexpr lookup tables in a functor header."""
    text = Path(path).read_text()
    out = {}
    for name, body in re.findall(
            r"(\w+)\(int [^)]*\) \{\s*constexpr \w+ t[^=]*= \{(.*?)\};",
            text, re.S):
        out[name] = [float(v) for v in re.findall(r"[-\d.]+", body)]
    return out


@pytest.mark.parametrize("functor,header", [
    ("rocket_projection", "rocket_projection.cuh"), ("hopper", "hopper.cuh")])
def test_cuda_functor_tables_match_cone_spec(functor, header):
    """The constexpr tables of the CUDA functor are the Python ConeSpec's
    masks, reset template, orthant variables (primal then dual) and SOC
    groups (every primal group, then every dual group), its sizes those
    of FUSED_IP_FUNCTORS; the hopper model's cold-start tail is
    init_z's."""
    path = _build.CSRC / header
    tables = _cuh_tables(path)
    model = tr.projection_model() if functor == "rocket_projection" \
        else th.model()
    spec = model.spec
    assert model.kernel == functor
    eq, bil, head = tip._row_masks(spec, "cpu", F64)
    rmask, rtmpl = tip._cone_reset(spec, "cpu", F64)
    assert tables["eq_mask"] == eq.tolist()
    assert tables["bil_mask"] == bil.tolist()
    assert tables["head_mask"] == head.tolist()
    assert tables["reset_mask"] == rmask.double().tolist()
    assert tables["reset_tmpl"] == rtmpl.tolist()
    assert tables["ort_idx"] == [float(i) for i in
                                 spec.ort_prim + spec.ort_dual]
    groups = list(spec.soc_prim) + list(spec.soc_dual)
    assert tables["soc_dim"] == [float(len(g)) for g in groups]
    width = max(len(g) for g in groups)
    assert tables["soc_idx"] == [float(i) for g in groups
                                 for i in tuple(g) + (-1,) * (width - len(g))]
    sizes = dict(re.findall(r"static constexpr int (\w+) = (\d+);",
                            path.read_text()))
    assert (int(sizes["NZ"]), int(sizes["NTH"])) \
        == _build.FUSED_IP_FUNCTORS[functor] == (spec.nz, spec.ntheta)
    assert int(sizes["N_ORT"]) == len(spec.ort_prim + spec.ort_dual)
    assert int(sizes["N_SOC"]) == len(groups)
    assert int(sizes["SOC_MAX"]) == width
    if functor == "hopper":
        z = th.init_z(torch.tensor([[0.1, 0.6, -0.2, 0.5]], dtype=F64))
        assert tables["init_tail"] == z[0, th.NQ:].tolist()
        assert tables["q_sel"] == [float(i) for i in model.q_sel]
        assert (int(sizes["NQ"]), int(sizes["NU"]), int(sizes["NAUX"])) \
            == (th.NQ, th.NU, 3)
        assert model.kernel_params == tuple(th.HopperParams())
    else:
        # no constants, no cold start table: the wrapper passes z0s
        assert model.kernel_params == ()
        assert "init_tail" not in tables


@functools.lru_cache(maxsize=None)
def _jax_batched_f64(name, opts):
    return jax.jit(jax_solver_batched(*_jax_model(name), opts))


CASES = {"rocket_projection": _rocket_inputs, "hopper": _hopper_inputs}


@pytest.mark.parametrize("name,opts,B", [
    ("rocket_projection", JOPTS, 16), ("rocket_projection", ROCKET_DEPLOY, 24),
    ("hopper", JOPTS, 8), ("hopper", HOPPER_DEPLOY, 12)])
def test_k1_plain_matches_jax_batched_f64(name, opts, B):
    """K1's plain version in float64 against the reference's batched
    solver in float64: every flag and iteration count, z within 1e-10."""
    z_j, th_j, model, z_t, th_t = CASES[name](B, 11, np.float64)
    ref = _jax_batched_f64(name, opts)(z_j, th_j)
    sol = make_fused_ip_plain(model, convert.ip_options(opts), "cpu",
                              F64)(z_t, th_t)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    assert sol.converged.numpy().mean() >= 0.9
    np.testing.assert_array_equal(sol.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(ref.z), atol=1e-10)


def test_k1_rocket_projection_plain_matches_pallas_interpret_f32():
    """The reference's wide-lane Pallas call on ``residual_proj`` in
    interpret mode against K1's wrapper on CPU tensors, which runs the
    plain version and launches nothing (tests/test_fused_ip.py's
    bounds)."""
    z_j, th_j, model, z_t, th_t = _rocket_inputs(16, 7, np.float32)
    ref = jax_fused_solver(jr.residual_proj, jr.cone_spec_proj(), JOPTS,
                           interpret=True)(z_j, th_j)
    before = fused_ip.launches
    sol = make_fused_ip_solver(model, convert.ip_options(JOPTS), "cpu",
                               torch.float32)(z_t, th_t)
    assert fused_ip.launches == before
    both = np.asarray(ref.converged) & sol.converged.numpy()
    assert both.sum() >= 14
    u = sol.z.numpy()[both][:, 0:3]
    assert (np.linalg.norm(u[:, 0:2], axis=1) <= u[:, 2] + 1e-4).all()
    np.testing.assert_allclose(u, np.asarray(ref.z)[both][:, 0:3],
                               atol=2e-4)


def test_k1_hopper_plain_matches_pallas_interpret_f32():
    """The reference's wide-lane Pallas call on the hopper model in
    interpret mode against K1's wrapper on CPU tensors
    (tests/test_fused_ip.py's bounds)."""
    z_j, th_j, model, z_t, th_t = _hopper_inputs(8, 3, np.float32)
    jm = jh.model()
    ref = jax_fused_solver(jm.residual, jm.spec, JOPTS,
                           interpret=True)(z_j, th_j)
    before = fused_ip.launches
    sol = make_fused_ip_solver(model, convert.ip_options(JOPTS), "cpu",
                               torch.float32)(z_t, th_t)
    assert fused_ip.launches == before
    cr = np.asarray(ref.converged)
    both = cr & sol.converged.numpy()
    assert both.sum() >= int(cr.sum()) - 1
    assert both.sum() >= 6
    np.testing.assert_allclose(sol.z.numpy()[both][:, :th.NQ],
                               np.asarray(ref.z)[both][:, :th.NQ],
                               atol=2e-4)


def test_hopper_kernel_params_come_from_converted_params():
    """One JAX parameter set drives the reference and the port: the
    port's ``model(convert.hopper_params(p))`` carries p as the functor's
    constants, and its plain K1 solve matches the reference's solver on
    the model built from p (float64, flags and iteration counts
    identical, z within 1e-10)."""
    p = jh.HopperParams(mass_body=1.2, mass_foot=0.3, inertia_body=0.12,
                        body_radius=0.09, foot_radius=0.04, gravity=9.7)
    tm = th.model(convert.hopper_params(p))
    assert tm.kernel == "hopper"
    assert tm.kernel_params == tuple(float(v) for v in p)
    z_j, th_j, model, z_t, th_t = _hopper_inputs(8, 4, np.float64, p)
    assert model.kernel_params == tm.kernel_params
    ref = jax.jit(jax_solver_batched(*_jax_model("hopper", p), JOPTS))(
        z_j, th_j)
    sol = make_fused_ip_solver(model, convert.ip_options(JOPTS), "cpu",
                               F64)(z_t, th_t)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(sol.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(ref.z), atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rocket_projection_on_cpu_is_make_solver_batched(dtype):
    """On CPU tensors the rocket's projection, now built on K1's wrapper,
    gives ``make_solver_batched``'s thrusts and Jacobians bit for bit."""
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions, make_sensitivity_batched, make_solver_batched)

    dyn = tr.make_rocket_dynamics(device="cpu", dtype=dtype)
    u = torch.as_tensor(6.0 * np.random.default_rng(9).standard_normal(
        (12, 3)), dtype=dtype)
    u_hat, J = dyn.project_jac_batched(u)
    thetas = torch.cat([u, u.new_full((12, 1), 12.5)], dim=1)
    z0s = tr.init_z_proj("cpu", dtype).expand(12, tr.NZ_PROJ)
    sol = make_solver_batched(tr.residual_proj, tr.cone_spec_proj(),
                              IPOptions(r_tol=1e-8, kappa_tol=1e-4), "cpu",
                              dtype)(z0s, thetas)
    sens = make_sensitivity_batched(tr.residual_proj, tr.cone_spec_proj())
    assert torch.equal(u_hat, sol.z[:, 0:3])
    assert torch.equal(J, sens(sol.z, thetas)[:, 0:3, 0:3])


def test_hopper_step_on_cpu_is_make_solver_batched():
    """On CPU tensors the hopper model's steps through K1's wrapper give
    the results of the same model without a functor
    (``make_solver_batched``) bit for bit."""
    m = th.model()
    bare = ImplicitModel(**{**m._asdict(), "kernel": None,
                            "kernel_params": ()})
    rng = np.random.default_rng(12)
    q1 = np.array([0.0, 0.55, 0.0, 0.5]) + 0.02 * rng.standard_normal((6, 4))
    q0 = q1 - 0.01 * rng.standard_normal((6, 4))
    xs = torch.as_tensor(np.concatenate([q0, q1], axis=1))
    us = torch.as_tensor(rng.standard_normal((6, 2)))
    aux = th.HopperAux(h=0.05)
    got = make_implicit_dynamics(m, "cpu", F64)
    ref = make_implicit_dynamics(bare, "cpu", F64)
    assert torch.equal(got.step_batched(xs, us, aux),
                       ref.step_batched(xs, us, aux))
    for a, b in zip(got.step_jac_batched(xs, us, aux),
                    ref.step_jac_batched(xs, us, aux)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,opts", [("rocket_projection", ROCKET_DEPLOY),
                                       ("hopper", HOPPER_DEPLOY)])
def test_ls_trials_count_the_first_improving_candidates(name, opts):
    """``interior_point.ls_trials`` (the trials an operation bound counts)
    adds, per active lane and Newton iteration, the line-search candidates
    up to the first improving one: lane by lane it sums to the batch's
    count, it lies between one and ``max_ls`` trials an iteration, and
    counting leaves the solve bit for bit as it was."""
    _, _, model, z0s, thetas = CASES[name](6, 11, np.float64)
    solve = make_fused_ip_plain(model, convert.ip_options(opts), "cpu", F64)

    def counted(z, t):
        tip.ls_trials.on, tip.ls_trials.n = True, 0
        try:
            sol = solve(z, t)
        finally:
            tip.ls_trials.on = False
        return sol, tip.ls_trials.n

    ref = solve(z0s, thetas)
    sol, n = counted(z0s, thetas)
    assert all(torch.equal(a, b) for a, b in zip(sol, ref))
    its = int(sol.iterations.sum())
    assert its <= n < opts.max_ls * its
    assert n == sum(counted(z0s[i:i + 1], thetas[i:i + 1])[1]
                    for i in range(6))
    assert not tip.ls_trials.on
