"""Port parity: ``parallel/mesh.py`` against the JAX package's.

The CPU mesh is ``[torch.device("cpu")] * 8``, so the split and the
merge run with eight shards as the reference's tests run on eight
virtual CPU devices. ``sharded_map`` of the acrobot's lane-batched step
over 16 lanes equals the unsharded call and the reference's
``sharded_map`` to 1e-12; ``convergence_summary``, ``quarantine`` and
``merge_retry`` return what the reference's return on the same inputs.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import (
    make_implicit_dynamics as jax_dynamics)
from optimization_dynamics_tpu.models import acrobot as jac
from optimization_dynamics_tpu.parallel import mesh as jm
from optimization_dynamics_tpu_torch.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu_torch.models import acrobot as tac
from optimization_dynamics_tpu_torch.parallel import mesh as tm
from optimization_dynamics_tpu_torch.solver.ilqr import ILQRResult
from optimization_dynamics_tpu_torch.utils import convert

torch.set_num_threads(1)
F64 = torch.float64
CPU8 = [torch.device("cpu")] * 8


def test_mesh_of_given_devices():
    mesh = tm.scenario_mesh(devices=["cpu"] * 8)
    assert mesh == CPU8
    assert tm.scenario_mesh(n_devices=2, devices=CPU8) == CPU8
    assert tm.device_count() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.scenario_mesh()


@pytest.mark.parametrize("B", [16, 13])
def test_shard_split_and_merge(B):
    """Eight contiguous chunks of the leading axis (the first ones a lane
    longer where 8 does not divide B), every leaf of a tree split alike,
    non-tensor leaves passed to every chunk; ``sharded_map`` concatenates
    the chunks' results back in order."""
    xs = torch.arange(B * 3, dtype=F64).reshape(B, 3)
    tree = {"x": xs, "flag": xs[:, 0] > 4, "h": 0.05}
    chunks = tm.shard_scenarios(CPU8, tree)
    assert len(chunks) == 8
    sizes = [c["x"].shape[0] for c in chunks]
    assert sizes == [len(a) for a in np.array_split(np.arange(B), 8)]
    assert all(c["h"] == 0.05 for c in chunks)
    assert torch.equal(torch.cat([c["x"] for c in chunks]), xs)
    assert torch.equal(torch.cat([c["flag"] for c in chunks]), tree["flag"])
    seen = []

    def fn(x, t):
        seen.append(x.shape[0])
        return {"y": 2.0 * x + t["x"], "n": x.sum(1)}

    out = tm.sharded_map(fn, CPU8)(xs, tree)
    assert seen == sizes
    assert torch.equal(out["y"], 3.0 * xs)
    assert torch.equal(out["n"], xs.sum(1))


def test_sharded_step_matches_unsharded_and_jax():
    """The acrobot impact step on 16 lanes: sharded over eight CPU
    devices it equals the unsharded call and the reference's
    ``sharded_map`` (eight virtual devices) to 1e-12. (The plain
    version's batched linear algebra may round differently at another
    batch width, so on the CPU the sharded call is not held bit for bit;
    on the card each lane is one thread's or tile's, and ``chip_smoke.py``
    holds it bit for bit.)"""
    jaux = jac.AcrobotAux(h=0.05)
    jd = jax_dynamics(jac.impact_model())
    td = make_implicit_dynamics(tac.impact_model(), "cpu", F64)
    taux = convert.acrobot_aux(jaux, "cpu", F64)

    B = 16
    rng = np.random.default_rng(0)
    xs = 0.3 * rng.standard_normal((B, 4))
    us = 0.1 * rng.standard_normal((B, 1))
    step = lambda x, u: td.step_batched(x, u, taux)
    txs, tus = torch.as_tensor(xs), torch.as_tensor(us)
    ys = tm.sharded_map(step, CPU8)(txs, tus)
    np.testing.assert_allclose(ys.numpy(), step(txs, tus).numpy(),
                               atol=1e-12, rtol=0)

    run = jm.sharded_map(lambda x, u: jd.step(x, u, jaux), jm.scenario_mesh())
    ys_j = run(jnp.asarray(xs), jnp.asarray(us))
    assert len(ys_j.sharding.device_set) == 8
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("conv, its", [
    ([True, False, True, True], [10, 50, 12, 8]),
    ([True, True], [3, 4]),
    ([False] * 40, list(range(40))),
    ([True, False, False, True, True, False, True], [7, 1, 9, 2, 5, 3, 3]),
])
def test_convergence_summary_and_quarantine_match_jax(conv, its):
    c, i = np.asarray(conv), np.asarray(its, np.int32)
    want = jm.convergence_summary(jnp.asarray(c), jnp.asarray(i))
    got = tm.convergence_summary(torch.as_tensor(c), torch.as_tensor(i))
    assert got == want
    assert type(got["fraction_converged"]) is float
    assert (tm.convergence_summary(torch.as_tensor(c))
            == jm.convergence_summary(jnp.asarray(c)))
    assert tm.quarantine(torch.as_tensor(c)) == jm.quarantine(jnp.asarray(c))
    if len(c) == 40:
        assert got["failed_indices"] == list(range(32))


def _random_result(rng, B, lib):
    f = lambda *s: rng.standard_normal(s)
    fields = dict(xs=f(B, 5, 4), us=f(B, 4, 1), objective=f(B),
                  al_objective=f(B),
                  iterations=rng.integers(0, 9, B).astype(np.int32),
                  al_iterations=rng.integers(0, 3, B).astype(np.int32),
                  constraint_violation=f(B), gradient_norm=f(B),
                  converged=rng.random(B) < 0.5, lam=f(B, 4, 1),
                  lamT=f(B, 4), rho=f(B))
    if lib == "jax":
        from optimization_dynamics_tpu.solver.ilqr import ILQRResult as J
        return J(**{k: jnp.asarray(v) for k, v in fields.items()})
    return ILQRResult(**{k: torch.as_tensor(v) for k, v in fields.items()})


def test_merge_retry_matches_jax():
    """Every field of an ``ILQRResult`` (the mask broadcast over trailing
    dimensions), and a dict, as the reference's unit test."""
    B = 9
    res = [_random_result(np.random.default_rng(1), B, lib)
           for lib in ("torch", "jax")]
    retry = [_random_result(np.random.default_rng(2), B, lib)
             for lib in ("torch", "jax")]
    got = tm.merge_retry(res[0], retry[0])
    want = jm.merge_retry(res[1], retry[1])
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)

    class R(NamedTuple):
        xs: jnp.ndarray
        converged: jnp.ndarray

    xs0 = np.array([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
    xs1 = np.array([[9.0, 9.0], [8.0, 8.0], [7.0, 7.0]])
    c0, c1 = np.array([True, False, False]), np.array([True, True, False])
    want = jm.merge_retry(R(jnp.asarray(xs0), jnp.asarray(c0)),
                          R(jnp.asarray(xs1), jnp.asarray(c1)))
    got = tm.merge_retry({"xs": torch.as_tensor(xs0),
                          "converged": torch.as_tensor(c0)},
                         {"xs": torch.as_tensor(xs1),
                          "converged": torch.as_tensor(c1)})
    np.testing.assert_array_equal(got["xs"].numpy(), np.asarray(want.xs))
    np.testing.assert_array_equal(got["converged"].numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got["xs"].numpy(),
                                  [[1.0, 1.0], [8.0, 8.0], [3.0, 3.0]])


def test_eight_virtual_devices_for_the_reference():
    assert len(jax.devices()) == 8
