"""Port parity: ``examples/sweep.py`` against the JAX package's.

Both modules are shrunk the same way with ``monkeypatch``: the module's
``T`` (and the cartpole example's, for the deploy sweep) and an
``ILQROptions`` wrapper (the deploy problem's options) that lowers
``max_iter`` and ``max_al_iter``; the solvers read both when they
solve. The draws are the reference's ``jax.random`` ones, passed to
the port as data.

* ``run_sweep``: each shard's first pass against the reference's
  ``jit(vmap(solve_one))`` lane by lane (objective rtol 1e-6, controls
  atol 1e-6, identical flags and iteration counts); the retry pass from
  the reference's ``fold_in(key, 1000 + s)`` perturbations and the
  merged result against the reference's ``merge_retry``; each shard's
  checkpoint loads with the reference's ``load_result``; a resumed
  sweep solves only the shards not on disk, and a finished one solves
  nothing.
* ``run_sweep_deploy`` cold and warm (float64, shards of 8, two shards)
  against the reference's on its ``dirs``: every shard's checkpoint
  (objective rtol 1e-6, controls atol 1e-6, identical flags, inner and
  AL counts) and summary. Compaction has one bucket at this width
  (8 // 4 < ``compact_min``), so the knife-edge sensitivity to the
  compaction width (ROADMAP Queue 3) does not enter. A warm sweep
  resumed after its first shard seeds the second from the checkpoint
  and gives the uninterrupted sweep's shard bit for bit.

Slow: the full-size friction grid's first and last lanes against the
reference's vmapped lanes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.examples import cartpole as jex
from optimization_dynamics_tpu.examples import sweep as jsw
from optimization_dynamics_tpu.parallel import mesh as jmesh
from optimization_dynamics_tpu.utils.checkpoint import load_result
from optimization_dynamics_tpu_torch.examples import cartpole as tex
from optimization_dynamics_tpu_torch.examples import sweep as tsw

torch.set_num_threads(1)

T_SMALL = 6
FIELDS_EXACT = ("converged", "iterations", "al_iterations")


def _shrink(mp, max_iter, max_al_iter):
    """The same cut in both packages' sweep and cartpole modules."""
    for sw, ex in ((jsw, jex), (tsw, tex)):
        mp.setattr(sw, "T", T_SMALL)
        mp.setattr(ex, "T", T_SMALL)
        opts = sw.ILQROptions
        mp.setattr(sw, "ILQROptions", lambda _o=opts, **k: _o(
            **{**k, "max_iter": max_iter, "max_al_iter": max_al_iter}))
        build = ex.build_deploy_problem

        def build_small(*a, _b=build, **k):
            prob, x0, us0, o = _b(*a, **k)
            return prob, x0, us0, dataclasses.replace(
                o, max_iter=max_iter, max_al_iter=max_al_iter)

        mp.setattr(ex, "build_deploy_problem", build_small)


def _compare(got: dict, want: dict, what: str):
    np.testing.assert_allclose(got["objective"], want["objective"],
                               rtol=1e-6, err_msg=what)
    np.testing.assert_allclose(got["us"], want["us"], atol=1e-6,
                               err_msg=what)
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(got[f], want[f], err_msg=what + f)


def _host(res) -> dict:
    return {f: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for f, v in res._asdict().items()}


@pytest.fixture(scope="module")
def friction_sweep(tmp_path_factory):
    """Two shards of one scenario (frictions 0.05 and 0.4), the first
    swept alone, then the whole grid resumed, then once more."""
    out = str(tmp_path_factory.mktemp("sweep"))
    key = jax.random.PRNGKey(0)
    n = 2
    fr = np.asarray(jnp.linspace(0.05, 0.4, n)[:, None].repeat(2, 1))
    x0s = np.asarray(0.02 * jax.random.normal(key, (n, 4), jnp.float64))
    noise = {s: np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1000 + s), (1, 4), jnp.float64))
        for s in range(n)}
    passes, solves = [], [0]
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp, max_iter=3, max_al_iter=2)
        merge = tsw.merge_retry
        mp.setattr(tsw, "merge_retry",
                   lambda r, rr: passes.append((r, rr)) or merge(r, rr))
        solve = tsw.solve
        mp.setattr(tsw, "solve",
                   lambda *a, **k: solves.__setitem__(0, solves[0] + 1)
                   or solve(*a, **k))
        kw = dict(shard_size=1, out_dir=out, devices=["cpu"],
                  retry_noise=noise, verbose=False)
        first = tsw.run_sweep(1, frictions=fr[:1], x0s=x0s[:1], **kw)
        resumed = tsw.run_sweep(n, frictions=fr, x0s=x0s, **kw)
        n_solves = solves[0]
        again = tsw.run_sweep(n, frictions=fr, x0s=x0s, **kw)
        again_solves = solves[0] - n_solves

        # the reference: jit(vmap(solve_one)) shard by shard, its retry
        # pass and merge
        run = jax.jit(jax.vmap(jsw.make_solver()))
        ref = []
        for s in range(n):
            fr_s, x0_s = jnp.asarray(fr[s:s + 1]), jnp.asarray(x0s[s:s + 1])
            res = run(fr_s, x0_s)
            failed = jmesh.quarantine(res.converged)
            retry = None
            if failed:
                retry = run(fr_s, x0_s + 0.05 * jnp.asarray(noise[s]))
                merged = jmesh.merge_retry(res, retry)
            else:
                merged = res
            summary = jmesh.convergence_summary(merged.converged,
                                                merged.iterations)
            summary["retried"] = len(failed)
            ref.append((res, retry, merged, summary))
    return dict(out=out, first=first, resumed=resumed, again=again,
                again_solves=again_solves, n_solves=n_solves,
                passes=passes, ref=ref)


def test_run_sweep_lanes_match_jax_vmap(friction_sweep):
    """Each shard's first pass and retry pass against the reference's
    vmapped lanes; the merged checkpoint against its merge."""
    ref = friction_sweep["ref"]
    retried = [r for r in ref if r[1] is not None]
    assert len(friction_sweep["passes"]) == len(retried)
    for (res, rr), (jres, jretry, _, _) in zip(friction_sweep["passes"],
                                               retried):
        _compare(_host(res), _host(jres), "first pass ")
        _compare(_host(rr), _host(jretry), "retry pass ")
    for s, (jres, _, merged, summary) in enumerate(ref):
        data, meta = load_result(os.path.join(friction_sweep["out"],
                                              "shard_%05d.npz" % s))
        _compare(data, _host(merged), "shard %d " % s)
        for k, v in summary.items():
            assert meta[k] == v, (k, meta[k], v)
        assert meta["wall_s"] > 0 and meta["solves_per_s"] > 0


def test_run_sweep_checkpoint_resume_and_retry(friction_sweep):
    """The first call saved shard 0; the resumed call skipped it and
    solved shard 1 alone; the third call solved nothing. With the cut
    budgets no lane converges, so every shard took the retry path."""
    st = friction_sweep
    assert len(st["first"]) == 1 and len(st["resumed"]) == 1
    assert st["again"] == [] and st["again_solves"] == 0
    # one lane a shard, a first pass and a retry each
    assert st["n_solves"] == 4
    assert [s["retried"] for s in st["first"] + st["resumed"]] == [1, 1]
    files = sorted(os.listdir(st["out"]))
    assert files == ["shard_00000.npz", "shard_00001.npz"]


@pytest.mark.parametrize("warm", [False, True])
def test_run_sweep_deploy_matches_jax(tmp_path, monkeypatch, warm):
    """Two float64 shards of 8 lanes, cold or warm-started from the
    previous shard, against the reference's ``run_sweep_deploy`` (its
    ``dirs`` from ``PRNGKey(0)``)."""
    _shrink(monkeypatch, max_iter=2, max_al_iter=2)
    # the reference sets a persistent compile cache and a matmul
    # precision for the process; keep both out of the test session
    real = jax.config.update
    prec = jax.config.jax_default_matmul_precision
    monkeypatch.setattr(jax.config, "update", lambda name, val: (
        None if "cache" in name else real(name, val)))
    try:
        jst = jsw.run_sweep_deploy(16, shard=8, warm=warm,
                                   out_dir=str(tmp_path / "jax"),
                                   verbose=False)
    finally:
        real("jax_default_matmul_precision", prec)
    dirs = np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 4)))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tst = tsw.run_sweep_deploy(16, shard=128, warm=warm,
                               out_dir=str(tmp_path / "port"), verbose=False,
                               device="cpu", dirs=dirs)
    assert len(tst) == len(jst) == 2
    for s in range(2):
        got, gm = load_result(str(tmp_path / "port" / ("shard_%05d.npz" % s)))
        want, wm = load_result(str(tmp_path / "jax" / ("shard_%05d.npz" % s)))
        assert sorted(got) == sorted(want)
        _compare(got, want, "shard %d " % s)
        np.testing.assert_allclose(got["lam"], want["lam"], atol=1e-6)
        np.testing.assert_allclose(got["lamT"], want["lamT"], atol=1e-6)
        for k in set(wm) - {"wall_s", "solves_per_s"}:
            assert gm[k] == wm[k], (s, k, gm[k], wm[k])
        assert gm["warm"] is (warm and s > 0)
    if warm:
        # resumed: shard 0 on disk seeds shard 1 from its checkpoint,
        # as the uninterrupted warm sweep seeded it from memory
        kw = dict(shard=8, warm=True, out_dir=str(tmp_path / "resumed"),
                  verbose=False, device="cpu", dirs=dirs)
        assert len(tsw.run_sweep_deploy(8, **kw)) == 1
        st = tsw.run_sweep_deploy(16, **kw)
        assert len(st) == 1 and st[0]["warm"] is True
        got, _ = load_result(str(tmp_path / "resumed" / "shard_00001.npz"))
        want, _ = load_result(str(tmp_path / "port" / "shard_00001.npz"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_full_size_sweep_lanes_match_jax_vmap(tmp_path, monkeypatch):
    """The friction grid's first and last lanes at full size (T=51, the
    reference's budgets, frictions 0.05 and 0.4 from its 64-scenario
    grid, its draws): the port's shard against the reference's
    ``jit(vmap(solve_one))``, its retry pass from the reference's
    ``fold_in(PRNGKey(0), 1000)`` noise and its ``merge_retry``. On both
    lanes of each pass and of the merged result: flags and
    ``check_finite`` equal to the reference's, and the retried count.
    Inner and AL counts, objective (rtol 1e-6) and controls (atol 1e-6)
    on the lanes whose reference solve is stable: the reference solved
    again from starts moved one unit in the last place gives the same
    counts and objective. The 0.4 lanes are not (their counts and
    objectives move by up to a third under such a move; ROADMAP Queue 3).
    Hours on one CPU thread: each lane is a full scalar friction
    swing-up through K1's plain version."""
    from optimization_dynamics_tpu.utils import debug as jdebug
    from optimization_dynamics_tpu_torch.utils.debug import check_finite

    key = jax.random.PRNGKey(0)
    fr = np.asarray(jnp.linspace(0.05, 0.4, 64)[:, None].repeat(2, 1))
    x0s = np.asarray(0.02 * jax.random.normal(key, (64, 4), jnp.float64))
    lanes = [0, 63]
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 1000),
                                         (2, 4), jnp.float64))
    run = jax.jit(jax.vmap(jsw.make_solver()))
    fr_j = jnp.asarray(fr[lanes])

    def reference(x0):
        """The reference's passes from ``x0`` (its retry pass when a lane
        failed, from the same noise) and its merged result."""
        passes = [run(fr_j, jnp.asarray(x0))]
        if jmesh.quarantine(passes[0].converged):
            passes.append(run(fr_j, jnp.asarray(x0 + 0.05 * noise)))
            return passes, jmesh.merge_retry(*passes)
        return passes, passes[0]

    jpasses, jres = reference(x0s[lanes])
    upasses, _ = reference(np.nextafter(x0s[lanes], np.inf))

    passes = []
    merge = tsw.merge_retry
    monkeypatch.setattr(tsw, "merge_retry",
                        lambda r, rr: passes.extend((r, rr)) or merge(r, rr))
    tsw.run_sweep(2, shard_size=2, out_dir=str(tmp_path), devices=["cpu"],
                  frictions=fr[lanes], x0s=x0s[lanes],
                  retry_noise={0: noise}, verbose=False)
    data, meta = load_result(str(tmp_path / "shard_00000.npz"))
    assert meta["retried"] == len(jmesh.quarantine(jpasses[0].converged))
    assert len(passes) == (2 if len(jpasses) == 2 else 0)

    def finite(d, pkg):
        if pkg == "port":
            return check_finite({k: torch.as_tensor(v)
                                 for k, v in d.items()}).numpy()
        return np.asarray(jdebug.check_finite({k: jnp.asarray(v)
                                                for k, v in d.items()}))

    # the merged result, then each pass: the port's first pass is its
    # checkpoint when no lane retried
    cases = [("merged ", data, _host(jres), None)]
    for i, got in enumerate([_host(g) for g in passes] or [data]):
        cases.append(("%s pass " % ("first", "retry")[i], got,
                      _host(jpasses[i]),
                      _host(upasses[i]) if i < len(upasses) else None))
    for what, got, want, moved in cases:
        np.testing.assert_array_equal(got["converged"], want["converged"],
                                      err_msg=what + "converged")
        np.testing.assert_array_equal(finite(got, "port"),
                                      finite(want, "ref"),
                                      err_msg=what + "check_finite")
        if moved is None:
            continue
        stable = ((moved["iterations"] == want["iterations"])
                  & (moved["al_iterations"] == want["al_iterations"])
                  & np.isclose(moved["objective"], want["objective"],
                               rtol=1e-6, atol=0.0))
        assert stable[0], what + "the 0.05 lane moved with its start's bits"
        for f in FIELDS_EXACT:
            np.testing.assert_array_equal(got[f][stable], want[f][stable],
                                          err_msg=what + f)
        np.testing.assert_allclose(got["objective"][stable],
                                   want["objective"][stable], rtol=1e-6,
                                   err_msg=what)
        np.testing.assert_allclose(got["us"][stable], want["us"][stable],
                                   atol=1e-6, err_msg=what)
