"""Multi-process scenario parallelism on the CPU: ``parallel/mesh.py``'s
process group and the worker ``scripts/multihost_worker.py``, against one
process and against the reference.

Each test starts two processes on a free localhost port, as the
reference's ``tests/test_multihost.py`` does, with gloo between them:

* the mesh itself: entries in rank order, each process's contiguous
  rows (13 over 4 entries, so uneven), the gathered batch and the
  convergence statistics the same on both processes;
* the worker's problem (cartpole friction, T=11, 16 lanes over two
  processes of four CPU entries each): the gathered result against one
  port process solving all 16 lanes in one call at 1e-11 with identical
  counts (the CPU's batched arithmetic is not bit-stable across widths),
  and against
  the reference's single-process ``solve_batched`` on the same starts at
  rtol 1e-6 / atol 1e-6 with identical iteration counts, AL rounds and
  flags;
* the deploy sweep over two processes (16 scenarios, shards of 8, two
  rounds of two inner iterations, T=6 as in ``tests/test_torch_sweep.py``):
  its checkpoints against one process's at 1e-12 (relative and
  absolute; each process solves 4 of a shard's 8 lanes), the second call
  resuming from the shard that rank 0 wrote in the first;
* the worker exits non-zero without a card unless given ``--device cpu``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.dynamics import make_implicit_dynamics
from optimization_dynamics_tpu.examples import cartpole as jex
from optimization_dynamics_tpu.models import cartpole as jcp
from optimization_dynamics_tpu.solver.ilqr_batched import (
    solve_batched as jax_solve_batched)
from optimization_dynamics_tpu_torch.examples import cartpole as tex
from optimization_dynamics_tpu_torch.examples import sweep as tsw
from optimization_dynamics_tpu_torch.parallel import mesh as tm
from optimization_dynamics_tpu_torch.scripts import multihost_worker as mw
from optimization_dynamics_tpu_torch.utils.checkpoint import load_result

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "optimization_dynamics_tpu_torch.scripts.multihost_worker"
COUNTS = ("iterations", "al_iterations", "converged")
T_SMALL = 6


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _two(cmd, timeout=600):
    """``cmd(pid, port)`` (argument lists) run as processes 0 and 1; each
    one's (exit code, stdout, stderr)."""
    port = _free_port()
    procs = [subprocess.Popen(cmd(pid, port), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(),
                              cwd=HERE)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, "rc=%s\nstdout:%s\nstderr:%s" % (rc, out, err)
    return outs


def _info(out: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith("MULTIHOST_INFO"))
    return json.loads(line.split(" ", 1)[1])


def _worker(*extra, T=None):
    """The worker as processes 0 and 1 on the CPU; with ``T``, the
    cartpole example's horizon cut first, as ``tests/test_torch_sweep.py``
    cuts it."""
    head = [sys.executable, "-m", WORKER]
    if T is not None:
        head = [sys.executable, "-c",
                "import sys; from optimization_dynamics_tpu_torch.examples "
                "import cartpole; cartpole.T = %d; from %s import main; "
                "sys.exit(main(sys.argv[1:]))" % (T, WORKER)]
    return lambda pid, port: [*head, str(pid), "2", str(port), "--device",
                              "cpu", *extra]


MESH_SCRIPT = r"""
import json, sys, torch
from optimization_dynamics_tpu_torch.parallel import mesh as pm
pid, port = int(sys.argv[1]), int(sys.argv[2])
assert pm.process_count() == 1 and pm.process_index() == 0
pm.initialize("localhost:%d" % port, 2, pid, devices=["cpu"] * 2)
try:
    mesh = pm.scenario_mesh()
    xs = torch.arange(13 * 2, dtype=torch.float64).reshape(13, 2)
    flags = xs[:, 0] % 3 != 0
    rows = [c["x"][:, 0].tolist() for c in
            pm.shard_scenarios(mesh, {"x": xs, "h": 0.5})]
    seen = []
    def fn(x, f):
        seen.append(x.shape[0])
        return {"y": 2.0 * x, "f": f, "n": None}
    out = pm.sharded_map(fn, mesh)(xs, flags)
    print(json.dumps(dict(
        count=pm.process_count(), index=pm.process_index(),
        mesh=[str(d) for d in mesh], ranks=mesh.ranks, mine=mesh.mine(),
        rows=rows, seen=seen, y=out["y"].tolist(),
        f=out["f"].tolist(), f_dtype=str(out["f"].dtype), n=out["n"],
        summary=pm.convergence_summary(out["f"], xs[:, 1].long()))))
finally:
    pm.shutdown()
assert pm.process_count() == 1
"""


def test_mesh_spans_two_processes():
    """Entries in rank order; each process's rows are its entries'
    contiguous chunks (``tensor_split``'s); every process gets the whole
    batch and the same statistics."""
    outs = _two(lambda pid, port: [sys.executable, "-c", MESH_SCRIPT,
                                   str(pid), str(port)], timeout=120)
    got = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    xs = np.arange(26.0).reshape(13, 2)
    chunks = [c[:, 0].tolist() for c in np.array_split(xs, 4)]
    for pid, g in enumerate(got):
        assert (g["count"], g["index"]) == (2, pid)
        assert g["mesh"] == ["cpu"] * 4 and g["ranks"] == [0, 0, 1, 1]
        assert g["mine"] == [2 * pid, 2 * pid + 1]
        assert g["rows"] == chunks[2 * pid:2 * pid + 2]
        assert g["seen"] == [len(c) for c in chunks[2 * pid:2 * pid + 2]]
        assert g["y"] == (2.0 * xs).tolist()
        assert g["f"] == (xs[:, 0] % 3 != 0).tolist()
        assert g["f_dtype"] == "torch.bool" and g["n"] is None
    assert got[0]["summary"] == got[1]["summary"] == tm.convergence_summary(
        torch.as_tensor(xs[:, 0] % 3 != 0), torch.as_tensor(xs[:, 1]).long())


@pytest.fixture(scope="module")
def two_process_solve(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost") / "solve.npz")
    outs = _two(_worker("--local-devices", "4", "--out", out))
    data, meta = load_result(out)
    return dict(outs=outs, data=data, meta=meta)


def test_two_process_solve_runs_on_every_entry(two_process_solve):
    for pid, (_, out, _) in enumerate(two_process_solve["outs"]):
        assert ("MULTIHOST_OK pid=%d devices=8 B=16 finite=16" % pid) in out
        info = _info(out)
        assert info["entries"] == ["cpu"] * 4 and len(info["mesh"]) == 8
    assert two_process_solve["meta"] == dict(B=16, devices=8, processes=2,
                                             dtype="f64")


def test_two_process_solve_matches_one_process(two_process_solve):
    """One port process solving all 16 lanes in one call of width 16:
    the counts and flags identical, every field within 1e-11 relative
    and absolute. The CPU's batched arithmetic rounds differently at
    another width than the processes' chunks of 2 lanes; over the whole
    solve that reaches 3.2e-12 on the states, 7.9e-12 on the controls
    and 2.2e-12 relative on the objectives (the gather itself adds
    nothing: ``test_mesh_spans_two_processes``)."""
    res, solved = mw._solve_worker_problem(
        SimpleNamespace(batch=16), tm.scenario_mesh(devices=["cpu"]),
        torch.device("cpu"), torch.float64)
    assert solved == 1
    data = two_process_solve["data"]
    for f, v in res._asdict().items():
        if f in COUNTS:
            np.testing.assert_array_equal(data[f], v.numpy(), err_msg=f)
        elif v is not None:
            np.testing.assert_allclose(data[f], v.numpy(), atol=1e-11,
                                       rtol=1e-11, err_msg=f)


def test_two_process_solve_matches_reference(two_process_solve):
    """The reference worker's problem solved by the reference's
    ``solve_batched`` in one process on the same starts."""
    prob, x0, us0, opts = jex.build_problem("friction")
    aux = jcp.CartpoleAux(h=jex.H, friction=jnp.asarray([0.35, 0.35]))
    dyn = make_implicit_dynamics(jcp.friction_model())
    T = mw.T_WORKER
    prob = prob._replace(
        T=T, dynamics_batched=lambda t, xs, us: dyn.step_batched(xs, us, aux))
    opts = dataclasses.replace(opts, max_iter=4, max_al_iter=2)
    rng = np.random.RandomState(0)
    x0s = np.tile(np.asarray(x0), (16, 1)) + 0.01 * rng.randn(16, 4)
    want = jax.jit(lambda xs: jax_solve_batched(prob, xs, us0[:T - 1], opts))(
        jnp.asarray(x0s))
    got = two_process_solve["data"]
    np.testing.assert_allclose(got["objective"], np.asarray(want.objective),
                               rtol=1e-6)
    np.testing.assert_allclose(got["us"], np.asarray(want.us), atol=1e-6)
    np.testing.assert_allclose(got["xs"], np.asarray(want.xs), atol=1e-6)
    for f in COUNTS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_two_process_deploy_sweep_matches_one_process_and_resumes(
        tmp_path, monkeypatch):
    """Shard 0 over two processes, then the sweep of both shards resumed
    from rank 0's checkpoint (it solves shard 1 alone); both shards
    against one process's sweep."""
    cut = dict(shard=8, max_iter=2, max_al_iter=2)
    flags = ["--shard", "8", "--max-iter", "2", "--max-al-iter", "2",
             "--out", str(tmp_path / "two")]
    first = _two(_worker("--sweep-deploy", "8", *flags, T=T_SMALL))
    resumed = _two(_worker("--sweep-deploy", "16", *flags, T=T_SMALL))
    for outs, n in ((first, 1), (resumed, 1)):
        infos = [_info(out) for _, out, _ in outs]
        assert len(infos[0]["summaries"]) == n
        assert infos[0]["summaries"] == infos[1]["summaries"]
        assert all("devices=2 B=%d finite=%d" % (8 * (2 - (outs is first)),
                                                 8 * (2 - (outs is first)))
                   in out for _, out, _ in outs)
    monkeypatch.setattr(tex, "T", T_SMALL)
    one = tsw.run_sweep_deploy(16, out_dir=str(tmp_path / "one"),
                               verbose=False, device="cpu", **cut)
    assert len(one) == 2
    for s in range(2):
        got, gm = load_result(str(tmp_path / "two" / ("shard_%05d.npz" % s)))
        want, wm = load_result(str(tmp_path / "one" / ("shard_%05d.npz" % s)))
        assert sorted(got) == sorted(want)
        for k in want:
            if k in COUNTS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], atol=1e-12,
                                           rtol=1e-12, err_msg=k)
        for k in ("n_scenarios", "n_converged", "fraction_converged",
                  "mean_iterations", "max_iterations", "warm"):
            assert gm[k] == wm[k], (s, k)
        assert gm["ip_solves"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_worker_without_a_card_exits_nonzero():
    out = subprocess.run([sys.executable, "-m", WORKER, "0", "1",
                          str(_free_port())], capture_output=True,
                         text=True, env=_env(), cwd=HERE, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "MULTIHOST_OK" not in out.stdout
