"""One process of a multi-process scenario-parallel solve.

Port of ``scripts/multihost_worker.py``: ``parallel.mesh.initialize`` and
one scenario mesh spanning the processes (the reference's
``jax.distributed.initialize``), the batched cartpole-friction solve with
the scenario axis split over the processes' devices, its results
gathered so that every process holds them, and the convergence reduction
across the process boundary. The processes talk over gloo at
``localhost:<port>``; each solves its rows on its own devices.

    python -m optimization_dynamics_tpu_torch.scripts.multihost_worker \\
        <process_id> <num_processes> <port> [--device cuda|cpu] \\
        [--local-devices N] [--batch B] [--dtype f32|f64] \\
        [--sweep-deploy N --shard S --max-iter I --max-al-iter A] \\
        [--out PATH]

Start it once for each process id, with the same ``num_processes`` and
``port``. ``--device`` defaults to ``cuda``: every visible card is a mesh
entry of each process (on a one-card machine every process uses
``cuda:0``), and the worker exits non-zero without a card; ``--device
cpu --local-devices 4`` gives each process four CPU entries, as the
reference's worker has four virtual CPU devices.

The default problem is the reference worker's: ``examples/cartpole.py::
build_problem("friction")`` (friction 0.35, 0.35) cut to T=11,
``max_iter=4``, ``max_al_iter=2``, B = ``--batch`` (default twice the
global mesh entries) starts ``x0 + 0.01 N(0, 1)`` from
``np.random.RandomState(0)``, solved by ``solve_batched`` on each
entry's rows. ``--dtype`` defaults to f64 (the reference's x64). The
worker checks that every lane is finite and that every global entry
solved its rows, and prints ``MULTIHOST_OK pid=... devices=... B=...
finite=...`` and a ``MULTIHOST_INFO {...}`` line (this process's entries,
its K1 and K2 launches by kernel and width, its wall, whether the
kernels' library was built before it started). With ``--out``, rank 0
saves the gathered result (``xs``, ``us``, the per-lane statistics
``iterations``, ``al_iterations``, ``converged`` and the other fields of
the ``ILQRResult``) to that ``.npz``.

``--sweep-deploy N`` runs ``examples/sweep.py::run_sweep_deploy(N,
shard=S)`` instead, each shard spread over the global mesh, its budgets
cut by ``--max-iter`` and ``--max-al-iter``; ``--out`` is then the
checkpoint directory (rank 0 writes it, every rank resumes from it).

On the card the processes load the kernels' library; rank 0 builds it
first if it is not there, and the others wait for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from optimization_dynamics_tpu_torch.examples import cartpole as ex
from optimization_dynamics_tpu_torch.examples import sweep
from optimization_dynamics_tpu_torch.ops.kernels import _build
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
from optimization_dynamics_tpu_torch.parallel import mesh as pm
from optimization_dynamics_tpu_torch.solver.ilqr_batched import solve_batched
from optimization_dynamics_tpu_torch.utils.checkpoint import (
    SweepCheckpointer, save_result)

T_WORKER = 11


def _launches() -> dict:
    """K1's launches by kernel and width, K2's by shape, kernel and width."""
    key = lambda k: " ".join(str(v) for v in k)
    return {"fused_ip": {key(k): n for k, n in sorted(fused_ip.widths.items())},
            "batched_solve": {key(k): n for k, n in
                              sorted(batched_solve.shape_widths.items())}}


def _clear_launches() -> None:
    for w in (fused_ip, batched_solve):
        w.launches = w.tile_launches = 0
        w.widths.clear()
    batched_solve.shapes.clear()
    batched_solve.shape_widths.clear()


def _solve_worker_problem(args, mesh, device, dtype):
    """The reference worker's batched solve, each entry's rows on it; the
    gathered result and the number of entries that solved rows here."""
    problems = {}

    def problem(dev):
        if dev not in problems:
            prob, x0, us0, opts = ex.build_problem("friction", device=dev,
                                                   dtype=dtype)
            problems[dev] = (prob._replace(T=T_WORKER),
                             us0[:T_WORKER - 1],
                             dataclasses.replace(opts, max_iter=4,
                                                 max_al_iter=2))
        return problems[dev]

    solved = [0]

    def solve_rows(x0s):
        prob, us0, opts = problem(x0s.device)
        solved[0] += 1
        return solve_batched(prob, x0s, us0, opts)

    B = args.batch or 2 * len(mesh)
    x0 = np.zeros(ex.NX)
    rng = np.random.RandomState(0)
    x0s = np.tile(x0, (B, 1)) + 0.01 * rng.randn(B, ex.NX)
    res = pm.sharded_map(solve_rows, mesh)(
        torch.as_tensor(x0s, dtype=dtype, device=device))
    return res, solved[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--local-devices", type=int, default=None,
                    help="mesh entries of this process (default: the "
                         "visible cards; 1 with --device cpu)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--dtype", default="f64", choices=("f32", "f64"))
    ap.add_argument("--sweep-deploy", type=int, default=None, metavar="N")
    ap.add_argument("--shard", type=int, default=128)
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--max-al-iter", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.sweep_deploy is not None and not args.out:
        ap.error("--sweep-deploy needs --out (the checkpoint directory)")
    on_gpu = args.device == "cuda"
    if on_gpu and not torch.cuda.is_available():
        print("multihost_worker: no CUDA device (pass --device cpu to run "
              "the plain versions)", file=sys.stderr)
        return 1
    if on_gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    local = None
    if args.local_devices is not None or not on_gpu:
        local = [args.device] * (args.local_devices or 1)
    pm.initialize("localhost:%d" % args.port, args.num_processes,
                  args.process_id, devices=local)
    try:
        prebuilt = None
        if on_gpu:
            prebuilt = _build.library_path().exists()
            if args.process_id == 0:
                _build.load_library()
            dist.barrier()
            _build.load_library()
        assert pm.process_count() == args.num_processes, pm.process_count()
        mesh = pm.scenario_mesh()
        mine = mesh.mine()
        device = mesh[mine[0]]
        dtype = torch.float32 if args.dtype == "f32" else torch.float64
        _clear_launches()
        t0 = time.perf_counter()
        if args.sweep_deploy is not None:
            stats = sweep.run_sweep_deploy(
                args.sweep_deploy, shard=args.shard, out_dir=args.out,
                verbose=False, device=device, max_iter=args.max_iter,
                max_al_iter=args.max_al_iter)
            wall = time.perf_counter() - t0
            ck = SweepCheckpointer(args.out)
            xs = [ck.load(s)[0]["xs"] for s in ck.completed_shards()]
            B = sum(x.shape[0] for x in xs)
            n_finite = sum(int(np.isfinite(x.reshape(x.shape[0], -1))
                               .all(axis=1).sum()) for x in xs)
            info = dict(summaries=stats)
        else:
            res, solved = _solve_worker_problem(args, mesh, device, dtype)
            if on_gpu:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            B = res.xs.shape[0]
            n_finite = int(torch.isfinite(res.xs.reshape(B, -1))
                           .all(dim=1).sum())
            total = torch.tensor([solved])
            dist.all_reduce(total)
            assert solved == len(mine) and int(total) == len(mesh), \
                (solved, int(total), len(mesh))
            if args.out and args.process_id == 0:
                save_result(args.out, res, meta=dict(
                    B=B, devices=len(mesh), processes=args.num_processes,
                    dtype=args.dtype))
            info = dict(converged=int(res.converged.sum()))
        assert n_finite == B, "non-finite lanes: %d of %d" % (B - n_finite, B)
        info.update(pid=args.process_id, device=str(device),
                    entries=[str(mesh[i]) for i in mine],
                    mesh=[str(d) for d in mesh], wall_s=wall,
                    library_prebuilt=prebuilt, launches=_launches())
        print("MULTIHOST_INFO %s" % json.dumps(info), flush=True)
        print("MULTIHOST_OK pid=%d devices=%d B=%d finite=%d"
              % (args.process_id, len(mesh), B, n_finite), flush=True)
    finally:
        pm.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
