"""The cartpole deploy solve with K3 and K4 on and off, on one CUDA card.

    python -m optimization_dynamics_tpu_torch.examples.deploy_compare \\
        [--batch 512] [--dtype f32] [--order off,on,on,off] [--no-profile]

"off" is the deploy solve as ``cartpole --deploy`` runs it by default
(every rollout step a K1 launch, the backward pass in eager PyTorch);
"on" adds ``--fused-rollout --riccati-kernel`` (every rollout one K4
launch, every backward pass one K3 launch); "k3" and "k4" turn on one
of the two. All solve the same scenarios (``deploy_x0s``, seed 0) with
the deploy executor settings.

After one short warm-up solve, the full solves run in the given
order, in turns, so that both versions meet the same card. Each prints
one JSON line: wall seconds, converged lanes, mean and median converged
objective, mean inner iterations, AL rounds, and the launches of the
four kernels.

Then, unless ``--no-profile``, "off" and "on" solve one AL round of five
inner iterations three times: unprofiled (wall), and under
``torch.profiler`` (device busy share: the union of the kernel intervals
over the profiled wall; device time per kernel). Every line names the
card and its power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.examples import cartpole as ex
from optimization_dynamics_tpu_torch.ops.kernels._build import load_library
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
    fused_rollout,
)
from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
    riccati_backward,
)
from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
    make_segmented_solver,
)

# --order token -> (K4 rollouts, K3 backward pass)
VERSIONS = {"off": (False, False), "on": (True, True), "k3": (False, True),
            "k4": (True, False)}
COUNTERS = {"fused_ip": fused_ip, "batched_solve": batched_solve,
            "riccati": riccati_backward, "fused_rollout": fused_rollout}
# kernel-name fragment in a trace -> the port's name for it
TRACE_NAMES = {"fused_ip_kernel": "K1 fused_ip",
               "fused_ip_tile_kernel": "K1 fused_ip (tile)",
               "batched_solve_kernel": "K2 batched_solve",
               "riccati_kernel": "K3 riccati",
               "fused_rollout_kernel": "K4 fused_rollout",
               "fused_rollout_tile_kernel": "K4 fused_rollout (tile)"}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _solver(version: str, B: int, dtype, schedule, al_rounds=None):
    dev = torch.device("cuda")
    k4, k3 = VERSIONS[version]
    prob, x0, us0, opts = ex.build_deploy_problem(dev, dtype=dtype,
                                                  fused_rollout=k4)
    opts = dataclasses.replace(opts, riccati_kernel=k3)
    if al_rounds is not None:
        opts = dataclasses.replace(opts, max_al_iter=al_rounds)
    solve = make_segmented_solver(
        prob, opts, B, x0.dtype, dev, max_iter_schedule=schedule,
        al_stall_rounds=ex.DEPLOY_AL_STALL_ROUNDS)
    return solve, ex.deploy_x0s(x0, B, seed=0), us0


def _timed(solve, x0s, us0):
    for c in COUNTERS.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, {k: c.launches
                                           for k, c in COUNTERS.items()}


def _busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def _profile(version: str, B: int, dtype) -> dict:
    from torch.profiler import ProfilerActivity, profile

    solve, x0s, us0 = _solver(version, B, dtype, [5], al_rounds=1)
    _timed(solve, x0s, us0)
    res, wall, launches = _timed(solve, x0s, us0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_wall, _ = _timed(solve, x0s, us0)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    kern = [e for e in events if e.get("cat") == "kernel"]
    busy = _busy_seconds((e["ts"], e["ts"] + e["dur"]) for e in kern) / 1e6
    by_name = {}
    for e in kern:
        name = next((v for k, v in TRACE_NAMES.items() if k in e["name"]),
                    "torch")
        n, d = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, d + e["dur"] / 1e6)
    return dict(version=version, unprofiled_wall_s=wall, launches=launches,
                converged=int(res.converged.sum()),
                profiled_wall_s=prof_wall, device_busy_s=busy,
                busy_share=busy / prof_wall, n_kernels=len(kern),
                device_s_by_kernel={k: dict(n=n, s=d)
                                    for k, (n, d) in by_name.items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--order", default="off,on,on,off")
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("deploy_compare: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    card = _card()
    load_library()
    B = args.batch
    order = args.order.split(",")
    if not set(order) <= set(VERSIONS):
        ap.error("--order takes %s" % ", ".join(VERSIONS))
    for version in sorted(set(order)):
        _timed(*_solver(version, B, dtype, [1], al_rounds=1))
    for version in order:
        solve, x0s, us0 = _solver(version, B, dtype,
                                  ex.DEPLOY_MAX_ITER_SCHEDULE)
        res, wall, launches = _timed(solve, x0s, us0)
        conv = res.converged.cpu().numpy()
        obj = res.objective.double().cpu().numpy()
        print(json.dumps(dict(
            card=card, version=version, dtype=args.dtype, batch=B,
            wall_s=wall, converged=int(conv.sum()),
            mean_converged_objective=(float(obj[conv].mean())
                                      if conv.any() else None),
            median_converged_objective=(float(np.median(obj[conv]))
                                        if conv.any() else None),
            mean_inner_iters=float(res.iterations.float().mean()),
            al_rounds=int(res.al_iterations.max()), launches=launches,
            stats=dict(solve.stats))), flush=True)
    if not args.no_profile:
        for version in ("off", "on"):
            print(json.dumps(dict(card=card,
                                  profile=_profile(version, B, dtype))),
                  flush=True)


if __name__ == "__main__":
    main()
