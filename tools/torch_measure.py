"""Card measurements of the port's deploy solves (cartpole, planar push,
acrobot).

Run from the repository root on a machine with one CUDA card:

    python -m tools.torch_measure deploy --dtype f64 --batch 512
    python -m tools.torch_measure deploy --dtype f32 --batch 16 --lanes
    python -m tools.torch_measure profile
    python -m tools.torch_measure deploy --model planar_push
    python -m tools.torch_measure profile --model planar_push
    python -m tools.torch_measure deploy --model acrobot [--dtype f64]
    python -m tools.torch_measure profile --model acrobot

``deploy`` runs the example's deploy solve (``examples/cartpole.py`` or
``examples/planar_push.py``, ``examples/acrobot.py``, ``main
--deploy``), which prints its own summary, then prints one JSON line: the
K1 (K1n for push, K1a for acrobot) and K2 launches of the solve, the
median converged objective and, with ``--lanes``, each lane's flag,
objective and inner iterations. The batch defaults to the deploy width:
512 for cartpole, 256 for push and acrobot.

``profile`` solves one AL round of five inner iterations at the deploy
width in float32 three times after a warm-up: unprofiled (wall), under
cProfile (host time per function of the port, and the 25 functions of
any module with the most time of their own), and under
``torch.profiler`` (kernel timeline). It prints the device busy share,
the union of the kernel intervals over the profiled wall, and the device
time per kernel.
"""

import argparse
import cProfile
import dataclasses
import io
import json
import os
import pstats
import tempfile
import time

import numpy as np
import torch


def _launch_counters():
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip

    return fused_ip, batched_solve


def _example(args):
    """(example module, deploy batch) of ``--model``."""
    import importlib

    ex = importlib.import_module("optimization_dynamics_tpu_torch.examples."
                                 + args.model)
    return ex, args.batch or {"cartpole": 512, "planar_push": 256,
                              "acrobot": 256}[args.model]


def deploy(args) -> None:
    ex, B = _example(args)
    k1, k2 = _launch_counters()
    k1.launches = k2.launches = 0
    res = ex.main(["--deploy", "--device", "cuda", "--dtype", args.dtype,
                   "--batch", str(B)])
    conv = res.converged.cpu().numpy()
    obj = res.objective.double().cpu().numpy()
    out = dict(model=args.model, dtype=args.dtype, batch=B,
               launches={"fused_ip": k1.launches,
                         "batched_solve": k2.launches},
               median_obj_converged=(float(np.median(obj[conv]))
                                     if conv.any() else None))
    if args.lanes:
        out.update(lane_converged=conv.tolist(), lane_objective=obj.tolist(),
                   lane_iterations=res.iterations.cpu().tolist())
    print(json.dumps(out), flush=True)


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


def profile(args) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    ex, B = _example(args)
    dev = torch.device("cuda")
    prob, x0, us0, opts = ex.build_deploy_problem(dev)
    opts = dataclasses.replace(opts, max_al_iter=1)
    x0s = ex.deploy_x0s(x0, B)
    solve = make_segmented_solver(prob, opts, B, x0.dtype, dev,
                                  max_iter_schedule=[5])

    def run():
        t0 = time.perf_counter()
        res = solve(x0s, us0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()
    k1, k2 = _launch_counters()
    k1.launches = k2.launches = 0
    res, wall = run()
    print("# unprofiled wall %.3f s, stats %s, launches K1 %d K2 %d, "
          "converged %d/%d" % (wall, dict(solve.stats), k1.launches,
                               k2.launches, int(res.converged.sum()), B))

    pr = cProfile.Profile()
    pr.enable()
    _, host_wall = run()
    pr.disable()
    print("# cProfile wall %.3f s" % host_wall)
    st = io.StringIO()
    pstats.Stats(pr, stream=st).sort_stats("cumulative").print_stats(
        "optimization_dynamics_tpu_torch", 30)
    pstats.Stats(pr, stream=st).sort_stats("tottime").print_stats(25)
    print(st.getvalue())

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as p:
        _, prof_wall = run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    p.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    kern = [e for e in events if e.get("cat") == "kernel"]
    busy = _busy_seconds((e["ts"], e["ts"] + e["dur"]) for e in kern) / 1e6
    print("# profiled wall %.3f s, kernels %d, device busy %.3f s, busy "
          "share %.4f" % (prof_wall, len(kern), busy, busy / prof_wall))
    by_name = {}
    for e in kern:
        name = ("K1n fused_ip" if "PlanarPush" in e["name"] else
                "K1a fused_ip" if "AcrobotImpact" in e["name"] else
                "K1 fused_ip" if "fused_ip_kernel" in e["name"] else
                "K2 batched_solve" if "batched_solve_kernel" in e["name"]
                else "torch: " + e["name"][:70])
        n, d = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, d + e["dur"] / 1e6)
    for name, (n, d) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]:
        print("#   %-80s n=%6d %.4f s" % (name, n, d))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    d = sub.add_parser("deploy")
    d.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    d.add_argument("--batch", type=int, default=None)
    d.add_argument("--lanes", action="store_true")
    pr = sub.add_parser("profile")
    for p in (d, pr):
        p.add_argument("--model",
                       choices=("cartpole", "planar_push", "acrobot"),
                       default="cartpole")
    pr.set_defaults(batch=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_measure: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        load_library)

    load_library()
    {"deploy": deploy, "profile": profile}[args.what](args)


if __name__ == "__main__":
    main()
