"""Card measurements of the port's deploy solves (cartpole, planar push,
acrobot, hopper, rocket).

Run from the repository root on a machine with one CUDA card:

    python -m tools.torch_measure deploy --dtype f64 --batch 512
    python -m tools.torch_measure deploy --dtype f32 --batch 16 --lanes
    python -m tools.torch_measure profile
    python -m tools.torch_measure deploy|profile --fused-rollout \
        --riccati-kernel
    python -m tools.torch_measure deploy --model planar_push
    python -m tools.torch_measure profile --model planar_push
    python -m tools.torch_measure deploy --model acrobot [--dtype f64]
    python -m tools.torch_measure profile --model acrobot
    python -m tools.torch_measure deploy|profile --model hopper \
        [--riccati-kernel]
    python -m tools.torch_measure deploy --model rocket [--log]
    python -m tools.torch_measure profile --model rocket

``deploy`` runs the example's deploy solve (``examples/cartpole.py``,
``examples/planar_push.py``, ``examples/acrobot.py``,
``examples/hopper.py`` or ``examples/rocket.py``, ``main --deploy``),
which prints its own summary, then prints one JSON line: the K1 (K1n for
push, K1a for acrobot; the ``hopper`` and ``rocket_projection``
functors), K2, K3 and K4 launches of the solve, each one's
launches by kernel (tile, group, or per-thread) and width, K2's by (n,
k) and by (n, k, kernel, width) (the rocket's K1 and K2: the solve's
alone, not its thrust-cone check's), the mean
and median converged objective and, with ``--lanes``, each lane's flag,
objective and inner iterations. The batch defaults to the deploy width:
512 for cartpole, 256 for push, acrobot, hopper and the rocket (the
rocket in projection mode, T=61, the reference bench's executor
settings; ``--log`` prints its progress, so a run that a time limit
cuts still shows the AL rounds it finished). ``--fused-rollout``
(cartpole only) and ``--riccati-kernel`` (cartpole and hopper) turn on
K4 and K3, as the example's flags of the same names do: the K3+K4 cell,
the hopper's K3 cell.

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
import pstats
import re
import time
from collections import Counter

import numpy as np
import torch


def _launch_counters():
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
        fused_rollout)
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward)

    return fused_ip, batched_solve, fused_rollout, riccati_backward


def _by_width(widths) -> dict:
    """``{"tile": {B: launches}, "group": {...}, "thread": {...}}`` of a
    wrapper's ``widths`` Counter."""
    return {route: {str(b): n for (r, b), n in sorted(widths.items())
                    if r == route}
            for route in ("tile", "group", "thread")}


def _kernel_flags(args) -> list:
    return (["--fused-rollout"] * args.fused_rollout
            + ["--riccati-kernel"] * args.riccati_kernel)


def _example(args):
    """(example module, deploy batch) of ``--model``."""
    import importlib

    ex = importlib.import_module("optimization_dynamics_tpu_torch.examples."
                                 + args.model)
    return ex, args.batch or {"cartpole": 512, "planar_push": 256,
                              "acrobot": 256, "hopper": 256,
                              "rocket": 256}[args.model]


def deploy(args) -> None:
    ex, B = _example(args)
    counters = _launch_counters()
    for c in counters:
        c.launches = 0
        c.widths.clear()
    k1, k2, k4, k3 = counters
    k2.shape_widths.clear()
    res = ex.main(["--deploy", "--device", "cuda", "--dtype", args.dtype,
                   "--batch", str(B)] + _kernel_flags(args)
                  + ["--log"] * args.log)
    # K2's launches by (n, k, kernel, width) and K1's by (kernel, width);
    # the rocket's example checks the thrust cone with K1 after the
    # solve, and keeps the solve's own
    k2_launches = getattr(ex.main, "k2_launches", k2.shape_widths)
    k1_launches, _, k1_widths = getattr(ex.main, "k1_launches", (
        k1.launches, k1.tile_launches, k1.widths))
    k2_widths, k2_shapes = Counter(), Counter()
    for (n, k, route, w), c in k2_launches.items():
        k2_widths[route, w] += c
        k2_shapes[n, k] += c
    conv = res.converged.cpu().numpy()
    obj = res.objective.double().cpu().numpy()
    out = dict(model=args.model, dtype=args.dtype, batch=B,
               fused_rollout=args.fused_rollout,
               riccati_kernel=args.riccati_kernel,
               converged=int(conv.sum()),
               launches={"fused_ip": k1_launches,
                         "batched_solve": sum(k2_launches.values()),
                         "fused_rollout": k4.launches,
                         "riccati": k3.launches},
               fused_ip_widths=_by_width(k1_widths),
               fused_rollout_widths=_by_width(k4.widths),
               batched_solve_widths=_by_width(k2_widths),
               batched_solve_shapes={"%d_%d" % nk: n for nk, n in
                                     sorted(k2_shapes.items())},
               batched_solve_shape_widths={
                   "%d_%d_%s_%d" % key: n
                   for key, n in sorted(k2_launches.items())},
               riccati_widths=_by_width(k3.widths),
               mean_obj_converged=(float(obj[conv].mean())
                                   if conv.any() else None),
               median_obj_converged=(float(np.median(obj[conv]))
                                     if conv.any() else None))
    if args.lanes:
        out.update(lane_converged=conv.tolist(), lane_objective=obj.tolist(),
                   lane_iterations=res.iterations.cpu().tolist())
    print(json.dumps(out), flush=True)


def _kernel_label(name: str) -> str:
    """The port's kernel a profiler event belongs to, by the CUDA kernel's
    name: K1 (cartpole), K1n (push) or K1a (acrobot) by the functor, each
    the tile (K1n: group) or the per-thread kernel; K2 the tile, the
    per-thread or the group solve; K3 the tile or the per-thread pass; K4
    the tile or the per-thread rollout."""
    for key, label in (("fused_ip_tile_kernel", "fused_ip (tile)"),
                       ("fused_ip_group_kernel", "fused_ip (group)"),
                       ("fused_ip_kernel", "fused_ip"),
                       ("batched_solve_group_kernel",
                        "K2 batched_solve (group)"),
                       ("batched_solve_tile_kernel",
                        "K2 batched_solve (tile)"),
                       ("batched_solve_kernel", "K2 batched_solve"),
                       ("riccati_tile_kernel", "K3 riccati (tile)"),
                       ("riccati", "K3 riccati"),
                       ("fused_rollout_tile_kernel",
                        "K4 fused_rollout (tile)"),
                       ("fused_rollout_kernel", "K4 fused_rollout")):
        if key in name:
            if label.startswith("fused_ip"):
                label = ("K1n " if "PlanarPush" in name else "K1a "
                         if "AcrobotImpact" in name else "K1 ") + label
            elif label.startswith(("K2", "K3")):
                # the shape: the template's (N, K) or (NX, NU)
                shape = re.search(r"<(?:float|double), (\d+), (\d+)>", name)
                if shape:
                    label += " (%s, %s)" % shape.groups()
            return label
    return "torch: " + name[:70]


def profile(args) -> None:
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)
    from optimization_dynamics_tpu_torch.utils.measure import (
        busy_seconds, kernel_trace)

    ex, B = _example(args)
    dev = torch.device("cuda")
    prob, x0, us0, opts = ex.build_deploy_problem(
        dev, **({"fused_rollout": True} if args.fused_rollout else {}))
    opts = dataclasses.replace(opts, max_al_iter=1,
                               riccati_kernel=args.riccati_kernel)
    x0s = ex.deploy_x0s(x0, B)
    solve = make_segmented_solver(prob, opts, B, x0.dtype, dev,
                                  max_iter_schedule=[5])

    def run():
        t0 = time.perf_counter()
        res = solve(x0s, us0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()
    k1, k2, k4, k3 = _launch_counters()
    k1.launches = k2.launches = k4.launches = k3.launches = 0
    res, wall = run()
    print("# unprofiled wall %.3f s, stats %s, launches K1 %d K2 %d K3 %d "
          "K4 %d, converged %d/%d" % (wall, dict(solve.stats), k1.launches,
                                      k2.launches, k3.launches, k4.launches,
                                      int(res.converged.sum()), B))

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

    (_, prof_wall), kern = kernel_trace(run)
    busy = busy_seconds(kern)
    print("# profiled wall %.3f s, kernels %d, device busy %.3f s, busy "
          "share %.4f" % (prof_wall, len(kern), busy, busy / prof_wall))
    by_name = {}
    for e in kern:
        name = _kernel_label(e["name"])
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
    d.add_argument("--log", action="store_true",
                   help="the rocket's progress lines, each inner iteration "
                        "and AL round with its seconds")
    pr = sub.add_parser("profile")
    for p in (d, pr):
        p.add_argument("--model",
                       choices=("cartpole", "planar_push", "acrobot",
                                "hopper", "rocket"),
                       default="cartpole")
        p.add_argument("--fused-rollout", action="store_true")
        p.add_argument("--riccati-kernel", action="store_true")
    pr.set_defaults(batch=None)
    args = ap.parse_args(argv)
    if args.fused_rollout and args.model != "cartpole":
        ap.error("--fused-rollout is cartpole's")
    if args.riccati_kernel and args.model not in ("cartpole", "hopper"):
        ap.error("--riccati-kernel is cartpole's and the hopper's")
    if getattr(args, "log", False) and args.model != "rocket":
        ap.error("--log is the rocket's")
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
