"""Profile of the scalar AL-iLQR solve on the card.

Runs one AL round of five inner iterations of an example's scalar solve
(``build_problem`` in its default mode or gait, float64,
``solver.ilqr.solve``, as the example's ``main`` without ``--deploy``
runs it) three times after a warm-up: unprofiled (its wall, with the
fused IP (K1) and batched QR (K2) launches by kernel and width), under
cProfile (the port's functions with the most cumulative host time), and
under ``torch.profiler`` (the device busy share, the union of the kernel
intervals over the profiled wall, and the device time of the largest
kernels). Run it on the card with

    python -m optimization_dynamics_tpu_torch.scripts.profile_scalar \\
        [--model cartpole|acrobot|planar_push|hopper|rocket]

It needs a CUDA device and exits without one.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import importlib
import io
import pstats
import time

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="cartpole",
                    choices=("cartpole", "acrobot", "planar_push", "hopper",
                             "rocket"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scalar: needs a CUDA device")

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        load_library)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.solver.ilqr import solve
    from optimization_dynamics_tpu_torch.utils.measure import (
        busy_seconds, kernel_trace)

    load_library()
    ex = importlib.import_module("optimization_dynamics_tpu_torch.examples."
                                 + args.model)
    prob, x0, us0, opts = ex.build_problem(device="cuda")[:4]
    opts = dataclasses.replace(opts, max_al_iter=1, max_iter=5)

    def run():
        t0 = time.perf_counter()
        res = solve(prob, x0, us0, opts)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run()
    for c in (fused_ip, batched_solve):
        c.widths.clear()
    res, wall = run()
    out = dict(model=args.model, wall_s=wall,
               iterations=int(res.iterations),
               objective=float(res.objective),
               fused_ip={"%s %d" % k: n for k, n in
                         sorted(fused_ip.widths.items())},
               batched_solve={"%s %d" % k: n for k, n in
                              sorted(batched_solve.widths.items())})
    print("# unprofiled: %s" % out, flush=True)

    pr = cProfile.Profile()
    pr.enable()
    _, host_wall = run()
    pr.disable()
    st = io.StringIO()
    pstats.Stats(pr, stream=st).sort_stats("cumulative").print_stats(
        "optimization_dynamics_tpu_torch", 25)
    print("# cProfile wall %.3f s\n%s" % (host_wall, st.getvalue()))

    (_, prof_wall), kernels = kernel_trace(run)
    busy = busy_seconds(kernels)
    out.update(profiled_wall_s=prof_wall, kernels=len(kernels),
               device_busy_s=busy, busy_share=busy / prof_wall)
    print("# profiled wall %.3f s, kernels %d, device busy %.3f s, busy "
          "share %.4f" % (prof_wall, len(kernels), busy, busy / prof_wall))
    by_name = {}
    for e in kernels:
        n, d = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, d + e["dur"] / 1e6)
    for name, (n, d) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:12]:
        print("#   %-90s n=%6d %.4f s" % (name[:90], n, d))
    return out


if __name__ == "__main__":
    main()
