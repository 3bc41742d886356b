"""Time K1 (cartpole) and K2 at (35, 13) on the card, to compare two
checkouts in one call, and K1's two kernels against each other by width.

Run on a machine with one CUDA card:

    python tools/kernel_times.py [--root DIR] [--widths 1600,6400]

``--root`` is the checkout whose ``optimization_dynamics_tpu_torch`` is
imported (default: the one this script sits in; it needs
``utils/measure.py``), so the same script times a parent commit unpacked
into a directory: run parent, change, change, parent and compare within
the call.

The inputs come from ``utils/measure.py``, as ``chip_smoke.py`` phases 1
and 7 take them: float32 K1 on 1,024 cold (a rollout step's width, B x 2
alphas at B=512, numpy seed 4), 25,600 cold (seed 1) and 25,600 warm
swing-up-envelope scenarios at the deploy IP options, through the
wrapper's own choice of kernel; K2 on the 6,400 (35, 13) IFT systems at
K1n's cold solutions, beside ``torch.linalg.solve`` on them. At each of
``--widths`` K1 runs cold (seed 1) and warm-started one iterate earlier,
through the tile kernel and through the per-thread kernel in turn (the
wrapper's width cut, ``FUSED_IP_TILE_MAX_B``, set for the call). Each
time is the median of CUDA events over ``--reps`` launches after a
warm-up. Prints one JSON line with the card's ``nvidia-smi`` name and
power limit.
"""

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--widths", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    from optimization_dynamics_tpu_torch.examples import planar_push as push
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.ops.kernels import _build
    from optimization_dynamics_tpu_torch.ops.kernels import fused_ip as k1
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions, batched_jacobian)
    from optimization_dynamics_tpu_torch.utils.measure import (
        cuda_ms, envelope_batch, nvidia_smi, push_batch, rel_residual,
        warm_batch)

    dev, f32 = torch.device("cuda"), torch.float32
    _build.load_library()
    out = dict(root=str(Path(args.root).resolve()), card=nvidia_smi())

    model, z0s, ths = envelope_batch(1024, 4, dev, f32)
    kern = k1.make_fused_ip_solver(model, IPOptions(**DEPLOY_IP_ACCEL), dev,
                                   f32)

    def time_k1(solve, z0, th) -> dict:
        sol = solve(z0, th)
        return dict(ms=cuda_ms(lambda: solve(z0, th), reps=args.reps),
                    converged=int(sol.converged.sum()),
                    iterations=int(sol.iterations.sum()),
                    max_iterations=int(sol.iterations.max()))

    def routed(tile: bool):
        """K1 through one kernel: the width cut set for the call."""
        cut = _build.FUSED_IP_TILE_MAX_B

        def solve(z0, th):
            old = cut["cartpole_friction"]
            cut["cartpole_friction"] = z0.shape[0] if tile else 0
            try:
                return kern(z0, th)
            finally:
                cut["cartpole_friction"] = old
        return solve

    def cold_warm(B: int):
        _, z0c, thc = envelope_batch(B, 1, dev, f32)
        return (z0c, thc), warm_batch(kern, model, z0c, thc, 3)

    cold, warm = cold_warm(25600)
    for case, (z0, th) in {"cold_1024": (z0s, ths), "cold_25600": cold,
                           "warm_25600": warm}.items():
        out["k1_" + case] = time_k1(kern, z0, th)
    for w in filter(None, args.widths.split(",")):
        for case, (z0, th) in zip(("cold_", "warm_"), cold_warm(int(w))):
            out["k1_" + case + w] = {
                name: time_k1(routed(name == "tile"), z0, th)
                for name in ("tile", "thread")}

    pm, pz, pth = push_batch(6400, 30, dev, f32)
    zs = k1.make_fused_ip_solver(pm, IPOptions(**push.DEPLOY_IP_ACCEL), dev,
                                 f32)(pz, pth).z
    A = batched_jacobian(pm.residual, 0)(zs, pth)
    b = batched_jacobian(pm.residual, 1)(zs, pth)
    out["k2_35_13"] = dict(
        ms=cuda_ms(lambda: batched_solve(A, b), reps=args.reps),
        library_ms=cuda_ms(lambda: torch.linalg.solve(A, b), reps=args.reps),
        rel_res=rel_residual(A, batched_solve(A, b), b))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
