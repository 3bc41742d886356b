"""Loop-overhead probe: what one loop trip costs inside a CUDA kernel.

Port of ``scripts/loop_overhead_r5.py``: the K5 kernel
(``ops/kernels/loop_overhead.py``) runs N = 1000 logical iterations of
``z = z * 0.999 + 0.001; z = z + max(z, axis=0) * 1e-6`` on a (10, 128)
float32 carry in three loop structures (``plain``: N trips; ``reps8``:
N/8 trips of eight; ``while``: a runtime trip count with an early-exit
test), and prints for each the reference script's line, timed with CUDA
events over 20 launches after one warm-up. Run it on the card with

    python -m optimization_dynamics_tpu_torch.scripts.loop_overhead

``--device`` defaults to ``cuda`` and the script stops if there is no
CUDA device; ``--device cpu`` runs the plain version and times it with
the host clock (not a device time).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from optimization_dynamics_tpu_torch.ops.kernels.loop_overhead import (
    N_ITER,
    SHAPE,
    VARIANTS,
    loop_overhead,
)

REPS = 20


def probe_input(device, seed: int = 0) -> torch.Tensor:
    """The reference's carry: uniform [0, 1) (10, 128) float32 from a
    numpy seed."""
    x = np.random.RandomState(seed).rand(*SHAPE)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def time_variant(x: torch.Tensor, variant: str, reps: int = REPS) -> float:
    """Mean milliseconds of one launch over ``reps`` launches after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    loop_overhead(x, variant)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            loop_overhead(x, variant)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        loop_overhead(x, variant)
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version)")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("loop_overhead: no CUDA device; pass --device cpu "
                         "to run the plain version on the CPU")
    x = probe_input(device)
    out = {}
    for variant in VARIANTS:
        ms = time_variant(x, variant, args.reps)
        out[variant] = ms
        print("%-8s  %8.3f ms total,  %7.3f us per logical iteration"
              % (variant, ms, 1e3 * ms / N_ITER), flush=True)
    return out


if __name__ == "__main__":
    main()
