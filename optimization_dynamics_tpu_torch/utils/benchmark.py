"""Timing harness: the examples' ``@benchmark`` equivalent.

Port of ``optimization_dynamics_tpu/utils/benchmark.py``: robust
statistics over repeated calls, each timed to the card's end.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np

from optimization_dynamics_tpu_torch.utils.profiling import block_until_ready

__all__ = ["BenchStats", "benchmark"]


class BenchStats(NamedTuple):
    mean_s: float
    median_s: float
    min_s: float
    max_s: float
    runs: int
    compile_s: float

    def __repr__(self):
        return (f"BenchStats(median {self.median_s * 1e3:.3f} ms, "
                f"min {self.min_s * 1e3:.3f} ms over {self.runs} runs; "
                f"compile {self.compile_s:.2f} s)")


def benchmark(fn: Callable, *args, runs: int = 10,
              warmup: int = 1) -> BenchStats:
    """Time ``fn(*args)``; every call ends with a device barrier
    (``block_until_ready`` on its outputs).

    There is no ``jit``: ``compile_s`` is the first call's wall time,
    which includes a kernel build on the first use of a CUDA kernel in
    the process (``ops/kernels/_build.py``) and the allocator's first
    requests. ``warmup`` counts that call, as the reference's does."""
    t0 = time.perf_counter()
    block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0

    for _ in range(max(warmup - 1, 0)):
        block_until_ready(fn(*args))

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return BenchStats(
        mean_s=float(t.mean()), median_s=float(np.median(t)),
        min_s=float(t.min()), max_s=float(t.max()),
        runs=runs, compile_s=compile_s)
