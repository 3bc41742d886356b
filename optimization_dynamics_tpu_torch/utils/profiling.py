"""Profiling hooks.

Port of ``optimization_dynamics_tpu/utils/profiling.py``:

* ``PhaseTimer``: a per-phase wall-time accumulator the segmented
  executor takes (``make_segmented_solver(..., timers=...)``), so a phase
  breakdown needs no access to the executor's closures;
* ``trace(log_dir)``: ``torch.profiler`` over the host and the card,
  written into ``log_dir`` as a Chrome trace (Perfetto or
  ``chrome://tracing`` open it); ``annotate(name)``: a named region on
  that trace's timeline;
* ``block_until_ready(out)``: the barrier both use, a
  ``torch.cuda.synchronize`` for every CUDA device among ``out``'s
  tensors.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.utils._pytree as pytree

__all__ = ["trace", "annotate", "PhaseTimer", "block_until_ready"]


def block_until_ready(out):
    """Wait for the work behind ``out`` (a tree of tensors): one
    ``torch.cuda.synchronize`` a CUDA device among its tensors; nothing
    for CPU tensors, whose operators return finished. Returns ``out``."""
    devs = {l.device for l in pytree.tree_leaves(out)
            if isinstance(l, torch.Tensor) and l.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)
    return out


class PhaseTimer:
    """Accumulates wall time per named phase with device barriers.

    ``wrap(name, fn)`` returns ``fn`` with a barrier after each call
    (``block_until_ready`` on its output), so the recorded time is the
    phase's own wall time on the card, host and launches included:
    what a latency budget needs. The barrier makes phases synchronous;
    use it only while profiling.
    """

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def wrap(self, name: str, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = block_until_ready(fn(*a, **k))
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            return out
        return run

    def report(self, total_s: float | None = None) -> dict:
        """Phase table sorted by cost; with ``total_s`` also the
        unattributed residual (host logic and launch gaps)."""
        out = {
            "phases_s": {k: round(v, 3) for k, v in sorted(
                self.times.items(), key=lambda kv: -kv[1])},
            "phase_calls": dict(self.counts),
            "phase_mean_ms": {
                k: round(1e3 * v / max(self.counts.get(k, 1), 1), 1)
                for k, v in self.times.items()},
        }
        if total_s is not None:
            out["total_wall_s"] = round(total_s, 3)
            out["host_and_dispatch_s"] = round(
                total_s - sum(self.times.values()), 3)
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block, host and card (the card where CUDA is
    available), and write a Chrome trace ``<host>_<pid>.<ns>.pt.trace.json``
    into ``log_dir``:

    >>> with trace("/tmp/odt_trace"):
    ...     block_until_ready(run(batch))
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)
