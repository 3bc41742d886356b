"""Port parity: the segmented executor's options against the JAX
package's same options, part 4: the per-lane line searches under
active-lane compaction, B=8 with ``compact_min=2`` (buckets of 8 and 2
lanes), eight scenarios drawn as ``test_torch_executor_variants.py``'s
four, where lanes finish apart and the last two run compacted:
``per_lane_alpha=True`` (also held to the port's cascade under the same
compaction) and ``per_lane_alpha="device"``, whose alpha memory is
gathered and scattered with the lanes.
"""

import torch

from tests.test_torch_executor_variants import (
    acrobot_x0s, assert_matches_jax, assert_same_decisions, port_solve,
    run_both)

torch.set_num_threads(1)

X0S_8 = acrobot_x0s(8, seed=0, scale=0.05)


def test_per_lane_alpha_compaction_matches_jax_and_cascade():
    cascade = port_solve(X0S_8, compact_min=2)[0]
    rt, st, logs, rj, sj, _ = run_both(X0S_8, per_lane_alpha=True,
                                       compact_min=2)
    assert_matches_jax(rt, st, rj, sj)
    assert_same_decisions(rt, cascade)
    assert any("W=2" in s for s in logs if "inner" in s), logs
    assert st["sweep_lanes"] < 8 * st["inner_iters"]


def test_device_adaptive_matches_jax():
    """The one-call adaptive iteration: the reference's decisions and
    counters; every iteration rolls the two-alpha window (``roll_lanes``
    at least twice the iterations), and the solver is reusable with a
    fresh alpha memory."""
    rt, st, logs, rj, sj, ts = run_both(X0S_8, per_lane_alpha="device",
                                        compact_min=2)
    assert_matches_jax(rt, st, rj, sj)
    assert st["roll_lanes"] >= 2 * st["inner_iters"]
    assert any("W=2" in s for s in logs if "inner" in s), logs
    r2 = ts(torch.as_tensor(X0S_8) + 0.01,
            torch.zeros((7, 1), dtype=torch.float64))
    assert bool(torch.isfinite(r2.xs).all())
