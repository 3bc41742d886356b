#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``optimization_dynamics_tpu_torch/ops/
kernels/csrc`` and runs phases 0-21, each printing one ``#`` line:

0. card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   kernel build time in all and per source, and what ``ptxas`` reported
   per kernel (registers, static shared memory, stack frame, spill
   bytes);
1. K1 (fused IP solve) against its plain PyTorch version on the card:
   cartpole friction at the deploy IP options, on 4096 cold
   swing-up-envelope scenarios (numpy seed 0), on 25,600 cold ones (the
   derivative sweep's width) and on the same 25,600 warm-started from
   K1's solutions one iterate earlier (the sweep's warm starts), both
   through the per-thread kernel, and on 1,024 cold ones (a rollout
   step's width, B x 2 alphas at B=512, seed 4) and the 4096 through the
   tile kernel; in
   float64 (flags identical on >= 99.5% of lanes, iteration counts on
   >= 99%, max|dz| <= 1e-10 where both converge: the kernel sums in
   sequence, torch in another order, so rare ties break differently) and
   float32 (converged count within 1%, max|dq| <= 1e-4); float32 timed,
   each case with its bound;
2. K2 (batched QR solve) against its plain version: the 25,600 IFT
   systems of a derivative sweep (10x10, 8 right-hand sides, Jacobians at
   K1 solutions), the first 4,096 with one right-hand side, the first
   4,093 (a ragged batch: not a whole number of tiles a block) and
   KKT-like saddle systems, relative residual <= 1e-5 in float32 and <=
   1e-12 in float64, and on the IFT systems max|dx| / max|x| <= 1e-3
   (float32) and 1e-10 (float64); each case through the wrapper's route
   and through each of K2's two kernels at n <= 16 (tile, per-thread),
   forced by the width cut, recording whether the two give x bit for
   bit, and x bit for bit from contiguous and row-interleaved systems;
   the route at the (10, 8) cut and one system past it (the systems
   repeated to that width; with the cut at 0, one system and all of
   them); float32 timed through each kernel, one call
   and queued, beside ``torch.linalg.solve``;
3. the main path at full width: the cartpole deploy problem (float32,
   T=51) solved by the segmented executor at B=512 for two AL rounds of
   three inner iterations; outputs finite, the objective below the
   initial open-loop rollout's on most lanes, the launch counters of K2
   and of both K1 kernels above zero (the tile kernel by the rollout
   steps, the per-thread one by the sweeps); then a small-input check:
   four lanes in float64
   on the card against the same solve on the CPU;
4. K3 (Riccati backward pass) against its plain version: random LQR data
   (numpy seeds) at the deploy shape (nx=4, nu=1, T=51) at B=512 and
   25,600, a ragged ``u_mask`` at (4, 3, 6), an indefinite Quu on
   every fifth lane at t=0 and a ragged batch of 509 lanes; ``ok``
   identical on every lane, relative difference <= 1e-10 in float64 and
   <= 1e-4 in float32 (on a lane that is not positive definite float32
   compares the gains only: its dV2 overflows); masked gains exactly 0;
   each case through the wrapper's route and through each of K3's two
   kernels (tile, per-thread), forced by the width cut, recording
   whether the two agree bit for bit; the route at the (4, 1) cut and
   one lane past it; float32 timed at B=512 and 25,600 through each
   kernel, one call and queued, beside an empty kernel's launch;
5. K4 (fused rollout) against its plain version: the deploy IP options,
   T=51, 1,024 lanes from ``rollout_batch``, random gains (numpy seed),
   alphas over the Armijo grid, all controls active and a ragged
   ``u_mask``; each case through the wrapper's route and through each of
   K4's two kernels (tile, per-thread), forced by the width cut; float64:
   per-step converged flags identical on >= 99.5% of lane-steps and
   max|dx| <= 1e-10 on the lanes whose every step converged in both in
   the same iteration count; float32: max|dx| <= 2e-4 on the lanes whose
   every step converged in both; then float64 K4 against the per-step K1
   path (``closed_loop`` without ``rollout_fused``; both through K1's
   tile solve at this width), max|dx| <= 1e-10 on >= 99.5% of lanes;
   float32 timed through each kernel, with its share of bound;
6. the slice's main path: the phase-3 solve with K4 for every rollout and
   K3 for every backward pass; outputs finite, the objective below the
   open-loop one on most lanes, K1, K2, K3 and K4's tile kernel launched,
   every K4 launch on the kernel its width picks (its launches by kernel
   and width printed), and K1 (either kernel) launched once per backward
   pass (by the derivative sweeps only, never per rollout step); then
   the four-lane float64 card-against-CPU check of phase 3 with both
   kernels on; K2's and K3's launches by kernel and width, each on the
   kernel its width picks;
7. K1n (the fused IP solve at nz=35, planar push) against its plain
   version at the push deploy IP options: 6,400 cold scenarios around the
   nominal pose (the push sweep's width, numpy seed 30), the same 6,400
   warm-started one iterate earlier, and 512 cold ones (a rollout step's
   width), each through the wrapper's route, and the 512 cold and 6,400
   warm through each of K1n's two kernels (group, per-thread), forced by
   the width cut; float64: flags identical on >= 99.5% of lanes, max|dz|
   <= 1e-10 where both converge in the same iteration count; float32:
   converged count within 1%, max|dq| <= 2e-4, timed, with its share of
   bound; then K2 at (35, 13) on the 6,400 IFT systems at K1n's solutions
   (one 64-thread block a system), relative residual <= 1e-12 in float64
   and <= 1e-4 in float32; float32 timed beside ``torch.linalg.solve`` on
   the same systems, with its share of bound;
8. the planar-push main path at full width: the push deploy problem
   (float32, T=26) solved by the segmented executor at B=256 for two AL
   rounds of three inner iterations; outputs finite, the objective below
   the open-loop one on most lanes, K1n's group kernel and K2 launched,
   every K1n launch on the kernel its width picks (its launches by kernel
   and width printed); then the four-lane float64 card-against-CPU check
   of phase 3 on push;
9. K1a (the fused IP solve at nz=6, acrobot with elbow joint limits)
   against its plain version at the acrobot deploy IP options (one-stage
   kappa schedule): 25,600 cold scenarios over the swing-up envelope
   (the sweep's width B x (T-1) at B=256, numpy seed 40), the same
   25,600 warm-started one iterate earlier, and 512 cold ones (a rollout
   step's width, B x 2 alphas), each through the wrapper's route, and
   the 512 cold and 25,600 warm through each of K1a's two kernels (tile,
   per-thread), forced by the width cut; float64: flags and iteration
   counts identical on every lane, max|dz| <= 1e-12 on every lane;
   float32: converged count within 1%, max|dq| <= 2e-4, timed, with its
   share of bound; then K2 at (6, 6) on the 25,600 IFT systems at K1a's
   solutions, through the wrapper's route and through each of its two
   kernels, and the route at its cut and one system past it, relative
   residual <= 1e-12 in float64 and <= 1e-4 in float32; float32 timed;
10. the acrobot main path at full width: the acrobot deploy problem
   (float32, T=101) solved by the segmented executor at B=256 for two AL
   rounds of three inner iterations; outputs finite, the terminal
   violation below the open-loop rollout's on most lanes (the rest start
   costs almost nothing and misses the goal by pi), the elbow within its
   joint limit, K1a's tile kernel and K2 launched, every K1a and K2
   launch on the kernel its width picks (their launches by kernel and
   width printed); then the four-lane float64 card-against-CPU check of
   phase 3 on the acrobot;
11. K5 (the loop-overhead probe) through its entry point
   (``scripts/loop_overhead.py``: each variant timed over 20 launches
   after a warm-up), then each variant against its plain version,
   float32 atol 1e-4 (the kernel rounds every product and sum as the
   plain loop does, so it is expected to match bit for bit);
12. K2 at the hopper's (20, 1) and (20, 13) against its plain version on
   the 5,120 Newton and IFT systems of a hopper sweep (B x (T-1) at
   B=256; ``hopper_systems``, numpy seed 50: first Newton steps from
   cold starts, IFT Jacobians at IP solutions, row-interleaved as the
   solver and the sweep pass them), relative residual <= 1e-12 in
   float64 and <= 1e-5 in float32, float32 timed one call and queued
   beside ``torch.linalg.solve``; then K3 at (16, 10), T=21, at 256 and
   253 lanes (``lqr_batch`` seeds 51, 52) with the hopper's ragged
   ``u_mask`` and, on every fifth lane, a Quu at t=0 whose last pivot is
   negative, through the wrapper's route and each of its two kernels
   (tile, per-thread), forced by the width cut: ``ok`` identical and
   "every pivot > 0", relative difference <= 1e-10 in float64 and <=
   1e-4 in float32 (float32 compares the indefinite lanes' gains only),
   masked gains exactly 0, whether the two kernels agree bit for bit
   recorded; float32 timed through each kernel;
13. the hopper main path at full width, twice: the hopper deploy problem
   (gait 1, float32, T=21) solved by the segmented executor at B=256 for
   two AL rounds of three inner iterations, with the eager backward pass
   and then with K3; each run: outputs finite, the objective and the
   constraint violation below the open-loop rollout's on most lanes,
   every IP solve in K1 on the ``hopper`` functor (launched, each launch
   on the kernel its width picks), K2 launched at (20, 13) and only
   there, on its group kernel (none at (20, 1): the Newton steps run
   inside K1), K3 launched only in the second run and on the kernel its
   width picks (launches by kernel, shape and width printed); then the
   four-lane float64 card-against-CPU check of phase 3 with the same
   backward pass (the CPU side runs K1's plain version);
14. K2 at the rocket's (10, 1), (10, 4), (12, 1) and (12, 16) against its
   plain version on the rocket's own systems (``rocket_systems``, numpy
   seed 60: the deploy's x0 scatter, thrusts inside, outside and above
   the cone; the thrust projection's first Newton step from its cold
   start and its IFT systems at its solutions, the midpoint solve's from
   y = x and at its solutions; the Jacobians row-interleaved as the
   solver and the sweep pass them) at the sweep's width 15,360 (B x
   (T-1) at B=256) and the Newton systems at a rollout's 512 too,
   through the wrapper's route and each of its two kernels (tile,
   per-thread), forced by the width cut, x bit for bit from contiguous
   and row-interleaved systems, relative residual <= 1e-12 in float64
   and <= 1e-5 in float32; float32 timed through each kernel and the
   route, one call and queued, beside the plain version and
   ``torch.linalg.solve``, with the bound;
15. the rocket main path at full width: the rocket deploy problem
   (projection mode, float32, T=61) solved by the segmented executor at
   B=256 for one AL round of three inner iterations; outputs finite, the
   objective and the constraint violation below the open-loop rollout's
   on most lanes, every lane's projected thrust in the cone, every thrust
   projection in K1 on the ``rocket_projection`` functor (launched, each
   launch on the kernel its width picks), K2 launched at (10, 4), (12, 1)
   and (12, 16) and only there (none at (10, 1): the projection's Newton
   steps run inside K1), each launch on the kernel its width picks
   (launches by shape, kernel and width printed); then the four-lane
   float64 card-against-CPU check of phase 3 (the CPU side runs K1's
   plain version);
16. K1 on ``rocket_projection`` (the thrust projection, nz=10) against its
   plain version at the deploy's projection options (r_tol 3e-5,
   kappa_tol 1e-4, 25 line-search candidates): 15,360 cold projections
   (the sweep's width, u_bar = 6 N(0, 1), u_max = 12.5,
   ``rocket_projection_batch`` numpy seed 70) and 512 (a rollout step's
   width, seed 71), each through the wrapper's route and through each of
   K1's two kernels (tile, per-thread), forced by the width cut; phase
   1's tolerances in float64, and in float32 converged counts within 1%,
   max|du_hat| <= 1e-4 where both converge and every converged thrust in
   the cone (``||u_xy|| <= u_z + 1e-4``); float32 timed through each
   kernel, one call and queued, with its bound, the plain version once a
   case;
17. K1 on ``hopper`` (nz=20) against its plain version at the hopper
   deploy's accelerator IP options: the deploy's own solves along
   open-loop rollouts of its initial controls (``hopper_deploy_batch``),
   5,120 (the sweep's width, numpy seed 80) cold and warm-started from
   K1's solutions one iterate earlier (seed 81), and 512 cold (a rollout
   step's, seed 82), as phase 16, float32 configurations within 2e-4 (the
   reference's bound for the hopper model);
18. the scalar path: the cartpole friction swing-up (``examples/
   cartpole.py::build_problem``, float64, T=51, nothing cut) solved by
   the scalar AL-iLQR ``solver.ilqr.solve`` on the card: converged, the
   constraint violation below con_tol, the final state within 1e-2 of
   the goal, the objective within 5% of one of the goldens of
   ``tests/goldens.json``; K1's tile kernel launched at width 1 (each
   rollout step) and at width 50 (each derivative sweep), K2 at (10, 8)
   (the sweeps' IFT solves), their launches by kernel and width printed
   with the wall; the derivative sweep at the solution (width 50: K1's
   tile with a ragged last block, K2 at (10, 8)) against the same sweep
   on a CPU copy of the problem, y within 1e-12, the Jacobians within
   1e-10; then ``simulate`` of the acrobot
   (``tests/test_simulate.py``'s inputs) and ``step_jac`` of every model
   (cartpole friction, the acrobot, planar push, the hopper model, the
   rocket's projected step) at three states each (numpy seed 90), float64
   on the card against the CPU: y within 1e-12, the Jacobians within
   1e-10;
19. the gradient bundle: the push translate problem with the bundle's
   Jacobians (``examples/planar_push.py::build_problem(gradient_bundle=
   True)``, float64, T=26, N=50 samples of size 1e-4 N(0, 1) a timestep,
   the draws from numpy seed 0): the bundle sweep at the initial
   trajectory (25 states: (T-1)(N+1) = 1,275 cold eval IP solves in one
   K1n launch) card against a CPU copy, the IP iteration counts first
   (identical on >= 99.5% of lanes), then y within 1e-12 and fx, fu
   within 1e-8 at the timesteps whose every solve took the same count;
   K1n's group kernel at those 1,275 lanes against its plain version
   with phase 7's checks, float64 at the scalar path's IP options and
   float32 at the push deploy's, each timed one call and queued, with
   its bound; then the scalar translate solve with the bundle's
   Jacobians on the card: converged, the block at x within 0.01 of 1,
   |u| <= 5 + 1e-6, its objective beside the golden 18.709 (the
   reference's draws differ, so not gated), K1n's group launched at
   width 1 (rollout steps) and once at width 1,275 a derivative sweep,
   no K2 launch, with the wall and the launches by width;
20. the direct-transcription hopper gait (``examples/comparisons/
   hopper_direct.py``, float64: 420 variables, 163 equality and 621
   inequality rows) solved by ``solver/direct.py::solve_direct`` on the
   card: converged, travel >= 0.5 - 1e-2, complementarity slack sum <
   1e-2 (the reference test's checks), with the wall; one Gauss-Newton
   gradient and Hessian at a perturbed w card against the CPU within
   1e-9. No kernel of the port runs there: its dense solve is
   ``torch.linalg.solve``, as the reference's is outside any Pallas
   kernel;
21. the scenario sweep (``examples/sweep.py``), a ``# sweep`` line as
   each part ends: ``scenario_mesh()`` lists the visible cards, and
   ``sharded_map`` of the acrobot's lane-batched step on 16 lanes
   (float64, numpy seed 210) equals the unsharded call bit for bit; the
   f32 deploy sweep (``run_sweep_deploy(256, shard=128)``: the deploy
   problem, the (15, 15, 25, 25, 30) schedule, ``al_stall_rounds=2``,
   nothing cut) cold into a temporary checkpoint directory, one call a
   shard (``run_sweep_deploy(128 (s + 1))``: the shards before resume
   from disk), the counts cleared before each call and read after it:
   each shard's converged count, wall, converged solves/s, IP solves, its
   non-finite fields and K1 and K2 launches by kernel and width (both
   launched on every shard, the trajectory finite and of its shape); the
   whole call on that directory again, which must solve nothing and
   launch nothing; the first shard again into a second directory with a
   ``PhaseTimer`` in the executor (its barriers order the work and change
   no operation), its checkpoint compared with the first's array by
   array (bit-identical, or the differences reported, not failed), and
   the timer's phase table with the host residual against its wall; the
   warm arm (``warm=True``), whose first shard starts cold as the cold
   arm's does, so it resumes from that checkpoint and solves the second
   shard warm from it, beside the cold arm; the friction grid
   ``run_sweep(1, shard_size=1)`` uncut (friction 0.05, the reference's
   T=51 and budgets; K1 at width 1), which must converge without a retry
   with every floating field finite and its objective within 1e-6 of the
   reference's (``GRID_REFERENCE``); and ``benchmark`` of one K1 call at
   128 cold lanes (float32, numpy seed 211).

The kernels' designs are in their wrappers' docstrings
(``ops/kernels/*.py``). K1 (cartpole, the rocket's projection, the
hopper model), K1a (acrobot) and K4 (cartpole's fused rollout) each have
two kernels, picked by the launch's width (``FUSED_IP_TILE_MAX_B``): up
to the cut (the rollout steps, the narrowed sweeps, every K4 launch of
the deploy) one scenario runs on a tile of threads, 16 for cartpole and
the rocket's projection, 32 for the hopper model and 8 for the acrobot,
in 64-thread blocks: thread j builds the Newton matrix's column j with one
dual-number residual, the tile solves it with a column a thread
(``csrc/qr_group.cuh``) and runs the line search's candidates in
parallel; K4's tile runs a scenario's 50 steps, one such solve a step.
Wider launches (the full sweeps) run one scenario a thread. K1n (planar
push, nz=35) has two kernels picked the same way: up to its cut (every
launch of the B=256 deploy) one scenario runs on a group of 64 threads,
two warps (``csrc/ip_group.cuh``): thread j builds column j, the group
solves with a column a thread, warp 0 runs the line search's candidates,
and the scenario's state sits once in shared memory; wider launches run
one scenario a thread. K2 above 16 unknowns runs one system on a
64-thread block, a column a thread; at or below 16, up to its cut
(``BATCHED_SOLVE_TILE_MAX_B``) one system on a tile of threads (the
smallest power of two >= n + k: 32 at (10, 8), 16 at (6, 6)), a column
a thread, wider launches one system a thread (at (10, 8), whose cut is
0, every launch); the hopper's (20, 1) and (20, 13) run the 64-thread
block. K3 up to its cut (``RICCATI_TILE_MAX_B``) runs one scenario on a
tile of threads (an element of the nx x nx updates a thread, up to a
warp: 16 at nx=4, 32 at the hopper's nx=16), its state and the step's
inputs in shared memory, an element or a column of the step's matrices
a thread; above 4 controls (the hopper's 10) one thread of the tile
factors Quu in shared memory for all; wider launches one scenario a
thread. K5 runs one column a thread.

Times: ``ms`` is the median of CUDA events around one call, host work
inside the call included, for every kernel; ``ms_device`` (K2, K3 and
an empty kernel), beside it, times calls queued back to back behind a
spin kernel, the card's own time a call (``utils/measure.py``). K2 is
timed on the IFT systems as the derivative sweep passes them
(``batched_jacobian``'s row-interleaved strides, read as they are).

Each kernel's ``bound_ms`` is the larger of its bytes (each input read
once, each output written once) at 3.35 TB/s and its operations at the
67 TFLOP/s of float32 outside the tensor cores (the H100 SXM data sheet),
for the timed float32 call. The IP solves' operations are counted from
the iterations this run's data took: per iteration NZ dual-number
residuals (3 residuals' work each), a Householder QR solve ((4/3) NZ^3 +
3 NZ^2) and one more residual, and per line-search trial a residual with
its merit (R + 4 NZ), where R is the residual's arithmetic counted on one
lane of its plain version. The trials are those the plain version's
solve of the same inputs needs (``interior_point.ls_trials``): on each
Newton iteration the candidates up to the first improving one.

Any failure raises and the exit code is non-zero. Before the last line it
prints the ``nvidia-smi`` line and a JSON line of the kernels: each
kernel of the two-kernel pairs is timed through itself, forced by the
width cut, and its ``launches`` are the main path's launches of it
(``fused_ip`` is K1's per-thread kernel, timed on 25,600 warm lanes,
with K1's time at 1,024 cold lanes as ``ms_cold_1024``; ``fused_ip_tile``
its tile kernel, timed on those 1,024; ``fused_rollout`` and
``fused_rollout_tile`` K4's kernels at 1,024 lanes; ``fused_ip_acrobot``
K1a's per-thread kernel at 25,600 warm lanes, ``fused_ip_acrobot_tile``
its tile kernel at 512 cold lanes; ``fused_ip_nz35`` K1n's per-thread
kernel at 6,400 warm lanes, ``fused_ip_nz35_group`` its group kernel at
512 cold lanes, with its time at 6,400 warm as ``ms_warm_6400``, its
launches in phase 19's bundle solve as ``launches_gb``, and its times
and bound at the bundle sweep's 1,275 cold lanes as ``ms_cold_1275``,
``ms_device_cold_1275`` and ``bound_ms_cold_1275`` (float32; float64,
the bundle's dtype, as ``ms_cold_1275_f64`` and
``ms_device_cold_1275_f64``);
``batched_solve`` and ``batched_solve_tile`` K2's per-thread and tile
kernels on the 25,600 (10, 8) systems, ``batched_solve_n6_k6`` and
``batched_solve_n6_k6_tile`` on the 25,600 (6, 6) ones; ``riccati`` and
``riccati_tile`` K3's per-thread and tile kernels at B=512, with their
times at 25,600 as ``ms_25600`` and ``ms_device_25600``; K2's
``library_ms`` is one call of ``torch.linalg.solve``, which waits for
the card to check its pivots, so its calls cannot be queued; and
``riccati_tile`` carries an empty kernel's launch time, both ways,
beside its bound; ``batched_solve_n20_k1`` and ``batched_solve_n20_k13``
are K2 on phase 12's 5,120 hopper Newton and IFT systems, with their
launches from phase 13's eager run; ``riccati_n16_u10`` and
``riccati_n16_u10_tile`` K3's per-thread and tile kernels at (16, 10) on
256 lanes, with their launches from phase 13's K3 run;
``batched_solve_n10_k1``, ``batched_solve_n10_k4``,
``batched_solve_n12_k1`` and ``batched_solve_n12_k16`` are K2 on phase
14's 15,360 rocket systems at each shape, ``ms`` and ``ms_device``
through the kernel the width picks (``kernel``), each kernel's forced
times beside them, with their launches from phase 15, in all and by
kernel; ``batched_solve_n10_k1`` and ``batched_solve_n20_k1``, whose
Newton solves now run inside K1, keep their entries with their launches
on phases 15 and 13, 0); ``fused_ip``, ``fused_ip_tile``,
``batched_solve`` and ``batched_solve_tile`` carry the scalar path's
launches (phase 18) as ``launches_scalar`` and the cold deploy sweep's
(phase 21) as ``launches_sweep``;
``fused_ip_rocket_projection`` and
``fused_ip_hopper`` are K1's per-thread kernels on those functors, timed
at the sweeps' widths (phases 16, 17: 15,360 cold projections, 5,120
warm hopper solves), ``fused_ip_rocket_projection_tile`` and
``fused_ip_hopper_tile`` their tile kernels, timed at 512 cold lanes,
each with ``ms_device`` and its time at the other width beside it
(``ms_<case>``), their launches from phases 15 and 13. The last line
is ``{"ok": true,
"device": {...}}``. It needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

from optimization_dynamics_tpu_torch.utils.measure import (
    cuda_ms, cut_routed, device_ms, envelope_batch, grow_batch,
    hopper_deploy_batch, hopper_systems, ift_systems, interleave_rows,
    launch_ms, lqr_batch, nvidia_smi, push_batch, rel_residual,
    rocket_projection_batch, rocket_systems, rollout_batch, routed,
    warm_batch)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes at the memory rate or
    operations at the float32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=float(nbytes), flops=float(flops))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _residual_flops(model, z0s, thetas) -> int:
    """Arithmetic of one residual evaluation, counted on the first lane of
    ``z0s``, ``thetas`` through the plain version: each elementwise add,
    subtract, multiply, divide, negation, square root, sine, cosine or sum
    element is one."""
    import torch
    from torch.overrides import TorchFunctionMode

    arith = {"add", "sub", "rsub", "mul", "div", "true_divide", "neg",
             "sqrt", "sin", "cos", "pow", "abs", "maximum", "minimum", "sum"}

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "").strip("_")
            if name.startswith("r") and name[1:] in arith:
                name = name[1:]
            if name in arith and isinstance(out, torch.Tensor):
                Count.n += out.numel()
            return out

    f64 = torch.float64
    z, th = (x[:1].to("cpu", f64) for x in (z0s, thetas))
    with Count():
        model.residual(z, th, torch.tensor(1e-3, dtype=f64))
    return Count.n


def _ip_flops(model, z0s, thetas, iterations: int, trials: int,
              solves: int) -> float:
    """Operations of ``solves`` IP solves on ``z0s``, ``thetas`` that took
    ``iterations`` Newton iterations and ``trials`` line-search trials in
    all (see the module docstring)."""
    R, nz = _residual_flops(model, z0s, thetas), model.spec.nz
    per_iter = nz * 3 * R + 4.0 / 3.0 * nz ** 3 + 3 * nz ** 2 + R
    return iterations * per_iter + trials * (R + 4 * nz) + solves * R


def _with_trials(run):
    """``run()`` with the plain solver's line-search trials counted
    (``interior_point.ls_trials``): (its result, the trials)."""
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        ls_trials)

    ls_trials.on, ls_trials.n = True, 0
    try:
        out = run()
    finally:
        ls_trials.on = False
    return out, ls_trials.n


def deploy_ip_options():
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    return IPOptions(**DEPLOY_IP_ACCEL)


def _k1_agreement(sk, sp, dtype, nq: int = 2, f32_tol: float = 1e-4,
                  min_same_iters: float = 0.99) -> dict:
    """Check K1 (or K1n) against its plain version on one batch; see the
    module docstring for the tolerances. K1n (``min_same_iters=None``)
    compares f64 z where both converged in the same iteration count and
    reports the iteration agreement without a bound."""
    import torch

    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    dz_all = (sk.z - sp.z).abs().cpu().numpy()
    dz = dz_all[both]
    same_conv = float((ck == cp).mean())
    same_it = float((sk.iterations == sp.iterations).float().mean())
    _check(bool(torch.isfinite(sk.z).all()), "K1 z not finite")
    out = dict(conv_kernel=int(ck.sum()), conv_plain=int(cp.sum()),
               lanes=len(ck), same_conv=same_conv, same_iters=same_it)
    if dtype == torch.float64:
        _check(same_conv >= 0.995, "K1 f64 converged flags agree on "
               "%.4f of lanes" % same_conv)
        if min_same_iters is None:
            both = both & (sk.iterations == sp.iterations).cpu().numpy()
            dz = dz_all[both]
            out["lanes_compared"] = int(both.sum())
        else:
            _check(same_it >= min_same_iters, "K1 f64 iteration counts "
                   "agree on %.4f of lanes" % same_it)
        err = float(dz.max()) if both.any() else float("nan")
        _check(both.sum() > 0 and err <= 1e-10, "K1 f64 max|dz| %.3e" % err)
        out["max_dz"] = err
    else:
        err = float(dz[:, :nq].max()) if both.any() else float("nan")
        _check(abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck),
               "K1 f32 converged %d vs plain %d" % (ck.sum(), cp.sum()))
        _check(both.sum() > 0 and err <= f32_tol,
               "K1 f32 max|dq| %.3e" % err)
        out["max_dq"] = err
    return out


def phase_k1(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        make_fused_ip_plain, make_fused_ip_solver)

    opts = deploy_ip_options()
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        model, z0s, ths = envelope_batch(4096, 0, device, dtype)
        kern = make_fused_ip_solver(model, opts, device, dtype)
        plain = make_fused_ip_plain(model, opts, device, dtype)
        _, z0c, thc = envelope_batch(25600, 1, device, dtype)
        z0w, thw = warm_batch(kern, model, z0c, thc, 3)
        _, z0r, thr = envelope_batch(1024, 4, device, dtype)
        cases = {"cold_4096": (z0s, ths), "cold_25600": (z0c, thc),
                 "warm_25600": (z0w, thw), "cold_1024": (z0r, thr)}
        res = {}
        for case, (z0, th) in cases.items():
            sk, (sp, trials) = kern(z0, th), _with_trials(
                lambda: plain(z0, th))
            torch.cuda.synchronize()
            res[case] = _k1_agreement(sk, sp, dtype)
            if dtype == torch.float32:
                res[case]["ms"] = cuda_ms(lambda: kern(z0, th))
                res[case]["plain_ms"] = cuda_ms(lambda: plain(z0, th),
                                                 reps=3)
                res[case].update(_bound(
                    _nbytes(z0, th, sk.z) + 4 * z0.shape[0] * 4,
                    _ip_flops(model, z0, th, int(sk.iterations.sum()),
                              trials, z0.shape[0])))
        out[name] = res
    return out


def _ift_systems(B: int, seed: int, device, dtype):
    """The IFT systems of the derivative sweep: dr/dz (B, 10, 10) and
    dr/dtheta (B, 10, 8) at cold K1 solutions of envelope scenarios."""
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        make_fused_ip_solver)

    model, z0s, ths = envelope_batch(B, seed, device, dtype)
    return ift_systems(make_fused_ip_solver(model, deploy_ip_options(),
                                            device, dtype), model, z0s, ths)


def _saddle(B: int, k: int, seed: int, device, dtype):
    """KKT-like [[H, C^T], [C, 0]] systems (zero lower-right block)."""
    import torch

    rng = np.random.default_rng(seed)
    m = 5
    A = np.zeros((B, 2 * m, 2 * m))
    Hs = rng.standard_normal((B, m, m))
    A[:, :m, :m] = Hs @ Hs.transpose(0, 2, 1) + 0.5 * np.eye(m)
    C = rng.standard_normal((B, m, m))
    A[:, :m, m:] = C.transpose(0, 2, 1)
    A[:, m:, :m] = C
    b = rng.standard_normal((B, 2 * m, k))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(A), t(b)


def _k2_routes(A, b, xp, res_tol: float, what: str, timed: bool) -> dict:
    """K2's tile and per-thread kernels on (A, b), each forced by the cut:
    relative residual <= res_tol each, max|dx| against the plain version's
    xp, x bit for bit the same from (A, b) contiguous and interleaved row
    by row (the kernels read strides), and whether the two kernels agree
    bit for bit; ``timed``: each timed on (A, b) as given, one call
    (``ms``) and queued (``ms_device``)."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        BATCHED_SOLVE_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)

    key = (A.shape[1], b.shape[2])
    out, xs = {}, {}
    for route in ("tile", "thread"):
        run = cut_routed(BATCHED_SOLVE_TILE_MAX_B, key, route == "tile",
                         batched_solve)
        tiles = batched_solve.tile_launches
        x = run(A, b)
        torch.cuda.synchronize()
        _check(batched_solve.tile_launches - tiles == (route == "tile"),
               "K2 %s: not on the %s kernel" % (what, route))
        _check(bool(torch.isfinite(x).all()), "K2 %s %s: x not finite"
               % (what, route))
        rk = rel_residual(A, x, b)
        _check(rk <= res_tol, "K2 %s %s relative residual %.3e"
               % (what, route, rk))
        for layout in ([A.contiguous(), b.contiguous()],
                       interleave_rows([A, b])):
            _check(torch.equal(run(*layout), x), "K2 %s %s: x depends on "
                   "the layout of A and b" % (what, route))
        dx = float((x - xp).abs().max())
        out[route] = dict(rel_res=rk, max_dx=dx,
                          rel_dx=dx / float(xp.abs().max()))
        if timed:
            out[route]["ms"] = cuda_ms(lambda: run(A, b))
            out[route]["ms_device"] = device_ms(lambda: run(A, b))
        xs[route] = x
    out["bitwise"] = bool(torch.equal(xs["tile"], xs["thread"]))
    out["max_dx_tile_thread"] = float((xs["tile"] - xs["thread"]).abs()
                                      .max())
    return out


def _k2_cut_sides(A, b, res_tol: float, what: str) -> dict:
    """K2 through the wrapper at its cut and one system past it (the
    systems repeated to that width, interleaved row by row as the sweep
    passes them): the tile kernel at the cut, the per-thread kernel past
    it, residual <= res_tol on each, and whether the shared systems' x
    agree bit for bit. A cut of 0 routes every width to the per-thread
    kernel: then one system and all of them."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        BATCHED_SOLVE_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)

    cut = BATCHED_SOLVE_TILE_MAX_B[A.shape[1], b.shape[2]]
    sides = (((cut, "tile"), (cut + 1, "thread")) if cut > 0
             else ((1, "thread"), (A.shape[0], "thread")))
    Ag, bg = interleave_rows(grow_batch([A, b], sides[1][0]))
    xs = {}
    for B, route in sides:
        before = batched_solve.widths[route, B]
        xs[B] = batched_solve(Ag[:B], bg[:B])
        torch.cuda.synchronize()
        _check(batched_solve.widths[route, B] == before + 1,
               "K2 %s at %d systems: not on the %s kernel" % (what, B,
                                                               route))
        rk = rel_residual(Ag[:B], xs[B], bg[:B])
        _check(rk <= res_tol, "K2 %s at %d systems: relative residual "
               "%.3e" % (what, B, rk))
    (n0, _), (n1, _) = sides
    return dict(cut=cut, bitwise=bool(torch.equal(xs[n0], xs[n1][:n0])))


def phase_k2(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        batched_solve_route)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve, batched_solve_plain)

    out = {}
    for dtype, res_tol, fwd_tol in ((torch.float32, 1e-5, 1e-3),
                                    (torch.float64, 1e-12, 1e-10)):
        name = "f32" if dtype == torch.float32 else "f64"
        rz, rth = _ift_systems(25600, 2, device, dtype)
        cases = [("ift_k8", (rz, rth)),
                 ("ift_k1", (rz[:4096], rth[:4096, :, 4:5].contiguous())),
                 ("saddle_k8", _saddle(4096, 8, 1, device, dtype)),
                 ("saddle_k1", _saddle(4096, 1, 2, device, dtype)),
                 # ragged: not a whole number of tiles a block
                 ("ift_k8_ragged", (rz[:4093], rth[:4093]))]
        res = {}
        for case, (A, b) in cases:
            xk = batched_solve(A, b)
            xp = batched_solve_plain(A, b)
            torch.cuda.synchronize()
            rk = rel_residual(A, xk, b)
            dx = float((xk - xp).abs().max())
            rel_dx = dx / float(xp.abs().max())
            _check(rk <= res_tol, "K2 %s %s relative residual %.3e"
                   % (name, case, rk))
            if case.startswith("ift"):
                _check(rel_dx <= fwd_tol, "K2 %s %s max|dx|/max|x| %.3e"
                       % (name, case, rel_dx))
            res[case] = dict(rel_res=rk,
                             rel_res_plain=rel_residual(A, xp, b),
                             max_dx=dx, rel_dx=rel_dx,
                             route=batched_solve_route(A.shape[1],
                                                       b.shape[2],
                                                       A.shape[0]))
            res[case]["routes"] = _k2_routes(
                A, b, xp, res_tol, "%s %s" % (name, case),
                timed=dtype == torch.float32 and case == "ift_k8")
            if case.startswith("ift"):
                _check(all(res[case]["routes"][r]["rel_dx"] <= fwd_tol
                           for r in ("tile", "thread")),
                       "K2 %s %s: a kernel's max|dx|/max|x| above %.0e"
                       % (name, case, fwd_tol))
        res["cut_sides_k8"] = _k2_cut_sides(rz, rth, res_tol, name)
        A, b = cases[0][1]
        res["ms_25600_k8"] = cuda_ms(lambda: batched_solve(A, b))
        res["plain_ms_25600_k8"] = cuda_ms(
            lambda: batched_solve_plain(A, b))
        # the one PyTorch call that computes the same function (timed
        # only; the port never calls it)
        res["library_ms_25600_k8"] = cuda_ms(lambda: torch.linalg.solve(A,
                                                                         b))
        n, k = A.shape[1], b.shape[2]
        res["bound_25600_k8"] = _bound(
            2 * _nbytes(b) + _nbytes(A),
            A.shape[0] * (4.0 / 3.0 * n ** 3 + 3 * n ** 2 * k))
        out[name] = res
    return out


def _zero_counts(wrapper) -> None:
    """Set a two-kernel wrapper's launch counts to 0."""
    wrapper.launches = wrapper.tile_launches = 0
    wrapper.widths.clear()


def _split_counts(name: str, wrapper) -> dict:
    """A K2 or K3 wrapper's launches since ``_zero_counts``: ``name`` its
    per-thread (or group) kernel's, ``name + "_tile"`` its tile
    kernel's."""
    return {name: wrapper.launches - wrapper.tile_launches,
            name + "_tile": wrapper.tile_launches}


def _routed_widths(what: str, wrapper, cut: int) -> dict:
    """A K2 or K3 wrapper's launches by kernel and width since
    ``_zero_counts``, each checked to be on the kernel its width picks:
    the tile kernel up to ``cut`` (the path's shape in
    ``BATCHED_SOLVE_TILE_MAX_B`` or ``RICCATI_TILE_MAX_B``), else the
    per-thread one."""
    widths = {"%s_%d" % kb: n for kb, n in sorted(wrapper.widths.items())}
    _check(all((route == "tile") == (b <= cut)
               for route, b in wrapper.widths),
           "%s launches off their route: %s" % (what, widths))
    return widths


def phase_main(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.examples import cartpole as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        BATCHED_SOLVE_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    B = 512
    prob, x0, us0, opts = ex.build_deploy_problem(device)
    _check(x0.dtype == torch.float32, "deploy dtype on the card is f32")
    opts = dataclasses.replace(opts, max_al_iter=2)
    x0s = ex.deploy_x0s(x0, B, seed=0)
    ph = make_phases(prob, opts, B, x0.dtype, device)
    xss0, _ = ph.rollout_open(x0s, us0[None].expand(B, -1, -1))
    obj0 = ph.smooth_cost(xss0, us0[None].expand(B, -1, -1))
    solve = make_segmented_solver(prob, opts, B, x0.dtype, device,
                                  max_iter_schedule=[3, 3],
                                  al_stall_rounds=1)

    fused_ip.launches = fused_ip.tile_launches = 0
    _zero_counts(batched_solve)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_ip": fused_ip.launches - fused_ip.tile_launches,
                "fused_ip_tile": fused_ip.tile_launches,
                **_split_counts("batched_solve", batched_solve)}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "main path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "objective fell on only %.3f of lanes" % fell)
    _check(launches["fused_ip"] > 0, "K1 (one thread a scenario, the "
           "sweeps) not launched on the main path")
    _check(launches["fused_ip_tile"] > 0, "K1 (a tile a scenario, the "
           "rollout steps) not launched on the main path")
    _check(launches["batched_solve"] + launches["batched_solve_tile"] > 0,
           "K2 not launched on the main path")
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(conv.sum()), batch=B,
               mean_objective=float(obj.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell,
               mean_inner_iters=float(res.iterations.float().mean()),
               batched_solve_widths=_routed_widths(
                   "K2", batched_solve, BATCHED_SOLVE_TILE_MAX_B[10, 8]))

    # small-input agreement: float64 on the card (K1 + K2) against the
    # same solve on the CPU (plain versions), accelerator IP settings
    small = []
    for dev in (device, torch.device("cpu")):
        p, x0d, usd, o = ex.build_deploy_problem(
            dev, dtype=torch.float64, ip_overrides=ex.DEPLOY_IP_ACCEL)
        o = dataclasses.replace(o, max_al_iter=1)
        s = make_segmented_solver(p, o, 4, torch.float64, dev,
                                  compact=False, max_iter_schedule=[2])
        r = s(ex.deploy_x0s(x0d, 4, seed=0), usd)
        small.append((r.objective.cpu(), r.us.cpu()))
    (obj_card, us_card), (obj_cpu, us_cpu) = small
    dobj = float((obj_card / obj_cpu - 1).abs().max())
    dus = float((us_card - us_cpu).abs().max())
    _check(dobj <= 1e-6 and dus <= 1e-6,
           "small f64 card vs CPU: rel dobj %.3e, max dus %.3e"
           % (dobj, dus))
    out["small_f64_vs_cpu"] = dict(rel_dobj=dobj, max_dus=dus)
    return out


def _rel_diff(got, ref, lanes=None) -> float:
    """Largest over the outputs of max|got - ref| / max|ref|, on
    ``lanes`` (a bool mask) or all lanes."""
    out = 0.0
    for g, r in zip(got, ref):
        if lanes is not None:
            g, r = g[lanes], r[lanes]
        if r.numel():
            scale = max(float(r.abs().max()), 1e-300)
            out = max(out, float((g - r).abs().max()) / scale)
    return out


def _riccati_flops(nx: int, nu: int) -> int:
    """Operations of one step of the recursion: the Q-terms, a Cholesky
    solve with nx + 1 right-hand sides, the value update and the stats."""
    q_terms = (2 * nx * nx + 2 * nu * nx + 4 * nx ** 3 + 2 * nx * nx * nu
               + 2 * nu * nu * nx + 2 * nu * nx * nx + nu)
    chol = nu ** 3 // 3 + nu * nu + 2 * nu * nu * (nx + 1)
    value = (2 * nu * nu + 6 * nx * nu + 2 * nu * nu * nx + 6 * nx * nx * nu
             + nx * nx)
    return q_terms + chol + value + 4 * nu


def _k3_agreement(got, ref, bad, dtype, tol: float, what: str,
                  mask) -> dict:
    """K3's outputs against its plain version's; see the module docstring
    for the checks."""
    import torch

    _check(torch.equal(got[5], ref[5]), "K3 %s: ok flags differ" % what)
    _check(torch.equal(got[5], ~bad),
           "K3 %s: ok is not 'every pivot > 0'" % what)
    _check(bool(torch.isfinite(got[0]).all() & torch.isfinite(got[1]).all()),
           "K3 %s: gains not finite" % what)
    rel = _rel_diff(got[:5], ref[:5], ~bad)
    if bool(bad.any()):
        whole = (got[:5] if dtype == torch.float64 else got[:2])
        rel = max(rel, _rel_diff(whole, ref[:len(whole)], bad))
    _check(rel <= tol, "K3 %s: relative difference %.3e" % (what, rel))
    off = mask == 0
    _check(bool((got[0][:, off] == 0).all() & (got[1][:, off] == 0).all()),
           "K3 %s: masked gains not 0" % what)
    return dict(rel_diff=rel,
                max_abs_err=float(max((g - r)[~bad].abs().max()
                                      for g, r in zip(got[:2], ref[:2]))),
                ok_lanes=int(got[5].sum()), lanes=int(got[5].numel()))


def phase_k3(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        RICCATI_TILE_MAX_B, riccati_route)
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward, riccati_backward_plain)

    # case -> (B, T, nx, nu, seed); 509 lanes are not a whole number of
    # the tile kernel's tiles a block
    cases = {"deploy_512": (512, 51, 4, 1, 10),
             "deploy_25600": (25600, 51, 4, 1, 11),
             "ragged_4_3_6": (512, 6, 4, 3, 12),
             "indefinite_512": (512, 51, 4, 1, 13),
             "ragged_batch_509": (509, 51, 4, 1, 14)}
    out = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        name = "f64" if dtype == torch.float64 else "f32"
        res, inputs = {}, {}
        for case, (B, T, nx, nu, seed) in cases.items():
            data = lqr_batch(seed, B, T, nx, nu, device, dtype)
            mask = torch.ones((T - 1, nu), dtype=dtype, device=device)
            if case.startswith("ragged_4"):
                mask[:, nu - 1] = 0
                mask[0, 0] = 0
            bad = torch.zeros(B, dtype=torch.bool, device=device)
            if case.startswith("indefinite"):
                bad[::5] = True
                data[5][bad, 0] = -1.0e4
            inputs[case] = (data, mask)
            ref = riccati_backward_plain(*data, mask)
            runs = {"route": riccati_backward}
            for route in ("tile", "thread"):
                runs[route] = cut_routed(RICCATI_TILE_MAX_B, (nx, nu),
                                         route == "tile", riccati_backward)
            got = {}
            for key, run in runs.items():
                tiles = riccati_backward.tile_launches
                got[key] = run(*data, mask)
                torch.cuda.synchronize()
                if key != "route":
                    _check(riccati_backward.tile_launches - tiles
                           == (key == "tile"),
                           "K3 %s %s: not on the %s kernel"
                           % (name, case, key))
                agree = _k3_agreement(got[key], ref, bad, dtype, tol,
                                      "%s %s %s" % (name, case, key), mask)
                if key == "route":
                    res[case] = dict(agree, route=riccati_route(nx, nu, B))
                else:
                    res[case][key] = agree
            res[case]["tile_bitwise_thread"] = all(
                torch.equal(a, b) for a, b in zip(got["tile"],
                                                  got["thread"]))
            if dtype == torch.float32 and case == "deploy_512":
                res[case]["ms"] = cuda_ms(
                    lambda: riccati_backward(*data, mask))
                res[case]["plain_ms"] = cuda_ms(
                    lambda: riccati_backward_plain(*data, mask), reps=3)
                res[case].update(_bound(
                    _nbytes(*data, mask, *got["route"][:2]) + 4 * B * 4,
                    B * (T - 1) * _riccati_flops(nx, nu)))
        if dtype == torch.float32:
            # each kernel, forced by the cut, at the deploy's width and at
            # 25,600 lanes: one call (ms) and queued (ms_device)
            for case in ("deploy_512", "deploy_25600"):
                data, mask = inputs[case]
                for route in ("tile", "thread"):
                    run = cut_routed(RICCATI_TILE_MAX_B, (4, 1),
                                     route == "tile", riccati_backward)
                    res[case][route].update(
                        ms=cuda_ms(lambda: run(*data, mask)),
                        ms_device=device_ms(lambda: run(*data, mask)))
                if case == "deploy_25600":
                    B = data[0].shape[0]
                    ks = run(*data, mask)[:2]
                    res[case].update(_bound(
                        _nbytes(*data, mask, *ks) + 4 * B * 4,
                        B * 50 * _riccati_flops(4, 1)))
            # the floor under a launch: an empty kernel on this card
            res["empty_launch"] = launch_ms()
        # the route at its cut and one lane past it (the deploy_25600 lanes
        # repeated): the tile kernel at the cut, the per-thread one past
        # it; the shared lanes' outputs bit for bit
        cut = RICCATI_TILE_MAX_B[4, 1]
        data, mask = inputs["deploy_25600"]
        data = grow_batch(data, cut + 1)
        sides = {}
        for B, route in ((cut, "tile"), (cut + 1, "thread")):
            before = riccati_backward.widths[route, B]
            sides[B] = riccati_backward(*(a[:B] for a in data), mask)
            torch.cuda.synchronize()
            _check(riccati_backward.widths[route, B] == before + 1,
                   "K3 %s at %d lanes: not on the %s kernel" % (name, B,
                                                                route))
            _check(bool(sides[B][5].all() & torch.isfinite(sides[B][0])
                        .all()), "K3 %s at %d lanes: not ok or not "
                   "finite" % (name, B))
        res["cut_sides"] = dict(cut=cut, bitwise=all(
            torch.equal(a, b[:cut]) for a, b in zip(sides[cut],
                                                    sides[cut + 1])))
        del data, sides
        out[name] = res
    return out


def _k4_agreement(k, p, dtype, what: str) -> dict:
    """K4 (xss, uss, wss, stats) against its plain version."""
    import torch

    _check(bool(torch.isfinite(k[0]).all() & torch.isfinite(k[2]).all()),
           "K4 %s: outputs not finite" % what)
    ck, cp = k[3][..., 1] > 0.5, p[3][..., 1] > 0.5
    same_flags = float((ck == cp).float().mean())
    every = ck.all(dim=1) & cp.all(dim=1)
    if dtype == torch.float64:
        every = every & (k[3][..., 0] == p[3][..., 0]).all(dim=1)
    dx = (k[0] - p[0]).abs().amax(dim=(1, 2))[every]
    err = float(dx.max()) if dx.numel() else float("nan")
    tol = 1e-10 if dtype == torch.float64 else 2e-4
    _check(float(every.float().mean()) >= 0.5,
           "K4 %s: every step converged on only %d lanes"
           % (what, int(every.sum())))
    if dtype == torch.float64:
        _check(same_flags >= 0.995, "K4 %s: per-step flags agree on %.4f "
               "of lane-steps" % (what, same_flags))
    _check(err <= tol, "K4 %s: max|dx| %.3e" % (what, err))
    return dict(same_flags=same_flags, lanes_compared=int(every.sum()),
                lanes=int(every.numel()), max_dx=err,
                step_conv_kernel=float(ck.float().mean()))


def phase_k4(device) -> dict:
    """K4 through the wrapper's route (the tile kernel at 1,024 scenarios)
    and through each of its two kernels, forced by the width cut, against
    the plain version; float32 timed through each kernel."""
    import torch

    from optimization_dynamics_tpu_torch.examples import cartpole as ex
    from optimization_dynamics_tpu_torch.models import cartpole
    from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
        make_fused_rollout, make_fused_rollout_plain)
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)

    B, T = 1024, ex.T
    opts = deploy_ip_options()
    model = cartpole.friction_model()
    ragged = np.ones((T - 1, ex.NU), bool)
    ragged[10:20] = False
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        aux = cartpole.CartpoleAux(h=ex.H, friction=torch.tensor(
            [0.35, 0.35], dtype=dtype, device=device))
        x0s, uss, Kss, kss, alphas = rollout_batch(B, 20, device, dtype)
        kern = make_fused_rollout(model, opts, aux, T, None, device, dtype)
        zero = torch.zeros_like
        xss_ref = kern(x0s, torch.zeros((B, T, ex.NX), dtype=dtype,
                                        device=device),
                       uss, zero(Kss), zero(kss), zero(alphas))[0]
        args = (x0s, xss_ref, uss, Kss, kss, alphas)
        res = {}
        for case, mask in (("all_active", None), ("ragged", ragged)):
            kern = make_fused_rollout(model, opts, aux, T, mask, device,
                                      dtype)
            plain = make_fused_rollout_plain(model, opts, aux, T, mask,
                                             device, dtype)
            p, trials = _with_trials(lambda: plain(*args))
            runs = {case: kern}
            for route in ("tile", "thread"):
                runs["%s_%s" % (case, route)] = routed(
                    model.kernel, route == "tile", kern)
            for key, run in runs.items():
                k = run(*args, return_stats=True)
                torch.cuda.synchronize()
                res[key] = _k4_agreement(k, p, dtype, "%s %s" % (name, key))
                if mask is not None:
                    _check(torch.equal(k[1][:, 10:20], uss[:, 10:20]),
                           "K4 %s %s: masked steps moved u" % (name, key))
                if dtype == torch.float32 and mask is None:
                    res[key]["ms"] = cuda_ms(lambda: run(*args))
                    nx, nu = ex.NX, ex.NU
                    res[key].update(_bound(
                        _nbytes(*args, *k[:3]) + (T - 1) * nu * 4,
                        _ip_flops(model, torch.zeros((1, model.spec.nz)),
                                  torch.zeros((1, model.spec.ntheta)),
                                  int(k[3][..., 0].sum()), trials,
                                  B * (T - 1))
                        + B * (T - 1) * (2 * nx * nu + 3 * nu)))
                    res[key]["bound_share"] = (res[key]["bound_ms"]
                                               / res[key]["ms"])
            if dtype == torch.float32 and mask is None:
                res[case]["plain_ms"] = cuda_ms(lambda: plain(*args),
                                                 reps=1)
        if dtype == torch.float64:
            # against the per-step K1 path: closed_loop without K4 (both
            # through ip_solve_tile at this width)
            prob, _, _, o = ex.build_deploy_problem(
                device, dtype=dtype, ip_overrides=ex.DEPLOY_IP_ACCEL)
            ph = make_phases(prob, o, B, dtype, device)
            xs_c = ph.closed_loop(
                xss_ref, uss, Kss, kss, alphas,
                torch.zeros((B, T - 1, 0), dtype=dtype, device=device),
                torch.zeros((B, ex.NX), dtype=dtype, device=device),
                torch.ones(B, dtype=dtype, device=device),
                torch.zeros((B, T - 1, 10), dtype=dtype, device=device))[0]
            xs_k = make_fused_rollout(model, opts, aux, T, None, device,
                                      dtype)(*args)[0]
            dx = (xs_k - xs_c).abs().amax(dim=(1, 2))
            agree = float((dx <= 1e-10).float().mean())
            _check(agree >= 0.995, "K4 vs the per-step K1 path: %.4f of "
                   "lanes within 1e-10" % agree)
            res["vs_k1_path"] = dict(lanes_within_tol=agree,
                                     max_dx=float(dx.max()))
        out[name] = res
    return out


def phase_new_path(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.examples import cartpole as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        BATCHED_SOLVE_TILE_MAX_B, FUSED_IP_TILE_MAX_B, RICCATI_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
        fused_rollout)
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward)
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    B = 512
    prob, x0, us0, opts = ex.build_deploy_problem(device, fused_rollout=True)
    _check(x0.dtype == torch.float32, "deploy dtype on the card is f32")
    opts = dataclasses.replace(opts, max_al_iter=2, riccati_kernel=True)
    x0s = ex.deploy_x0s(x0, B, seed=0)
    ph = make_phases(prob, opts, B, x0.dtype, device)
    xss0, _ = ph.rollout_open(x0s, us0[None].expand(B, -1, -1))
    obj0 = ph.smooth_cost(xss0, us0[None].expand(B, -1, -1))
    solve = make_segmented_solver(prob, opts, B, x0.dtype, device,
                                  max_iter_schedule=[3, 3],
                                  al_stall_rounds=1)

    counters = {"fused_ip": fused_ip, "fused_rollout": fused_rollout}
    for c in counters.values():
        c.launches = 0
    fused_ip.tile_launches = fused_rollout.tile_launches = 0
    fused_rollout.widths.clear()
    _zero_counts(batched_solve)
    _zero_counts(riccati_backward)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    launches["fused_ip"] -= fused_ip.tile_launches
    launches["fused_ip_tile"] = fused_ip.tile_launches
    launches["fused_rollout"] -= fused_rollout.tile_launches
    launches["fused_rollout_tile"] = fused_rollout.tile_launches
    launches.update(_split_counts("batched_solve", batched_solve))
    launches.update(_split_counts("riccati", riccati_backward))
    k2_launches = launches["batched_solve"] + launches["batched_solve_tile"]
    k3_launches = launches["riccati"] + launches["riccati_tile"]
    k4_widths = {"%s_%d" % kb: n
                 for kb, n in sorted(fused_rollout.widths.items())}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "new path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "objective fell on only %.3f of lanes" % fell)
    _check(k2_launches > 0, "batched_solve not launched on the new path")
    _check(k3_launches > 0, "riccati not launched on the new path")
    _check(launches["fused_rollout_tile"] > 0,
           "fused_rollout_tile not launched on the new path")
    # K4's route: each launch on the kernel its width picks
    cut = FUSED_IP_TILE_MAX_B["fused_rollout", "cartpole_friction"]
    _check(all((route == "tile") == (b <= cut)
               for route, b in fused_rollout.widths),
           "K4 launches off their route: %s" % k4_widths)
    # one derivative sweep (one K1 launch, of either kernel: the sweep
    # narrows as lanes converge) per backward pass (one K3 launch): no K1
    # launch comes from a rollout step
    k1_launches = launches["fused_ip"] + launches["fused_ip_tile"]
    _check(k1_launches == k3_launches,
           "K1 launched %d times for %d backward passes"
           % (k1_launches, k3_launches))
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(conv.sum()), batch=B,
               mean_objective=float(obj.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell,
               mean_inner_iters=float(res.iterations.float().mean()),
               fused_rollout_widths=k4_widths,
               batched_solve_widths=_routed_widths(
                   "K2", batched_solve, BATCHED_SOLVE_TILE_MAX_B[10, 8]),
               riccati_widths=_routed_widths("K3", riccati_backward,
                                             RICCATI_TILE_MAX_B[4, 1]))

    # small-input agreement with both kernels on: float64 on the card
    # against the same solve on the CPU (plain versions)
    small = []
    for dev in (device, torch.device("cpu")):
        p, x0d, usd, o = ex.build_deploy_problem(
            dev, dtype=torch.float64, ip_overrides=ex.DEPLOY_IP_ACCEL,
            fused_rollout=True)
        o = dataclasses.replace(o, max_al_iter=1, riccati_kernel=True)
        s = make_segmented_solver(p, o, 4, torch.float64, dev,
                                  compact=False, max_iter_schedule=[2])
        r = s(ex.deploy_x0s(x0d, 4, seed=0), usd)
        small.append((r.objective.cpu(), r.us.cpu()))
    (obj_card, us_card), (obj_cpu, us_cpu) = small
    dobj = float((obj_card / obj_cpu - 1).abs().max())
    dus = float((us_card - us_cpu).abs().max())
    _check(dobj <= 1e-6 and dus <= 1e-6,
           "new path small f64 card vs CPU: rel dobj %.3e, max dus %.3e"
           % (dobj, dus))
    out["small_f64_vs_cpu"] = dict(rel_dobj=dobj, max_dus=dus)
    return out


def _fused_ip_phase(device, batch, opts, n_sweep: int, seeds,
                    exact_f64: bool) -> dict:
    """A fused-IP instantiation (K1n, K1a) and K2 at its IFT shape against
    their plain versions: ``n_sweep`` cold lanes and the same warm-started
    one iterate earlier (the sweep's width), 512 cold ones (a rollout
    step's width), each through the wrapper's route; for a functor with a
    tile kernel, the 512 cold and the warm lanes also through each of its
    two kernels, forced by the width cut (``tile_*`` or, for K1n,
    ``group_*``, and ``thread_*``); then
    K2 on the sweep's IFT systems at the kernel's cold solutions.
    ``batch(B, seed, device, dtype) -> (model, z0s, thetas)``; ``seeds``:
    (cold, warm, 512). ``exact_f64``: every f64 flag and iteration count
    identical and max|dz| <= 1e-12 on every lane, else z compared where
    both converge in the same count (<= 1e-10)."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        FUSED_IP_TILE_MAX_B, UNROLL_MAX_N, fused_ip_narrow)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve, batched_solve_plain)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        make_fused_ip_plain, make_fused_ip_solver)

    out = {}
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        model, z0c, thc = batch(n_sweep, seeds[0], device, dtype)
        kern = make_fused_ip_solver(model, opts, device, dtype)
        plain = make_fused_ip_plain(model, opts, device, dtype)
        z0w, thw = warm_batch(kern, model, z0c, thc, seeds[1])
        _, z0s, ths = batch(512, seeds[2], device, dtype)
        cases = {"cold_%d" % n_sweep: (z0c, thc),
                 "warm_%d" % n_sweep: (z0w, thw), "cold_512": (z0s, ths)}
        runs = [(case, case, kern) for case in cases]
        if ("fused_ip", model.kernel) in FUSED_IP_TILE_MAX_B:
            narrow = fused_ip_narrow(model.kernel)
            runs += [("%s_%s" % (route, case), case,
                      routed(model.kernel, route == narrow, kern))
                     for route in (narrow, "thread")
                     for case in ("cold_512", "warm_%d" % n_sweep)]
        res, refs = {}, {}
        for key, case, solve in runs:
            z0, th = cases[case]
            if case not in refs:
                refs[case] = _with_trials(lambda: plain(z0, th))
            sk, (sp, trials) = solve(z0, th), refs[case]
            torch.cuda.synchronize()
            res[key] = _k1_agreement(
                sk, sp, dtype, nq=model.nq, f32_tol=2e-4,
                min_same_iters=1.0 if exact_f64 else None)
            res[key]["mean_iters"] = float(sk.iterations.float().mean())
            if dtype == torch.float64 and exact_f64:
                _check(res[key]["same_conv"] == 1.0, "%s f64 %s flags "
                       "differ on some lane" % (model.kernel, key))
                dz = float((sk.z - sp.z).abs().max())
                _check(dz <= 1e-12, "%s f64 %s max|dz| %.3e"
                       % (model.kernel, key, dz))
                res[key]["max_dz_all_lanes"] = dz
            if dtype == torch.float32:
                res[key]["ms"] = cuda_ms(lambda: solve(z0, th))
                if key == case:
                    res[key]["plain_ms"] = cuda_ms(lambda: plain(z0, th),
                                                    reps=1)
                res[key].update(_bound(
                    _nbytes(z0, th, sk.z) + 4 * z0.shape[0] * 4,
                    _ip_flops(model, z0, th, int(sk.iterations.sum()),
                              trials, z0.shape[0])))
                res[key]["bound_share"] = res[key]["bound_ms"] / res[key]["ms"]

        # K2 on the IFT systems of the sweep at the kernel's cold solutions
        A, b = ift_systems(kern, model, z0c, thc)
        n, k = A.shape[1], b.shape[2]
        res_tol = 1e-12 if dtype == torch.float64 else 1e-4
        xk, xp = batched_solve(A, b), batched_solve_plain(A, b)
        torch.cuda.synchronize()
        rk = rel_residual(A, xk, b)
        _check(bool(torch.isfinite(xk).all()), "K2 %s (%d, %d): x not "
               "finite" % (name, n, k))
        _check(rk <= res_tol,
               "K2 %s (%d, %d) relative residual %.3e" % (name, n, k, rk))
        dx = float((xk - xp).abs().max())
        k2 = dict(rel_res=rk, rel_res_plain=rel_residual(A, xp, b),
                  max_dx=dx, rel_dx=dx / float(xp.abs().max()))
        if n <= UNROLL_MAX_N:
            # the tile and per-thread kernels, each forced by the cut; the
            # route at the cut and one system past it
            what = "%s (%d, %d)" % (name, n, k)
            k2["routes"] = _k2_routes(A, b, xp, res_tol, what,
                                      timed=dtype == torch.float32)
            k2["cut_sides"] = _k2_cut_sides(A, b, res_tol, what)
        if dtype == torch.float32:
            k2["ms"] = cuda_ms(lambda: batched_solve(A, b))
            k2["plain_ms"] = cuda_ms(lambda: batched_solve_plain(A, b))
            # the one PyTorch call that computes the same function (timed
            # only; the port never calls it)
            k2["library_ms"] = cuda_ms(lambda: torch.linalg.solve(A, b))
            k2.update(_bound(2 * _nbytes(b) + _nbytes(A),
                             A.shape[0] * (4.0 / 3.0 * n ** 3
                                           + 3 * n ** 2 * k)))
            k2["bound_share"] = k2["bound_ms"] / k2["ms"]
        res["k2_ift_%d" % n_sweep] = k2
        out[name] = res
    return out


def phase_k1n(device) -> dict:
    """K1n (fused IP at nz=35) and K2 at (35, 13) against their plain
    versions: 6,400 cold and warm lanes (the push sweep's width, B x
    (T-1) at B=256) and 512 cold ones (a rollout step's width), the 512
    cold and 6,400 warm also through each of K1n's two kernels (group,
    per-thread), then K2 on the 6,400 IFT systems at K1n's cold
    solutions."""
    from optimization_dynamics_tpu_torch.examples import planar_push as ex
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    return _fused_ip_phase(device, push_batch,
                           IPOptions(**ex.DEPLOY_IP_ACCEL), 6400,
                           (30, 31, 32), exact_f64=False)


def phase_push(device) -> dict:
    """The planar-push deploy solve at full width (B=256, T=26, float32)
    for two AL rounds of three inner iterations, then the four-lane
    float64 card-against-CPU check."""
    import torch

    from optimization_dynamics_tpu_torch.examples import planar_push as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        FUSED_IP_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    B = 256
    prob, x0, us0, opts = ex.build_deploy_problem(device)
    _check(x0.dtype == torch.float32, "push deploy dtype on the card is f32")
    opts = dataclasses.replace(opts, max_al_iter=2)
    x0s = ex.deploy_x0s(x0, B, seed=0)
    ph = make_phases(prob, opts, B, x0.dtype, device)
    xss0, _ = ph.rollout_open(x0s, us0[None].expand(B, -1, -1))
    obj0 = ph.smooth_cost(xss0, us0[None].expand(B, -1, -1))
    solve = make_segmented_solver(prob, opts, B, x0.dtype, device,
                                  max_iter_schedule=[3, 3],
                                  al_stall_rounds=ex.DEPLOY_AL_STALL_ROUNDS)

    counters = {"fused_ip_nz35": fused_ip,
                "batched_solve_n35_k13": batched_solve}
    for c in counters.values():
        c.launches = 0
    fused_ip.tile_launches = 0
    fused_ip.widths.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    launches["fused_ip_nz35"] -= fused_ip.tile_launches
    launches["fused_ip_nz35_group"] = fused_ip.tile_launches
    k1n_widths = {"%s_%d" % kb: n
                  for kb, n in sorted(fused_ip.widths.items())}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "push path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "push xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "push objective fell on only %.3f of lanes" % fell)
    for k in ("fused_ip_nz35_group", "batched_solve_n35_k13"):
        _check(launches[k] > 0, "%s not launched on the push path" % k)
    # K1n's route: each launch on the kernel its width picks
    cut = FUSED_IP_TILE_MAX_B["fused_ip", "planar_push"]
    _check(all((route == "group") == (b <= cut)
               for route, b in fused_ip.widths),
           "K1n launches off their route: %s" % k1n_widths)
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(conv.sum()), batch=B,
               mean_objective=float(obj.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell,
               max_violation=float(res.constraint_violation.max()),
               mean_inner_iters=float(res.iterations.float().mean()),
               fused_ip_widths=k1n_widths)

    # small-input agreement: float64 on the card (K1n + K2) against the
    # same solve on the CPU (plain versions), accelerator IP settings
    small = []
    for dev in (device, torch.device("cpu")):
        p, x0d, usd, o = ex.build_deploy_problem(
            dev, dtype=torch.float64, ip_overrides=ex.DEPLOY_IP_ACCEL)
        o = dataclasses.replace(o, max_al_iter=1)
        s = make_segmented_solver(p, o, 4, torch.float64, dev,
                                  compact=False, max_iter_schedule=[2])
        r = s(ex.deploy_x0s(x0d, 4, seed=0), usd)
        small.append((r.objective.cpu(), r.us.cpu()))
    (obj_card, us_card), (obj_cpu, us_cpu) = small
    dobj = float((obj_card / obj_cpu - 1).abs().max())
    dus = float((us_card - us_cpu).abs().max())
    _check(dobj <= 1e-6 and dus <= 1e-6,
           "push small f64 card vs CPU: rel dobj %.3e, max dus %.3e"
           % (dobj, dus))
    out["small_f64_vs_cpu"] = dict(rel_dobj=dobj, max_dus=dus)
    return out


def acrobot_ip_options():
    from optimization_dynamics_tpu_torch.examples import acrobot as ex
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    return IPOptions(**ex.DEPLOY_IP_ACCEL, **ex.DEPLOY_KAPPA_SCHEDULE)


def phase_k1a(device) -> dict:
    """K1a (fused IP at nz=6, acrobot) and K2 at (6, 6) against their plain
    versions: 25,600 cold and warm lanes (the sweep's width, B x (T-1) at
    B=256) and 512 cold ones (a rollout step's width, B x 2 alphas), then
    K2 on the 25,600 IFT systems at K1a's cold solutions; every f64 flag
    and count identical."""
    from optimization_dynamics_tpu_torch.examples import acrobot as ex

    return _fused_ip_phase(device, ex.envelope_batch, acrobot_ip_options(),
                           25600, (40, 41, 42), exact_f64=True)


def phase_acrobot(device) -> dict:
    """The acrobot deploy solve at full width (B=256, T=101, float32) for
    two AL rounds of three inner iterations, then the four-lane float64
    card-against-CPU check."""
    import torch

    from optimization_dynamics_tpu_torch.examples import acrobot as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        BATCHED_SOLVE_TILE_MAX_B, FUSED_IP_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    B = 256
    prob, x0, us0, opts = ex.build_deploy_problem(device)
    _check(x0.dtype == torch.float32, "acrobot deploy dtype on the card is "
           "f32")
    opts = dataclasses.replace(opts, max_al_iter=2)
    x0s = ex.deploy_x0s(x0, B, seed=0)
    ph = make_phases(prob, opts, B, x0.dtype, device)
    uss0 = us0[None].expand(B, -1, -1)
    xss0, _ = ph.rollout_open(x0s, uss0)
    # hanging at rest costs almost nothing and misses the upright goal by
    # pi, which is a terminal equality constraint, not a cost: the swing-up
    # raises the smooth objective and lowers the terminal violation
    obj0 = ph.smooth_cost(xss0, uss0)
    vio0 = ph.con_violation(xss0, uss0)
    solve = make_segmented_solver(prob, opts, B, x0.dtype, device,
                                  max_iter_schedule=[3, 3],
                                  al_stall_rounds=ex.DEPLOY_AL_STALL_ROUNDS)

    fused_ip.launches = fused_ip.tile_launches = 0
    fused_ip.widths.clear()
    _zero_counts(batched_solve)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_ip_acrobot": fused_ip.launches - fused_ip.tile_launches,
                "fused_ip_acrobot_tile": fused_ip.tile_launches,
                **_split_counts("batched_solve_n6_k6", batched_solve)}
    k1a_widths = {"%s_%d" % kb: n
                  for kb, n in sorted(fused_ip.widths.items())}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "acrobot path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "acrobot xs shape")
    fell = float((res.constraint_violation < vio0).float().mean())
    _check(fell >= 0.5, "acrobot terminal violation fell on only %.3f of "
           "lanes" % fell)
    _check(launches["fused_ip_acrobot_tile"] > 0,
           "fused_ip_acrobot_tile not launched on the acrobot path")
    _check(launches["batched_solve_n6_k6"]
           + launches["batched_solve_n6_k6_tile"] > 0,
           "batched_solve_n6_k6 not launched on the acrobot path")
    # K1a's route: each launch on the kernel its width picks
    cut = FUSED_IP_TILE_MAX_B["fused_ip", "acrobot_impact"]
    _check(all((route == "tile") == (b <= cut)
               for route, b in fused_ip.widths),
           "K1a launches off their route: %s" % k1a_widths)
    elbow = float(res.xs[..., 3].abs().max())
    _check(elbow <= 0.5 * np.pi + 1e-3, "acrobot elbow %.6f past its "
           "joint limit" % elbow)
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(res.converged.sum()), batch=B,
               mean_objective=float(res.objective.mean()),
               mean_initial_objective=float(obj0.mean()),
               violation_fell_frac=fell,
               mean_initial_violation=float(vio0.mean()),
               mean_violation=float(res.constraint_violation.mean()),
               max_violation=float(res.constraint_violation.max()),
               max_elbow=elbow,
               mean_inner_iters=float(res.iterations.float().mean()),
               fused_ip_widths=k1a_widths,
               batched_solve_widths=_routed_widths(
                   "K2", batched_solve, BATCHED_SOLVE_TILE_MAX_B[6, 6]))

    # small-input agreement: float64 on the card (K1a + K2) against the
    # same solve on the CPU (plain versions), accelerator IP settings
    small = []
    for dev in (device, torch.device("cpu")):
        p, x0d, usd, o = ex.build_deploy_problem(
            dev, dtype=torch.float64, accelerator_ip=True)
        o = dataclasses.replace(o, max_al_iter=1)
        s = make_segmented_solver(p, o, 4, torch.float64, dev,
                                  compact=False, max_iter_schedule=[2])
        r = s(ex.deploy_x0s(x0d, 4, seed=0), usd)
        small.append((r.objective.cpu(), r.us.cpu()))
    (obj_card, us_card), (obj_cpu, us_cpu) = small
    dobj = float((obj_card / obj_cpu - 1).abs().max())
    dus = float((us_card - us_cpu).abs().max())
    _check(dobj <= 1e-6 and dus <= 1e-6,
           "acrobot small f64 card vs CPU: rel dobj %.3e, max dus %.3e"
           % (dobj, dus))
    out["small_f64_vs_cpu"] = dict(rel_dobj=dobj, max_dus=dus)
    return out


def phase_k5(device) -> dict:
    """K5 (the loop-overhead probe) through its entry point, which times
    each variant (20 launches after one warm-up), then each variant
    against its plain version, float32 atol 1e-4."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels.loop_overhead import (
        N_ITER, VARIANTS, loop_overhead, loop_overhead_plain)
    from optimization_dynamics_tpu_torch.scripts import (
        loop_overhead as script)

    loop_overhead.launches = 0
    torch.cuda.synchronize()
    ms = script.main([])
    torch.cuda.synchronize()
    out = dict(launches=loop_overhead.launches, ms=ms)
    x = script.probe_input(device)
    # bytes: the carry read once and written once; operations per
    # logical iteration: a scale, a shift and an add an element, rows - 1
    # compares for each column max and one scale of each max
    rows, cols = x.shape
    bound = _bound(2 * _nbytes(x),
                   N_ITER * (3 * x.numel() + (rows - 1) * cols + cols))
    for variant in VARIANTS:
        got = loop_overhead(x, variant)
        ref = loop_overhead_plain(x, variant)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        _check(bool(torch.isfinite(got).all()) and err <= 1e-4,
               "K5 %s max|dz| %.3e" % (variant, err))
        out[variant] = dict(
            max_abs_err=err, bitwise=bool(torch.equal(got, ref)),
            ms=ms[variant],
            plain_ms=cuda_ms(lambda: loop_overhead_plain(x, variant),
                              reps=1),
            us_per_iteration=1e3 * ms[variant] / N_ITER, **bound)
    return out


def phase_hopper_kernels(device) -> dict:
    """K2 at (20, 1) and (20, 13) on the 5,120 Newton and IFT systems of
    a hopper sweep (B=256 x 20 steps; ``utils/measure.py::
    hopper_systems``), and K3 at (16, 10) at B=256 and 253 lanes (T=21)
    with the hopper's mask and an indefinite Quu on every fifth lane,
    through the route and each of its two kernels, against their plain
    versions; see the module docstring for the tolerances."""
    import torch

    from optimization_dynamics_tpu_torch.examples import hopper as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        RICCATI_TILE_MAX_B, batched_solve_route, riccati_route)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve, batched_solve_plain)
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward, riccati_backward_plain)

    T, nx, nu = ex.T, ex.NX, ex.NU
    out = {}
    for dtype, res_tol, k3_tol in ((torch.float64, 1e-12, 1e-10),
                                   (torch.float32, 1e-5, 1e-4)):
        name = "f64" if dtype == torch.float64 else "f32"
        newton, ift = hopper_systems(5120, 50, device, dtype)
        res = {}
        for case, (A, b) in (("newton_k1", newton), ("ift_k13", ift)):
            n, k = A.shape[1], b.shape[2]
            xk = batched_solve(A, b)
            xp = batched_solve_plain(A, b)
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(xk).all()), "K2 %s (%d, %d): x not "
                   "finite" % (name, n, k))
            rk = rel_residual(A, xk, b)
            _check(rk <= res_tol, "K2 %s (%d, %d) relative residual %.3e"
                   % (name, n, k, rk))
            dx = float((xk - xp).abs().max())
            r = dict(rel_res=rk, rel_res_plain=rel_residual(A, xp, b),
                     max_dx=dx, rel_dx=dx / float(xp.abs().max()),
                     route=batched_solve_route(n, k, A.shape[0]))
            if dtype == torch.float32:
                r["ms"] = cuda_ms(lambda: batched_solve(A, b))
                r["ms_device"] = device_ms(lambda: batched_solve(A, b))
                r["plain_ms"] = cuda_ms(lambda: batched_solve_plain(A, b))
                # the one PyTorch call that computes the same function
                # (timed only; the port never calls it)
                r["library_ms"] = cuda_ms(lambda: torch.linalg.solve(A, b))
                r.update(_bound(2 * _nbytes(b) + _nbytes(A),
                                A.shape[0] * (4.0 / 3.0 * n ** 3
                                              + 3 * n ** 2 * k)))
            res[case] = r

        mask = ex.control_mask(device).to(dtype)
        for case, (B, seed) in (("hopper_256", (256, 51)),
                                ("ragged_batch_253", (253, 52))):
            data = lqr_batch(seed, B, T, nx, nu, device, dtype)
            # the last pivot of Quu at t=0 negative on every fifth lane
            bad = torch.zeros(B, dtype=torch.bool, device=device)
            bad[::5] = True
            data[5][bad, 0, nu - 1, nu - 1] = -1.0e4
            ref = riccati_backward_plain(*data, mask)
            runs = {"route": riccati_backward}
            for route in ("tile", "thread"):
                runs[route] = cut_routed(RICCATI_TILE_MAX_B, (nx, nu),
                                         route == "tile", riccati_backward)
            got = {}
            for key, run in runs.items():
                tiles = riccati_backward.tile_launches
                got[key] = run(*data, mask)
                torch.cuda.synchronize()
                if key != "route":
                    _check(riccati_backward.tile_launches - tiles
                           == (key == "tile"),
                           "K3 %s %s: not on the %s kernel"
                           % (name, case, key))
                agree = _k3_agreement(got[key], ref, bad, dtype, k3_tol,
                                      "%s %s %s" % (name, case, key), mask)
                if key == "route":
                    res[case] = dict(agree, route=riccati_route(nx, nu, B))
                else:
                    res[case][key] = agree
            res[case]["tile_bitwise_thread"] = all(
                torch.equal(a, b) for a, b in zip(got["tile"],
                                                  got["thread"]))
            if dtype == torch.float32 and case == "hopper_256":
                res[case]["ms"] = cuda_ms(
                    lambda: riccati_backward(*data, mask))
                res[case]["plain_ms"] = cuda_ms(
                    lambda: riccati_backward_plain(*data, mask), reps=3)
                for route in ("tile", "thread"):
                    res[case][route].update(
                        ms=cuda_ms(lambda: runs[route](*data, mask)),
                        ms_device=device_ms(lambda: runs[route](*data,
                                                                mask)))
                res[case].update(_bound(
                    _nbytes(*data, mask, *got["route"][:2]) + 4 * B * 4,
                    B * (T - 1) * _riccati_flops(nx, nu)))
        out[name] = res
    return out


def _hopper_solve(device, riccati_kernel: bool) -> dict:
    """The hopper deploy solve at full width (B=256, T=21, float32) for
    two AL rounds of three inner iterations, eager backward pass or K3,
    every IP solve in K1 (``hopper``), then the four-lane float64
    card-against-CPU check with the same backward pass (the CPU side runs
    K1's plain version)."""
    import torch

    from optimization_dynamics_tpu_torch.examples import hopper as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        FUSED_IP_TILE_MAX_B, RICCATI_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward)
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    B = 256
    prob, x0, us0, opts = ex.build_deploy_problem(device, gait=1)
    _check(x0.dtype == torch.float32, "hopper deploy dtype on the card is "
           "f32")
    opts = dataclasses.replace(opts, max_al_iter=2,
                               riccati_kernel=riccati_kernel)
    x0s = ex.deploy_x0s(x0, B, seed=0)
    ph = make_phases(prob, opts, B, x0.dtype, device)
    uss0 = us0[None].expand(B, -1, -1)
    xss0, _ = ph.rollout_open(x0s, uss0)
    # standing still costs more than the gait and misses its travel and
    # periodicity, which are terminal constraints: the solve lowers both
    obj0 = ph.smooth_cost(xss0, uss0)
    vio0 = ph.con_violation(xss0, uss0)
    solve = make_segmented_solver(prob, opts, B, x0.dtype, device,
                                  max_iter_schedule=[3, 3],
                                  al_stall_rounds=ex.DEPLOY_AL_STALL_ROUNDS)

    _zero_counts(batched_solve)
    batched_solve.shapes.clear()
    _zero_counts(riccati_backward)
    _zero_counts(fused_ip)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"batched_solve_n%d_k%d" % nk: c
                for nk, c in sorted(batched_solve.shapes.items())}
    launches["batched_solve_n20_k1"] = batched_solve.shapes[20, 1]
    launches.update(_split_counts("riccati_n16_u10", riccati_backward))
    launches.update(_split_counts("fused_ip_hopper", fused_ip))

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "hopper path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "hopper xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "hopper objective fell on only %.3f of lanes"
           % fell)
    vfell = float((res.constraint_violation < vio0).float().mean())
    _check(vfell >= 0.5, "hopper violation fell on only %.3f of lanes"
           % vfell)
    # every IP solve in K1: K2 only for the IFT solves, none at (20, 1)
    _check(launches["fused_ip_hopper"] + launches["fused_ip_hopper_tile"]
           > 0, "K1 (hopper) not launched on the hopper path")
    _check(launches.get("batched_solve_n20_k13", 0) > 0,
           "batched_solve_n20_k13 not launched on the hopper path")
    _check(set(batched_solve.shapes) == {(20, 13)}
           and all(route == "group" for route, _ in batched_solve.widths),
           "hopper K2 launches off (20, 13) or the group kernel: %s"
           % sorted(batched_solve.shapes))
    k3 = launches["riccati_n16_u10"] + launches["riccati_n16_u10_tile"]
    _check((k3 > 0) == riccati_kernel,
           "K3 launched %d times with riccati_kernel=%s"
           % (k3, riccati_kernel))
    travel, per = ex.gait_errors(res.xs[:, -1])
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(res.converged.sum()), batch=B,
               mean_objective=float(res.objective.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell, violation_fell_frac=vfell,
               mean_initial_violation=float(vio0.mean()),
               mean_violation=float(res.constraint_violation.mean()),
               mean_travel=float(travel.mean()),
               max_periodicity=float(per.max()),
               mean_inner_iters=float(res.iterations.float().mean()),
               batched_solve_widths={"%s_%d" % kb: n for kb, n in sorted(
                   batched_solve.widths.items())},
               riccati_widths=_routed_widths(
                   "K3", riccati_backward, RICCATI_TILE_MAX_B[16, 10]),
               fused_ip_widths=_routed_widths(
                   "K1 (hopper)", fused_ip,
                   FUSED_IP_TILE_MAX_B["fused_ip", "hopper"]))

    # small-input agreement: float64 on the card (K1, K2, and K3 if on)
    # against the same solve on the CPU (plain versions), accelerator IP
    # settings
    small = []
    for dev in (device, torch.device("cpu")):
        p, x0d, usd, o = ex.build_deploy_problem(
            dev, dtype=torch.float64, accelerator_ip=True)
        o = dataclasses.replace(o, max_al_iter=1,
                                riccati_kernel=riccati_kernel)
        s = make_segmented_solver(p, o, 4, torch.float64, dev,
                                  compact=False, max_iter_schedule=[2])
        r = s(ex.deploy_x0s(x0d, 4, seed=0), usd)
        small.append((r.objective.cpu(), r.us.cpu()))
    (obj_card, us_card), (obj_cpu, us_cpu) = small
    dobj = float((obj_card / obj_cpu - 1).abs().max())
    dus = float((us_card - us_cpu).abs().max())
    _check(dobj <= 1e-6 and dus <= 1e-6,
           "hopper small f64 card vs CPU: rel dobj %.3e, max dus %.3e"
           % (dobj, dus))
    out["small_f64_vs_cpu"] = dict(rel_dobj=dobj, max_dus=dus)
    return out


def phase_hopper(device) -> dict:
    """The hopper main path twice: with the eager backward pass, then
    with K3."""
    return {"eager": _hopper_solve(device, False),
            "riccati_kernel": _hopper_solve(device, True)}


ROCKET_K2_CASES = (("proj_newton_512", (10, 1), 512),
                   ("proj_newton_15360", (10, 1), 15360),
                   ("proj_ift_15360", (10, 4), 15360),
                   ("dyn_newton_512", (12, 1), 512),
                   ("dyn_newton_15360", (12, 1), 15360),
                   ("dyn_ift_15360", (12, 16), 15360))


def phase_rocket_kernels(device) -> dict:
    """K2 at the rocket's (10, 1), (10, 4), (12, 1) and (12, 16) on its own
    systems (``utils/measure.py::rocket_systems``, numpy seed 60: the
    deploy's x0 scatter, 15,360 = B x (T-1) at B=256, the sweep's width;
    the Newton systems also at 512, a rollout's width), through the
    wrapper's route and through each of its two kernels, forced by the
    cut, against the plain version; see the module docstring for the
    tolerances."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        batched_solve_route)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve, batched_solve_plain)

    out = {}
    for dtype, res_tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = "f64" if dtype == torch.float64 else "f32"
        systems = rocket_systems(15360, 60, device, dtype)
        res = {}
        for case, (n, k), B in ROCKET_K2_CASES:
            A, b = (t[:B] for t in systems[n, k])
            xk = batched_solve(A, b)
            xp = batched_solve_plain(A, b)
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(xk).all()), "K2 %s %s: x not finite"
                   % (name, case))
            rk = rel_residual(A, xk, b)
            _check(rk <= res_tol, "K2 %s %s relative residual %.3e"
                   % (name, case, rk))
            dx = float((xk - xp).abs().max())
            timed = dtype == torch.float32
            r = dict(rel_res=rk, rel_res_plain=rel_residual(A, xp, b),
                     max_dx=dx, rel_dx=dx / float(xp.abs().max()),
                     route=batched_solve_route(n, k, B),
                     routes=_k2_routes(A, b, xp, res_tol,
                                       "%s %s" % (name, case), timed))
            if timed:
                r["ms"] = cuda_ms(lambda: batched_solve(A, b))
                r["ms_device"] = device_ms(lambda: batched_solve(A, b))
                r["plain_ms"] = cuda_ms(lambda: batched_solve_plain(A, b))
                # the one PyTorch call that computes the same function
                # (timed only; the port never calls it)
                r["library_ms"] = cuda_ms(lambda: torch.linalg.solve(A, b))
                r.update(_bound(2 * _nbytes(b) + _nbytes(A),
                                B * (4.0 / 3.0 * n ** 3 + 3 * n ** 2 * k)))
            res[case] = r
        out[name] = res
    return out


def phase_rocket(device) -> dict:
    """The rocket deploy solve at full width (B=256, T=61, float32) for
    one AL round of at most three inner iterations, every thrust
    projection in K1 (``rocket_projection``), then the four-lane float64
    card-against-CPU check (the CPU side runs K1's plain version); see
    the module docstring."""
    import torch

    from optimization_dynamics_tpu_torch.examples import rocket as ex
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        BATCHED_SOLVE_TILE_MAX_B, FUSED_IP_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.solver.ilqr_batched import (
        make_phases)
    from optimization_dynamics_tpu_torch.solver.ilqr_segmented import (
        make_segmented_solver)

    B = 256
    prob, x0, us0, opts = ex.build_deploy_problem(device)
    _check(x0.dtype == torch.float32, "rocket deploy dtype on the card is "
           "f32")
    opts = dataclasses.replace(opts, max_al_iter=1)
    x0s = ex.deploy_x0s(x0, B, seed=0)
    ph = make_phases(prob, opts, B, x0.dtype, device)
    uss0 = us0[None].expand(B, -1, -1)
    xss0, _ = ph.rollout_open(x0s, uss0)
    # with almost no thrust the rocket falls through the pad: the solve
    # lowers the cost and the ground and terminal violations
    obj0 = ph.smooth_cost(xss0, uss0)
    vio0 = ph.con_violation(xss0, uss0)
    solve = make_segmented_solver(prob, opts, B, x0.dtype, device,
                                  max_iter_schedule=[3],
                                  al_stall_rounds=ex.DEPLOY_AL_STALL_ROUNDS)

    _zero_counts(batched_solve)
    batched_solve.shapes.clear()
    batched_solve.shape_widths.clear()
    _zero_counts(fused_ip)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"batched_solve_n%d_k%d" % nk: c
                for nk, c in sorted(batched_solve.shapes.items())}
    launches["batched_solve_n10_k1"] = batched_solve.shapes[10, 1]
    launches.update(_split_counts("fused_ip_rocket_projection", fused_ip))
    shape_widths = dict(batched_solve.shape_widths)
    k1_widths = _routed_widths(
        "K1 (rocket_projection)", fused_ip,
        FUSED_IP_TILE_MAX_B["fused_ip", "rocket_projection"])

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "rocket path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "rocket xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "rocket objective fell on only %.3f of lanes"
           % fell)
    vfell = float((res.constraint_violation < vio0).float().mean())
    _check(vfell >= 0.5, "rocket violation fell on only %.3f of lanes"
           % vfell)
    # every projection solve in K1: K2 only at the projection's IFT
    # shape and the midpoint solve's two, none at (10, 1)
    _check(launches["fused_ip_rocket_projection"]
           + launches["fused_ip_rocket_projection_tile"] > 0,
           "K1 (rocket_projection) not launched on the rocket path")
    _check(set(batched_solve.shapes) == {(10, 4), (12, 1), (12, 16)},
           "rocket K2 launches off its three shapes: %s"
           % sorted(batched_solve.shapes))
    _check(all((route == "tile") == (w <= BATCHED_SOLVE_TILE_MAX_B[n, k])
               for n, k, route, w in shape_widths),
           "rocket K2 launches off their route: %s" % shape_widths)
    cone = ex.thrust_cone_ok(res.us)
    _check(bool(cone.all()), "rocket thrust outside the cone on %d lanes"
           % int((~cone).sum()))
    _, xT = ex.initial_and_goal(device, x0.dtype)
    by_kernel = {}
    for (n, k, route, w), c in shape_widths.items():
        key = "batched_solve_n%d_k%d_%s" % (n, k, route)
        by_kernel[key] = by_kernel.get(key, 0) + c
    out = dict(wall_s=wall, launches=launches, launches_by_kernel=by_kernel,
               stats=dict(solve.stats),
               converged=int(res.converged.sum()), batch=B,
               mean_objective=float(res.objective.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell, violation_fell_frac=vfell,
               mean_initial_violation=float(vio0.mean()),
               mean_violation=float(res.constraint_violation.mean()),
               max_final_state_error=float(ex.final_state_error(res.xs, xT)
                                           .max()),
               mean_inner_iters=float(res.iterations.float().mean()),
               batched_solve_widths={
                   "n%d_k%d_%s_%d" % key: c
                   for key, c in sorted(shape_widths.items())},
               fused_ip_widths=k1_widths)

    # small-input agreement: float64 on the card (K1, K2) against the
    # same solve on the CPU (plain versions), accelerator IP settings
    small = []
    for dev in (device, torch.device("cpu")):
        p, x0d, usd, o = ex.build_deploy_problem(
            dev, dtype=torch.float64, accelerator_ip=True)
        o = dataclasses.replace(o, max_al_iter=1)
        s = make_segmented_solver(p, o, 4, torch.float64, dev,
                                  compact=False, max_iter_schedule=[2])
        r = s(ex.deploy_x0s(x0d, 4, seed=0), usd)
        small.append((r.objective.cpu(), r.us.cpu()))
    (obj_card, us_card), (obj_cpu, us_cpu) = small
    dobj = float((obj_card / obj_cpu - 1).abs().max())
    dus = float((us_card - us_cpu).abs().max())
    _check(dobj <= 1e-6 and dus <= 1e-6,
           "rocket small f64 card vs CPU: rel dobj %.3e, max dus %.3e"
           % (dobj, dus))
    out["small_f64_vs_cpu"] = dict(rel_dobj=dobj, max_dus=dus)
    return out


def _k1_model_phase(device, cases, opts, nq: int, f32_tol: float,
                    cone: bool = False) -> dict:
    """K1 on one of its later functors against its plain version: every
    case of ``cases(dtype, kern) -> {case: (model, z0s, thetas)}`` (``kern``
    the K1 solver of that dtype, for warm starts) through the wrapper's
    route and through each of K1's two kernels, forced by the width cut;
    phase 1's tolerances (``_k1_agreement``), float32 on the first ``nq``
    entries of z within ``f32_tol``; ``cone``: every converged float32
    thrust in the cone (``||u_xy|| <= u_z + 1e-4``). float32 timed
    through each kernel, one call and queued, with the bound; the plain
    version once a case."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        FUSED_IP_TILE_MAX_B)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip, make_fused_ip_plain, make_fused_ip_solver)

    out = {}
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        res = {}
        for case, (model, z0, th) in cases(
                dtype, lambda m: make_fused_ip_solver(m, opts, device,
                                                      dtype)).items():
            kern = make_fused_ip_solver(model, opts, device, dtype)
            plain = make_fused_ip_plain(model, opts, device, dtype)
            sp, trials = _with_trials(lambda: plain(z0, th))
            cut = FUSED_IP_TILE_MAX_B["fused_ip", model.kernel]
            r = dict(lanes=int(z0.shape[0]),
                     kernel="tile" if z0.shape[0] <= cut else "thread")
            for route in ("route", "tile", "thread"):
                solve = kern if route == "route" else routed(
                    model.kernel, route == "tile", kern)
                tiles = fused_ip.tile_launches
                sk = solve(z0, th)
                torch.cuda.synchronize()
                if route != "route":
                    _check(fused_ip.tile_launches - tiles
                           == (route == "tile"), "K1 %s %s %s: not on the "
                           "%s kernel" % (model.kernel, name, case, route))
                a = _k1_agreement(sk, sp, dtype, nq=nq, f32_tol=f32_tol)
                a["mean_iters"] = float(sk.iterations.float().mean())
                if cone and dtype == torch.float32:
                    u = sk.z[:, 0:3][sk.converged]
                    gap = float((torch.linalg.vector_norm(u[:, 0:2], dim=1)
                                 - u[:, 2]).max())
                    _check(gap <= 1e-4, "K1 %s %s %s: a converged thrust "
                           "%.3e outside the cone" % (model.kernel, name,
                                                      case, gap))
                    a["max_cone_gap"] = gap
                if dtype == torch.float32:
                    a["ms"] = cuda_ms(lambda: solve(z0, th))
                    a["ms_device"] = device_ms(lambda: solve(z0, th))
                    a.update(_bound(
                        _nbytes(z0, th, sk.z) + 4 * z0.shape[0] * 4,
                        _ip_flops(model, z0, th, int(sk.iterations.sum()),
                                  trials, z0.shape[0])))
                r[route] = a
            if dtype == torch.float32:
                r["plain_ms"] = cuda_ms(lambda: plain(z0, th), reps=1)
            res[case] = r
        out[name] = res
    return out


def phase_k1_rocket(device) -> dict:
    """K1 on ``rocket_projection`` (nz=10) against its plain version at
    the deploy's projection options: cold projections (u_bar = 6 N(0, 1),
    u_max = 12.5; ``rocket_projection_batch``) at the sweep's width,
    15,360 (B x (T-1) at B=256, numpy seed 70), and at a rollout step's,
    512 (seed 71); see the module docstring."""
    from optimization_dynamics_tpu_torch.examples import rocket as ex
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    def cases(dtype, _):
        return {"cold_%d" % B: rocket_projection_batch(B, seed, device, dtype)
                for B, seed in ((15360, 70), (512, 71))}

    opts = IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL, kappa_tol=ex.PROJ_KAPPA_TOL)
    return _k1_model_phase(device, cases, opts, nq=3, f32_tol=1e-4,
                           cone=True)


def phase_k1_hopper(device) -> dict:
    """K1 on ``hopper`` (nz=20) against its plain version: the hopper
    deploy's own solves (``hopper_deploy_batch``) at the sweep's width,
    5,120 (B x (T-1) at B=256, numpy seed 80), cold and warm-started from
    K1's solutions one iterate earlier (seed 81), and 512 cold ones (a
    rollout step's width, seed 82); see the module docstring."""
    from optimization_dynamics_tpu_torch.examples import hopper as ex
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    def cases(dtype, make_kern):
        model, z0c, thc = hopper_deploy_batch(5120, 80, device, dtype)
        z0w, thw = warm_batch(make_kern(model), model, z0c, thc, 81)
        return {"cold_5120": (model, z0c, thc),
                "warm_5120": (model, z0w, thw),
                "cold_512": hopper_deploy_batch(512, 82, device, dtype)}

    return _k1_model_phase(device, cases, IPOptions(**ex.DEPLOY_IP_ACCEL),
                           nq=4, f32_tol=2e-4)


def _scalar_states(name: str, rng, n: int):
    """``n`` states and controls of model ``name`` about its example's
    nominal state (numpy ``rng``)."""
    if name == "cartpole":
        q1 = 0.3 * rng.standard_normal((n, 2))
        return (np.concatenate([q1 - 0.02 * rng.standard_normal((n, 2)),
                                q1], 1), 0.8 * rng.standard_normal((n, 1)))
    if name == "acrobot":
        q1 = np.stack([rng.standard_normal(n), rng.uniform(1.3, 1.7, n)], 1)
        return (np.concatenate([q1 - 0.05 * rng.standard_normal((n, 2)),
                                q1], 1), 3.0 * rng.standard_normal((n, 1)))
    if name == "planar_push":
        from optimization_dynamics_tpu_torch.models import planar_push as pp
        free = np.array([1, 1, 1, 0, 1])
        q1 = (np.array([0.0, 0.0, 0.0, -pp.R_DIM - 1e-8, 0.0])
              + 0.01 * rng.standard_normal((n, 5)) * free)
        return (np.concatenate([q1 - 0.005 * rng.standard_normal((n, 5))
                                * free, q1], 1),
                np.abs(rng.standard_normal((n, 2))) * [1.0, 0.2])
    if name == "hopper":
        from optimization_dynamics_tpu_torch.models import hopper as hp
        p = hp.HopperParams()
        q1 = (np.array([0.0, 0.5 + p.foot_radius, 0.0, 0.5])
              + 0.02 * rng.standard_normal((n, 4)))
        return (np.concatenate([q1 - 0.01 * rng.standard_normal((n, 4)),
                                q1], 1),
                [0.0, p.gravity * p.mass_body * 0.025]
                + 0.1 * rng.standard_normal((n, 2)))
    x1 = np.zeros(12)
    x1[0:3] = [2.5, 2.5, 10.0]
    x1[8] = -1.0
    return (x1 + 0.1 * rng.standard_normal((n, 12)),
            np.array([3.0, 3.0, 9.0]) * rng.standard_normal((n, 3)))


def _scalar_step_jacs(device) -> dict:
    """``step_jac`` of each model's scalar dynamics, float64 on the card
    against the CPU: max|dy| and the Jacobians' max|d|."""
    import torch

    from optimization_dynamics_tpu_torch.dynamics import (
        make_implicit_dynamics)
    from optimization_dynamics_tpu_torch.models import acrobot as ac
    from optimization_dynamics_tpu_torch.models import cartpole as cp
    from optimization_dynamics_tpu_torch.models import hopper as hp
    from optimization_dynamics_tpu_torch.models import planar_push as pp
    from optimization_dynamics_tpu_torch.models import rocket as ro

    f64 = torch.float64

    def implicit(model, aux, k_eval, k_grad):
        def make(dev):
            dyn = make_implicit_dynamics(model, dev, f64, r_tol=1e-8,
                                         kappa_eval_tol=k_eval,
                                         kappa_grad_tol=k_grad)
            a = aux(dev)
            return lambda x, u: dyn.step_jac(x, u, a)
        return make

    def rocket(dev):
        return ro.make_rocket_dynamics(device=dev, dtype=f64).step_jac

    makers = {
        "cartpole": implicit(cp.friction_model(), lambda d: cp.CartpoleAux(
            h=0.05, friction=torch.tensor([0.35, 0.35], dtype=f64,
                                          device=d)), 1e-4, 1e-3),
        "acrobot": implicit(ac.impact_model(), lambda d: ac.AcrobotAux(
            h=torch.tensor(0.05, dtype=f64, device=d)), 1e-4, 1e-3),
        "planar_push": implicit(pp.model(), lambda d: pp.PlanarPushAux(
            h=0.1), 1e-4, 1e-2),
        "hopper": implicit(hp.model(), lambda d: hp.HopperAux(
            h=torch.tensor(0.05, dtype=f64, device=d)), 1e-4, 1e-3),
        "rocket": rocket}
    out = {}
    for name, make in makers.items():
        xs, us = _scalar_states(name, np.random.default_rng(90), 3)
        card, cpu = make(device), make(torch.device("cpu"))
        dy = djac = 0.0
        for x, u in zip(xs, us):
            args = [torch.tensor(a, dtype=f64) for a in (x, u)]
            got = card(*(a.to(device) for a in args))
            ref = cpu(*args)
            _check(all(bool(torch.isfinite(g).all()) for g in got),
                   "step_jac %s: not finite on the card" % name)
            dy = max(dy, float((got[0].cpu() - ref[0]).abs().max()))
            djac = max(djac, max(float((g.cpu() - r).abs().max())
                                 for g, r in zip(got[1:], ref[1:])))
        _check(dy <= 1e-12 and djac <= 1e-10,
               "step_jac %s f64 card vs CPU: max|dy| %.3e, max|dJ| %.3e"
               % (name, dy, djac))
        out[name] = dict(max_dy=dy, max_djac=djac)
    return out


def phase_scalar(device) -> dict:
    """The scalar path on the card: the cartpole friction swing-up by the
    scalar ``solve`` to a golden, K1's and K2's launches by width, then
    ``simulate`` and ``step_jac`` card against CPU; see the module
    docstring."""
    import torch

    from optimization_dynamics_tpu_torch.dynamics import (
        make_implicit_dynamics, simulate)
    from optimization_dynamics_tpu_torch.examples import cartpole as ex
    from optimization_dynamics_tpu_torch.models import acrobot as ac
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.utils.measure import scalar_solve

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens.json")) as f:
        goldens = json.load(f)["cartpole_friction_objective"]
    prob, x0, us0, opts = ex.build_problem("friction", device=device,
                                           dtype=torch.float64)
    _zero_counts(fused_ip)
    _zero_counts(batched_solve)
    res, wall, by_width = scalar_solve(prob, x0, us0, opts)
    launches = {"fused_ip": fused_ip.launches - fused_ip.tile_launches,
                "fused_ip_tile": fused_ip.tile_launches,
                **_split_counts("batched_solve", batched_solve)}
    obj = float(res.objective)
    xT = np.array([0.0, np.pi, 0.0, np.pi])
    err = float(np.abs(res.xs[-1].cpu().numpy() - xT).max())
    _check(bool(res.converged), "scalar cartpole: not converged")
    _check(float(res.constraint_violation) < opts.con_tol,
           "scalar cartpole: violation %.3e" % float(res.constraint_violation))
    _check(err <= 1e-2, "scalar cartpole: final state off by %.3e" % err)
    _check(any(abs(obj - g) <= 0.05 * g for g in goldens),
           "scalar cartpole: objective %.6f not within 5%% of %s"
           % (obj, goldens))
    k1 = fused_ip.widths
    _check(k1["tile", 1] > 0 and k1["tile", ex.T - 1] > 0,
           "scalar cartpole: K1 tile not launched at widths 1 and %d: %s"
           % (ex.T - 1, dict(k1)))
    _check(batched_solve.shapes[10, 8] > 0,
           "scalar cartpole: K2 (10, 8) not launched")
    out = dict(wall_s=wall, converged=True, objective=obj,
               goldens=goldens, final_state_err=err,
               iterations=int(res.iterations),
               al_iterations=int(res.al_iterations),
               constraint_violation=float(res.constraint_violation),
               launches=launches, launches_by_width=by_width)

    # the derivative sweep at the solution, the solve's launches at width
    # T-1 (K1's tile, a ragged last block, and K2 (10, 8)), card against
    # a CPU copy of the problem
    prob_h = ex.build_problem("friction", device="cpu",
                              dtype=torch.float64)[0]
    ts = torch.arange(ex.T - 1)
    got = prob.dynamics_jac_batched(ts.to(device), res.xs[:-1], res.us)
    ref = prob_h.dynamics_jac_batched(ts, res.xs[:-1].cpu(), res.us.cpu())
    dy = float((got[0].cpu() - ref[0]).abs().max())
    djac = max(float((g.cpu() - r).abs().max())
               for g, r in zip(got[1:], ref[1:]))
    _check(dy <= 1e-12 and djac <= 1e-10,
           "sweep at width %d f64 card vs CPU: max|dy| %.3e, max|dJ| %.3e"
           % (ex.T - 1, dy, djac))
    out["sweep_f64_vs_cpu"] = dict(width=ex.T - 1, max_dy=dy, max_djac=djac)

    # simulate: tests/test_simulate.py's acrobot case, card against CPU
    sims = []
    for dev in (device, torch.device("cpu")):
        dyn = make_implicit_dynamics(ac.impact_model(), dev, torch.float64)
        aux = ac.AcrobotAux(h=torch.tensor(0.05, dtype=torch.float64,
                                           device=dev))
        xs, sols = simulate(dyn, torch.tensor([0.0, 1.4, 0.0, 1.45],
                                              dtype=torch.float64,
                                              device=dev),
                            torch.full((12, 1), 3.0, dtype=torch.float64,
                                       device=dev), aux)
        sims.append((xs.cpu(), sols.z.cpu(), sols.converged.cpu()))
    (xs_c, z_c, ok_c), (xs_h, z_h, _) = sims
    dx = float((xs_c - xs_h).abs().max())
    dz = float((z_c - z_h).abs().max())
    _check(bool(ok_c.all()) and float(z_c[:, 2:4].max()) > 1e-3,
           "simulate: not converged, or the limit never engaged")
    _check(dx <= 1e-12 and dz <= 1e-12,
           "simulate f64 card vs CPU: max|dx| %.3e, max|dz| %.3e"
           % (dx, dz))
    out["simulate_f64_vs_cpu"] = dict(max_dx=dx, max_dz=dz)
    out["step_jac_f64_vs_cpu"] = _scalar_step_jacs(device)
    return out


def phase_gb(device) -> dict:
    """The gradient bundle on the card: the bundle sweep at the push
    translate problem's initial trajectory card against a CPU copy, K1n's
    group kernel at the sweep's 1,275 cold lanes against its plain
    version, and the scalar push translate solve with the bundle's
    Jacobians; see the module docstring."""
    import torch

    from optimization_dynamics_tpu_torch.dynamics import (
        make_implicit_dynamics)
    from optimization_dynamics_tpu_torch.examples import planar_push as ex
    from optimization_dynamics_tpu_torch.models import planar_push as pp
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip, make_fused_ip_plain, make_fused_ip_solver)
    from optimization_dynamics_tpu_torch.solver.gradient_bundle import (
        bundle_inputs, make_gradient_bundle)
    from optimization_dynamics_tpu_torch.solver.ilqr import rollout
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)
    from optimization_dynamics_tpu_torch.utils.measure import scalar_solve

    f64, cpu = torch.float64, torch.device("cpu")
    width = (ex.T - 1) * (ex.GB_SAMPLES + 1)
    dyn_h = make_implicit_dynamics(pp.model(), cpu, f64)
    draws = make_gradient_bundle(dyn_h, ex.GB_SAMPLES, ex.GB_EPS).sample(
        np.random.default_rng(0), (ex.T - 1,))
    prob, x0, us0, opts = ex.build_problem("translate", True, device=device,
                                           dtype=f64, gb_draws=draws)
    prob_h = ex.build_problem("translate", True, device=cpu, dtype=f64,
                              gb_draws=draws)[0]
    xs = rollout(prob, x0, us0)[:-1]
    ts = torch.arange(ex.T - 1)

    # K1n at the sweep's lanes: the bundle's eval solves, f64 at the
    # scalar path's IP options (the sweep's) and f32 at the push deploy's
    # accelerator options (phase 7's f32 checks)
    model, aux = pp.model(), pp.PlanarPushAux(h=ex.H)
    xs_all, us_all, _ = bundle_inputs(
        xs, us0, tuple(d.to(device) for d in draws), pp.NQ)
    q1 = xs_all[:, pp.NQ:]
    th64 = model.theta_fn(xs_all[:, :pp.NQ], q1, us_all, aux)
    z064 = model.init_z(q1)
    out, counts = {}, {}
    for name, dtype, o in (
            ("f64", f64, IPOptions(r_tol=1e-8, kappa_tol=1e-4,
                                   kappa_init_min=1e-2)),
            ("f32", torch.float32, IPOptions(**ex.DEPLOY_IP_ACCEL))):
        z0, th = z064.to(dtype), th64.to(dtype)
        kern = make_fused_ip_solver(model, o, device, dtype)
        plain = make_fused_ip_plain(model, o, device, dtype)
        sp, trials = _with_trials(lambda: plain(z0, th))
        groups = fused_ip.widths["group", width]
        sk = kern(z0, th)
        torch.cuda.synchronize()
        _check(fused_ip.widths["group", width] == groups + 1,
               "K1n %s at %d lanes: not on the group kernel" % (name, width))
        a = _k1_agreement(sk, sp, dtype, nq=pp.NQ, f32_tol=2e-4,
                          min_same_iters=None)
        a["mean_iters"] = float(sk.iterations.float().mean())
        a["ms"] = cuda_ms(lambda: kern(z0, th))
        a["ms_device"] = device_ms(lambda: kern(z0, th))
        a["plain_ms"] = cuda_ms(lambda: plain(z0, th), reps=1)
        a.update(_bound(_nbytes(z0, th, sk.z) + 4 * z0.shape[0] * 4,
                        _ip_flops(model, z0, th, int(sk.iterations.sum()),
                                  trials, z0.shape[0])))
        a["bound_share"] = a["bound_ms"] / a["ms"]
        out["k1n_group_cold_%d_%s" % (width, name)] = a
        counts[name] = sk.iterations.cpu()

    # the bundle sweep, card against a CPU copy: the IP iteration counts
    # first (the f64 solves above; the CPU copy's from K1n's plain version
    # on the CPU), then y, fx and fu at the timesteps whose every solve
    # took the same count
    plain_h = make_fused_ip_plain(model, IPOptions(
        r_tol=1e-8, kappa_tol=1e-4, kappa_init_min=1e-2), cpu, f64)
    same = (counts["f64"] == plain_h(z064.cpu(), th64.cpu()).iterations)
    got = prob.dynamics_jac_batched(ts.to(device), xs, us0)
    ref = prob_h.dynamics_jac_batched(ts, xs.cpu(), us0.cpu())
    steps = same.reshape(ex.T - 1, ex.GB_SAMPLES + 1).all(1)
    _check(float(same.float().mean()) >= 0.995 and bool(steps.any()),
           "bundle sweep card vs CPU: IP counts agree on %.4f of lanes"
           % float(same.float().mean()))
    dy = float((got[0].cpu() - ref[0])[steps].abs().max())
    djac = max(float((g.cpu() - r)[steps].abs().max())
               for g, r in zip(got[1:], ref[1:]))
    _check(dy <= 1e-12 and djac <= 1e-8, "bundle sweep f64 card vs CPU: "
           "max|dy| %.3e, max|dJ| %.3e" % (dy, djac))
    out["sweep_f64_vs_cpu"] = dict(
        lanes=width, same_iters=float(same.float().mean()),
        steps_compared=int(steps.sum()), max_dy=dy, max_djac=djac)

    # the main path: the scalar translate solve with the bundle's
    # Jacobians, K1n's group at width 1 (rollout steps) and 1,275 (one
    # launch a derivative sweep), no IFT solve
    _zero_counts(fused_ip)
    _zero_counts(batched_solve)
    res, wall, by_width = scalar_solve(prob, x0, us0, opts)
    k1n = dict(fused_ip.widths)
    obj = float(res.objective)
    umax = float(res.us.abs().max())
    _check(bool(res.converged), "bundle push: not converged")
    _check(abs(float(res.xs[-1][5]) - 1.0) < 0.01,
           "bundle push: block x %.4f" % float(res.xs[-1][5]))
    _check(umax <= ex.U_LIM + 1e-6, "bundle push: |u| %.6f" % umax)
    _check(fused_ip.launches == fused_ip.tile_launches
           and k1n.get(("group", 1), 0) > 0
           and k1n.get(("group", width), 0) == int(res.iterations),
           "bundle push: K1n launches %s, %d inner iterations"
           % (k1n, int(res.iterations)))
    _check(batched_solve.launches == 0, "bundle push: K2 launched")
    out["solve"] = dict(
        wall_s=wall, converged=True, objective=obj, golden=18.709,
        iterations=int(res.iterations), al_iterations=int(res.al_iterations),
        constraint_violation=float(res.constraint_violation),
        final_block_pose=res.xs[-1][5:8].cpu().numpy().tolist(),
        max_abs_u=umax, launches_gb=fused_ip.tile_launches,
        launches_by_width=by_width)
    return out


def phase_direct(device) -> dict:
    """The direct-transcription hopper gait on the card to the reference
    test's checks, and one Gauss-Newton gradient and Hessian card against
    the CPU; see the module docstring."""
    import torch

    from optimization_dynamics_tpu_torch.examples.comparisons import (
        hopper_direct as hd)
    from optimization_dynamics_tpu_torch.solver.direct import (
        make_al, solve_direct)

    prob, w0, opts = hd.build_problem(device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_direct(prob, w0, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = res.w.reshape(hd.T - 1, hd.NW_STAGE).cpu().numpy()
    travel, slack = float(w[-1, 0]), float(np.sum(w[:, 20]))
    _check(res.converged, "hopper direct: not converged (violation %.3e)"
           % res.constraint_violation)
    _check(travel >= 0.5 - 1e-2, "hopper direct: travel %.4f" % travel)
    _check(slack < 1e-2, "hopper direct: slack sum %.3e" % slack)
    out = dict(wall_s=wall, converged=True, objective=float(res.objective),
               constraint_violation=res.constraint_violation,
               iterations=res.iterations, al_iterations=res.al_iterations,
               travel=travel, slack_sum=slack,
               final_config=w[-1, 0:4].tolist())

    # one Gauss-Newton (g, H) at a perturbed w with multipliers from a
    # numpy seed (some inequality rows active), card against the CPU
    rng = np.random.default_rng(100)
    w1 = w0.cpu().numpy() + 0.01 * rng.standard_normal(prob.n)
    lam_eq = rng.standard_normal(163)
    lam_in = np.maximum(rng.standard_normal(621), 0.0)
    gh = []
    for dev in (device, torch.device("cpu")):
        p = hd.build_problem(device=dev)[0]
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        g, H = make_al(p)[1](t(w1), t(lam_eq), t(lam_in), 10.0)
        gh.append((g.cpu(), H.cpu()))
    (g_c, H_c), (g_h, H_h) = gh
    dg = float((g_c - g_h).abs().max())
    dH = float((H_c - H_h).abs().max())
    _check(dg <= 1e-9 and dH <= 1e-9, "hopper direct GN card vs CPU: "
           "max|dg| %.3e, max|dH| %.3e" % (dg, dH))
    out["gn_f64_vs_cpu"] = dict(max_dg=dg, max_dH=dH,
                                max_abs_H=float(H_h.abs().max()))
    return out


def _launches_by_width() -> dict:
    """K1's and K2's launches since the counts were last cleared, by
    kernel and width (K2 by n, k, kernel and width)."""
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip

    key = lambda k: " ".join(str(v) for v in k)
    return {"fused_ip": {key(k): n for k, n in sorted(fused_ip.widths.items())},
            "batched_solve": {key(k): n for k, n in
                              sorted(batched_solve.shape_widths.items())}}


def _clear_launches() -> None:
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip

    _zero_counts(fused_ip)
    _zero_counts(batched_solve)
    batched_solve.shape_widths.clear()


def _same_shards(dir_a: str, dir_b: str, n: int) -> dict:
    """Whether two sweeps' checkpoints hold bit-identical arrays, and
    where not, the largest difference by field."""
    from optimization_dynamics_tpu_torch.utils.checkpoint import load_result

    diffs = {}
    for s in range(n):
        a, _ = load_result(os.path.join(dir_a, "shard_%05d.npz" % s))
        b, _ = load_result(os.path.join(dir_b, "shard_%05d.npz" % s))
        _check(sorted(a) == sorted(b), "determinism: fields differ")
        for k in a:
            if not np.array_equal(a[k], b[k], equal_nan=True):
                d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
                diffs["%d %s" % (s, k)] = float(np.nanmax(d))
    return dict(bit_identical=not diffs, max_abs_diff_by_field=diffs)


# the reference's solve of the friction grid's scenario of phase 21
# (friction 0.05, x0 = 0.02 N(0, 1) from numpy seed 0): the JAX
# package's jit(vmap(solve_one)) in float64 on the CPU
# (``python -m tools.sweep_lanes reference``)
GRID_REFERENCE = {"objective": 8.14967736205116, "iterations": 265,
                  "al_iterations": 5}


def phase_sweep(device) -> dict:
    """The scenario sweep on the card (``examples/sweep.py``); see the
    module docstring. Prints a ``# sweep`` line as each part ends."""
    import shutil
    import tempfile

    import torch

    from optimization_dynamics_tpu_torch.dynamics import (
        make_implicit_dynamics)
    from optimization_dynamics_tpu_torch.examples import cartpole as ex
    from optimization_dynamics_tpu_torch.examples import sweep as sw
    from optimization_dynamics_tpu_torch.models import acrobot as ac
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        fused_ip, make_fused_ip_solver)
    from optimization_dynamics_tpu_torch.parallel.mesh import (
        scenario_mesh, sharded_map)
    from optimization_dynamics_tpu_torch.solver.ilqr import ILQRResult
    from optimization_dynamics_tpu_torch.utils.benchmark import benchmark
    from optimization_dynamics_tpu_torch.utils.checkpoint import load_result
    from optimization_dynamics_tpu_torch.utils.debug import check_finite
    from optimization_dynamics_tpu_torch.utils.profiling import PhaseTimer

    def say(part, obj):
        print("# sweep %s: %s" % (part, json.dumps(obj)), flush=True)

    out = {}
    # the mesh: the visible cards; the acrobot step sharded over it bit
    # for bit the unsharded call
    mesh = scenario_mesh()
    _check(len(mesh) == torch.cuda.device_count() >= 1
           and mesh[0] == torch.device("cuda", 0),
           "scenario_mesh: %s" % mesh)
    dyn = make_implicit_dynamics(ac.impact_model(), device, torch.float64)
    aux = ac.AcrobotAux(h=torch.tensor(0.05, dtype=torch.float64,
                                       device=device))
    rng = np.random.default_rng(210)
    xs = torch.as_tensor(0.3 * rng.standard_normal((16, 4)), device=device)
    us = torch.as_tensor(0.1 * rng.standard_normal((16, 1)), device=device)
    step = lambda x, u: dyn.step_batched(x, u, aux)
    ys = sharded_map(step, mesh)(xs, us)
    _check(torch.equal(ys, step(xs, us)),
           "sharded_map(step_batched) differs from the unsharded call")
    out["mesh"] = dict(devices=[str(d) for d in mesh], lanes=16,
                       sharded_equal=True)
    say("mesh", out["mesh"])

    n, shard = 256, 128
    tmp = tempfile.TemporaryDirectory()
    dirs = {a: os.path.join(tmp.name, a) for a in ("cold", "again", "warm",
                                                    "grid")}

    def arm(name, n_lanes, **kw):
        """The sweep into ``dirs[name]`` one call a shard, each call
        ``n_lanes`` cut to the shards up to it: the shards before resume
        from disk (a warm arm seeds from the last of them), so each call
        solves one shard, and its launches are read just after it."""
        shards, st = [], []
        t0 = time.perf_counter()
        for s in range(n_lanes // shard):
            if os.path.exists(os.path.join(dirs[name], "shard_%05d.npz" % s)):
                continue
            _clear_launches()
            torch.cuda.synchronize()
            got = sw.run_sweep_deploy(shard * (s + 1), shard=shard,
                                      out_dir=dirs[name], verbose=False,
                                      device=device, **kw)
            launches = _launches_by_width()
            _check(len(got) == 1, "deploy sweep shard %d: %d shards solved"
                   % (s, len(got)))
            summary = got[0]
            st.append(summary)
            data, _ = load_result(os.path.join(dirs[name],
                                               "shard_%05d.npz" % s))
            _check(np.isfinite(data["xs"]).all()
                   and data["xs"].shape == (shard, ex.T, ex.NX),
                   "deploy sweep shard %d: xs not finite or misshapen" % s)
            fi = sum(fused_ip.widths.values())
            bs = sum(batched_solve.widths.values())
            _check(fi > 0 and bs > 0, "deploy sweep shard %d: K1 %d, K2 %d "
                   "launches" % (s, fi, bs))
            shards.append(dict(
                shard=s, n_converged=summary["n_converged"],
                wall_s=summary["wall_s"],
                solves_per_s=summary["solves_per_s"],
                ip_solves=summary["ip_solves"], warm=summary["warm"],
                non_finite_fields=sorted(
                    k for k, v in data.items()
                    if v.dtype.kind == "f" and not np.isfinite(v).all()),
                launches=launches))
            say("shard", shards[-1])
        wall = time.perf_counter() - t0
        return dict(wall_s=wall, converged=sum(x["n_converged"] for x in st),
                    summaries=st, shards=shards)

    # the cold arm: two shards
    cold = arm("cold", n)
    _check(len(cold["summaries"]) == n // shard, "cold arm: shards")
    out["deploy_cold"] = cold
    say("cold", dict(wall_s=cold["wall_s"], converged=cold["converged"]))

    # resume: every shard is on disk, so no solve and no launch
    _clear_launches()
    st = sw.run_sweep_deploy(n, shard=shard, out_dir=dirs["cold"],
                             verbose=False, device=device)
    _check(st == [] and fused_ip.launches == 0
           and batched_solve.launches == 0,
           "resume: %d shards solved, K1 %d, K2 %d launches"
           % (len(st), fused_ip.launches, batched_solve.launches))
    out["resume"] = dict(shards_solved=0, launches=0)
    say("resume", out["resume"])

    # determinism: the cold arm's first shard again, with the phase
    # timers (their barriers order the work and change no operation)
    timers = PhaseTimer()
    again = arm("again", shard, timers=timers)
    out["determinism"] = dict(_same_shards(dirs["cold"], dirs["again"], 1),
                              shards=1, converged=again["converged"],
                              wall_s=again["wall_s"])
    out["phase_timers"] = dict(timers.report(total_s=again["wall_s"]),
                               shard=again["summaries"][0])
    say("determinism", out["determinism"])
    say("phase timers", out["phase_timers"])

    # the warm arm: its first shard starts cold, as the cold arm's, so it
    # resumes from that checkpoint and solves the second shard warm
    os.makedirs(dirs["warm"])
    shutil.copy(os.path.join(dirs["cold"], "shard_00000.npz"), dirs["warm"])
    warm = arm("warm", n, warm=True)
    _check(len(warm["summaries"]) == 1 and warm["summaries"][0]["warm"],
           "warm arm: shards %s" % warm["summaries"])
    out["deploy_warm"] = warm
    out["arms"] = {
        "cold": [(x["n_converged"], x["wall_s"], x["solves_per_s"],
                  x["ip_solves"]) for x in cold["summaries"]],
        "warm": [(x["n_converged"], x["wall_s"], x["solves_per_s"],
                  x["ip_solves"]) for x in (cold["summaries"][:1]
                                             + warm["summaries"])]}
    say("arms (converged, wall_s, solves/s, IP solves a shard)", out["arms"])

    # the friction grid, uncut: run_sweep(1)'s one scenario (friction
    # 0.05, numpy seed 0), the reference's T=51 and budgets, a scalar
    # float64 solve that converges without a retry
    _clear_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = sw.run_sweep(1, shard_size=1, out_dir=dirs["grid"],
                        verbose=False)
    wall = time.perf_counter() - t0
    launches = _launches_by_width()
    data, meta = load_result(os.path.join(dirs["grid"], "shard_00000.npz"))
    res = ILQRResult(**{k: torch.as_tensor(v) for k, v in data.items()})
    bad = sorted(k for k, v in data.items()
                 if v.dtype.kind == "f" and not np.isfinite(v).all())
    _check(len(grid) == 1 and meta == grid[0], "friction grid: summary")
    _check(not bad, "friction grid: non-finite %s" % bad)
    _check(bool(data["converged"].all()) and meta["retried"] == 0,
           "friction grid: not converged (%s)" % meta)
    rel = abs(float(data["objective"][0]) - GRID_REFERENCE["objective"]) \
        / GRID_REFERENCE["objective"]
    _check(rel <= 1e-6, "friction grid: objective %r, the reference's %r"
           % (float(data["objective"][0]), GRID_REFERENCE["objective"]))
    _check(any(k in ("tile 1", "thread 1") for k in launches["fused_ip"]),
           "friction grid: K1 not launched at width 1: %s"
           % launches["fused_ip"])
    out["friction_grid"] = dict(summary=grid[0], wall_s=wall,
                                frictions=[0.05],
                                check_finite=check_finite(res).tolist(),
                                non_finite_fields=bad,
                                objective=data["objective"].tolist(),
                                objective_rel_err=rel,
                                iterations=data["iterations"].tolist(),
                                reference=GRID_REFERENCE,
                                launches=launches)
    say("friction grid", out["friction_grid"])

    # benchmark: one K1 call at width 128 (a shard's rollout step)
    model, z0, th = envelope_batch(128, 211, device, torch.float32)
    kern = make_fused_ip_solver(model, deploy_ip_options(), device,
                                torch.float32)
    out["benchmark_k1_128"] = benchmark(kern, z0, th, runs=20,
                                        warmup=2)._asdict()
    tmp.cleanup()
    return out

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")

    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        load_library, ptxas_report)

    smi = nvidia_smi()
    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    report = ptxas_report()
    print("# phase 0 card: %s | torch %s cuda %s | kernel build %.1f s | "
          "per source %s" % (smi, torch.__version__, torch.version.cuda,
                             build_s, json.dumps(report["compile_s"])),
          flush=True)
    print("# phase 0 ptxas: %s" % json.dumps(report["kernels"]), flush=True)

    k1 = phase_k1(device)
    print("# phase 1 K1 fused_ip vs plain: %s" % json.dumps(k1), flush=True)
    k2 = phase_k2(device)
    print("# phase 2 K2 batched_solve vs plain: %s" % json.dumps(k2),
          flush=True)
    mp = phase_main(device)
    print("# phase 3 main path: %s" % json.dumps(mp), flush=True)
    k3 = phase_k3(device)
    print("# phase 4 K3 riccati vs plain: %s" % json.dumps(k3), flush=True)
    k4 = phase_k4(device)
    print("# phase 5 K4 fused_rollout vs plain: %s" % json.dumps(k4),
          flush=True)
    nw = phase_new_path(device)
    print("# phase 6 main path with K3 and K4: %s" % json.dumps(nw),
          flush=True)
    k1n = phase_k1n(device)
    print("# phase 7 K1n fused_ip nz=35 and K2 (35, 13) vs plain: %s"
          % json.dumps(k1n), flush=True)
    pu = phase_push(device)
    print("# phase 8 planar-push main path: %s" % json.dumps(pu),
          flush=True)
    k1a = phase_k1a(device)
    print("# phase 9 K1a fused_ip nz=6 and K2 (6, 6) vs plain: %s"
          % json.dumps(k1a), flush=True)
    ac = phase_acrobot(device)
    print("# phase 10 acrobot main path: %s" % json.dumps(ac), flush=True)
    k5 = phase_k5(device)
    print("# phase 11 K5 loop_overhead vs plain: %s" % json.dumps(k5),
          flush=True)
    hk = phase_hopper_kernels(device)
    print("# phase 12 K2 (20, 1), (20, 13) and K3 (16, 10) vs plain: %s"
          % json.dumps(hk), flush=True)
    ho = phase_hopper(device)
    print("# phase 13 hopper main path: %s" % json.dumps(ho), flush=True)
    rk = phase_rocket_kernels(device)
    print("# phase 14 K2 (10, 1), (10, 4), (12, 1), (12, 16) vs plain: %s"
          % json.dumps(rk), flush=True)
    ro = phase_rocket(device)
    print("# phase 15 rocket main path: %s" % json.dumps(ro), flush=True)
    kr = phase_k1_rocket(device)
    print("# phase 16 K1 fused_ip rocket_projection vs plain: %s"
          % json.dumps(kr), flush=True)
    kh = phase_k1_hopper(device)
    print("# phase 17 K1 fused_ip hopper vs plain: %s" % json.dumps(kh),
          flush=True)
    sc = phase_scalar(device)
    print("# phase 18 scalar path: %s" % json.dumps(sc), flush=True)
    gb = phase_gb(device)
    print("# phase 19 gradient bundle: %s" % json.dumps(gb), flush=True)
    di = phase_direct(device)
    print("# phase 20 hopper direct transcription: %s" % json.dumps(di),
          flush=True)
    sw = phase_sweep(device)
    print("# phase 21 scenario sweep: %s" % json.dumps(sw), flush=True)

    src = "optimization_dynamics_tpu_torch/ops/kernels/csrc/"
    tpu = "optimization_dynamics_tpu/ops/pallas/"
    k1t = k1["f32"]["warm_25600"]
    k1r = k1["f32"]["cold_1024"]
    k4t, k4s = k4["f32"]["all_active_thread"], k4["f32"]["all_active_tile"]
    k4p = k4["f32"]["all_active"]["plain_ms"]
    k2b = k2["f32"]["bound_25600_k8"]
    k3d, k3w = k3["f32"]["deploy_512"], k3["f32"]["deploy_25600"]
    k1nt, k2p = k1n["f32"]["thread_warm_6400"], k1n["f32"]["k2_ift_6400"]
    k1ng = k1n["f32"]["group_cold_512"]
    k1gb = gb["k1n_group_cold_1275_f32"]

    def k2_entry(name, route, routes, plain_ms, bound, library_ms):
        """K2's tile or per-thread kernel, timed in one call (``ms``) and
        queued (``ms_device``)."""
        r = routes[route]
        return dict(name=name, route="cuda", source=src + "batched_solve.cu",
                    replaces=tpu + "batched_solve.py:119",
                    max_abs_err=r["max_dx"], ms=r["ms"],
                    ms_device=r["ms_device"], plain_ms=plain_ms,
                    bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                    library_ms=library_ms)

    def k3_entry(name, route):
        return dict(name=name, route="cuda", source=src + "riccati.cuh",
                    replaces=tpu + "riccati.py:262",
                    max_abs_err=max(c[route]["max_abs_err"]
                                    for c in k3["f32"].values()
                                    if isinstance(c, dict) and route in c),
                    ms=k3d[route]["ms"],
                    ms_device=k3d[route]["ms_device"],
                    plain_ms=k3d["plain_ms"],
                    bound_ms=k3d["bound_ms"], bound_by=k3d["bound_by"],
                    library_ms=None,
                    ms_25600=k3w[route]["ms"],
                    ms_device_25600=k3w[route]["ms_device"],
                    bound_ms_25600=k3w["bound_ms"])

    k2r = k2["f32"]["ift_k8"]["routes"]
    # one call: linalg.solve waits for the card to check its pivots, so
    # its calls cannot be queued
    k2lib = k2["f32"]["library_ms_25600_k8"]
    kernels = [
        dict(name="fused_ip", route="cuda", source=src + "fused_ip.cu",
             replaces=tpu + "fused_ip.py:410",
             max_abs_err=max(c["max_dq"] for c in k1["f32"].values()),
             ms=k1t["ms"], plain_ms=k1t["plain_ms"],
             bound_ms=k1t["bound_ms"], bound_by=k1t["bound_by"],
             library_ms=None, ms_cold_1024=k1r["ms"]),
        k2_entry("batched_solve", "thread", k2r,
                 k2["f32"]["plain_ms_25600_k8"], k2b, k2lib),
        k2_entry("batched_solve_tile", "tile", k2r,
                 k2["f32"]["plain_ms_25600_k8"], k2b, k2lib),
        k3_entry("riccati", "thread"),
        dict(k3_entry("riccati_tile", "tile"),
             empty_launch_ms=k3["f32"]["empty_launch"]["ms"],
             empty_launch_ms_device=k3["f32"]["empty_launch"]["ms_device"]),
        dict(name="fused_rollout", route="cuda",
             source=src + "fused_rollout.cu",
             replaces=tpu + "fused_rollout.py:177",
             max_abs_err=max(k4["f32"][c]["max_dx"]
                             for c in ("all_active_thread", "ragged_thread")),
             ms=k4t["ms"], plain_ms=k4p,
             bound_ms=k4t["bound_ms"], bound_by=k4t["bound_by"],
             library_ms=None),
        dict(name="fused_rollout_tile", route="cuda",
             source=src + "fused_rollout.cu",
             replaces=tpu + "fused_rollout.py:177",
             max_abs_err=max(k4["f32"][c]["max_dx"]
                             for c in ("all_active_tile", "ragged_tile")),
             ms=k4s["ms"], plain_ms=k4p,
             bound_ms=k4s["bound_ms"], bound_by=k4s["bound_by"],
             library_ms=None),
    ]
    for k in kernels:
        k["launches"] = nw["launches"][k["name"]]
    kernels += [
        dict(name="fused_ip_tile", route="cuda", source=src + "fused_ip.cu",
             replaces=tpu + "fused_ip.py:410",
             launches=mp["launches"]["fused_ip_tile"],
             max_abs_err=max(k1["f32"][c]["max_dq"]
                             for c in ("cold_1024", "cold_4096")),
             ms=k1r["ms"], plain_ms=k1r["plain_ms"],
             bound_ms=k1r["bound_ms"], bound_by=k1r["bound_by"],
             library_ms=None),
        dict(name="fused_ip_nz35", route="cuda",
             source=src + "fused_ip_push.cu",
             replaces=tpu + "fused_ip.py:442",
             launches=pu["launches"]["fused_ip_nz35"],
             max_abs_err=max(k1n["f32"][c]["max_dq"] for c in
                             ("thread_cold_512", "thread_warm_6400")),
             ms=k1nt["ms"], plain_ms=k1n["f32"]["warm_6400"]["plain_ms"],
             bound_ms=k1nt["bound_ms"], bound_by=k1nt["bound_by"],
             library_ms=None),
        dict(name="fused_ip_nz35_group", route="cuda",
             source=src + "fused_ip_push.cu",
             replaces=tpu + "fused_ip.py:442",
             launches=pu["launches"]["fused_ip_nz35_group"],
             max_abs_err=max(k1n["f32"][c]["max_dq"] for c in
                             ("group_cold_512", "group_warm_6400")),
             ms=k1ng["ms"], plain_ms=k1n["f32"]["cold_512"]["plain_ms"],
             bound_ms=k1ng["bound_ms"], bound_by=k1ng["bound_by"],
             library_ms=None,
             ms_warm_6400=k1n["f32"]["group_warm_6400"]["ms"],
             launches_gb=gb["solve"]["launches_gb"],
             ms_cold_1275=k1gb["ms"], ms_device_cold_1275=k1gb["ms_device"],
             bound_ms_cold_1275=k1gb["bound_ms"],
             bound_by_cold_1275=k1gb["bound_by"],
             ms_cold_1275_f64=gb["k1n_group_cold_1275_f64"]["ms"],
             ms_device_cold_1275_f64=gb["k1n_group_cold_1275_f64"][
                 "ms_device"]),
        dict(name="batched_solve_n35_k13", route="cuda",
             source=src + "batched_solve.cu",
             replaces=tpu + "batched_solve.py:119",
             launches=pu["launches"]["batched_solve_n35_k13"],
             max_abs_err=k2p["max_dx"], ms=k2p["ms"],
             plain_ms=k2p["plain_ms"], bound_ms=k2p["bound_ms"],
             bound_by=k2p["bound_by"], library_ms=k2p["library_ms"]),
    ]
    k1at, k2a = k1a["f32"]["thread_warm_25600"], k1a["f32"]["k2_ift_25600"]
    k1as = k1a["f32"]["tile_cold_512"]
    k5t = k5["plain"]
    kernels += [
        dict(name="fused_ip_acrobot", route="cuda",
             source=src + "fused_ip_acrobot.cu",
             replaces=tpu + "fused_ip.py:410",
             launches=ac["launches"]["fused_ip_acrobot"],
             max_abs_err=max(k1a["f32"][c]["max_dq"] for c in
                             ("thread_cold_512", "thread_warm_25600")),
             ms=k1at["ms"], plain_ms=k1a["f32"]["warm_25600"]["plain_ms"],
             bound_ms=k1at["bound_ms"], bound_by=k1at["bound_by"],
             library_ms=None),
        dict(name="fused_ip_acrobot_tile", route="cuda",
             source=src + "fused_ip_acrobot.cu",
             replaces=tpu + "fused_ip.py:410",
             launches=ac["launches"]["fused_ip_acrobot_tile"],
             max_abs_err=max(k1a["f32"][c]["max_dq"] for c in
                             ("tile_cold_512", "tile_warm_25600")),
             ms=k1as["ms"], plain_ms=k1a["f32"]["cold_512"]["plain_ms"],
             bound_ms=k1as["bound_ms"], bound_by=k1as["bound_by"],
             library_ms=None),
        dict(k2_entry("batched_solve_n6_k6", "thread", k2a["routes"],
                      k2a["plain_ms"], k2a, k2a["library_ms"]),
             launches=ac["launches"]["batched_solve_n6_k6"]),
        dict(k2_entry("batched_solve_n6_k6_tile", "tile", k2a["routes"],
                      k2a["plain_ms"], k2a, k2a["library_ms"]),
             launches=ac["launches"]["batched_solve_n6_k6_tile"]),
        dict(name="loop_overhead", route="cuda",
             source=src + "loop_overhead.cu",
             replaces="scripts/loop_overhead_r5.py:50,92",
             launches=k5["launches"],
             max_abs_err=max(k5[v]["max_abs_err"] for v in
                             ("plain", "reps8", "while")),
             ms=k5t["ms"], plain_ms=k5t["plain_ms"],
             bound_ms=k5t["bound_ms"], bound_by=k5t["bound_by"],
             library_ms=None),
    ]
    for case, nk in (("newton_k1", "n20_k1"), ("ift_k13", "n20_k13")):
        h = hk["f32"][case]
        kernels.append(dict(
            name="batched_solve_" + nk, route="cuda",
            source=src + "batched_solve.cu",
            replaces=tpu + "batched_solve.py:119",
            launches=ho["eager"]["launches"]["batched_solve_" + nk],
            max_abs_err=h["max_dx"], ms=h["ms"], ms_device=h["ms_device"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"]))
    k3h = hk["f32"]["hopper_256"]
    for name, route in (("riccati_n16_u10", "thread"),
                        ("riccati_n16_u10_tile", "tile")):
        kernels.append(dict(
            name=name, route="cuda", source=src + "riccati.cuh",
            replaces=tpu + "riccati.py:262",
            launches=ho["riccati_kernel"]["launches"][name],
            max_abs_err=max(hk["f32"][c][route]["max_abs_err"]
                            for c in ("hopper_256", "ragged_batch_253")),
            ms=k3h[route]["ms"], ms_device=k3h[route]["ms_device"],
            plain_ms=k3h["plain_ms"], bound_ms=k3h["bound_ms"],
            bound_by=k3h["bound_by"], library_ms=None))
    for nk, case in (("n10_k1", "proj_newton_15360"),
                     ("n10_k4", "proj_ift_15360"),
                     ("n12_k1", "dyn_newton_15360"),
                     ("n12_k16", "dyn_ift_15360")):
        r = rk["f32"][case]
        name = "batched_solve_" + nk
        kernels.append(dict(
            name=name, route="cuda", source=src + "batched_solve.cu",
            replaces=tpu + "batched_solve.py:119",
            launches=ro["launches"][name],
            launches_by_kernel={
                route: ro["launches_by_kernel"].get(name + "_" + route, 0)
                for route in ("tile", "thread")},
            max_abs_err=max(rk["f32"][c]["routes"][route]["max_dx"]
                            for c, cnk, _ in ROCKET_K2_CASES
                            if "n%d_k%d" % cnk == nk
                            for route in ("tile", "thread")),
            kernel=r["route"], ms=r["ms"], ms_device=r["ms_device"],
            ms_tile=r["routes"]["tile"]["ms"],
            ms_device_tile=r["routes"]["tile"]["ms_device"],
            ms_thread=r["routes"]["thread"]["ms"],
            ms_device_thread=r["routes"]["thread"]["ms_device"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # K1's later functors: the per-thread kernel timed at the sweep's
    # width, the tile kernel at a rollout step's, each forced by the cut,
    # with its time at the other width beside it
    for name, res, path, source, sweep in (
            ("fused_ip_rocket_projection", kr, ro, "fused_ip_rocket.cu",
             "cold_15360"),
            ("fused_ip_hopper", kh, ho["eager"], "fused_ip_hopper.cu",
             "warm_5120")):
        for route, case, other in (("thread", sweep, "cold_512"),
                                   ("tile", "cold_512", sweep)):
            r = res["f32"][case][route]
            kernels.append(dict(
                name=name + ("_tile" if route == "tile" else ""),
                route="cuda", source=src + source,
                replaces=tpu + "fused_ip.py:410",
                launches=path["launches"][name + ("_tile" if route == "tile"
                                                  else "")],
                max_abs_err=max(c[route]["max_dq"]
                                for c in res["f32"].values()),
                ms=r["ms"], ms_device=r["ms_device"], case=case,
                plain_ms=res["f32"][case]["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None,
                **{"ms_" + other: res["f32"][other][route]["ms"],
                   "ms_device_" + other:
                       res["f32"][other][route]["ms_device"]}))
    for k in kernels:
        if k["name"] in sc["launches"]:
            k["launches_scalar"] = sc["launches"][k["name"]]
    # phase 21's cold deploy sweep (two shards of 128): K1 by kernel, K2
    # at (10, 8) by kernel
    by_name = dict.fromkeys(("fused_ip", "fused_ip_tile", "batched_solve",
                             "batched_solve_tile"), 0)
    for sh in sw["deploy_cold"]["shards"]:
        for key, v in sh["launches"]["fused_ip"].items():
            by_name["fused_ip_tile" if key.startswith("tile ")
                    else "fused_ip"] += v
        for key, v in sh["launches"]["batched_solve"].items():
            if key.startswith("10 8 "):
                by_name["batched_solve_tile" if " tile " in key
                        else "batched_solve"] += v
    for k in kernels:
        if k["name"] in by_name:
            k["launches_sweep"] = by_name[k["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
