#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``optimization_dynamics_tpu_torch/ops/
kernels/csrc`` and runs twelve phases, each printing one ``#`` line:

0. card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   kernel build time in all and per source, and what ``ptxas`` reported
   per kernel (registers, stack frame, spill bytes);
1. K1 (fused IP solve) against its plain PyTorch version on the card:
   cartpole friction at the deploy IP options, on 4096 cold
   swing-up-envelope scenarios (numpy seed 0), on 25,600 cold ones (the
   derivative sweep's width) and on the same 25,600 warm-started from
   K1's solutions one iterate earlier (the sweep's warm starts); in
   float64 (flags identical on >= 99.5% of lanes, iteration counts on
   >= 99%, max|dz| <= 1e-10 where both converge: the kernel sums in
   sequence, torch in another order, so rare ties break differently) and
   float32 (converged count within 1%, max|dq| <= 1e-4); float32 timed;
2. K2 (batched QR solve) against its plain version: the 25,600 IFT
   systems of a derivative sweep (10x10, 8 right-hand sides, Jacobians at
   K1 solutions) and KKT-like saddle systems, relative residual <= 1e-5
   in float32 and <= 1e-12 in float64, and on the IFT systems
   max|dx| / max|x| <= 1e-3 (float32) and 1e-10 (float64); timed;
3. the main path at full width: the cartpole deploy problem (float32,
   T=51) solved by the segmented executor at B=512 for two AL rounds of
   three inner iterations; outputs finite, the objective below the
   initial open-loop rollout's on most lanes, both kernels' launch
   counters above zero; then a small-input check: four lanes in float64
   on the card against the same solve on the CPU;
4. K3 (Riccati backward pass) against its plain version: random LQR data
   (numpy seeds) at the deploy shape (nx=4, nu=1, T=51) at B=512 and
   25,600, a ragged ``u_mask`` at (4, 3, 6) and an indefinite Quu on
   every fifth lane at t=0; ``ok`` identical on every lane, relative
   difference <= 1e-10 in float64 and <= 1e-4 in float32 (on a lane that
   is not positive definite float32 compares the gains only: its dV2
   overflows); masked gains exactly 0; float32 timed at B=512;
5. K4 (fused rollout) against its plain version: the deploy IP options,
   T=51, 1,024 lanes from ``deploy_x0s``, random gains (numpy seed),
   alphas over the Armijo grid, all controls active and a ragged
   ``u_mask``; float64: per-step converged flags identical on >= 99.5% of
   lane-steps and max|dx| <= 1e-10 on the lanes whose every step
   converged in both in the same iteration count; float32: max|dx| <=
   2e-4 on the lanes whose every step converged in both; then float64
   K4 against the per-step K1 path (``closed_loop`` without
   ``rollout_fused``), max|dx| <= 1e-10 on >= 99.5% of lanes; float32
   timed;
6. the slice's main path: the phase-3 solve with K4 for every rollout and
   K3 for every backward pass; outputs finite, the objective below the
   open-loop one on most lanes, K1, K2, K3 and K4 launched, and K1
   launched once per backward pass (by the derivative sweeps only, never
   per rollout step); then the four-lane float64 card-against-CPU check
   of phase 3 with both kernels on;
7. K1n (the fused IP solve at nz=35, planar push) against its plain
   version at the push deploy IP options: 6,400 cold scenarios around the
   nominal pose (the push sweep's width, numpy seed 30), the same 6,400
   warm-started one iterate earlier, and 512 cold ones (a rollout step's
   width); float64: flags identical on >= 99.5% of lanes, max|dz| <=
   1e-10 where both converge in the same iteration count; float32:
   converged count within 1%, max|dq| <= 2e-4; then K2 at (35, 13) on the
   6,400 IFT systems at K1n's solutions, relative residual <= 1e-12 in
   float64 and <= 1e-4 in float32; float32 timed;
8. the planar-push main path at full width: the push deploy problem
   (float32, T=26) solved by the segmented executor at B=256 for two AL
   rounds of three inner iterations; outputs finite, the objective below
   the open-loop one on most lanes, K1n and K2 launched; then the
   four-lane float64 card-against-CPU check of phase 3 on push;
9. K1a (the fused IP solve at nz=6, acrobot with elbow joint limits)
   against its plain version at the acrobot deploy IP options (one-stage
   kappa schedule): 25,600 cold scenarios over the swing-up envelope
   (the sweep's width B x (T-1) at B=256, numpy seed 40), the same
   25,600 warm-started one iterate earlier, and 512 cold ones (a rollout
   step's width, B x 2 alphas); float64: flags and iteration counts
   identical on every lane, max|dz| <= 1e-12 on every lane; float32:
   converged count within 1%, max|dq| <= 2e-4; then K2 at (6, 6) on the
   25,600 IFT systems at K1a's solutions, relative residual <= 1e-12 in
   float64 and <= 1e-4 in float32; float32 timed;
10. the acrobot main path at full width: the acrobot deploy problem
   (float32, T=101) solved by the segmented executor at B=256 for two AL
   rounds of three inner iterations; outputs finite, the terminal
   violation below the open-loop rollout's on most lanes (the rest start
   costs almost nothing and misses the goal by pi), the elbow within its
   joint limit, K1a and K2 launched; then the four-lane float64
   card-against-CPU check of phase 3 on the acrobot;
11. K5 (the loop-overhead probe) through its entry point
   (``scripts/loop_overhead.py``: each variant timed over 20 launches
   after a warm-up), then each variant against its plain version,
   float32 atol 1e-4 (the kernel rounds every product and sum as the
   plain loop does, so it is expected to match bit for bit).

Each kernel's ``bound_ms`` is the larger of its bytes (each input read
once, each output written once) at 3.35 TB/s and its operations at the
67 TFLOP/s of float32 outside the tensor cores (the H100 SXM data sheet),
for the timed float32 call. The IP solves' operations are counted from
the iterations this run's data took: per iteration NZ dual-number
residuals (3 residuals' work each), a Householder QR solve ((4/3) NZ^3 +
3 NZ^2), max_ls trial residuals with their merit (R + 4 NZ each) and one
more residual, where R is the residual's arithmetic counted on one lane
of its plain version.

Any failure raises and the exit code is non-zero. Before the last line it
prints the ``nvidia-smi`` line and a JSON line of the kernels; the last
line is ``{"ok": true, "device": {...}}``. It needs one card and no
network.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the card, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def _residual_flops(model) -> int:
    """Arithmetic of one residual evaluation, counted on one lane of the
    plain version: each elementwise add, subtract, multiply, divide,
    negation, square root, sine, cosine or sum element is one."""
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
    q = torch.zeros((1, model.nq), dtype=f64)
    z = model.init_z(q)
    th = torch.zeros((1, model.spec.ntheta), dtype=f64)
    with Count():
        model.residual(z, th, torch.tensor(1e-3, dtype=f64))
    return Count.n


def _ip_flops(model, opts, iterations: int, solves: int) -> float:
    """Operations of ``solves`` IP solves that took ``iterations`` Newton
    iterations in all (see the module docstring)."""
    R, nz = _residual_flops(model), model.spec.nz
    per_iter = (nz * 3 * R + 4.0 / 3.0 * nz ** 3 + 3 * nz ** 2
                + opts.max_ls * (R + 4 * nz) + R)
    return iterations * per_iter + solves * R


def envelope_batch(B: int, seed: int, device, dtype):
    """Cold cartpole-friction solves over the swing-up envelope: |q| up to
    ~2, angles +-pi, u +-3 sigma (the distribution of the reference's
    fused-vs-XLA parity test), from a numpy seed."""
    import torch

    from optimization_dynamics_tpu_torch.models import cartpole

    rng = np.random.default_rng(seed)
    q1 = np.stack([2.0 * rng.standard_normal(B),
                   np.pi * rng.standard_normal(B)], axis=1)
    q0 = q1 - 0.05 * rng.standard_normal((B, 2))
    u = 3.0 * rng.standard_normal((B, 1))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    model = cartpole.friction_model()
    aux = cartpole.CartpoleAux(h=0.05, friction=t([0.35, 0.35]))
    q1_t = t(q1)
    return model, model.init_z(q1_t), model.theta_fn(t(q0), q1_t, t(u), aux)


def deploy_ip_options():
    from optimization_dynamics_tpu_torch.examples.cartpole import (
        DEPLOY_IP_ACCEL)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    return IPOptions(**DEPLOY_IP_ACCEL)


def warm_batch(kern, model, z0s, ths, seed: int):
    """The derivative sweep's warm starts: z0s are K1's solutions of the
    same lanes one iterate earlier (the control moved by 0.05 N(0, 1))."""
    import torch

    rng = np.random.default_rng(seed)
    du = torch.as_tensor(
        0.05 * rng.standard_normal((ths.shape[0], len(model.th_u))),
        dtype=ths.dtype, device=ths.device)
    prev = ths.clone()
    prev[:, list(model.th_u)] += du
    return kern(z0s, prev).z, ths


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
        cases = {"cold_4096": (z0s, ths), "cold_25600": (z0c, thc),
                 "warm_25600": (z0w, thw)}
        res = {}
        for case, (z0, th) in cases.items():
            sk, sp = kern(z0, th), plain(z0, th)
            torch.cuda.synchronize()
            res[case] = _k1_agreement(sk, sp, dtype)
            if dtype == torch.float32:
                res[case]["ms"] = _cuda_ms(lambda: kern(z0, th))
                res[case]["plain_ms"] = _cuda_ms(lambda: plain(z0, th),
                                                 reps=3)
                res[case].update(_bound(
                    _nbytes(z0, th, sk.z) + 4 * z0.shape[0] * 4,
                    _ip_flops(model, opts, int(sk.iterations.sum()),
                              z0.shape[0])))
        out[name] = res
    return out


def _ift_systems(B: int, seed: int, device, dtype):
    """The IFT systems of the derivative sweep: dr/dz (B, 10, 10) and
    dr/dtheta (B, 10, 8) at cold K1 solutions of envelope scenarios."""
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        make_fused_ip_solver)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        batched_jacobian)

    model, z0s, ths = envelope_batch(B, seed, device, dtype)
    zs = make_fused_ip_solver(model, deploy_ip_options(), device,
                              dtype)(z0s, ths).z
    return (batched_jacobian(model.residual, 0)(zs, ths),
            batched_jacobian(model.residual, 1)(zs, ths))


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


def _rel_residual(A, x, b) -> float:
    """max over systems of |A x - b|_inf / (|A|_inf |x|_inf + |b|_inf),
    evaluated in float64."""
    A, x, b = A.double(), x.double(), b.double()
    r = (A @ x - b).abs().amax(dim=(1, 2))
    scale = (A.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=(1, 2))
             + b.abs().amax(dim=(1, 2)))
    return float((r / scale).max())


def phase_k2(device) -> dict:
    import torch

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
                 ("saddle_k1", _saddle(4096, 1, 2, device, dtype))]
        res = {}
        for case, (A, b) in cases:
            xk = batched_solve(A, b)
            xp = batched_solve_plain(A, b)
            torch.cuda.synchronize()
            rk = _rel_residual(A, xk, b)
            dx = float((xk - xp).abs().max())
            rel_dx = dx / float(xp.abs().max())
            _check(rk <= res_tol, "K2 %s %s relative residual %.3e"
                   % (name, case, rk))
            if case.startswith("ift"):
                _check(rel_dx <= fwd_tol, "K2 %s %s max|dx|/max|x| %.3e"
                       % (name, case, rel_dx))
            res[case] = dict(rel_res=rk,
                             rel_res_plain=_rel_residual(A, xp, b),
                             max_dx=dx, rel_dx=rel_dx)
        A, b = cases[0][1]
        res["ms_25600_k8"] = _cuda_ms(lambda: batched_solve(A, b))
        res["plain_ms_25600_k8"] = _cuda_ms(
            lambda: batched_solve_plain(A, b))
        # the one PyTorch call that computes the same function (timed
        # only; the port never calls it)
        res["library_ms_25600_k8"] = _cuda_ms(lambda: torch.linalg.solve(A,
                                                                         b))
        n, k = A.shape[1], b.shape[2]
        res["bound_25600_k8"] = _bound(
            2 * _nbytes(b) + _nbytes(A),
            A.shape[0] * (4.0 / 3.0 * n ** 3 + 3 * n ** 2 * k))
        out[name] = res
    return out


def phase_main(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.examples import cartpole as ex
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

    fused_ip.launches = 0
    batched_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_ip": fused_ip.launches,
                "batched_solve": batched_solve.launches}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "main path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "objective fell on only %.3f of lanes" % fell)
    _check(launches["fused_ip"] > 0, "K1 not launched on the main path")
    _check(launches["batched_solve"] > 0,
           "K2 not launched on the main path")
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(conv.sum()), batch=B,
               mean_objective=float(obj.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell,
               mean_inner_iters=float(res.iterations.float().mean()))

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


def _lqr(seed: int, B: int, T: int, nx: int, nu: int, device, dtype):
    """Random LQR data (fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs,
    regs) from a numpy seed, drawn as the reference's Riccati kernel test
    draws it."""
    import torch

    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)

    def spd(m):
        A = n(B, T - 1, m, m)
        return np.einsum("btij,btkj->btik", A, A) + 0.5 * np.eye(m)

    A = n(B, nx, nx)
    data = [0.5 * n(B, T - 1, nx, nx), 0.5 * n(B, T - 1, nx, nu),
            n(B, T - 1, nx), n(B, T - 1, nu), spd(nx), spd(nu),
            0.3 * n(B, T - 1, nu, nx), n(B, nx),
            np.einsum("bij,bkj->bik", A, A) + np.eye(nx), np.full(B, 1e-6)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in data]


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


def phase_k3(device) -> dict:
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward, riccati_backward_plain)

    # case -> (B, T, nx, nu, seed)
    cases = {"deploy_512": (512, 51, 4, 1, 10),
             "deploy_25600": (25600, 51, 4, 1, 11),
             "ragged_4_3_6": (512, 6, 4, 3, 12),
             "indefinite_512": (512, 51, 4, 1, 13)}
    out = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        name = "f64" if dtype == torch.float64 else "f32"
        res = {}
        for case, (B, T, nx, nu, seed) in cases.items():
            data = _lqr(seed, B, T, nx, nu, device, dtype)
            mask = torch.ones((T - 1, nu), dtype=dtype, device=device)
            if case.startswith("ragged"):
                mask[:, nu - 1] = 0
                mask[0, 0] = 0
            bad = torch.zeros(B, dtype=torch.bool, device=device)
            if case.startswith("indefinite"):
                bad[::5] = True
                data[5][bad, 0] = -1.0e4
            got = riccati_backward(*data, mask)
            ref = riccati_backward_plain(*data, mask)
            torch.cuda.synchronize()
            _check(torch.equal(got[5], ref[5]),
                   "K3 %s %s: ok flags differ" % (name, case))
            _check(torch.equal(got[5], ~bad),
                   "K3 %s %s: ok is not 'every pivot > 0'" % (name, case))
            _check(bool(torch.isfinite(got[0]).all()
                        & torch.isfinite(got[1]).all()),
                   "K3 %s %s: gains not finite" % (name, case))
            rel = _rel_diff(got[:5], ref[:5], ~bad)
            if bool(bad.any()):
                whole = (got[:5] if dtype == torch.float64 else got[:2])
                rel = max(rel, _rel_diff(whole, ref[:len(whole)], bad))
            _check(rel <= tol, "K3 %s %s: relative difference %.3e"
                   % (name, case, rel))
            if case.startswith("ragged"):
                _check(bool((got[0][:, :, nu - 1] == 0).all()
                            & (got[1][:, 0, 0] == 0).all()),
                       "K3 %s: masked gains not 0" % name)
            res[case] = dict(rel_diff=rel,
                             max_abs_err=float(max(
                                 (g - r)[~bad].abs().max()
                                 for g, r in zip(got[:2], ref[:2]))),
                             ok_lanes=int(got[5].sum()), lanes=B)
            if dtype == torch.float32 and case == "deploy_512":
                res[case]["ms"] = _cuda_ms(
                    lambda: riccati_backward(*data, mask))
                res[case]["plain_ms"] = _cuda_ms(
                    lambda: riccati_backward_plain(*data, mask), reps=3)
                res[case].update(_bound(
                    _nbytes(*data, mask, *got[:2]) + 4 * B * 4,
                    B * (T - 1) * _riccati_flops(nx, nu)))
        out[name] = res
    return out


def _rollout_inputs(B: int, seed: int, device, dtype):
    """K4's inputs: x0s from ``deploy_x0s``, controls around the deploy
    initial guess, random gains (numpy seed) and alphas over the Armijo
    grid; the reference states are the zero-gain rollout of the controls
    (filled in by the caller)."""
    import torch

    from optimization_dynamics_tpu_torch.examples import cartpole as ex

    T = ex.T
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x0s = ex.deploy_x0s(torch.zeros(ex.NX, dtype=dtype, device=device), B,
                        seed)
    us0 = np.zeros((T - 1, ex.NU))
    us0[0, 0] = -1.5
    uss = t(us0[None] + 0.5 * rng.standard_normal((B, T - 1, ex.NU)))
    Kss = t(0.1 * rng.standard_normal((B, T - 1, ex.NU, ex.NX)))
    kss = t(0.2 * rng.standard_normal((B, T - 1, ex.NU)))
    alphas = t(0.5 ** (np.arange(B) % 8))
    return x0s, uss, Kss, kss, alphas


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
        x0s, uss, Kss, kss, alphas = _rollout_inputs(B, 20, device, dtype)
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
            k = kern(*args, return_stats=True)
            p = plain(*args)
            torch.cuda.synchronize()
            res[case] = _k4_agreement(k, p, dtype, "%s %s" % (name, case))
            if mask is not None:
                _check(torch.equal(k[1][:, 10:20], uss[:, 10:20]),
                       "K4 %s: masked steps moved u" % name)
            if dtype == torch.float32 and mask is None:
                res[case]["ms"] = _cuda_ms(lambda: kern(*args))
                res[case]["plain_ms"] = _cuda_ms(lambda: plain(*args),
                                                 reps=1)
                nx, nu = ex.NX, ex.NU
                res[case].update(_bound(
                    _nbytes(*args, *k[:3]) + (T - 1) * nu * 4,
                    _ip_flops(model, opts, int(k[3][..., 0].sum()),
                              B * (T - 1))
                    + B * (T - 1) * (2 * nx * nu + 3 * nu)))
        if dtype == torch.float64:
            # against the per-step K1 path: closed_loop without K4
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

    counters = {"fused_ip": fused_ip, "batched_solve": batched_solve,
                "riccati": riccati_backward, "fused_rollout": fused_rollout}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "new path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "objective fell on only %.3f of lanes" % fell)
    for k, n in launches.items():
        _check(n > 0, "%s not launched on the new path" % k)
    # one derivative sweep (one K1 launch) per backward pass (one K3
    # launch): no K1 launch comes from a rollout step
    _check(launches["fused_ip"] == launches["riccati"],
           "K1 launched %d times for %d backward passes"
           % (launches["fused_ip"], launches["riccati"]))
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(conv.sum()), batch=B,
               mean_objective=float(obj.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell,
               mean_inner_iters=float(res.iterations.float().mean()))

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


def push_batch(B: int, seed: int, device, dtype):
    """Cold planar-push solves around the nominal pose (pusher touching the
    box's left face, u = [1, 0.1]): q0 = q_nom + 0.005 N(0, 1), q1 = q0 +
    0.001 N(0, 1), u = u_nom + 0.1 N(0, 1), the distribution of the
    reference's fused-kernel test, from a numpy seed."""
    import torch

    from optimization_dynamics_tpu_torch.models import planar_push as pp

    rng = np.random.default_rng(seed)
    q0 = (np.array([0.0, 0.0, 0.0, -pp.R_DIM - 1e-6, 0.0])
          + 0.005 * rng.standard_normal((B, 5)))
    q1 = q0 + 0.001 * rng.standard_normal((B, 5))
    u = np.array([1.0, 0.1]) + 0.1 * rng.standard_normal((B, 2))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    model = pp.model()
    q1_t = t(q1)
    return model, model.init_z(q1_t), model.theta_fn(
        t(q0), q1_t, t(u), pp.PlanarPushAux(h=0.1))


def _fused_ip_phase(device, batch, opts, n_sweep: int, seeds,
                    exact_f64: bool) -> dict:
    """A fused-IP instantiation (K1n, K1a) and K2 at its IFT shape against
    their plain versions: ``n_sweep`` cold lanes and the same warm-started
    one iterate earlier (the sweep's width), 512 cold ones (a rollout
    step's width), then K2 on the sweep's IFT systems at the kernel's cold
    solutions. ``batch(B, seed, device, dtype) -> (model, z0s, thetas)``;
    ``seeds``: (cold, warm, 512). ``exact_f64``: every f64 flag and
    iteration count identical and max|dz| <= 1e-12 on every lane, else z
    compared where both converge in the same count (<= 1e-10)."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve, batched_solve_plain)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
        make_fused_ip_plain, make_fused_ip_solver)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        batched_jacobian)

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
        res = {}
        for case, (z0, th) in cases.items():
            sk, sp = kern(z0, th), plain(z0, th)
            torch.cuda.synchronize()
            res[case] = _k1_agreement(
                sk, sp, dtype, nq=model.nq, f32_tol=2e-4,
                min_same_iters=1.0 if exact_f64 else None)
            res[case]["mean_iters"] = float(sk.iterations.float().mean())
            if dtype == torch.float64 and exact_f64:
                _check(res[case]["same_conv"] == 1.0, "%s f64 %s flags "
                       "differ on some lane" % (model.kernel, case))
                dz = float((sk.z - sp.z).abs().max())
                _check(dz <= 1e-12, "%s f64 %s max|dz| %.3e"
                       % (model.kernel, case, dz))
                res[case]["max_dz_all_lanes"] = dz
            if dtype == torch.float32:
                res[case]["ms"] = _cuda_ms(lambda: kern(z0, th))
                res[case]["plain_ms"] = _cuda_ms(lambda: plain(z0, th),
                                                 reps=1)
                res[case].update(_bound(
                    _nbytes(z0, th, sk.z) + 4 * z0.shape[0] * 4,
                    _ip_flops(model, opts, int(sk.iterations.sum()),
                              z0.shape[0])))

        # K2 on the IFT systems of the sweep at the kernel's cold solutions
        zs = kern(z0c, thc).z
        A = batched_jacobian(model.residual, 0)(zs, thc)
        b = batched_jacobian(model.residual, 1)(zs, thc)
        n, k = A.shape[1], b.shape[2]
        xk, xp = batched_solve(A, b), batched_solve_plain(A, b)
        torch.cuda.synchronize()
        rk = _rel_residual(A, xk, b)
        _check(bool(torch.isfinite(xk).all()), "K2 %s (%d, %d): x not "
               "finite" % (name, n, k))
        _check(rk <= (1e-12 if dtype == torch.float64 else 1e-4),
               "K2 %s (%d, %d) relative residual %.3e" % (name, n, k, rk))
        dx = float((xk - xp).abs().max())
        k2 = dict(rel_res=rk, rel_res_plain=_rel_residual(A, xp, b),
                  max_dx=dx, rel_dx=dx / float(xp.abs().max()))
        if dtype == torch.float32:
            k2["ms"] = _cuda_ms(lambda: batched_solve(A, b))
            k2["plain_ms"] = _cuda_ms(lambda: batched_solve_plain(A, b))
            # the one PyTorch call that computes the same function (timed
            # only; the port never calls it)
            k2["library_ms"] = _cuda_ms(lambda: torch.linalg.solve(A, b))
            k2.update(_bound(2 * _nbytes(b) + _nbytes(A),
                             A.shape[0] * (4.0 / 3.0 * n ** 3
                                           + 3 * n ** 2 * k)))
        res["k2_ift_%d" % n_sweep] = k2
        out[name] = res
    return out


def phase_k1n(device) -> dict:
    """K1n (fused IP at nz=35) and K2 at (35, 13) against their plain
    versions: 6,400 cold and warm lanes (the push sweep's width, B x
    (T-1) at B=256) and 512 cold ones (a rollout step's width), then K2
    on the 6,400 IFT systems at K1n's cold solutions."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lam", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "push path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "push xs shape")
    fell = float((res.objective < obj0).float().mean())
    _check(fell >= 0.5, "push objective fell on only %.3f of lanes" % fell)
    for k, n in launches.items():
        _check(n > 0, "%s not launched on the push path" % k)
    conv = res.converged.cpu().numpy()
    obj = res.objective.cpu().numpy()
    out = dict(wall_s=wall, launches=launches, stats=dict(solve.stats),
               converged=int(conv.sum()), batch=B,
               mean_objective=float(obj.mean()),
               mean_initial_objective=float(obj0.mean()),
               objective_fell_frac=fell,
               max_violation=float(res.constraint_violation.max()),
               mean_inner_iters=float(res.iterations.float().mean()))

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

    counters = {"fused_ip_acrobot": fused_ip,
                "batched_solve_n6_k6": batched_solve}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(x0s, us0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    for name in ("xs", "us", "objective", "al_objective",
                 "constraint_violation", "lamT", "rho"):
        _check(bool(torch.isfinite(getattr(res, name)).all()),
               "acrobot path: %s not finite" % name)
    _check(tuple(res.xs.shape) == (B, ex.T, ex.NX), "acrobot xs shape")
    fell = float((res.constraint_violation < vio0).float().mean())
    _check(fell >= 0.5, "acrobot terminal violation fell on only %.3f of "
           "lanes" % fell)
    for k, n in launches.items():
        _check(n > 0, "%s not launched on the acrobot path" % k)
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
               mean_inner_iters=float(res.iterations.float().mean()))

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
            plain_ms=_cuda_ms(lambda: loop_overhead_plain(x, variant),
                              reps=1),
            us_per_iteration=1e3 * ms[variant] / N_ITER, **bound)
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

    smi = _nvidia_smi()
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

    src = "optimization_dynamics_tpu_torch/ops/kernels/csrc/"
    tpu = "optimization_dynamics_tpu/ops/pallas/"
    k1t, k3t = k1["f32"]["warm_25600"], k3["f32"]["deploy_512"]
    k4t = k4["f32"]["all_active"]
    k2b = k2["f32"]["bound_25600_k8"]
    k1nt, k2p = k1n["f32"]["warm_6400"], k1n["f32"]["k2_ift_6400"]
    kernels = [
        dict(name="fused_ip", route="cuda", source=src + "fused_ip.cu",
             replaces=tpu + "fused_ip.py:410",
             max_abs_err=max(c["max_dq"] for c in k1["f32"].values()),
             ms=k1t["ms"], plain_ms=k1t["plain_ms"],
             bound_ms=k1t["bound_ms"], bound_by=k1t["bound_by"],
             library_ms=None),
        dict(name="batched_solve", route="cuda",
             source=src + "batched_solve.cu",
             replaces=tpu + "batched_solve.py:119",
             max_abs_err=k2["f32"]["ift_k8"]["max_dx"],
             ms=k2["f32"]["ms_25600_k8"],
             plain_ms=k2["f32"]["plain_ms_25600_k8"],
             bound_ms=k2b["bound_ms"], bound_by=k2b["bound_by"],
             library_ms=k2["f32"]["library_ms_25600_k8"]),
        dict(name="riccati", route="cuda", source=src + "riccati.cu",
             replaces=tpu + "riccati.py:262",
             max_abs_err=max(c["max_abs_err"] for c in k3["f32"].values()),
             ms=k3t["ms"], plain_ms=k3t["plain_ms"],
             bound_ms=k3t["bound_ms"], bound_by=k3t["bound_by"],
             library_ms=None),
        dict(name="fused_rollout", route="cuda",
             source=src + "fused_rollout.cu",
             replaces=tpu + "fused_rollout.py:177",
             max_abs_err=max(k4["f32"][c]["max_dx"]
                             for c in ("all_active", "ragged")),
             ms=k4t["ms"], plain_ms=k4t["plain_ms"],
             bound_ms=k4t["bound_ms"], bound_by=k4t["bound_by"],
             library_ms=None),
    ]
    for k in kernels:
        k["launches"] = nw["launches"][k["name"]]
    kernels += [
        dict(name="fused_ip_nz35", route="cuda",
             source=src + "fused_ip_push.cu",
             replaces=tpu + "fused_ip.py:442",
             launches=pu["launches"]["fused_ip_nz35"],
             max_abs_err=max(c["max_dq"] for k, c in k1n["f32"].items()
                             if k != "k2_ift_6400"),
             ms=k1nt["ms"], plain_ms=k1nt["plain_ms"],
             bound_ms=k1nt["bound_ms"], bound_by=k1nt["bound_by"],
             library_ms=None),
        dict(name="batched_solve_n35_k13", route="cuda",
             source=src + "batched_solve.cu",
             replaces=tpu + "batched_solve.py:119",
             launches=pu["launches"]["batched_solve_n35_k13"],
             max_abs_err=k2p["max_dx"], ms=k2p["ms"],
             plain_ms=k2p["plain_ms"], bound_ms=k2p["bound_ms"],
             bound_by=k2p["bound_by"], library_ms=k2p["library_ms"]),
    ]
    k1at, k2a = k1a["f32"]["warm_25600"], k1a["f32"]["k2_ift_25600"]
    k5t = k5["plain"]
    kernels += [
        dict(name="fused_ip_acrobot", route="cuda",
             source=src + "fused_ip_acrobot.cu",
             replaces=tpu + "fused_ip.py:410",
             launches=ac["launches"]["fused_ip_acrobot"],
             max_abs_err=max(c["max_dq"] for k, c in k1a["f32"].items()
                             if k != "k2_ift_25600"),
             ms=k1at["ms"], plain_ms=k1at["plain_ms"],
             bound_ms=k1at["bound_ms"], bound_by=k1at["bound_by"],
             library_ms=None),
        dict(name="batched_solve_n6_k6", route="cuda",
             source=src + "batched_solve.cu",
             replaces=tpu + "batched_solve.py:119",
             launches=ac["launches"]["batched_solve_n6_k6"],
             max_abs_err=k2a["max_dx"], ms=k2a["ms"],
             plain_ms=k2a["plain_ms"], bound_ms=k2a["bound_ms"],
             bound_by=k2a["bound_by"], library_ms=k2a["library_ms"]),
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
