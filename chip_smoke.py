#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``optimization_dynamics_tpu_torch/ops/
kernels/csrc`` and runs four phases, each printing one ``#`` line:

0. card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   kernel build time;
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
   on the card against the same solve on the CPU.

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
    du = torch.as_tensor(0.05 * rng.standard_normal((ths.shape[0], 1)),
                         dtype=ths.dtype, device=ths.device)
    prev = ths.clone()
    prev[:, list(model.th_u)] += du
    return kern(z0s, prev).z, ths


def _k1_agreement(sk, sp, dtype) -> dict:
    """Check K1 against its plain version on one batch; see the module
    docstring for the tolerances."""
    import torch

    ck, cp = sk.converged.cpu().numpy(), sp.converged.cpu().numpy()
    both = ck & cp
    dz = (sk.z - sp.z).abs().cpu().numpy()[both]
    same_conv = float((ck == cp).mean())
    same_it = float((sk.iterations == sp.iterations).float().mean())
    _check(bool(torch.isfinite(sk.z).all()), "K1 z not finite")
    out = dict(conv_kernel=int(ck.sum()), conv_plain=int(cp.sum()),
               lanes=len(ck), same_conv=same_conv, same_iters=same_it)
    if dtype == torch.float64:
        err = float(dz.max()) if both.any() else float("nan")
        _check(same_conv >= 0.995, "K1 f64 converged flags agree on "
               "%.4f of lanes" % same_conv)
        _check(same_it >= 0.99, "K1 f64 iteration counts agree on "
               "%.4f of lanes" % same_it)
        _check(both.sum() > 0 and err <= 1e-10, "K1 f64 max|dz| %.3e" % err)
        out["max_dz"] = err
    else:
        err = float(dz[:, :2].max()) if both.any() else float("nan")
        _check(abs(int(ck.sum()) - int(cp.sum())) <= 0.01 * len(ck),
               "K1 f32 converged %d vs plain %d" % (ck.sum(), cp.sum()))
        _check(both.sum() > 0 and err <= 1e-4, "K1 f32 max|dq| %.3e" % err)
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
        load_library)

    smi = _nvidia_smi()
    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    print("# phase 0 card: %s | torch %s cuda %s | kernel build %.1f s"
          % (smi, torch.__version__, torch.version.cuda, build_s),
          flush=True)

    k1 = phase_k1(device)
    print("# phase 1 K1 fused_ip vs plain: %s" % json.dumps(k1), flush=True)
    k2 = phase_k2(device)
    print("# phase 2 K2 batched_solve vs plain: %s" % json.dumps(k2),
          flush=True)
    mp = phase_main(device)
    print("# phase 3 main path: %s" % json.dumps(mp), flush=True)

    kernels = [
        {"name": "fused_ip", "route": "cuda",
         "source": "optimization_dynamics_tpu_torch/ops/kernels/csrc/"
                   "fused_ip.cu",
         "replaces": "optimization_dynamics_tpu/ops/pallas/fused_ip.py:410",
         "launches": mp["launches"]["fused_ip"],
         "max_abs_err": max(c["max_dq"] for c in k1["f32"].values()),
         "ms": k1["f32"]["warm_25600"]["ms"],
         "plain_ms": k1["f32"]["warm_25600"]["plain_ms"]},
        {"name": "batched_solve", "route": "cuda",
         "source": "optimization_dynamics_tpu_torch/ops/kernels/csrc/"
                   "batched_solve.cu",
         "replaces": "optimization_dynamics_tpu/ops/pallas/"
                     "batched_solve.py:119",
         "launches": mp["launches"]["batched_solve"],
         "max_abs_err": k2["f32"]["ift_k8"]["max_dx"],
         "ms": k2["f32"]["ms_25600_k8"],
         "plain_ms": k2["f32"]["plain_ms_25600_k8"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
