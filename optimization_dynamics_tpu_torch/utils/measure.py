"""Timers and kernel inputs shared by the port's card measurements.

``chip_smoke.py`` and ``tools/kernel_times.py`` time the kernels on these
inputs, so two checkouts that both have this module time the same work:

* ``nvidia_smi``: the card's name and power limit, as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
  prints them;
* ``cuda_ms``: the median of CUDA-event times of a call, host work
  between the events included;
* ``device_ms``: the card's own time a call, calls queued back to back
  behind a spin kernel so that no host time falls between the events;
  ``launch_ms``: an empty kernel's, both ways;
* ``kernel_route``, ``routed``: every K1 and K4 launch of a functor sent
  to its narrow kernel (tile, K1n's group, the rocket projection's warp)
  or to its per-thread kernel, for a block of code or a call;
  ``cut_routed``: the same for a wrapper with its own cut table (K2's
  ``BATCHED_SOLVE_TILE_MAX_B``, whose narrow kernel at (12, 1) is the
  shuffle kernel; K3's ``RICCATI_TILE_MAX_B``);
* ``rel_residual``: the relative residual of batched solves;
  ``ift_systems``: the IFT systems of a derivative sweep at a fused IP
  solve's solutions, laid out as the sweep passes them;
  ``interleave_rows``: tensors laid out so;
* ``envelope_batch``, ``warm_batch``: cold cartpole-friction IP solves
  over the swing-up envelope, and their warm starts one iterate earlier
  (the derivative sweep's);
* ``push_batch``: cold planar-push IP solves around the nominal pose;
* ``rocket_projection_batch``: cold thrust-cone projections;
* ``hopper_batch``: cold hopper-model IP solves about the standing pose;
  ``hopper_deploy_batch``: the hopper deploy's own IP solves, along
  open-loop rollouts of its initial controls;
* ``hopper_systems``: K2's inputs at the hopper's shapes, the Newton
  and IFT systems of a derivative sweep;
* ``rocket_systems``: K2's inputs at the rocket's four shapes, the
  Newton and IFT systems of its two chained solves;
* ``rollout_batch``: K4's inputs at the cartpole deploy's shapes;
* ``lqr_batch``: K3's inputs, random LQR data;
* ``grow_batch``: a batch repeated to a wider width (a cut's far side,
  a width sweep);
* ``scalar_solve``: one scenario's AL-iLQR solve, timed, with the K1 and
  K2 launches it made;
* ``kernel_trace``: a call under ``torch.profiler`` and the card's kernel
  events of its trace; ``busy_seconds``: the union of their intervals.

Every input comes from a numpy seed.
"""

from __future__ import annotations

import contextlib
import subprocess

import numpy as np
import torch

__all__ = ["nvidia_smi", "cuda_ms", "device_ms", "launch_ms",
           "kernel_route", "routed", "cut_routed", "rel_residual",
           "ift_systems", "interleave_rows", "envelope_batch",
           "warm_batch", "push_batch", "rocket_projection_batch",
           "hopper_batch", "hopper_deploy_batch", "hopper_systems",
           "rocket_systems", "rollout_batch",
           "lqr_batch", "grow_batch", "scalar_solve", "kernel_trace",
           "busy_seconds"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the card, after one warm-up."""
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


def device_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call of ``fn()`` keeps the card busy: ``reps`` calls
    queued behind a spin kernel (``torch.cuda._sleep``), then timed by
    CUDA events around them, so the host's time between calls falls
    while the card still spins and the events time the card's work back
    to back. A spin that ends before the host has queued every call is
    doubled, up to four times; then it raises."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()      # the card was still spinning
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError("device_ms: the host did not queue %d calls within "
                       "the spin" % reps)


def launch_ms() -> dict:
    """An empty kernel (a spin of 0 cycles, one thread): ``ms_device``,
    its time on the card between kernels queued back to back, and
    ``ms``, one launch timed as ``cuda_ms`` times a wrapper's call."""
    empty = lambda: torch.cuda._sleep(0)
    return dict(ms_device=device_ms(empty, reps=200),
                ms=cuda_ms(empty, reps=20))


@contextlib.contextmanager
def kernel_route(functor: str, tile: bool):
    """Within the block, every K1 and K4 launch of ``functor`` runs its
    narrow kernel (``tile``: the tile kernel, K1n's group kernel or the
    rocket projection's warp kernel) or its per-thread kernel, whatever
    its width:
    the wrappers' width cuts ``FUSED_IP_TILE_MAX_B`` set for the block."""
    from optimization_dynamics_tpu_torch.ops.kernels._build import (
        FUSED_IP_TILE_MAX_B)

    keys = [k for k in FUSED_IP_TILE_MAX_B if k[1] == functor]
    old = {k: FUSED_IP_TILE_MAX_B[k] for k in keys}
    FUSED_IP_TILE_MAX_B.update({k: 2 ** 31 if tile else 0 for k in keys})
    try:
        yield
    finally:
        FUSED_IP_TILE_MAX_B.update(old)


def routed(functor: str, tile: bool, fn):
    """``fn`` with every K1 and K4 launch of ``functor`` on its tile kernel
    (``tile``) or on its per-thread kernel (``kernel_route``)."""
    def call(*args, **kwargs):
        with kernel_route(functor, tile):
            return fn(*args, **kwargs)
    return call


def cut_routed(table: dict, key, tile: bool, fn):
    """``fn`` with the cut ``table[key]`` set for the call: every launch of
    that wrapper and shape runs its narrow kernel (``tile``: the tile, or
    K2's shuffle kernel at (12, 1)) or its per-thread kernel, whatever its
    width."""
    def call(*args, **kwargs):
        old = table[key]
        table[key] = 2 ** 31 - 1 if tile else 0
        try:
            return fn(*args, **kwargs)
        finally:
            table[key] = old
    return call


def rel_residual(A, x, b) -> float:
    """max over systems of |A x - b|_inf / (|A|_inf |x|_inf + |b|_inf),
    evaluated in float64."""
    A, x, b = A.double(), x.double(), b.double()
    r = (A @ x - b).abs().amax(dim=(1, 2))
    scale = (A.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=(1, 2))
             + b.abs().amax(dim=(1, 2)))
    return float((r / scale).max())


def ift_systems(solve, model, z0s, ths):
    """The IFT systems of a derivative sweep at ``solve``'s solutions of
    (z0s, ths): dr/dz (B, nz, nz) and dr/dtheta (B, nz, ntheta) as
    ``batched_jacobian`` gives them to the sweep's solve, row r of every
    system before row r + 1."""
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        batched_jacobian)

    zs = solve(z0s, ths).z
    return (batched_jacobian(model.residual, 0)(zs, ths),
            batched_jacobian(model.residual, 1)(zs, ths))


def interleave_rows(ts):
    """Each (B, n, m) tensor laid out as ``batched_jacobian`` gives its
    Jacobians: row r of every system before row r + 1, strides (m, B m,
    1)."""
    return [t.transpose(0, 1).contiguous().transpose(0, 1) for t in ts]


def envelope_batch(B: int, seed: int, device, dtype):
    """Cold cartpole-friction solves over the swing-up envelope: |q| up to
    ~2, angles +-pi, u +-3 sigma (the distribution of the reference's
    fused-vs-XLA parity test), from a numpy seed."""
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


def warm_batch(kern, model, z0s, ths, seed: int):
    """The derivative sweep's warm starts: z0s are K1's solutions of the
    same lanes one iterate earlier (the control moved by 0.05 N(0, 1))."""
    rng = np.random.default_rng(seed)
    du = torch.as_tensor(
        0.05 * rng.standard_normal((ths.shape[0], len(model.th_u))),
        dtype=ths.dtype, device=ths.device)
    prev = ths.clone()
    prev[:, list(model.th_u)] += du
    return kern(z0s, prev).z, ths


def push_batch(B: int, seed: int, device, dtype):
    """Cold planar-push solves around the nominal pose (pusher touching the
    box's left face, u = [1, 0.1]): q0 = q_nom + 0.005 N(0, 1), q1 = q0 +
    0.001 N(0, 1), u = u_nom + 0.1 N(0, 1), the distribution of the
    reference's fused-kernel test, from a numpy seed."""
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


def rocket_projection_batch(B: int, seed: int, device, dtype):
    """Cold thrust-cone projections, the distribution of the reference's
    fused-kernel test: u_bar = 6 N(0, 1) (inside, outside and above the
    cone), u_max = 12.5, z0 the cold start ``init_z_proj``, from a numpy
    seed. Returns ``(model, z0s, thetas)``, the model the projection's
    ``ProjectionModel``."""
    from optimization_dynamics_tpu_torch.examples import rocket as ex
    from optimization_dynamics_tpu_torch.models import rocket

    rng = np.random.default_rng(seed)
    ths = np.concatenate([6.0 * rng.standard_normal((B, 3)),
                          np.full((B, 1), ex.U_MAX)], axis=1)
    z0s = rocket.init_z_proj(device, dtype).expand(B, rocket.NZ_PROJ)
    return (rocket.projection_model(), z0s.contiguous(),
            torch.as_tensor(ths, dtype=dtype, device=device))


def hopper_batch(B: int, seed: int, device, dtype):
    """Cold hopper-model solves about the standing pose, the distribution
    of the reference's fused-kernel test: q0 = [0, 0.5 + foot_radius, 0,
    0.5] + 0.005 N(0, 1), q1 = q0 + 0.001 N(0, 1), u = 0.1 N(0, 1),
    friction 0.5 and 0.5, h = 0.05, from a numpy seed. Returns ``(model,
    z0s, thetas)``."""
    from optimization_dynamics_tpu_torch.models import hopper

    rng = np.random.default_rng(seed)
    q_nom = np.array([0.0, 0.5 + hopper.HopperParams().foot_radius, 0.0,
                      0.5])
    q0 = q_nom + 0.005 * rng.standard_normal((B, 4))
    q1 = q0 + 0.001 * rng.standard_normal((B, 4))
    u = 0.1 * rng.standard_normal((B, 2))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    model = hopper.model()
    aux = hopper.HopperAux(h=0.05, friction=t([0.5, 0.5]))
    q1_t = t(q1)
    return model, model.init_z(q1_t), model.theta_fn(t(q0), q1_t, t(u), aux)


def hopper_deploy_batch(n: int, seed: int, device, dtype):
    """``n`` of the hopper deploy's own IP solves: the step inputs of
    ceil(n / (T-1)) open-loop rollouts of the deploy's initial controls
    (gait 1), each perturbed from a numpy seed (the two real controls by
    0.1 N(0, 1), the first step's configurations by 0.005 N(0, 1), the
    deploy's x0 scatter), rolled out by the deploy's own dynamics on
    ``device``, so the solves meet the contact modes those controls
    reach. Row b (T-1) + t is scenario b's step t; every solve cold, as a
    rollout's. Returns ``(model, z0s, thetas)``."""
    from optimization_dynamics_tpu_torch.examples import hopper as ex
    from optimization_dynamics_tpu_torch.models import hopper

    prob, x0, us0, _ = ex.build_deploy_problem(device, dtype=dtype,
                                               accelerator_ip=True)
    model = hopper.model()
    aux = hopper.HopperAux(h=ex.H)
    B = -(-n // (ex.T - 1))
    rng = np.random.default_rng(seed)
    noise = np.zeros((B, ex.T - 1, ex.NU))
    noise[:, :, 0:ex.NUS] = 0.1 * rng.standard_normal((B, ex.T - 1, ex.NUS))
    noise[:, 0, ex.NUS:] = 0.005 * rng.standard_normal((B, ex.NU - ex.NUS))
    uss = us0[None] + torch.as_tensor(noise, dtype=dtype, device=device)
    xs = ex.deploy_x0s(x0, B, seed)
    z0s, ths = [], []
    for t in range(ex.T - 1):
        us = uss[:, t]
        x8 = us[:, 2:10] if t == 0 else xs[:, 0:8]
        q1 = x8[:, 4:8]
        z0s.append(model.init_z(q1))
        ths.append(model.theta_fn(x8[:, 0:4], q1, us[:, 0:2], aux))
        xs = prob.dynamics_batched(t, xs, us)
    flat = lambda a: torch.stack(a, dim=1).reshape(B * (ex.T - 1), -1)[:n]
    return model, flat(z0s).contiguous(), flat(ths).contiguous()


def hopper_systems(B: int, seed: int, device, dtype):
    """The hopper's K2 systems over its gait: B (q0, q1, u) around the
    standing pose, in flight and on the ground (q1 = [0, 0.55, 0, 0.5] +
    [0.1, 0.1, 0.2, 0.1] N(0, 1), q0 = q1 - 0.01 N(0, 1), u = N(0, 1),
    from a numpy seed), solved by ``make_solver_batched`` at the deploy's
    accelerator IP options. Returns ``(newton, ift)``: the first Newton
    step's systems (dr/dz at the cold start, its residual at kappa 0.1;
    (B, 20, 20), (B, 20, 1)) and the IFT systems at the solutions (dr/dz,
    dr/dtheta; (B, 20, 20), (B, 20, 13)), the Jacobians row-interleaved
    as ``batched_jacobian`` gives them to the solver and the sweep."""
    from optimization_dynamics_tpu_torch.examples import hopper as ex
    from optimization_dynamics_tpu_torch.models import hopper
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions, batched_jacobian, make_solver_batched)

    rng = np.random.default_rng(seed)
    q1 = (np.array([0.0, 0.55, 0.0, 0.5])
          + np.array([0.1, 0.1, 0.2, 0.1]) * rng.standard_normal((B, 4)))
    q0 = q1 - 0.01 * rng.standard_normal((B, 4))
    u = rng.standard_normal((B, 2))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    model = hopper.model()
    ths = model.theta_fn(t(q0), t(q1), t(u), hopper.HopperAux(h=ex.H))
    z0s = model.init_z(t(q1))
    zs = make_solver_batched(model.residual, model.spec,
                             IPOptions(**ex.DEPLOY_IP_ACCEL), device,
                             dtype)(z0s, ths).z
    jz = batched_jacobian(model.residual, 0)
    newton = (jz(z0s, ths), model.residual(z0s, ths, 0.1)[..., None])
    ift = (jz(zs, ths), batched_jacobian(model.residual, 1)(zs, ths))
    return newton, ift


def rocket_systems(B: int, seed: int, device, dtype):
    """The rocket's K2 systems at the deploy's scenarios: B states from
    ``deploy_x0s`` (numpy seed ``seed``) and thrusts ``[0, 0, g] + [3, 3,
    4] N(0, 1)`` (seed ``seed + 1``: inside, outside and above the cone),
    solved by ``make_solver_batched`` at the deploy's accelerator r_tol.
    Returns ``{(n, k): (A, b)}``: the thrust projection's first Newton
    step from its cold start (dr/dz, r at kappa 0.1; (10, 1)) and its IFT
    systems at the solutions ((10, 4)), the midpoint solve's first Newton
    step from y = x ((12, 1)) and its IFT systems at the solutions ((12,
    16)); the Jacobians row-interleaved as ``batched_jacobian`` gives them
    to the solver and the sweep."""
    from optimization_dynamics_tpu_torch.examples import rocket as ex
    from optimization_dynamics_tpu_torch.models import rocket
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions, batched_jacobian, make_solver_batched)

    x1, _ = ex.initial_and_goal(device, dtype)
    xs = ex.deploy_x0s(x1, B, seed)
    rng = np.random.default_rng(seed + 1)
    us = torch.as_tensor(
        np.array([0.0, 0.0, 9.81])
        + np.array([3.0, 3.0, 4.0]) * rng.standard_normal((B, 3)),
        dtype=dtype, device=device)
    p = rocket.RocketParams()
    res_dyn = lambda z, th, k: rocket.residual_dyn(p, z, th, k)
    out = {}
    for res, spec, z0s, ths, kappa_tol in (
            (rocket.residual_proj, rocket.cone_spec_proj(),
             rocket.init_z_proj(device, dtype).expand(B, rocket.NZ_PROJ),
             torch.cat([us, us.new_full((B, 1), ex.U_MAX)], dim=1),
             ex.PROJ_KAPPA_TOL),
            (res_dyn, rocket.cone_spec_dyn(), xs, None, 1.0)):
        if ths is None:         # the midpoint solve at the projected thrust
            ths = torch.cat([xs, zs[:, 0:3], xs.new_full((B, 1), ex.H)],
                            dim=1)
        zs = make_solver_batched(
            res, spec, IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL,
                                 kappa_tol=kappa_tol), device,
            dtype)(z0s, ths).z
        jz = batched_jacobian(res, 0)
        n, k = spec.nz, spec.ntheta
        out[n, 1] = (jz(z0s, ths), res(z0s, ths, 0.1)[..., None])
        out[n, k] = (jz(zs, ths), batched_jacobian(res, 1)(zs, ths))
    return out


def rollout_batch(B: int, seed: int, device, dtype):
    """K4's inputs at the cartpole deploy's shapes (T=51): ``(x0s, uss,
    Kss, kss, alphas)``, x0s from ``deploy_x0s``, controls around the
    deploy's initial guess, random gains and alphas over the Armijo grid,
    from a numpy seed. The reference states are the caller's: K4's
    zero-gain rollout of the controls."""
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


def lqr_batch(seed: int, B: int, T: int, nx: int, nu: int, device, dtype):
    """Random LQR data (fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs,
    regs) from a numpy seed, drawn as the reference's Riccati kernel test
    draws it at its nx=4; fx is N(0, 1) / sqrt(nx) at any nx (0.5 N(0, 1)
    at nx=4), so its spectral radius stays about 1 and Vxx does not grow
    geometrically over the horizon at the hopper's nx=16."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)

    def spd(m):
        A = n(B, T - 1, m, m)
        return np.einsum("btij,btkj->btik", A, A) + 0.5 * np.eye(m)

    A = n(B, nx, nx)
    data = [n(B, T - 1, nx, nx) / np.sqrt(nx), 0.5 * n(B, T - 1, nx, nu),
            n(B, T - 1, nx), n(B, T - 1, nu), spd(nx), spd(nu),
            0.3 * n(B, T - 1, nu, nx), n(B, nx),
            np.einsum("bij,bkj->bik", A, A) + np.eye(nx), np.full(B, 1e-6)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in data]


def grow_batch(ts, B: int):
    """The tensors' first B lanes, their batch repeated as often as
    needed."""
    reps = -(-B // ts[0].shape[0])
    return [t.repeat((reps,) + (1,) * (t.ndim - 1))[:B].contiguous()
            for t in ts]


def scalar_solve(prob, x0, us0, opts):
    """The scalar AL-iLQR solve of ``prob`` from ``(x0, us0)`` on their
    device, timed from its start to the card's end (on the card the
    kernels are built before the clock starts). Returns ``(result, wall
    seconds, launches)``: launches of the fused IP kernel (K1, by kernel
    and width) and of the batched QR (K2, by n, k, kernel and width)
    during the solve, as ``{"fused_ip": {"tile B": n}, "batched_solve":
    {"n k kernel B": n}}``."""
    import time

    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import fused_ip
    from optimization_dynamics_tpu_torch.solver.ilqr import solve

    cuda = x0.device.type == "cuda"
    if cuda:
        from optimization_dynamics_tpu_torch.ops.kernels._build import (
            load_library)
        load_library()
        torch.cuda.synchronize()
    fused_ip.widths.clear()
    batched_solve.shape_widths.clear()
    t0 = time.perf_counter()
    res = solve(prob, x0, us0, opts)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    key = lambda k: " ".join(str(v) for v in k)
    return res, wall, {
        "fused_ip": {key(k): n for k, n in sorted(fused_ip.widths.items())},
        "batched_solve": {key(k): n for k, n in
                          sorted(batched_solve.shape_widths.items())}}


def kernel_trace(run):
    """``run()`` under ``torch.profiler``, host and card: ``(its result,
    the card's kernel events)``, each event a dict of the Chrome trace
    with the kernel's ``name`` and its start ``ts`` and ``dur`` in
    microseconds."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, [e for e in events if e.get("cat") == "kernel"]


def busy_seconds(kernels) -> float:
    """Seconds in the union of the kernel events' intervals: the time the
    card was busy."""
    busy, cur = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6
