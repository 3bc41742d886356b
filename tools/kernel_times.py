"""Time the port's kernels on the card (K1, K1a, K1n, K4, K2 at (35, 13),
(10, 8), (6, 6), (20, 1) and (20, 13), K3; or K2 at the rocket's (10, 1),
(10, 4), (12, 1) and (12, 16) and K1 on its thrust projection; or K1 on
the hopper model), to compare two checkouts in
one call, and each two-kernel pair's narrow kernel (tile or group)
against its per-thread kernel by width.

Run on a machine with one CUDA card:

    python tools/kernel_times.py [--root DIR]
                                 [--model cartpole|acrobot|planar_push
                                  |rocket|hopper]
                                 [--widths 1600,6400]
                                 [--linalg-widths 512,25600,102400]

``--root`` is the checkout whose ``optimization_dynamics_tpu_torch`` is
imported (default: the one this script sits in). The inputs come from
this script's own checkout (``utils/measure.py``, loaded by its path),
so a parent commit unpacked into a directory times the same work: run
parent, change, change, parent and compare within the call.

Through the wrapper's own choice of kernel, float32:

* K1 (cartpole) on 1,024 cold swing-up-envelope scenarios (a rollout
  step's width, B x 2 alphas at B=512, numpy seed 4), 25,600 cold (seed
  1) and 25,600 warm, at the deploy IP options (``chip_smoke.py`` phase
  1's inputs);
* K1a (acrobot) on 512 cold (a rollout step's width, B x 2 alphas at
  B=256, seed 42), 25,600 cold (the sweep's width, seed 40) and 25,600
  warm, at the acrobot deploy IP options (phase 9's inputs);
* K1n (planar push) on 512 cold (a rollout step's width, B x 2 alphas
  at B=256, seed 32), 6,400 cold (the sweep's width B x (T-1), seed 30)
  and 6,400 warm, at the push deploy IP options (phase 7's inputs);
* K4 (cartpole) at 1,024 scenarios, T=51, every control active
  (``rollout_batch``, seed 20: phase 5's inputs);
* K2 on the 6,400 (35, 13) IFT systems at K1n's cold solutions, on the
  25,600 (10, 8) IFT systems at K1's cold solutions of envelope seed 2
  (phase 2's) and on the 25,600 (6, 6) ones at K1a's cold solutions
  (phase 9's), each beside ``torch.linalg.solve`` on them (one call
  only: it waits for the card to check its pivots, so its calls cannot
  be queued). The systems are laid out as the derivative sweep passes
  them (``batched_jacobian``'s row-interleaved strides), so a wrapper
  that copies them to contiguous memory is timed with its copy;
* K2 at the hopper's (20, 1) and (20, 13) on the 5,120 Newton and IFT
  systems of a hopper sweep (``hopper_systems`` seed 50, phase 12's),
  beside ``torch.linalg.solve``;
* K3 at nx=4, nu=1, T=51 on 512 lanes (``lqr_batch`` seed 10) and 25,600
  (seed 11), phase 4's inputs; at the hopper's (16, 10), T=21, on 256
  lanes (seed 51, the hopper's ``u_mask``), phase 12's;
* an empty kernel's launch (``launch_ms``), the floor under any launch.

At each of ``--widths``, ``--model``'s fused IP solve (K1, K1a or K1n)
runs cold and warm-started one iterate earlier, through its narrow
kernel (``"tile"``; K1n's group kernel) and through its per-thread
kernel in turn (``routed``: the wrapper's width cut
``FUSED_IP_TILE_MAX_B`` set for the call); for cartpole, K4 too at that
width. At each of ``--linalg-widths``, K3 (4, 1), (2, 1) and (4, 2)
(T=51, ``lqr_batch`` seeds 220, 221: ``chip_smoke.py`` phase 22's
inputs, every lane positive definite) and K2 at (10, 8) and (6, 6) run
through their tile and per-thread kernels in turn
(``cut_routed``: ``RICCATI_TILE_MAX_B`` or ``BATCHED_SOLVE_TILE_MAX_B``
set for the call), on the inputs above repeated to the width (K2's
interleaved row by row as above); K3 at (10, 4) too, on 2,048 lanes of
``lqr_batch`` seed 12 repeated, at the widths up to 102,400 (its
inputs take 62 kB a lane), and K3 at (16, 10) on the 256 hopper lanes
repeated, up to 102,400 (77 kB a lane). That is where each cut is
measured; a checkout without the tables (before the tile kernels) skips
this sweep, and one without the hopper's shapes skips them.

``--model rocket`` times K2 alone, at the rocket's four shapes: (10, 1)
and (10, 4), the thrust projection's Newton and IFT solves, and (12, 1)
and (12, 16), the implicit-midpoint solve's, on the 15,360 systems of a
deploy sweep at B=256 (``rocket_systems`` seed 70: Jacobians at the
deploy's x0 scatter, row-interleaved; the Newton right-hand sides
contiguous, as the solver passes them), one call and queued beside
``torch.linalg.solve``; and at each of ``--linalg-widths`` each shape's
narrow kernel (``"narrow"``: the tile; at (12, 1) the shuffle kernel,
where the checkout has it) and per-thread kernel in turn, on those
systems repeated to the width, where the four cuts of
``BATCHED_SOLVE_TILE_MAX_B`` are measured.

``--model rocket`` and ``--model hopper`` also time K1 on their functors
(``rocket_projection``, nz=10, at the deploy's projection options;
``hopper``, nz=20, at the hopper deploy's accelerator IP options),
through the wrapper's route at the deploy's widths: the rocket's 512 (a
rollout step's B x alphas) and 15,360 (the sweep's B x (T-1)) cold
projections (``rocket_projection_batch`` seeds 71 and 70); the hopper
model's 512 cold and 5,120 cold and warm solves of its deploy
(``hopper_deploy_batch`` seeds 82, 80, 81, warm-started from K1's
solutions one iterate earlier). At each of ``--widths`` they run through
the narrow kernel (``"narrow"``: the tile; the rocket's warp kernel,
where the checkout has it) and the per-thread kernel in turn
(``routed``; the rocket's
projections cold, as the deploy's always are, the hopper model's cold
and warm), where ``FUSED_IP_TILE_MAX_B``'s cuts for the two functors are
measured; K1 there is timed one call and queued. A checkout without
these functors skips them.

``ms`` is the median of CUDA events around one call over ``--reps``
calls after a warm-up, host work inside the call included, the time a
caller waits for one call; ``ms_device`` (K2, K3) times ``--reps``
calls queued back to back behind a spin kernel, the card's own time a
call. Prints one JSON line with the card's
``nvidia-smi`` name and power limit.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _measure():
    """This checkout's ``utils/measure.py``, whatever ``--root`` is."""
    spec = importlib.util.spec_from_file_location(
        "odt_measure",
        HERE / "optimization_dynamics_tpu_torch" / "utils" / "measure.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROCKET_SHAPES = ((10, 1), (10, 4), (12, 1), (12, 16))


def _rocket_k2(m, args, dev, f32, batched_solve, _build) -> dict:
    """K2 at the rocket's four shapes on the 15,360 systems of a deploy
    sweep (``rocket_systems`` seed 70), through the wrapper's route, one
    call and queued, beside ``torch.linalg.solve``; at each of
    ``--linalg-widths`` each shape's narrow and per-thread kernel in
    turn, forced by the cut, on those systems repeated to the width
    (row-interleaved)."""
    import torch

    systems = m.rocket_systems(15360, 70, dev, f32)
    out = {}
    for (n, k) in ROCKET_SHAPES:
        A, b = systems[n, k]
        out["k2_%d_%d_15360" % (n, k)] = dict(
            route=_build.batched_solve_route(n, k, A.shape[0]),
            ms=m.cuda_ms(lambda: batched_solve(A, b), reps=args.reps),
            ms_device=m.device_ms(lambda: batched_solve(A, b),
                                  reps=args.reps),
            library_ms=m.cuda_ms(lambda: torch.linalg.solve(A, b),
                                 reps=args.reps),
            rel_res=m.rel_residual(A, batched_solve(A, b), b))
    for w in (int(w) for w in filter(None, args.linalg_widths.split(","))):
        for (n, k) in ROCKET_SHAPES:
            ab = m.interleave_rows(m.grow_batch(systems[n, k], w))
            if k == 1:          # the solver's right-hand side: contiguous
                ab[1] = ab[1].contiguous()
            res = {}
            for route in ("narrow", "thread"):
                run = m.cut_routed(_build.BATCHED_SOLVE_TILE_MAX_B, (n, k),
                                   route == "narrow", batched_solve)
                res[route] = dict(
                    ms=m.cuda_ms(lambda: run(*ab), reps=args.reps),
                    ms_device=m.device_ms(lambda: run(*ab),
                                          reps=args.reps))
            out["k2_%d_%d_sweep_%d" % (n, k, w)] = res
            del ab
    return out


def _k1_functor(m, args, dev, f32, name) -> dict:
    """K1 on the rocket's ``rocket_projection`` or the ``hopper`` functor:
    through the wrapper's route at the deploy's widths (the rocket's 512
    and 15,360 cold projections, ``rocket_projection_batch`` seeds 71 and
    70; the hopper model's 512 cold and 5,120 cold and warm deploy solves,
    ``hopper_deploy_batch`` seeds 82, 80 and 81), and at each of
    ``--widths`` through the narrow and the per-thread kernel in turn
    (the rocket's cold, the hopper model's cold and warm), one call and
    queued."""
    import torch

    from optimization_dynamics_tpu_torch.ops.kernels import fused_ip as k1
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    if name == "rocket":
        from optimization_dynamics_tpu_torch.examples import rocket as ex

        opts = IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL,
                         kappa_tol=ex.PROJ_KAPPA_TOL)

        def batches(B, seeds=(70,)):
            return {"cold": m.rocket_projection_batch(B, seeds[0], dev,
                                                      f32)}
        deploy = {512: (71,), 15360: (70,)}
    else:
        from optimization_dynamics_tpu_torch.examples import hopper as ex

        opts = IPOptions(**ex.DEPLOY_IP_ACCEL)

        def batches(B, seeds=(80, 81)):
            model, z0c, thc = m.hopper_deploy_batch(B, seeds[0], dev, f32)
            out = {"cold": (model, z0c, thc)}
            if len(seeds) > 1:
                out["warm"] = (model, *m.warm_batch(
                    k1.make_fused_ip_solver(model, opts, dev, f32), model,
                    z0c, thc, seeds[1]))
            return out
        deploy = {512: (82,), 5120: (80, 81)}

    def time_ip(solve, z0, th) -> dict:
        sol = solve(z0, th)
        return dict(ms=m.cuda_ms(lambda: solve(z0, th), reps=args.reps),
                    ms_device=m.device_ms(lambda: solve(z0, th),
                                          reps=args.reps),
                    converged=int(sol.converged.sum()),
                    iterations=int(sol.iterations.sum()),
                    max_iterations=int(sol.iterations.max()))

    out = {}
    for B, seeds in deploy.items():
        for case, (model, z0, th) in batches(B, seeds).items():
            kern = k1.make_fused_ip_solver(model, opts, dev, f32)
            out["k1_%s_%s_%d" % (name, case, B)] = time_ip(kern, z0, th)
    for w in (int(w) for w in filter(None, args.widths.split(","))):
        for case, (model, z0, th) in batches(w).items():
            kern = k1.make_fused_ip_solver(model, opts, dev, f32)
            out["k1_%s_%s_sweep_%d" % (name, case, w)] = {
                route: time_ip(m.routed(model.kernel, route == "narrow",
                                        kern), z0, th)
                for route in ("narrow", "thread")}
            del z0, th
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--model",
                    choices=("cartpole", "acrobot", "planar_push", "rocket",
                             "hopper"),
                    default="cartpole")
    ap.add_argument("--widths", default="")
    ap.add_argument("--linalg-widths", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    from optimization_dynamics_tpu_torch.examples import acrobot
    from optimization_dynamics_tpu_torch.examples import cartpole
    from optimization_dynamics_tpu_torch.examples import planar_push as push
    from optimization_dynamics_tpu_torch.models import cartpole as cp_model
    from optimization_dynamics_tpu_torch.ops.kernels import _build
    from optimization_dynamics_tpu_torch.ops.kernels import fused_ip as k1
    from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
        batched_solve)
    from optimization_dynamics_tpu_torch.ops.kernels.fused_rollout import (
        make_fused_rollout)
    from optimization_dynamics_tpu_torch.ops.kernels.riccati import (
        riccati_backward)
    from optimization_dynamics_tpu_torch.solver.interior_point import (
        IPOptions)

    m = _measure()
    dev, f32 = torch.device("cuda"), torch.float32
    _build.load_library()
    out = dict(root=str(Path(args.root).resolve()), card=m.nvidia_smi())
    if args.model in ("rocket", "hopper"):
        if args.model == "rocket":
            out.update(_rocket_k2(m, args, dev, f32, batched_solve, _build))
        functor = {"rocket": "rocket_projection", "hopper": "hopper"}
        if functor[args.model] in _build.FUSED_IP_FUNCTORS:
            out.update(_k1_functor(m, args, dev, f32, args.model))
        print(json.dumps(out), flush=True)
        return

    def time_ip(solve, z0, th) -> dict:
        sol = solve(z0, th)
        return dict(ms=m.cuda_ms(lambda: solve(z0, th), reps=args.reps),
                    converged=int(sol.converged.sum()),
                    iterations=int(sol.iterations.sum()),
                    max_iterations=int(sol.iterations.max()))

    # (batch, IP options, (rollout-step width, seed), sweep width, seeds
    # (sweep cold, warm), tag) per model
    models = {
        "cartpole": (m.envelope_batch, IPOptions(**cartpole.DEPLOY_IP_ACCEL),
                     (1024, 4), 25600, 1, 3, "k1"),
        "acrobot": (acrobot.envelope_batch,
                    IPOptions(**acrobot.DEPLOY_IP_ACCEL,
                              **acrobot.DEPLOY_KAPPA_SCHEDULE),
                    (512, 42), 25600, 40, 41, "k1a"),
        "planar_push": (m.push_batch, IPOptions(**push.DEPLOY_IP_ACCEL),
                        (512, 32), 6400, 30, 31, "k1n")}
    solvers = {}
    for name, (batch, opts, (nr, sr), ns, sc, sw, tag) in models.items():
        model, z0s, ths = batch(nr, sr, dev, f32)
        kern = k1.make_fused_ip_solver(model, opts, dev, f32)
        solvers[name] = (model, kern, batch, sc, sw, tag)
        _, z0c, thc = batch(ns, sc, dev, f32)
        for case, (z0, th) in {
                "cold_%d" % nr: (z0s, ths), "cold_%d" % ns: (z0c, thc),
                "warm_%d" % ns: m.warm_batch(kern, model, z0c, thc,
                                             sw)}.items():
            out["%s_%s" % (tag, case)] = time_ip(kern, z0, th)

    # K4 at 1,024 scenarios, phase 5's inputs
    T, NX = cartpole.T, cartpole.NX
    cpm = cp_model.friction_model()
    aux = cp_model.CartpoleAux(h=cartpole.H, friction=torch.tensor(
        [0.35, 0.35], dtype=f32, device=dev))
    roll = make_fused_rollout(cpm, IPOptions(**cartpole.DEPLOY_IP_ACCEL),
                              aux, T, None, dev, f32)

    def rollout_args(B: int):
        x0s, uss, Kss, kss, alphas = m.rollout_batch(B, 20, dev, f32)
        z = torch.zeros_like
        xss_ref = roll(x0s, torch.zeros((B, T, NX), dtype=f32, device=dev),
                       uss, z(Kss), z(kss), z(alphas))[0]
        return x0s, xss_ref, uss, Kss, kss, alphas

    def time_rollout(fn, a) -> dict:
        st = fn(*a, return_stats=True)[3]
        return dict(ms=m.cuda_ms(lambda: fn(*a), reps=args.reps),
                    step_converged=int((st[..., 1] > 0.5).sum()),
                    iterations=int(st[..., 0].sum()))

    out["k4_1024"] = time_rollout(roll, rollout_args(1024))

    model, kern, batch, sc, sw, tag = solvers[args.model]
    narrow = "group" if args.model == "planar_push" else "tile"
    for w in filter(None, args.widths.split(",")):
        _, z0c, thc = batch(int(w), sc, dev, f32)
        cases = {"cold_": (z0c, thc),
                 "warm_": m.warm_batch(kern, model, z0c, thc, sw)}
        for case, (z0, th) in cases.items():
            out["%s_%s%s" % (tag, case, w)] = {
                route: time_ip(m.routed(model.kernel, route == narrow,
                                        kern), z0, th)
                for route in (narrow, "thread")}
        if args.model == "cartpole":
            a = rollout_args(int(w))
            out["k4_" + w] = {
                route: time_rollout(m.routed(cpm.kernel, route == "tile",
                                             roll), a)
                for route in ("tile", "thread")}

    def time_solve(A, b) -> dict:
        return dict(
            ms=m.cuda_ms(lambda: batched_solve(A, b), reps=args.reps),
            ms_device=m.device_ms(lambda: batched_solve(A, b),
                                  reps=args.reps),
            library_ms=m.cuda_ms(lambda: torch.linalg.solve(A, b),
                                 reps=args.reps),
            rel_res=m.rel_residual(A, batched_solve(A, b), b))

    # K2 on the sweeps' IFT systems: push (35, 13), cartpole (10, 8) from
    # envelope seed 2 (phase 2), acrobot (6, 6) at K1a's cold solutions
    pm, pkern = solvers["planar_push"][:2]
    _, pz, pth = m.push_batch(6400, 30, dev, f32)
    out["k2_35_13"] = time_solve(*m.ift_systems(pkern, pm, pz, pth))
    cm, ckern = solvers["cartpole"][:2]
    _, cz, cth = m.envelope_batch(25600, 2, dev, f32)
    systems = {(10, 8): m.ift_systems(ckern, cm, cz, cth)}
    am, akern, abatch = solvers["acrobot"][:3]
    _, az, ath = abatch(25600, 40, dev, f32)
    systems[6, 6] = m.ift_systems(akern, am, az, ath)
    for (n, k), (A, b) in systems.items():
        out["k2_%d_%d" % (n, k)] = time_solve(A, b)
    hopper = (20, 1) in _build.BATCHED_SOLVE_SHAPES
    if hopper:
        for (A, b) in m.hopper_systems(5120, 50, dev, f32):
            out["k2_20_%d" % b.shape[2]] = time_solve(A, b)

    # K3 at the deploy shape, phase 4's inputs
    mask = torch.ones((50, 1), dtype=f32, device=dev)
    lqr = {B: m.lqr_batch(seed, B, 51, 4, 1, dev, f32)
           for B, seed in ((512, 10), (25600, 11))}
    for B, data in lqr.items():
        out["k3_%d" % B] = dict(
            ms=m.cuda_ms(lambda: riccati_backward(*data, mask),
                         reps=args.reps),
            ms_device=m.device_ms(lambda: riccati_backward(*data, mask),
                                  reps=args.reps))
    if hopper:
        from optimization_dynamics_tpu_torch.examples import hopper as hop

        mask16 = hop.control_mask(dev).to(f32)
        lqr16 = m.lqr_batch(51, 256, hop.T, 16, 10, dev, f32)
        out["k3_16_10_256"] = dict(
            ms=m.cuda_ms(lambda: riccati_backward(*lqr16, mask16),
                         reps=args.reps),
            ms_device=m.device_ms(lambda: riccati_backward(*lqr16, mask16),
                                  reps=args.reps))
    out["empty_launch"] = m.launch_ms()

    widths = [int(w) for w in filter(None, args.linalg_widths.split(","))]
    if widths and hasattr(_build, "RICCATI_TILE_MAX_B"):
        mask4 = torch.ones((50, 4), dtype=f32, device=dev)
        lqr10 = m.lqr_batch(12, 2048, 51, 10, 4, dev, f32)
        # the reference's kernel-test shapes, where this checkout has them
        small = {s: (m.lqr_batch(seed, 2048, 51, *s, dev, f32),
                     torch.ones((50, s[1]), dtype=f32, device=dev))
                 for s, seed in (((2, 1), 220), ((4, 2), 221))
                 if s in _build.RICCATI_TILE_MAX_B}

        def both(table, key, fn, *a) -> dict:
            return {route: dict(
                ms=m.cuda_ms(lambda: run(*a), reps=args.reps),
                ms_device=m.device_ms(lambda: run(*a), reps=args.reps))
                for route in ("tile", "thread")
                for run in [m.cut_routed(table, key, route == "tile", fn)]}

        for w in widths:
            data = m.grow_batch(lqr[25600], w)
            out["k3_sweep_%d" % w] = both(_build.RICCATI_TILE_MAX_B, (4, 1),
                                          riccati_backward, *data, mask)
            del data
            if w <= 102400:
                data = m.grow_batch(lqr10, w)
                out["k3_10_4_sweep_%d" % w] = both(
                    _build.RICCATI_TILE_MAX_B, (10, 4), riccati_backward,
                    *data, mask4)
                del data
            for (nx, nu), (lqr_s, mask_s) in small.items():
                data = m.grow_batch(lqr_s, w)
                out["k3_%d_%d_sweep_%d" % (nx, nu, w)] = both(
                    _build.RICCATI_TILE_MAX_B, (nx, nu), riccati_backward,
                    *data, mask_s)
                del data
            if hopper and w <= 102400:
                data = m.grow_batch(lqr16, w)
                out["k3_16_10_sweep_%d" % w] = both(
                    _build.RICCATI_TILE_MAX_B, (16, 10), riccati_backward,
                    *data, mask16)
                del data
            for (n, k), ab in systems.items():
                out["k2_%d_%d_sweep_%d" % (n, k, w)] = both(
                    _build.BATCHED_SOLVE_TILE_MAX_B, (n, k), batched_solve,
                    *m.interleave_rows(m.grow_batch(ab, w)))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
