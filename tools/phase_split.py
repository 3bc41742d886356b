"""Where K1's narrow kernels on the rocket's projection and K2 at (12, 1)
spend their cycles, by clock64() stamps, on the card.

    python tools/phase_split.py [--out FILE]

Builds ``tools/phase_split.cu`` (stamped copies of the kernels' bodies;
see its head) with ``nvcc`` into a temporary directory under
``build/``, apart from the port's library, and runs, float32 and float64
where named:

* the latency in cycles of a dependent chain of FMAs, divisions, square
  roots and shuffles in one warp, and the clock it ran at;
* the 16-thread tile on the rocket's cold projections at 512 and 15,360
  (``rocket_projection_batch`` seeds 71 and 70, the deploy's projection
  options): the largest and mean IP iteration count, the iterations
  whose line search needed a second chunk, and the cycles an iteration
  spends in the Jacobian, the reflector steps, the back substitution,
  the line search and the rest, over all lanes and for the slowest;
* the warp kernel on the same inputs (float64 at 512), and the same with
  its QR's loops rolled;
* K2 at (12, 1) on 512 and 15,360 of the rocket's midpoint Newton systems
  (``rocket_systems`` seed 60, the Jacobians row-interleaved, the
  right-hand sides contiguous): the staging tile's staging, solve and
  write-back, the per-thread kernel's whole solve, the shuffle kernel's
  load, steps, back substitution and store, in cycles, with each
  instrumented kernel's queued time.

Prints one JSON line a measurement and one with all of them, with the
card's ``nvidia-smi`` name and power limit; ``--out`` writes the last to
a file. The stamps (a warp or tile sync each) add their own cycles, so
the instrumented times run above the kernels'. Needs a CUDA device."""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from optimization_dynamics_tpu_torch.examples import rocket as ex  # noqa
from optimization_dynamics_tpu_torch.ops.kernels import _build  # noqa
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (  # noqa
    _ip_params, make_fused_ip_plain)
from optimization_dynamics_tpu_torch.solver.interior_point import (  # noqa
    IPOptions)
from optimization_dynamics_tpu_torch.utils import measure as m  # noqa

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--out", default=None)
cli = ap.parse_args()
if not torch.cuda.is_available():
    raise SystemExit("phase_split: needs a CUDA device")
out = {"card": m.nvidia_smi()}
dev = torch.device("cuda")
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
tmp = Path(tempfile.mkdtemp(prefix="phase_split_", dir=_build.BUILD_DIR))
t0 = time.time()
r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), "-o", str(tmp / "probe.so"),
                    str(ROOT / "tools" / "phase_split.cu")],
                   capture_output=True, text=True)
out["build_s"] = time.time() - t0
if r.returncode:
    print(r.stdout, r.stderr)
    raise SystemExit(1)
lib = ctypes.CDLL(str(tmp / "probe.so"))
VP, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
for f in ("probe_k1_f32", "probe_k1_f64", "probe_k1w_f32", "probe_k1w_f64",
          "probe_k1wr_f32", "probe_k1wr_f64"):
    getattr(lib, f).argtypes = [VP] * 5 + [I, VP]
for f in ("probe_k2_tile_f32", "probe_k2_thread_f32", "probe_k2s_f32",
          "probe_k2sr_f32"):
    getattr(lib, f).argtypes = [VP] * 4 + [I] + [I64] * 4
lib.probe_lat.argtypes = [VP]
lat = torch.zeros(11, dtype=torch.int64, device=dev)
torch.cuda._sleep(50_000_000)
for _ in range(3):
    lib.probe_lat(lat.data_ptr())
torch.cuda.synchronize()
L = lat.cpu().tolist()
out["latency_cycles"] = dict(zip(["f32_fma", "f32_div", "f32_sqrt",
                                  "f32_shfl", "f64_fma", "f64_div",
                                  "f64_sqrt", "f64_shfl"], L[:8]))
out["latency_mhz"] = L[8] / max(1, L[9]) * 1e3
print(json.dumps({"latency": out["latency_cycles"],
                  "mhz": out["latency_mhz"]}), flush=True)
khz = lib.probe_clock_khz()
out["clock_khz"] = khz

opts = IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL, kappa_tol=ex.PROJ_KAPPA_TOL)
ip = _ip_params(opts)

NAMES = ["jacobian", "qr_steps", "back_sub", "line_search", "rest"]
for dtype in (torch.float32, torch.float64):
    dn = "f32" if dtype == torch.float32 else "f64"
    for B, seed in ((512, 71), (15360, 70)):
        model, z0, th = m.rocket_projection_batch(B, seed, dev, dtype)
        zs = torch.empty_like(z0)
        st = torch.empty((B, 4), dtype=dtype, device=dev)
        prof = torch.zeros((B, 8), dtype=torch.int64, device=dev)
        fn = getattr(lib, "probe_k1_" + dn)
        err = fn(z0.data_ptr(), th.data_ptr(), zs.data_ptr(), st.data_ptr(),
                 prof.data_ptr(), B, ip.ctypes.data)
        torch.cuda.synchronize()
        assert err == 0, err
        ref = make_fused_ip_plain(model, opts, dev, dtype)(z0, th)
        P = prof.cpu().numpy()
        its = P[:, 0]
        res = dict(
            iters_equal_plain_frac=float((st[:, 0].to(torch.int32)
                                          == ref.iterations).float().mean()),
            max_iters=int(its.max()), mean_iters=float(its.mean()),
            total_iters=int(its.sum()),
            second_chunk_iters=int(P[:, 1].sum()),
            lanes_with_second_chunk=int((P[:, 1] > 0).sum()),
            converged=int((st[:, 1] > 0.5).sum()))
        tot = P[:, 2:7].sum(axis=0)
        res["cycles_per_iter_mean"] = {
            n: float(v) / max(1, its.sum()) for n, v in zip(NAMES, tot)}
        slow = int(np.argmax(P[:, 7]))
        res["slowest_lane"] = dict(
            lane=slow, iters=int(its[slow]), second_chunks=int(P[slow, 1]),
            cycles=int(P[slow, 7]),
            us=float(P[slow, 7]) / khz * 1e3,
            per_iter={n: float(P[slow, 2 + i]) / max(1, its[slow])
                      for i, n in enumerate(NAMES)})
        # the instrumented kernel's own queued time (its stamps' syncs
        # included)
        res["probe_ms_device"] = m.device_ms(lambda: fn(
            z0.data_ptr(), th.data_ptr(), zs.data_ptr(), st.data_ptr(),
            prof.data_ptr(), B, ip.ctypes.data))
        out["k1_%s_%d" % (dn, B)] = res
        print(json.dumps({"k1_%s_%d" % (dn, B): res}), flush=True)

WNAMES = ["jacobian", "qr_steps", "back_sub", "boundary_alpha",
          "candidates", "pick", "rest"]
for dtype, cases in ((torch.float32, ((512, 71), (15360, 70))),
                     (torch.float64, ((512, 71),))):
    dn = "f32" if dtype == torch.float32 else "f64"
    for (B, seed), rolled in [(c, r) for c in cases for r in ("", "r")]:
        model, z0, th = m.rocket_projection_batch(B, seed, dev, dtype)
        zs = torch.empty_like(z0)
        st = torch.empty((B, 4), dtype=dtype, device=dev)
        prof = torch.zeros((B, 10), dtype=torch.int64, device=dev)
        fn = getattr(lib, "probe_k1w%s_%s" % (rolled, dn))
        args = (z0.data_ptr(), th.data_ptr(), zs.data_ptr(), st.data_ptr(),
                prof.data_ptr(), B, ip.ctypes.data)
        torch.cuda._sleep(50_000_000)
        assert fn(*args) == 0
        torch.cuda.synchronize()
        P = prof.cpu().numpy()
        its = P[:, 0]
        slow = int(np.argmax(P[:, 8]))
        res = dict(max_iters=int(its.max()), mean_iters=float(its.mean()),
                   cycles_per_iter_mean={
                       n: float(P[:, 1 + i].sum()) / its.sum()
                       for i, n in enumerate(WNAMES)},
                   slowest_lane=dict(
                       iters=int(its[slow]), cycles=int(P[slow, 8]),
                       ns=int(P[slow, 9]),
                       mhz=float(P[slow, 8]) / max(1, P[slow, 9]) * 1e3,
                       per_iter={n: float(P[slow, 1 + i]) / its[slow]
                                 for i, n in enumerate(WNAMES)}),
                   probe_ms_device=m.device_ms(lambda: fn(*args)))
        ref = make_fused_ip_plain(model, opts, dev, dtype)(z0, th)
        res["iters_equal_plain_frac"] = float(
            (st[:, 0].to(torch.int32) == ref.iterations).float().mean())
        key = "k1w%s_%s_%d" % (rolled, dn, B)
        out[key] = res
        print(json.dumps({key: res}), flush=True)

# K2 (12, 1) at 512 and 15,360: staging vs solve of the tile, the
# per-thread kernel's whole solve
systems = m.rocket_systems(15360, 60, torch.device("cpu"), torch.float32)
A_all, b_all = systems[12, 1]
for B in (512, 15360):
    A = m.interleave_rows([A_all[:B].to(dev)])[0]
    b = b_all[:B].to(dev).contiguous()
    x = torch.empty((B, 12, 1), device=dev)
    blocks = (B + 7) // 8
    prof = torch.zeros((blocks, 4), dtype=torch.int64, device=dev)
    lib.probe_k2_tile_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                          prof.data_ptr(), B, A.stride(0), A.stride(1),
                          b.stride(0), b.stride(1))
    torch.cuda.synchronize()
    P = prof.cpu().numpy()
    pt = torch.zeros(B, dtype=torch.int64, device=dev)
    x2 = torch.empty_like(x)
    lib.probe_k2_thread_f32(A.data_ptr(), b.data_ptr(), x2.data_ptr(),
                            pt.data_ptr(), B, A.stride(0), A.stride(1),
                            b.stride(0), b.stride(1))
    torch.cuda.synchronize()
    Pt = pt.cpu().numpy()
    res = dict(tile_cycles_mean={n: float(P[:, i].mean()) for i, n in
                                 enumerate(["stage", "solve", "write",
                                            "whole"])},
               tile_cycles_max={n: int(P[:, i].max()) for i, n in
                                enumerate(["stage", "solve", "write",
                                           "whole"])},
               thread_cycles_mean=float(Pt.mean()),
               thread_cycles_max=int(Pt.max()),
               rel_res_tile=m.rel_residual(A, x, b),
               rel_res_thread=m.rel_residual(A, x2, b))
    res["tile_probe_ms_device"] = m.device_ms(lambda: lib.probe_k2_tile_f32(
        A.data_ptr(), b.data_ptr(), x.data_ptr(), prof.data_ptr(), B,
        A.stride(0), A.stride(1), b.stride(0), b.stride(1)))
    res["thread_probe_ms_device"] = m.device_ms(
        lambda: lib.probe_k2_thread_f32(
            A.data_ptr(), b.data_ptr(), x2.data_ptr(), pt.data_ptr(), B,
            A.stride(0), A.stride(1), b.stride(0), b.stride(1)))
    ps = torch.zeros((B, 5), dtype=torch.int64, device=dev)
    x3 = torch.empty_like(x)
    sargs = (A.data_ptr(), b.data_ptr(), x3.data_ptr(), ps.data_ptr(), B,
             A.stride(0), A.stride(1), b.stride(0), b.stride(1))
    lib.probe_k2s_f32(*sargs)
    torch.cuda.synchronize()
    Ps = ps.cpu().numpy()
    res["shfl_cycles_mean"] = {n: float(Ps[:, i].mean()) for i, n in
                               enumerate(["load", "steps", "back_sub",
                                          "store", "whole"])}
    res["shfl_cycles_max"] = {n: int(Ps[:, i].max()) for i, n in
                              enumerate(["load", "steps", "back_sub",
                                         "store", "whole"])}
    res["rel_res_shfl"] = m.rel_residual(A, x3, b)
    res["shfl_probe_ms_device"] = m.device_ms(
        lambda: lib.probe_k2s_f32(*sargs))
    x4 = torch.empty_like(x)
    rargs = (A.data_ptr(), b.data_ptr(), x4.data_ptr(), ps.data_ptr(), B,
             A.stride(0), A.stride(1), b.stride(0), b.stride(1))
    lib.probe_k2sr_f32(*rargs)
    torch.cuda.synchronize()
    Ps = ps.cpu().numpy()
    res["shfl_rolled_cycles_mean"] = {n: float(Ps[:, i].mean()) for i, n in
                                      enumerate(["load", "steps", "back_sub",
                                                 "store", "whole"])}
    res["shfl_rolled_eq_unrolled"] = bool(torch.equal(x4, x3))
    res["shfl_rolled_probe_ms_device"] = m.device_ms(
        lambda: lib.probe_k2sr_f32(*rargs))
    out["k2_12_1_%d" % B] = res
    print(json.dumps({"k2_12_1_%d" % B: res}), flush=True)
out["empty_launch"] = m.launch_ms()

print(json.dumps(out))
if cli.out:
    Path(cli.out).write_text(json.dumps(out, indent=1))
