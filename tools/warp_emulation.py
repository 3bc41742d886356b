"""The rocket's register-resident warp kernels on the host CPU, against
their plain versions: a check of their arithmetic where there is no card.

    python tools/warp_emulation.py [--lanes 300] [--seed 70] [--systems 64]

Compiles ``tools/warp_emulation/emu.cpp`` with ``g++`` against the
kernels' own device functions (``csrc/ip_warp.cuh``'s ``ip_solve_warp``
and ``csrc/qr_shfl.cuh``'s ``qr_solve_shfl``, read from this checkout;
the kernels and launchers of ``ip_warp.cuh`` are cut off, since they
need ``nvcc``), with ``tools/warp_emulation/cuda_runtime.h`` standing in
for the runtime: a warp is 32 threads that meet at each shuffle and
ballot. Then, in float64 and float32:

* K1's warp solve on ``--lanes`` cold projections
  (``rocket_projection_batch`` seed ``--seed``, the deploy's projection
  options) against K1's plain version: converged counts, the share of
  lanes whose flags and iteration counts agree, max|dz| where both
  converge in the same count;
* K2's shuffle solve at (12, 1), two systems a warp as the kernel runs
  them, on ``--systems`` of the rocket's midpoint Newton systems
  (``rocket_systems`` seed 60) against ``batched_solve_plain``: max|dx|
  over max|x|.

g++ contracts a * b + c into an FMA where the expression allows, as
nvcc does, but it is not nvcc: the check is of the kernels' logic and
order of operations, not of their last bits on the card, and says
nothing of their speed. Prints one JSON line. Needs ``g++`` with C++20.
"""

from __future__ import annotations

import argparse
import json
import platform
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from optimization_dynamics_tpu_torch.examples import rocket as ex  # noqa
from optimization_dynamics_tpu_torch.ops.kernels._build import CSRC  # noqa
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (  # noqa
    batched_solve_plain)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (  # noqa
    _ip_params, make_fused_ip_plain)
from optimization_dynamics_tpu_torch.solver.interior_point import (  # noqa
    IPOptions)
from optimization_dynamics_tpu_torch.utils import measure as m  # noqa

HERE = Path(__file__).resolve().parent / "warp_emulation"
CUT = "// One warp a scenario, IP_WARP_BLOCK / 32 a block."


def build(tmp: Path) -> Path:
    """The emulator, built against this checkout's headers."""
    inc = tmp / "inc"
    inc.mkdir()
    for p in CSRC.glob("*.cuh"):
        shutil.copy(p, inc / p.name)
    text = (CSRC / "ip_warp.cuh").read_text()
    (inc / "ip_warp.cuh").write_text(text[:text.index(CUT)]
                                     + "}  // namespace odt\n")
    exe = tmp / "emu"
    fma = ["-mfma"] if platform.machine() == "x86_64" else []
    subprocess.run(["g++", "-std=c++20", "-O2", *fma, "-ffp-contract=fast",
                    "-pthread", "-I", str(HERE), "-I", str(inc), "-o",
                    str(exe), str(HERE / "emu.cpp")], check=True)
    return exe


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=300)
    ap.add_argument("--seed", type=int, default=70)
    ap.add_argument("--systems", type=int, default=64)
    args = ap.parse_args(argv)
    cpu = torch.device("cpu")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        exe = build(tmp)
        B = args.lanes
        opts = IPOptions(r_tol=ex.DEPLOY_R_TOL_ACCEL,
                         kappa_tol=ex.PROJ_KAPPA_TOL)
        model, z0, th = m.rocket_projection_batch(B, args.seed, cpu,
                                                  torch.float64)
        with open(tmp / "k1.in", "wb") as f:
            for a in (np.int32(B), z0.numpy(), th.numpy(), _ip_params(opts)):
                f.write(a.tobytes())
        n, k = 12, 1
        A, b = m.rocket_systems(args.systems, 60, cpu, torch.float64)[n, k]
        with open(tmp / "k2.in", "wb") as f:
            for a in (np.int32(args.systems), A.contiguous().numpy(),
                      b.contiguous().numpy()):
                f.write(a.tobytes())
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            subprocess.run([str(exe), "k1" + name, str(tmp / "k1.in"),
                            str(tmp / "k1.out")], check=True)
            res = np.fromfile(tmp / "k1.out")
            z, st = res[:B * 10].reshape(B, 10), res[B * 10:].reshape(B, 4)
            sp = make_fused_ip_plain(model, opts, cpu, dtype)(
                z0.to(dtype), th.to(dtype))
            conv, its = st[:, 1] > 0.5, st[:, 0].astype(np.int64)
            pc, pit = sp.converged.numpy(), sp.iterations.numpy()
            same = (its == pit) & conv & pc
            dz = np.abs(z - sp.z.double().numpy())[same]
            out["k1_warp_" + name] = dict(
                lanes=B, converged=int(conv.sum()),
                converged_plain=int(pc.sum()),
                flags_agree=float((conv == pc).mean()),
                iterations_agree=float((its == pit).mean()),
                max_dz=float(dz.max()) if dz.size else None)
            subprocess.run([str(exe), "k2" + name, str(tmp / "k2.in"),
                            str(tmp / "k2.out")], check=True)
            x = np.fromfile(tmp / "k2.out").reshape(args.systems, n)
            xp = batched_solve_plain(A.to(dtype), b.to(dtype)).double()
            xp = xp.numpy()[..., 0]
            out["k2_shfl_%s" % name] = dict(
                systems=args.systems,
                rel_dx=float(np.abs(x - xp).max() / np.abs(xp).max()))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
