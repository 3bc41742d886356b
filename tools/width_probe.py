"""Whether the deploys' line-search candidates depend on the width they
are rolled at, on the card (``chip_smoke.py`` phase 23's functions).

    python tools/width_probe.py [--root DIR] [--models a,b] \\
        [--identity a,b] [--out FILE]

For each deploy of ``--models`` (default acrobot, planar_push, hopper,
rocket; ``cartpole`` too), float64, B=64, options cut to two AL rounds
of 10 inner iterations: ``chip_smoke.py::_width_probe`` (every grid
alpha's states and AL costs at widths B, 2B and n_alpha B, the terminal
cost at B and n_alpha B, bit for bit). For each of ``--identity``,
``per_lane_alpha=True`` against the cascade, lane by lane
(``chip_smoke.py::lane_identity``). ``--root`` is the checkout whose
``optimization_dynamics_tpu_torch`` runs (default this one): a parent
unpacked with ``git archive`` into a directory that ``.gitignore``
lists gives the probe on the parent's problems. Prints one JSON line a
deploy and writes them all to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--models", default="acrobot,planar_push,hopper,rocket")
    ap.add_argument("--identity", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("width_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import optimization_dynamics_tpu_torch as pkg

    device = torch.device("cuda")
    ident = [m for m in args.identity.split(",") if m]
    out = {"root": os.path.dirname(os.path.dirname(pkg.__file__)),
           "card": cs.nvidia_smi()}
    for name in dict.fromkeys(
            [m for m in args.models.split(",") if m] + ident):
        prob, opts, x0s, us0 = cs.deploy_f64(name, device)
        entry = {}
        if name in args.models.split(","):
            t0 = time.perf_counter()
            entry["width_probe"] = cs._width_probe(prob, opts, x0s, us0,
                                                   device)
            entry["width_probe"]["wall_s"] = time.perf_counter() - t0
        if name in ident:
            try:
                entry["per_lane_alpha"] = cs.lane_identity(prob, opts, x0s,
                                                           us0, device)
            except AssertionError as e:     # fewer lanes than phase 22's rule
                entry["per_lane_alpha"] = {"failed": str(e)}
        out[name] = entry
        print("%s: %s" % (name, json.dumps(entry)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
