"""The friction grid's lanes at full size, pass by pass, port against
reference.

``examples/sweep.py::run_sweep`` solves each scenario with the scalar
AL-iLQR ``solve`` (T=51, float64, ``max_iter=100``, ``max_al_iter=20``)
and, where a lane failed, re-solves the shard from ``x0 + 0.05 noise``.
This tool runs both passes on every lane, unconditionally, and keeps
every field of every result, so that a non-finite field or a flag that
differs can be traced to its lane and pass. Run from the repository
root:

    python -m tools.sweep_lanes draws {numpy,jax} DIR
        # DIR/draws.npz: frictions, x0s, noise. ``numpy``: the port's
        # default draws of run_sweep(2, shard_size=2) (numpy seed 0);
        # ``jax``: lanes 0 and 63 of the reference's 64-scenario grid
        # and its fold_in(PRNGKey(0), 1000) retry noise (needs jax)
    JAX_PLATFORMS=cpu python -m tools.sweep_lanes reference DIR [--ulp K]
        # the reference's jit(vmap(solve_one)) on the CPU, both passes:
        # DIR/ref_first.npz, DIR/ref_retry.npz; with --ulp K every start
        # moved K units in the last place (DIR/ref_ulpK_*.npz), to see
        # how far a lane follows its start's last bits
    python -m tools.sweep_lanes port DIR [--device cuda] [--passes first]
        # the port's solve_one, one process a (lane, pass), all started
        # together (the scalar solve is host-bound): DIR/port_first.npz,
        # DIR/port_retry.npz, each lane's AL rounds in DIR/port_*.log
    python -m tools.sweep_lanes compare DIR [--a port] [--b ref]
        # per lane and pass: flags, counts, the fields that hold a
        # non-finite value, objective and controls of run a (``port``,
        # ``ref_ulpK``) against run b (the reference)

``port`` and ``compare`` import no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

PASSES = ("first", "retry")
RETRY_SCALE = 0.05


def _draws(kind: str, out: str):
    if kind == "numpy":
        fr = np.repeat(np.linspace(0.05, 0.4, 2)[:, None], 2, axis=1)
        x0s = 0.02 * np.random.default_rng(0).standard_normal((2, 4))
        noise = np.random.default_rng([0, 1000]).standard_normal((2, 4))
    else:
        import jax

        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        key = jax.random.PRNGKey(0)
        lanes = [0, 63]
        fr = np.asarray(jnp.linspace(0.05, 0.4, 64)[:, None].repeat(2, 1))
        x0s = np.asarray(0.02 * jax.random.normal(key, (64, 4), jnp.float64))
        fr, x0s = fr[lanes], x0s[lanes]
        noise = np.asarray(jax.random.normal(
            jax.random.fold_in(key, 1000), (2, 4), jnp.float64))
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "draws.npz"), frictions=fr, x0s=x0s,
             noise=noise)
    print(json.dumps(dict(frictions=fr.tolist(), x0s=x0s.tolist(),
                          noise=noise.tolist())))


def _starts(d, p, ulp=0):
    x0 = d["x0s"] + (RETRY_SCALE * d["noise"] if p == "retry" else 0.0)
    for _ in range(ulp):
        x0 = np.nextafter(x0, np.inf)
    return x0


def _reference(out: str, ulp: int):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from optimization_dynamics_tpu.examples import sweep as jsw
    from optimization_dynamics_tpu.utils.checkpoint import save_result

    d = np.load(os.path.join(out, "draws.npz"))
    run = jax.jit(jax.vmap(jsw.make_solver()))
    for p in PASSES:
        t0 = time.perf_counter()
        res = run(jnp.asarray(d["frictions"]),
                  jnp.asarray(_starts(d, p, ulp)))
        jax.block_until_ready(res.xs)
        tag = "ref_ulp%d" % ulp if ulp else "ref"
        save_result(os.path.join(out, "%s_%s.npz" % (tag, p)), res,
                    meta=dict(wall_s_cpu=time.perf_counter() - t0))
        print("%s %s: converged %s, %.1f s" % (
            tag, p, np.asarray(res.converged).tolist(),
            time.perf_counter() - t0), flush=True)


def _port_one(out: str, lane: int, p: str, device: str):
    import torch

    from optimization_dynamics_tpu_torch.examples import sweep as sw
    from optimization_dynamics_tpu_torch.solver.ilqr import ILQROptions
    from optimization_dynamics_tpu_torch.utils.checkpoint import save_result

    torch.set_num_threads(1)
    dev = torch.device(device)
    # each AL round on its own line: the same options, verbose
    sw.ILQROptions = lambda **k: ILQROptions(**k, verbose=True)
    d = np.load(os.path.join(out, "draws.npz"))
    x0 = torch.as_tensor(_starts(d, p)[lane], dtype=torch.float64,
                         device=dev)
    fr = torch.as_tensor(d["frictions"][lane], dtype=torch.float64)
    t0 = time.perf_counter()
    res = sw.make_solver()(fr, x0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    save_result(os.path.join(out, "port_%s_%d.npz" % (p, lane)), res,
                meta=dict(wall_s=time.perf_counter() - t0, device=device))


def _port(out: str, device: str, passes):
    if device.startswith("cuda"):
        from optimization_dynamics_tpu_torch.ops.kernels._build import (
            load_library)

        load_library()              # once, before the processes start
    d = np.load(os.path.join(out, "draws.npz"))
    lanes = range(d["x0s"].shape[0])
    procs = {}
    for p in passes:
        for i in lanes:
            log = open(os.path.join(out, "port_%s_%d.log" % (p, i)), "w")
            procs[(p, i)] = (subprocess.Popen(
                [sys.executable, "-m", "tools.sweep_lanes", "port-one", out,
                 "--lane", str(i), "--pass", p, "--device", device],
                stdout=log, stderr=subprocess.STDOUT), log)
    rc = 0
    for (p, i), (proc, log) in procs.items():
        rc |= proc.wait()
        log.close()
        print("port %s lane %d: rc %d" % (p, i, proc.returncode), flush=True)
    if rc:
        raise SystemExit("sweep_lanes: a port process failed")
    from optimization_dynamics_tpu_torch.utils.checkpoint import (
        load_result, save_result)

    for p in passes:
        parts = [load_result(os.path.join(out, "port_%s_%d.npz" % (p, i)))
                 for i in lanes]
        stacked = {k: np.stack([a[k] for a, _ in parts]) for k in parts[0][0]}
        save_result(os.path.join(out, "port_%s.npz" % p), stacked,
                    meta=dict(wall_s=[m["wall_s"] for _, m in parts],
                              device=device))


def _lanes(out: str, run: str, p: str) -> dict:
    """Run ``run``'s pass ``p`` lane by lane, ``{lane: (fields, wall)}``:
    from its stacked file, else from the per-lane files of a port run
    whose other lanes are still going."""
    from optimization_dynamics_tpu_torch.utils.checkpoint import load_result

    path = os.path.join(out, "%s_%s.npz" % (run, p))
    if os.path.exists(path):
        data, meta = load_result(path)
        wall = meta.get("wall_s", meta.get("wall_s_cpu"))
        return {i: ({k: v[i] for k, v in data.items()},
                    wall[i] if isinstance(wall, list) else wall)
                for i in range(data["xs"].shape[0])}
    found = {}
    for name in sorted(os.listdir(out)):
        head, _, lane = name[:-len(".npz")].rpartition("_")
        if name.endswith(".npz") and head == "%s_%s" % (run, p):
            data, meta = load_result(os.path.join(out, name))
            found[int(lane)] = (data, meta["wall_s"])
    return found


def _compare(out: str, a: str, b: str):
    rows = []
    for p in PASSES:
        got, want = _lanes(out, a, p), _lanes(out, b, p)
        for i, (data, wall) in got.items():
            row = dict(pass_=p, lane=i, a=a, b=b, wall_s=wall)
            for side, d in ((a, data), (b, want.get(i, (None,))[0])):
                if d is None:
                    continue
                row[side] = dict(
                    converged=bool(d["converged"]),
                    iterations=int(d["iterations"]),
                    al_iterations=int(d["al_iterations"]),
                    objective=float(d["objective"]),
                    constraint_violation=float(d["constraint_violation"]),
                    gradient_norm=float(d["gradient_norm"]),
                    non_finite=sorted(
                        k for k, v in d.items()
                        if v.dtype.kind == "f" and not np.isfinite(v).all()))
            if i in want:
                ref = want[i][0]
                row["objective_rel_diff"] = float(
                    abs(data["objective"] - ref["objective"])
                    / abs(ref["objective"]))
                row["us_max_abs_diff"] = float(
                    np.max(np.abs(data["us"] - ref["us"])))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=("draws", "reference", "port",
                                    "port-one", "compare"))
    ap.add_argument("args", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lane", type=int, default=0)
    ap.add_argument("--pass", dest="pass_", choices=PASSES, default="first")
    ap.add_argument("--passes", nargs="+", choices=PASSES, default=PASSES)
    ap.add_argument("--ulp", type=int, default=0)
    ap.add_argument("--a", default="port")
    ap.add_argument("--b", default="ref")
    a = ap.parse_args(argv)
    if a.cmd == "draws":
        _draws(a.args[0], a.args[1])
    elif a.cmd == "reference":
        _reference(a.args[0], a.ulp)
    elif a.cmd == "port":
        _port(a.args[0], a.device, a.passes)
    elif a.cmd == "port-one":
        _port_one(a.args[0], a.lane, a.pass_, a.device)
    else:
        _compare(a.args[0], a.a, a.b)


if __name__ == "__main__":
    main()
