"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use, by ``nvcc`` alone, into one
shared library with a plain C interface, which ``ctypes`` loads. The
sources compile in parallel, one ``nvcc`` each, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <src>.o csrc/<src>.cu      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/odt_kernels/libodt_kernels_<hash>.so *.o

The library lands in ``build/odt_kernels/`` at the repository root, named
by a hash of every source under ``csrc/`` and of the flags, so a change
to a kernel rebuilds it and nothing else is read. The compilers' output
(``-Xptxas -v``: registers, spills) and each source's compile time are
kept beside it as ``<name>.log``; ``ptxas_report`` reads it back.
No ``--use_fast_math``: approximate division and square root would move
the interior-point line search's picks.

A build failure raises; no caller catches it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["library_path", "build", "load_library", "ptxas_report",
           "FUSED_IP_FUNCTORS", "FUSED_IP_TILE_MAX_B",
           "BATCHED_SOLVE_SHAPES", "BATCHED_SOLVE_TILE_MAX_B",
           "RICCATI_SHAPES", "RICCATI_TILE_MAX_B", "UNROLL_MAX_N",
           "FUSED_ROLLOUT_FUNCTORS", "fused_ip_symbol", "fused_ip_narrow",
           "fused_ip_narrow_symbol", "batched_solve_symbol",
           "batched_solve_route", "riccati_symbol", "riccati_route",
           "fused_rollout_symbol", "fused_rollout_tile_symbol"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "odt_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

# The one table of compiled entry points. The wrappers take their shapes
# from it, and the C names of csrc/*.cu follow the ``*_symbol`` helpers
# below: a new instantiation is one line here plus its line in the .cu
# file.
FUSED_IP_FUNCTORS = {"cartpole_friction": (10, 8),  # name -> (nz, ntheta)
                     "planar_push": (35, 13),
                     "acrobot_impact": (6, 6),
                     "rocket_projection": (10, 4),
                     "hopper": (20, 13)}
# (wrapper, functor) pairs that also have a narrow kernel, and the
# widest batch the wrapper sends it; wider launches run the per-thread
# kernel. The narrow kernel runs a scenario on several threads: a tile
# (csrc/ip_tile.cuh) where the NZ + 1 Jacobian columns fit a warp, else a
# 64-thread group (csrc/ip_group.cuh; ``fused_ip_narrow``). A narrow
# launch leaves most SMs idle with a thread a scenario; a wide one fills
# the card, and then the per-thread kernel, with fewer instructions a
# scenario, is the faster. Each cut is the widest measured width at
# which the narrow kernel was faster, on cold and on warm-started
# scenarios alike, from the width sweeps of tools/kernel_times.py
# (PERF.md section 6). K1 (cartpole): cold the tile loses from 20,480 on,
# warm from 25,600; the B=512 deploy sends no width between 6,400 and
# 25,600. K1a (acrobot): it wins up to 204,800 and loses cold at 409,600;
# the B=256 deploy sends at most 25,600. K1n (planar push): the group
# kernel wins up to 51,200 (the widest width swept); the B=256 deploy
# sends at most 6,400. K4 (cartpole): it wins at 12,288 and loses at
# 16,384; the deploy sends at most 2,048. K1 on the rocket's projection
# (always cold): the 16-thread tile wins up to 3,840 and loses from
# 15,360 (0.386 against 0.244 ms queued: the per-thread kernel runs all
# 25 line-search candidates, but with fewer instructions a scenario);
# the B=256 deploy sends 32-1,024 (the rollouts, the compacted sweeps)
# and 15,360 (the full sweeps). K1 on the hopper model: the 32-thread
# tile wins at every width swept, 32 to 51,200, cold and warm (the
# per-thread kernel keeps J in local memory: 7.7 against 1.65 ms cold at
# 5,120), so its 51,200 is the end of the sweep; the deploy sends at
# most 5,120.
FUSED_IP_TILE_MAX_B = {("fused_ip", "cartpole_friction"): 16384,
                       ("fused_ip", "acrobot_impact"): 204800,
                       ("fused_ip", "planar_push"): 51200,
                       ("fused_ip", "rocket_projection"): 3840,
                       ("fused_ip", "hopper"): 51200,
                       ("fused_rollout", "cartpole_friction"): 12288}
FUSED_ROLLOUT_FUNCTORS = {"cartpole_friction": (2, 1)}  # name -> (nq, nu)
BATCHED_SOLVE_SHAPES = frozenset({(10, 8), (10, 1), (35, 13), (6, 6),
                                  (2, 1), (2, 6), (20, 1), (20, 13),
                                  (12, 1), (12, 16), (10, 4)})  # (n, k)
RICCATI_SHAPES = frozenset({(4, 1), (4, 3), (6, 3), (10, 4),
                            (16, 10)})  # (nx, nu)
# K2 above this many unknowns runs one 64-thread block a system
# (csrc/odt_common.cuh, UNROLL_MAX_N); at or below, a tile kernel and a
# per-thread kernel
UNROLL_MAX_N = 16
# The widest batch each wrapper sends its tile kernel (a tile of threads a
# system or scenario); wider launches run the per-thread kernel. Each cut
# is the widest width of the sweep (512 to 409,600; K3 at (10, 4) and
# (16, 10) to 102,400; K2 at the rocket's shapes 32 to 61,440;
# tools/kernel_times.py --linalg-widths, K2 on the derivative sweep's
# row-interleaved systems; PERF.md section 6) at which the tile kernel
# took less of the card's time, queued. K3 at (4, 1) and K2 at (6, 6) win
# at every width swept, so their 409,600 is the end of the sweep, not a
# measured crossover; so does K3 at the hopper's (16, 10) up to 102,400,
# the end of its sweep (41 against 92 ms there; its per-thread kernel
# spills). K3 at (10, 4) wins at 6,400 and loses from 25,600.
# K2 at (10, 8) is the exception, at 0: reading the strides made its
# per-thread kernel as fast as the tile at 25,600 (and faster wider);
# at 512-6,400 the tile saves at most 0.013 ms of the card's time a
# launch, which one call, host-bound, does not show, and its rounding
# (1-2 ulp apart from the per-thread kernel's) moves the f32 deploys.
# The rocket's shapes, swept from 32 to 61,440 on its own systems
# (``--model rocket``; the Newton right-hand sides contiguous, as the
# solver passes them): at (10, 1) and (12, 1) the per-thread kernel
# takes less of the card's time at every width (0.0044 against 0.0073
# ms at 32, 0.0068 against 0.0185 at 15,360 for (10, 1)), so their cut
# is 0; at (10, 4) the tile wins from 128 to 3,840 and ties at 15,360
# (0.0201 against 0.0200 ms), so its cut is 3,840; at (12, 16) the
# per-thread kernel spills (12 x 28 values a thread) and the tile wins
# at every width (0.052 against 0.114 ms at 15,360), so its 61,440 is
# the end of the sweep. The shapes not swept take the cut of their
# swept neighbour, or the lower of the two (guessed, not measured): the
# acrobot-without-limits shapes (2, 1), (2, 6) that of (10, 8); K3's
# (4, 3) and (6, 3) that of (10, 4).
BATCHED_SOLVE_TILE_MAX_B = {(10, 8): 0, (10, 1): 0, (6, 6): 409600,
                            (2, 1): 0, (2, 6): 0, (12, 1): 0,
                            (12, 16): 61440, (10, 4): 3840}  # (n, k) -> B
RICCATI_TILE_MAX_B = {(4, 1): 409600, (4, 3): 6400, (6, 3): 6400,
                      (10, 4): 6400, (16, 10): 102400}  # (nx, nu) -> B
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def fused_ip_symbol(functor: str, dtype: torch.dtype) -> str:
    return "odt_fused_ip_%s_%s" % (functor, SUFFIX[dtype])


def fused_ip_narrow(functor: str) -> str:
    """The narrow kernel of a fused IP functor: ``"tile"`` where its NZ + 1
    Jacobian columns fit a warp, else ``"group"`` (64 threads)."""
    return "tile" if FUSED_IP_FUNCTORS[functor][0] + 1 <= 32 else "group"


def fused_ip_narrow_symbol(functor: str, dtype: torch.dtype) -> str:
    """``odt_fused_ip_tile_*`` or ``odt_fused_ip_group_*``."""
    return "odt_fused_ip_%s_%s_%s" % (fused_ip_narrow(functor), functor,
                                      SUFFIX[dtype])


def fused_rollout_symbol(functor: str, dtype: torch.dtype) -> str:
    return "odt_fused_rollout_%s_%s" % (functor, SUFFIX[dtype])


def fused_rollout_tile_symbol(functor: str, dtype: torch.dtype) -> str:
    return "odt_fused_rollout_tile_%s_%s" % (functor, SUFFIX[dtype])


def batched_solve_route(n: int, k: int, B: int) -> str:
    """K2's kernel for a launch of B systems: ``"group"`` above
    ``UNROLL_MAX_N`` unknowns, else ``"tile"`` up to the shape's cut in
    ``BATCHED_SOLVE_TILE_MAX_B`` and ``"thread"`` above it."""
    if n > UNROLL_MAX_N:
        return "group"
    return "tile" if B <= BATCHED_SOLVE_TILE_MAX_B[n, k] else "thread"


def batched_solve_symbol(n: int, k: int, dtype: torch.dtype,
                         route: str = "thread") -> str:
    """The entry point of K2's ``route`` kernel (the per-thread and group
    kernels share one name, picked by n at compile time)."""
    tile = "tile_" if route == "tile" else ""
    return "odt_batched_solve_%sn%d_k%d_%s" % (tile, n, k, SUFFIX[dtype])


def riccati_route(nx: int, nu: int, B: int) -> str:
    """K3's kernel for a launch of B scenarios: ``"tile"`` up to the
    shape's cut in ``RICCATI_TILE_MAX_B``, else ``"thread"``."""
    return "tile" if B <= RICCATI_TILE_MAX_B[nx, nu] else "thread"


def riccati_symbol(nx: int, nu: int, dtype: torch.dtype,
                   route: str = "thread") -> str:
    tile = "tile_" if route == "tile" else ""
    return "odt_riccati_%snx%d_nu%d_%s" % (tile, nx, nu, SUFFIX[dtype])


_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    **{fused_ip_symbol(f, dt): [_VP, _VP, _VP, _VP, _INT, _VP, _VP, _VP]
       for f in FUSED_IP_FUNCTORS for dt in SUFFIX},
    **{fused_ip_narrow_symbol(f, dt): [_VP, _VP, _VP, _VP, _INT, _VP, _VP,
                                       _VP]
       for w, f in FUSED_IP_TILE_MAX_B if w == "fused_ip" for dt in SUFFIX},
    **{fused_rollout_symbol(f, dt): [_VP] * 11 + [_INT, _INT] + [_VP] * 4
       for f in FUSED_ROLLOUT_FUNCTORS for dt in SUFFIX},
    **{fused_rollout_tile_symbol(f, dt): [_VP] * 11 + [_INT, _INT] + [_VP] * 4
       for w, f in FUSED_IP_TILE_MAX_B if w == "fused_rollout"
       for dt in SUFFIX},
    **{batched_solve_symbol(n, k, dt, route): [_VP, _VP, _VP, _INT]
       + [_I64] * 4 + [_VP]
       for n, k in BATCHED_SOLVE_SHAPES for dt in SUFFIX
       for route in (("thread", "tile") if n <= UNROLL_MAX_N
                     else ("group",))},
    **{riccati_symbol(nx, nu, dt, route): [_VP] * 14 + [_INT, _INT, _VP]
       for nx, nu in RICCATI_SHAPES for dt in SUFFIX
       for route in ("thread", "tile")},
    "odt_loop_overhead": [_VP, _VP, _INT, _INT, _VP],
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / ("libodt_kernels_%s.so" % h.hexdigest()[:16])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def _run(cmd):
    """Run one compiler command; (exit code, output, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, cwd=str(CSRC))
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 str(Path(tmp) / (src.stem + ".o")), str(src)]
                for src in _sources() if src.suffix == ".cu"]
        with ThreadPoolExecutor(len(cmds)) as pool:
            runs = list(pool.map(_run, cmds))
        so = str(Path(tmp) / "lib.so")
        link = [nvcc, *ARCH, "-shared", "-o", so,
                *(c[c.index("-o") + 1] for c in cmds)]
        failed = [c for c, r in zip(cmds, runs) if r[0] != 0]
        if not failed:
            cmds.append(link)
            runs.append(_run(link))
            if runs[-1][0] != 0:
                failed = [link]
        log = "".join("$ %s\n%s# %.1f s\n" % (" ".join(c), out, sec)
                      for c, (_, out, sec) in zip(cmds, runs))
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s"
                               % (", ".join(c[-1] for c in failed), log))
        os.replace(so, lib)
    return lib


def ptxas_report() -> dict:
    """What the build of these sources logged: per command its seconds,
    and per kernel its registers, static shared memory, stack frame and
    spill bytes (``{"compile_s": {source: s}, "kernels": {name: {...}}}``)."""
    text = library_path().with_suffix(".log").read_text()
    out = {"compile_s": {}, "kernels": {}}
    for cmd, body, sec in re.findall(r"^\$ (.*?)\n(.*?)^# ([\d.]+) s$",
                                     text, re.S | re.M):
        src = "link" if " -shared " in cmd else Path(cmd.split()[-1]).name
        out["compile_s"][src] = float(sec)
        for name, props in re.findall(
                r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry"
                r" function|\Z)", body, re.S):
            num = lambda pat: int((re.search(pat, props) or [0, 0])[1])
            out["kernels"][name] = dict(
                registers=num(r"Used (\d+) registers"),
                smem=num(r"(\d+) bytes smem"),
                stack=num(r"(\d+) bytes stack frame"),
                spill_stores=num(r"(\d+) bytes spill stores"),
                spill_loads=num(r"(\d+) bytes spill loads"))
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
