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
(``-Xptxas -v``: registers, spills) is kept beside it as ``<name>.log``.
No ``--use_fast_math``: approximate division and square root would move
the interior-point line search's picks.

A build failure raises; no caller catches it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["library_path", "build", "load_library", "FUSED_IP_FUNCTORS",
           "BATCHED_SOLVE_SHAPES", "RICCATI_SHAPES",
           "FUSED_ROLLOUT_FUNCTORS", "fused_ip_symbol",
           "batched_solve_symbol", "riccati_symbol", "fused_rollout_symbol"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "odt_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

# The one table of compiled entry points. The wrappers take their shapes
# from it, and the C names of csrc/*.cu follow the ``*_symbol`` helpers
# below: a new instantiation is one line here plus its line in the .cu
# file.
FUSED_IP_FUNCTORS = {"cartpole_friction": (10, 8)}    # name -> (nz, ntheta)
FUSED_ROLLOUT_FUNCTORS = {"cartpole_friction": (2, 1)}  # name -> (nq, nu)
BATCHED_SOLVE_SHAPES = frozenset({(10, 8), (10, 1)})  # (n, k)
RICCATI_SHAPES = frozenset({(4, 1), (4, 3), (6, 3), (10, 4)})  # (nx, nu)
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def fused_ip_symbol(functor: str, dtype: torch.dtype) -> str:
    return "odt_fused_ip_%s_%s" % (functor, SUFFIX[dtype])


def fused_rollout_symbol(functor: str, dtype: torch.dtype) -> str:
    return "odt_fused_rollout_%s_%s" % (functor, SUFFIX[dtype])


def batched_solve_symbol(n: int, k: int, dtype: torch.dtype) -> str:
    return "odt_batched_solve_n%d_k%d_%s" % (n, k, SUFFIX[dtype])


def riccati_symbol(nx: int, nu: int, dtype: torch.dtype) -> str:
    return "odt_riccati_nx%d_nu%d_%s" % (nx, nu, SUFFIX[dtype])


_VP, _INT = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    **{fused_ip_symbol(f, dt): [_VP, _VP, _VP, _VP, _INT, _VP, _VP, _VP]
       for f in FUSED_IP_FUNCTORS for dt in SUFFIX},
    **{fused_rollout_symbol(f, dt): [_VP] * 11 + [_INT, _INT] + [_VP] * 4
       for f in FUSED_ROLLOUT_FUNCTORS for dt in SUFFIX},
    **{batched_solve_symbol(n, k, dt): [_VP, _VP, _VP, _INT, _VP]
       for n, k in BATCHED_SOLVE_SHAPES for dt in SUFFIX},
    **{riccati_symbol(nx, nu, dt): [_VP] * 14 + [_INT, _INT, _VP]
       for nx, nu in RICCATI_SHAPES for dt in SUFFIX},
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


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o",
                         str(Path(tmp) / (src.stem + ".o")), str(src)])
            procs.append(subprocess.Popen(
                cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=str(CSRC)))
        outs = [p.communicate()[0] for p in procs]
        so = str(Path(tmp) / "lib.so")
        link = [nvcc, *ARCH, "-shared", "-o", so,
                *(c[c.index("-o") + 1] for c in cmds)]
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            cmds.append(link)
            outs.append(proc.stdout)
            if proc.returncode != 0:
                failed = [link]
        log = "".join("$ %s\n%s" % (" ".join(c), o)
                      for c, o in zip(cmds, outs))
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s"
                               % (", ".join(c[-1] for c in failed), log))
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
