"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use, by ``nvcc`` alone, into one
shared library with a plain C interface, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/odt_kernels/libodt_kernels_<hash>.so
         csrc/*.cu

The library lands in ``build/odt_kernels/`` at the repository root, named
by a hash of every source under ``csrc/`` and of the flags, so a change
to a kernel rebuilds it and nothing else is read. The compiler's output
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
           "BATCHED_SOLVE_SHAPES", "fused_ip_symbol",
           "batched_solve_symbol"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "odt_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The one table of compiled entry points. The wrappers take their shapes
# from it, and the C names of csrc/*.cu follow ``fused_ip_symbol`` and
# ``batched_solve_symbol``: a new instantiation is one line here plus its
# line in the .cu file.
FUSED_IP_FUNCTORS = {"cartpole_friction": (10, 8)}    # name -> (nz, ntheta)
BATCHED_SOLVE_SHAPES = frozenset({(10, 8), (10, 1)})  # (n, k)
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def fused_ip_symbol(functor: str, dtype: torch.dtype) -> str:
    return "odt_fused_ip_%s_%s" % (functor, SUFFIX[dtype])


def batched_solve_symbol(n: int, k: int, dtype: torch.dtype) -> str:
    return "odt_batched_solve_n%d_k%d_%s" % (n, k, SUFFIX[dtype])


_VP, _INT = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    **{fused_ip_symbol(f, dt): [_VP, _VP, _VP, _VP, _INT, _VP, _VP, _VP]
       for f in FUSED_IP_FUNCTORS for dt in SUFFIX},
    **{batched_solve_symbol(n, k, dt): [_VP, _VP, _VP, _INT, _VP]
       for n, k in BATCHED_SOLVE_SHAPES for dt in SUFFIX},
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
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(CSRC))
    log = "$ %s\n%s%s" % (" ".join(cmd), proc.stdout, proc.stderr)
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (%d):\n%s" % (proc.returncode, log))
    os.replace(tmp, lib)
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
