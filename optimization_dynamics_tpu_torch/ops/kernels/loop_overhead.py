"""K5: the loop-overhead probe, a diagnostic kernel on no solver path.

Replaces the three ``pl.pallas_call`` micro-kernels of ``scripts/
loop_overhead_r5.py`` (the ``fori_loop`` kernels ``plain`` and ``reps8``
built at ``:50``, the ``while_loop`` kernel at ``:92``), which measured
what one loop trip costs inside a kernel. Each computes N = 1000 logical
iterations of

    z = z * 0.999 + 0.001;  z = z + max(z, axis=0) * 1e-6

on a (10, 128) float32 carry; the variants differ in loop structure only
(``plain``: N trips; ``reps8``: N/8 trips of eight; ``while``: a runtime
trip count with an early-exit test on the data). Its own entry point,
``optimization_dynamics_tpu_torch/scripts/loop_overhead.py``, is its
path.

What bounds it on an H100: the serial chain of 1,000 dependent updates a
column, not memory (5,120 bytes each way) or arithmetic (5,120
operations an iteration: a scale, a shift and an add an element, nine
compares and one scale a column; 5.12 MFLOP, 76.4 ns at the float32
rate). The kernel (``csrc/loop_overhead.cu``) runs
one block of 128 threads, one column a thread, its ten values in
registers. Its products and sums are rounded one by one (no FMA), so it
matches the plain version bit for bit.

The wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import load_library

__all__ = ["VARIANTS", "SHAPE", "N_ITER", "loop_overhead",
           "loop_overhead_plain"]

VARIANTS = ("plain", "reps8", "while")
SHAPE = (10, 128)
N_ITER = 1000


def loop_overhead_plain(x: torch.Tensor, variant: str,
                        n_iter: int = N_ITER) -> torch.Tensor:
    """The plain PyTorch loop: the same iterations on any device.
    ``variant`` picks the loop structure, which does not change the
    arithmetic: ``plain`` and ``reps8`` run ``N_ITER`` iterations,
    ``while`` runs ``n_iter`` and freezes a column once its max is not
    finite."""
    if variant not in VARIANTS:
        raise ValueError("loop_overhead: variant %r not in %s"
                         % (variant, VARIANTS))
    n = n_iter if variant == "while" else N_ITER
    z = x.clone()
    active = torch.ones_like(z[:1], dtype=torch.bool)
    for _ in range(n):
        z_new = z * 0.999 + 0.001
        m = torch.amax(z_new, dim=0, keepdim=True)
        z_new = z_new + m * 1e-6
        if variant == "while":
            z = torch.where(active, z_new, z)
            active = active & torch.isfinite(m)
        else:
            z = z_new
    return z


def loop_overhead(x: torch.Tensor, variant: str,
                  n_iter: int = N_ITER) -> torch.Tensor:
    """x (10, 128) float32 -> z after the probe's iterations. CPU tensors
    take ``loop_overhead_plain``; CUDA tensors launch the K5 kernel."""
    if x.device.type == "cpu":
        return loop_overhead_plain(x, variant, n_iter)
    if x.device.type != "cuda":
        raise ValueError("loop_overhead: a CPU or CUDA tensor (got %s)"
                         % x.device)
    if x.dtype != torch.float32 or tuple(x.shape) != SHAPE:
        raise ValueError("loop_overhead: x is float32 %s (got %s %s)"
                         % (SHAPE, x.dtype, tuple(x.shape)))
    if variant not in VARIANTS:
        raise ValueError("loop_overhead: variant %r not in %s"
                         % (variant, VARIANTS))
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = load_library().odt_loop_overhead(
            x.data_ptr(), out.data_ptr(), VARIANTS.index(variant), n_iter,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("loop_overhead kernel launch failed: CUDA error "
                           "%d" % err)
    loop_overhead.launches += 1
    return out


loop_overhead.launches = 0
