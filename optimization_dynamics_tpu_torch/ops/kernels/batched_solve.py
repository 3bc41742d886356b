"""K2: batched small dense solves ``A x = b`` by unpivoted Householder QR.

Replaces the Pallas kernel ``batched_solve`` of
``optimization_dynamics_tpu/ops/pallas/batched_solve.py`` (``:100``, the
``pl.pallas_call`` at ``:119``; QR body ``_qr_solve_block``, ``:34``). On
the main path it is the IFT multi-right-hand-side solve of every
derivative sweep (n=10, k=8, B x (T-1) = 25,600 systems at the deploy
width) and the Newton solve of ``make_solver_batched`` (n=10, k=1), which
runs on the card for a model without a fused-IP device functor.

What bounds it on an H100: each system is ~4k flops on 260 values, so
the arithmetic is small and the kernel is bound by latency: at 25,600
systems one thread per system fills each of the 132 SMs with under two
128-thread blocks, the thread's row-major loads of its own 100-entry
matrix are not coalesced across the warp, and in double the 10x10 factor
spills to local memory. The design keeps the whole factorisation of a
system in one thread (no shared memory, no synchronisation), the same
device function as the fused IP kernel, with n and k as template
parameters so every loop unrolls; it is right and simple first. Staging
batch-last tiles through shared memory would coalesce the loads.

The wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    BATCHED_SOLVE_SHAPES,
    SUFFIX,
    batched_solve_symbol,
    load_library,
)

__all__ = ["batched_solve", "batched_solve_plain"]


def batched_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch batch-first Householder QR solve, the counterpart of
    the reference's ``batched_solve_reference``: A (B, n, n), b (B, n, k)
    -> x (B, n, k). Same steps as the kernel and as ``_qr_solve_block``."""
    n = A.shape[1]
    rows = torch.arange(n, device=A.device)
    R, y = A, b
    for i in range(n):
        col = R[:, :, i]                                    # (B, n)
        x = torch.where(rows >= i, col, 0.0)
        normx = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        x0 = col[:, i:i + 1]                                # (B, 1)
        sign = torch.where(x0 >= 0, 1.0, -1.0).to(A.dtype)
        alpha = -sign * normx
        v = torch.where(rows == i, x0 - alpha, x)           # (B, n)
        vnorm2 = torch.sum(v * v, dim=1, keepdim=True)
        inv = torch.where(vnorm2 > 0,
                          2.0 / torch.where(vnorm2 > 0, vnorm2, 1.0), 0.0)
        w = torch.sum(v[:, :, None] * R, dim=1)             # (B, n) per col
        R_new = R - inv[:, :, None] * v[:, :, None] * w[:, None, :]
        R = torch.where(rows[None, None, :] >= i, R_new, R)
        wy = torch.sum(v[:, :, None] * y, dim=1)            # (B, k)
        y = y - inv[:, :, None] * v[:, :, None] * wy[:, None, :]

    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[:, i, :]
        if i + 1 < n:
            acc = acc - torch.sum(R[:, i, i + 1:, None]
                                  * torch.stack(xs[i + 1:], dim=1), dim=1)
        diag = R[:, i, i:i + 1]
        safe = torch.where(torch.abs(diag) > 1e-30, diag, 1.0)
        xs[i] = acc / safe
    return torch.stack(xs, dim=1)


def batched_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (B, n, n), b (B, n, k) -> x (B, n, k).

    CPU tensors take ``batched_solve_plain``; CUDA tensors launch the K2
    kernel, which is compiled for the (n, k) in ``BATCHED_SOLVE_SHAPES``
    and for float32 and float64, and raise on anything else."""
    if A.device.type == "cpu" and b.device.type == "cpu":
        return batched_solve_plain(A, b)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError("batched_solve: A and b must share one CUDA "
                         "device (got %s, %s)" % (A.device, b.device))
    if A.dtype not in SUFFIX or b.dtype != A.dtype:
        raise TypeError("batched_solve: float32 or float64 A and b of one "
                        "dtype (got %s, %s)" % (A.dtype, b.dtype))
    if A.ndim != 3 or b.ndim != 3 or A.shape[1] != A.shape[2] \
            or b.shape[:2] != A.shape[:2]:
        raise ValueError("batched_solve: A (B, n, n), b (B, n, k); got %s, "
                         "%s" % (tuple(A.shape), tuple(b.shape)))
    B, n, _ = A.shape
    k = b.shape[2]
    if (n, k) not in BATCHED_SOLVE_SHAPES:
        raise ValueError("batched_solve: no CUDA kernel for n=%d, k=%d "
                         "(compiled: %s)"
                         % (n, k, sorted(BATCHED_SOLVE_SHAPES)))
    if B >= 2 ** 31:
        raise ValueError("batched_solve: batch too large for int32")
    A = A.contiguous()
    b = b.contiguous()
    x = torch.empty_like(b)
    if B == 0:
        return x
    fn = getattr(load_library(), batched_solve_symbol(n, k, A.dtype))
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("batched_solve kernel launch failed: CUDA error "
                           "%d" % err)
    batched_solve.launches += 1
    return x


batched_solve.launches = 0
