"""K2: batched small dense solves ``A x = b`` by unpivoted Householder QR.

Replaces the Pallas kernel ``batched_solve`` of
``optimization_dynamics_tpu/ops/pallas/batched_solve.py`` (``:100``, the
``pl.pallas_call`` at ``:119``; QR body ``_qr_solve_block``, ``:34``). On
the main path it is the IFT multi-right-hand-side solve of every
derivative sweep (n=10, k=8, B x (T-1) = 25,600 systems at the deploy
width) and the Newton solve of ``make_solver_batched``, which runs on
the card for a solve without a fused-IP device functor: the rocket's
implicit-midpoint solve at (12, 1), with its IFT solves at (12, 16) and
the thrust projection's at (10, 4), B x (T-1) = 15,360 systems a sweep
at its deploy width; the hopper model's IFT solves at (20, 13), 5,120
systems. The Newton shapes of solves that K1 runs whole, (10, 1) for the
rocket's projection and (20, 1) for the hopper model, are compiled and
tested but run on no deploy path on the card.

What bounds it on an H100: the arithmetic is small (a 10x10 system with
8 right-hand sides is ~4k flops on 260 values), so the kernel is bound by
latency and by how its loads coalesce. Three kernels, each running
``qr_body.cuh``'s steps in its order:

* Up to 16 unknowns (``UNROLL_MAX_N``) and up to the shape's cut in
  ``BATCHED_SOLVE_TILE_MAX_B`` systems, a tile of threads a system (the
  smallest power of two that holds the n + k columns of [A | b]: 32 at
  (10, 8) and (12, 16), 16 at (10, 1), (10, 4), (12, 1) and (6, 6)),
  several tiles a 128-thread block.
  The block loads its systems' A and b into shared memory with all its
  threads, coalesced, each thread owns one column of [A | b] in
  registers, and each Householder step is one owner's reflector and a
  parallel update of the other columns (``csrc/qr_group.cuh`` on a
  ``thread_block_tile``); x goes back through shared memory the same
  way. It runs the acrobot's (6, 6) sweeps, the rocket's (12, 16) sweeps
  and its (10, 4) sweeps up to 3,840 systems (those that compaction
  narrowed); at (10, 8) and (10, 1) the cut is 0 (``_build.py`` says
  why).
* At (12, 1), the rocket's midpoint Newton steps, launched 32-1,024
  systems wide, the narrow kernel is the shuffle kernel instead
  (``BATCHED_SOLVE_SHFL_SHAPES``): a 16-lane tile a system, two a warp,
  four a 64-thread block. Lane c loads column c of A (lane 12 the
  right-hand side) straight from its strides into registers, with no
  staging through shared memory, and the Householder steps and the back
  substitution run on every lane from shuffled rows, with no barrier
  (``csrc/qr_shfl.cuh``, the Newton step of K1's warp kernel on the
  rocket's projection too). There one thread a system fills a few SMs
  with one long chain each, and the tile's staging and its barrier a
  step lost to it at every width (PERF.md section 6).
* Wider launches at up to 16 unknowns, and every (10, 8) and (10, 1)
  launch, run
  the per-thread kernel (128 threads a block, the factorisation
  unrolled into registers, the per-thread QR of the fused IP kernels,
  ``csrc/qr.cuh``). On the sweep's row-interleaved Jacobians the warp's
  threads read words n apart, and at 25,600 systems it takes the
  card as long as the tile kernel.
* Above 16 unknowns (planar push's 35x35 systems with 13 right-hand
  sides, the hopper's 20x20 with 1 and 13) one system would be up to
  ~57k dependent operations in one thread's local memory, so one
  64-thread block solves a system with ``qr_group.cuh``, staged through
  shared memory as the tile kernel (21 and 33 of the 64 threads own a
  column at the hopper's shapes; the rest only sync).

The tile and group kernels run the same code (``qr_solve_group``), and
the group kernel gives the rolled per-thread QR's x bit for bit at (35,
13). At n <= 16 the per-thread QR is unrolled into registers, and there
nvcc sees that the reflector's entries below the pivot are the column's
own: it rounds each of their squares once and adds it into the norms
and the pivot column's product, where the tile kernel fuses each into
an FMA. So the tile and per-thread kernels agree to rounding, not bit
for bit (PERF.md section 6).

Every kernel reads A and b at their own strides between systems and
between rows (a row's entries adjacent), so the IFT Jacobians of
``batched_jacobian``, which come interleaved row by row (strides (n,
B n, 1)), go in as they are, with no copy on every derivative sweep;
the tile kernel's staging walks such a layout along its rows, across
the block's systems, so its loads still coalesce.

The wrapper picks by ``_build.batched_solve_route(n, k, B)``; it counts
every launch in ``batched_solve.launches``, the narrow kernel's (tile or
shuffle) in ``batched_solve.tile_launches`` too, each launch by (kernel, B) in
``batched_solve.widths``, by (n, k) in ``batched_solve.shapes`` and by
(n, k, kernel, B) in ``batched_solve.shape_widths``.

The wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from collections import Counter

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    BATCHED_SOLVE_SHAPES,
    SUFFIX,
    batched_solve_route,
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


def _rows_adjacent(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its rows' entries are adjacent, else a
    contiguous copy: the kernels take any strides between systems and
    between rows."""
    return t if t.stride(2) == 1 or t.shape[2] == 1 else t.contiguous()


def batched_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (B, n, n), b (B, n, k) -> x (B, n, k).

    CPU tensors take ``batched_solve_plain``; CUDA tensors launch the K2
    kernel that ``batched_solve_route`` picks, compiled for the (n, k) in
    ``BATCHED_SOLVE_SHAPES`` and for float32 and float64, and raise on
    anything else."""
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
    A, b = _rows_adjacent(A), _rows_adjacent(b)
    x = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if B == 0:
        return x
    route = batched_solve_route(n, k, B)
    fn = getattr(load_library(), batched_solve_symbol(n, k, A.dtype, route))
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                 A.stride(0), A.stride(1), b.stride(0), b.stride(1),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("batched_solve kernel launch failed: CUDA error "
                           "%d" % err)
    batched_solve.launches += 1
    batched_solve.tile_launches += route in ("tile", "shfl")
    batched_solve.widths[route, B] += 1
    batched_solve.shapes[n, k] += 1
    batched_solve.shape_widths[n, k, route, B] += 1
    return x


batched_solve.launches = 0
batched_solve.tile_launches = 0
batched_solve.widths = Counter()
batched_solve.shapes = Counter()
batched_solve.shape_widths = Counter()
