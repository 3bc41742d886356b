"""K3: the whole iLQR Riccati backward pass, fused in one kernel.

Replaces the Pallas kernel of ``optimization_dynamics_tpu/ops/pallas/
riccati.py``: ``make_riccati_backward`` (``:166``; the ``pl.pallas_call``
at ``:262``) running ``_make_body`` (``:93``) with the Cholesky solve
``_chol_solve_block`` (``:45``). On the main path it is the backward pass
of every inner iteration when ``ILQROptions.riccati_kernel`` is set: B
lanes (each lane of the phase width), T-1 = 50 steps, nx=4, nu=1 at the
deploy width.

What bounds it on an H100: latency. At the deploy shape a lane reads
about 10 KB (fx, fu and the cost expansion of 50 steps) and does about
10 kflop, so the bytes would take microseconds at 3.35 TB/s, but the
recursion is sequential in time: a launch lasts as long as 50 steps of
one scenario's dependent chain, loads included. Two kernels, picked by
``_build.riccati_route(nx, nu, B)``:

* Up to the shape's cut in ``RICCATI_TILE_MAX_B`` scenarios, a tile of
  threads a scenario (an element of the nx x nx updates a thread, up to
  a warp: 16 at the deploy's nx=4, 32 at nx=6 and 10), 64-thread
  blocks. The scenario's Vx and Vxx, the step's inputs and its
  intermediates sit in the tile's slab of shared memory; each step is
  three stages with a tile sync after each: VF = Vxx fx, Vxx fu (an
  element a thread), Qx and Qu; then Qxx (an element a thread), Quu and
  its Cholesky on every thread alike (nu <= 4), and the gains a column a
  thread; then the symmetrised Vxx (an element a thread). The next step's inputs are loaded into registers while the
  step computes (neighbouring threads, neighbouring words) and stored to
  the slab at its end, so the loads leave the dependent chain. One
  thread a scenario, the alternative, puts 512 scenarios on 16 warps of
  16 SMs, each thread waiting out its own uncoalesced loads and the
  whole step's chain.
* Wider launches run that per-thread kernel (32 threads a block, Vx and
  Vxx in registers; NX and NU are template parameters, so every
  contraction and the Cholesky unroll).

Either replaces the 50-step eager loop of ``backward_xla`` and its ~25
small kernels per step with one launch, and both compute every value by
the same expression in the same order, so they agree bit for bit.

Semantics are the Pallas kernel's, not ``backward_xla``'s: ``ok`` is
"every Cholesky pivot d > 0", pivots are ``sqrt(max(d, 1e-30))``, and
the substitutions divide by a diagonal guarded at 1e-30, so a lane that
is not positive definite gets finite gains (``backward_xla`` gives it
NaN) and ``ok = False``. ``u_mask`` is a (T-1, nu) device array, not a
constant of the build.

``riccati_backward_plain`` is the plain PyTorch version of the same
recursion (the Pallas body's broadcast-multiply-reduce contractions and
an unrolled Cholesky that follows ``_chol_solve_block``). The wrapper
takes it for CPU tensors only; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    RICCATI_SHAPES,
    SUFFIX,
    load_library,
    riccati_route,
    riccati_symbol,
)

__all__ = ["make_riccati_backward", "riccati_backward",
           "riccati_backward_plain"]


def _chol_solve(A: torch.Tensor, b: torch.Tensor):
    """Unrolled Cholesky solve, ``_chol_solve_block`` batch first:
    A (B, n, n), b (B, n, k) -> (x (B, n, k), ok (B,) every pivot > 0)."""
    n = A.shape[1]
    L = [[None] * n for _ in range(n)]        # L[r][c], r >= c
    ok = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
    for j in range(n):
        col = [A[:, r, j] for r in range(j, n)]
        if j > 0:
            col = [col[r - j] - sum(L[r][c] * L[j][c] for c in range(j))
                   for r in range(j, n)]
        d = col[0]
        ok = ok & (d > 0.0)
        sq = torch.sqrt(torch.clamp_min(d, 1e-30))
        L[j][j] = sq
        for r in range(j + 1, n):
            L[r][j] = col[r - j] / sq
    safe = [torch.where(L[i][i] > 1e-30, L[i][i], 1.0)[:, None]
            for i in range(n)]
    y = [None] * n
    for i in range(n):
        acc = b[:, i]
        if i > 0:
            acc = acc - sum(L[i][r][:, None] * y[r] for r in range(i))
        y[i] = acc / safe[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[i]
        if i + 1 < n:
            acc = acc - sum(L[r][i][:, None] * x[r] for r in range(i + 1, n))
        x[i] = acc / safe[i]
    return torch.stack(x, dim=1), ok


def riccati_backward_plain(fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs,
                           regs, u_mask):
    """K3's plain version: the Pallas body's recursion on batch-first
    tensors. ``u_mask`` (T-1, nu), nonzero = active. Returns ``(Ks (B,
    T-1, nu, nx), ks (B, T-1, nu), dV1, dV2, qu_inf, ok)``."""
    Tm1 = fxs.shape[1]
    B, nu = lus.shape[0], lus.shape[2]
    dtype, device = lxs.dtype, lxs.device
    Vx, Vxx = gTs, HTs
    dV1 = torch.zeros(B, dtype=dtype, device=device)
    dV2 = torch.zeros_like(dV1)
    qu_inf = torch.zeros_like(dV1)
    ok_all = torch.ones(B, dtype=torch.bool, device=device)
    Ks, ks = [None] * Tm1, [None] * Tm1
    for t in range(Tm1 - 1, -1, -1):
        fx, fu = fxs[:, t], fus[:, t]
        # contractions as broadcast-multiply-reduce, as the Pallas body
        Qx = lxs[:, t] + torch.sum(fx * Vx[:, :, None], dim=1)
        Qu = lus[:, t] + torch.sum(fu * Vx[:, :, None], dim=1)
        VF = torch.sum(Vxx[:, :, :, None] * fx[:, None], dim=2)
        Qxx = lxxs[:, t] + torch.sum(fx[:, :, :, None] * VF[:, :, None],
                                     dim=1)
        VFu = torch.sum(Vxx[:, :, :, None] * fu[:, None], dim=2)
        Quu = luus[:, t] + torch.sum(fu[:, :, :, None] * VFu[:, :, None],
                                     dim=1)
        Qux = luxs[:, t] + torch.sum(fu[:, :, :, None] * VF[:, :, None],
                                     dim=1)

        m = u_mask[t] != 0
        Qu = torch.where(m[None], Qu, 0.0)
        Qux = torch.where(m[None, :, None], Qux, 0.0)
        Quu = (torch.where((m[:, None] & m[None, :])[None], Quu, 0.0)
               + torch.diag_embed(torch.where(m[None], regs[:, None], 1.0)))

        sol, ok = _chol_solve(Quu, torch.cat([Qu[..., None], Qux], dim=2))
        k = -sol[:, :, 0]
        K = -sol[:, :, 1:]

        Quu_k = torch.sum(Quu * k[:, None], dim=2)
        Vx = (Qx + torch.sum(K * Qu[:, :, None], dim=1)
              + torch.sum(Qux * k[:, :, None], dim=1)
              + torch.sum(K * Quu_k[:, :, None], dim=1))
        KQ = torch.sum(K[:, :, :, None] * Qux[:, :, None], dim=1)
        QK = torch.sum(Quu[:, :, :, None] * K[:, None], dim=2)
        KWK = torch.sum(K[:, :, :, None] * QK[:, :, None], dim=1)
        Vxx = Qxx + KQ + KQ.transpose(1, 2) + KWK
        Vxx = 0.5 * (Vxx + Vxx.transpose(1, 2))

        dV1 = dV1 + torch.sum(k * Qu, dim=1)
        dV2 = dV2 + 0.5 * torch.sum(k * Quu_k, dim=1)
        qu_inf = torch.maximum(qu_inf, torch.amax(torch.abs(Qu), dim=1))
        ok_all = ok_all & ok
        Ks[t], ks[t] = K, k
    return (torch.stack(Ks, dim=1), torch.stack(ks, dim=1), dV1, dV2,
            qu_inf, ok_all)


def riccati_backward(fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs,
                     u_mask):
    """The K3 wrapper; ``u_mask`` (T-1, nu), nonzero = active. CPU tensors
    run ``riccati_backward_plain``; CUDA tensors launch the kernel that
    ``riccati_route`` picks, compiled for their (nx, nu) in
    ``RICCATI_SHAPES`` (float32 or float64), and raise on anything else.
    Launches are counted in ``riccati_backward.launches``, the tile
    kernel's in ``.tile_launches`` too, and by (kernel, B) in
    ``.widths``."""
    ins = (fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs)
    if all(a.device.type == "cpu" for a in ins + (u_mask,)):
        return riccati_backward_plain(*ins, u_mask)
    dev = fxs.device
    if dev.type != "cuda" or any(a.device != dev for a in ins + (u_mask,)):
        raise ValueError("riccati_backward: every input must lie on one "
                         "CUDA device (got %s)"
                         % sorted({str(a.device) for a in ins}))
    dtype = fxs.dtype
    if dtype not in SUFFIX or any(a.dtype != dtype for a in ins):
        raise TypeError("riccati_backward: float32 or float64 inputs of one "
                        "dtype (got %s)" % sorted({str(a.dtype) for a in ins}))
    B, Tm1, nx, nu = fus.shape
    want = [(B, Tm1, nx, nx), (B, Tm1, nx, nu), (B, Tm1, nx), (B, Tm1, nu),
            (B, Tm1, nx, nx), (B, Tm1, nu, nu), (B, Tm1, nu, nx), (B, nx),
            (B, nx, nx), (B,)]
    got = [tuple(a.shape) for a in ins]
    if got != want or tuple(u_mask.shape) != (Tm1, nu):
        raise ValueError("riccati_backward: shapes %s, u_mask %s; want %s, "
                         "(%d, %d)" % (got, tuple(u_mask.shape), want, Tm1,
                                       nu))
    if (nx, nu) not in RICCATI_SHAPES:
        raise ValueError("riccati_backward: no CUDA kernel for nx=%d, nu=%d "
                         "(compiled: %s)" % (nx, nu, sorted(RICCATI_SHAPES)))
    if B * Tm1 * nx * nx >= 2 ** 31:
        raise ValueError("riccati_backward: batch too large for int32")
    ins = [a.contiguous() for a in ins]
    mask = u_mask.to(dtype).contiguous()      # no copy when already so
    Ks = torch.empty((B, Tm1, nu, nx), dtype=dtype, device=dev)
    ks = torch.empty((B, Tm1, nu), dtype=dtype, device=dev)
    stats = torch.empty((B, 4), dtype=dtype, device=dev)
    if B > 0 and Tm1 > 0:
        route = riccati_route(nx, nu, B)
        fn = getattr(load_library(), riccati_symbol(nx, nu, dtype, route))
        with torch.cuda.device(dev):
            err = fn(*(a.data_ptr() for a in ins), mask.data_ptr(),
                     Ks.data_ptr(), ks.data_ptr(), stats.data_ptr(), B, Tm1,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("riccati kernel launch failed: CUDA error "
                               "%d" % err)
        riccati_backward.launches += 1
        riccati_backward.tile_launches += route == "tile"
        riccati_backward.widths[route, B] += 1
    return Ks, ks, stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3] > 0.5


riccati_backward.launches = 0
riccati_backward.tile_launches = 0
riccati_backward.widths = Counter()


def make_riccati_backward(T: int, nx: int, nu: int, u_mask, device,
                          dtype) -> Callable:
    """Build ``backward(fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs,
    regs) -> (Ks, ks, dV1, dV2, qu_inf, ok)``, the drop-in for
    ``ilqr_batched``'s ``backward_xla`` (same batch-first shapes) on
    ``dtype`` tensors. ``u_mask``: (T-1, nu) active control dims per
    stage (bool), kept on ``device`` as 1/0 of ``dtype``."""
    mask = torch.as_tensor(u_mask, device=device).to(dtype)
    if tuple(mask.shape) != (T - 1, nu):
        raise ValueError("make_riccati_backward: u_mask %s, want (%d, %d)"
                         % (tuple(mask.shape), T - 1, nu))

    def backward(fxs, fus, lxs, lus, lxxs, luus, luxs, gTs, HTs, regs):
        if fxs.shape[-1] != nx:
            raise ValueError("backward: built for nx=%d, got fxs %s"
                             % (nx, tuple(fxs.shape)))
        return riccati_backward(fxs, fus, lxs, lus, lxxs, luus, luxs, gTs,
                                HTs, regs, mask)

    return backward
