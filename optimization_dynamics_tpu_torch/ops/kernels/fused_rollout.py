"""K4: a whole closed-loop rollout, fused in one kernel.

Replaces the Pallas kernel of ``optimization_dynamics_tpu/ops/pallas/
fused_rollout.py``: ``make_fused_rollout`` (``:60``; the
``pl.pallas_call`` at ``:177``) running ``step_bl`` (``:91``) for each of
the T-1 steps. On the main path it is every rollout of the deploy solve
when the problem carries ``rollout_fused``: the open-loop rollout that
starts a solve (B lanes) and each line-search rung's closed-loop rollout
(B x alphas lanes: 1,024 for the first rung at B=512), T-1 = 50 steps.

Per scenario and step: ``u = u_ref + alpha k + K (x - x_ref)`` on the
active controls of ``u_mask`` (``u_ref`` elsewhere: the same value as
folding the mask into K and k, as the Pallas kernel does at
``:150-153``), the model's ``pack_theta`` and cold ``init_z(q1)``, the IP
solve of K1 (the very device function K1 runs, so the two cannot drift),
then ``x = [q1; z[q_sel]]``. Each step's solution ``z`` goes to ``wss``
for the derivative sweep's warm start, as the deploy policy's cold line
search hands it on.

What bounds it on an H100: latency, as K1. A scenario reads its gains
and references (11 values a step) and writes 15, then runs T-1 = 50
data-dependent Newton loops in sequence; the bytes are nothing beside
the arithmetic, and a batch of 1,024 scenarios at a thread each fills 32
warps on 32 of the 132 SMs, each thread running 50 serial solves. Two
kernels (``csrc/fused_rollout.cu``), picked by the launch's width (K4's
entry of ``FUSED_IP_TILE_MAX_B``, measured as K1's is):

* Up to the cut, every launch of the deploy (B, B x alphas and the
  narrower widths after compaction): one tile a scenario, 16 threads for
  cartpole, four tiles a 64-thread block. Every thread of the tile holds
  x, alpha and the step's u, computed in the same order, so the tile
  branches together; each step's solve is ``ip_solve_tile``
  (``csrc/ip_tile.cuh``), K1's tile solve: a Jacobian column a thread, a
  column-per-thread QR, the line search's candidates at once. The
  stores are spread over the tile's threads.
* Above it (no deploy width): one thread a scenario in 32-thread blocks,
  each step's solve ``ip_solve_lane`` (``csrc/ip_body.cuh``), K1's
  per-thread solve. Once the tiles fill the card (16,384 scenarios) it is
  the faster, with fewer instructions a scenario (PERF.md section 6).

``fused_rollout.widths`` counts the launches by (kernel, B). One launch
replaces a rollout's 50 K1 launches and their ~20 small glue ops per
step.

``fused_rollout_plain`` is the plain PyTorch version: a loop over steps
through K1's plain version (``make_fused_ip_plain``). The wrapper takes
it for CPU tensors only; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import numpy as np
import torch

from optimization_dynamics_tpu_torch.ops.kernels._build import (
    FUSED_IP_FUNCTORS,
    FUSED_IP_TILE_MAX_B,
    FUSED_ROLLOUT_FUNCTORS,
    SUFFIX,
    fused_rollout_symbol,
    fused_rollout_tile_symbol,
    load_library,
)
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    _ip_params,
    make_fused_ip_plain,
)
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions

__all__ = ["make_fused_rollout", "make_fused_rollout_plain",
           "fused_rollout", "fused_rollout_plain"]


def fused_rollout_plain(x0s, xss_ref, uss_ref, Kss, kss, alphas, u_mask,
                        model, aux, ip_solve):
    """K4's plain version: the rollout step by step, each IP solve through
    ``ip_solve(z0s, thetas) -> IPSolution`` from a cold ``init_z``.
    Returns ``(xss (B, T, nx), uss (B, T-1, nu), wss (B, T-1, nz),
    stats (B, T-1, 4))``; stats per step: iterations, converged (1/0),
    equality-row and bilinear-row violation."""
    nq, nx = model.nq, 2 * model.nq
    q_sel = list(model.q_sel)
    x = x0s
    xs, us, ws, st = [x0s], [], [], []
    for t in range(uss_ref.shape[1]):
        dx = x - xss_ref[:, t]
        acc = alphas[:, None] * kss[:, t]
        for j in range(nx):
            acc = acc + Kss[:, t, :, j] * dx[:, j:j + 1]
        u = torch.where(u_mask[t] != 0, uss_ref[:, t] + acc, uss_ref[:, t])
        q1 = x[:, nq:]
        sol = ip_solve(model.init_z(q1), model.theta_fn(x[:, :nq], q1, u,
                                                        aux))
        x = torch.cat([q1, sol.z[:, q_sel]], dim=1)
        xs.append(x)
        us.append(u)
        ws.append(sol.z)
        st.append(torch.stack([sol.iterations.to(x.dtype),
                               sol.converged.to(x.dtype), sol.r_vio,
                               sol.kappa_vio], dim=1))
    return (torch.stack(xs, dim=1), torch.stack(us, dim=1),
            torch.stack(ws, dim=1), torch.stack(st, dim=1))


def fused_rollout(x0s, xss_ref, uss_ref, Kss, kss, alphas, u_mask,
                  kernel: str, model_params: np.ndarray,
                  ip_params: np.ndarray, aux_vals: np.ndarray,
                  plain: Callable, return_stats: bool = False):
    """The K4 wrapper; ``u_mask`` (T-1, nu), nonzero = active. CPU tensors
    run ``plain`` (``fused_rollout_plain`` bound to the model); CUDA
    tensors launch a kernel of the device functor ``kernel`` (float32 or
    float64) and raise on anything else: the tile kernel up to
    ``FUSED_IP_TILE_MAX_B["fused_rollout", kernel]`` scenarios (counted in
    ``fused_rollout.tile_launches`` too), else the per-thread kernel.
    ``fused_rollout.widths`` counts the launches by (kernel, B), kernel
    ``"tile"`` or ``"thread"``. Returns ``(xss, uss, wss)`` and, with
    ``return_stats``, each step's solve stats (B, T-1, 4)."""
    ins = (x0s, xss_ref, uss_ref, Kss, kss, alphas)
    if all(a.device.type == "cpu" for a in ins + (u_mask,)):
        out = plain(*ins, u_mask)
        return out if return_stats else out[:3]
    dev = x0s.device
    if dev.type != "cuda" or any(a.device != dev for a in ins + (u_mask,)):
        raise ValueError("fused_rollout: every input must lie on one CUDA "
                         "device (got %s)"
                         % sorted({str(a.device) for a in ins}))
    dtype = x0s.dtype
    if dtype not in SUFFIX or any(a.dtype != dtype for a in ins):
        raise TypeError("fused_rollout: float32 or float64 inputs of one "
                        "dtype (got %s)" % sorted({str(a.dtype) for a in ins}))
    if kernel not in FUSED_ROLLOUT_FUNCTORS:
        raise ValueError("fused_rollout: no CUDA functor %r (compiled: %s)"
                         % (kernel, sorted(FUSED_ROLLOUT_FUNCTORS)))
    nq, nu = FUSED_ROLLOUT_FUNCTORS[kernel]
    nz, nth = FUSED_IP_FUNCTORS[kernel]
    nx = 2 * nq
    if aux_vals.shape != (nth - 2 * nq - nu,):
        raise ValueError("fused_rollout: %s takes %d theta values after "
                         "[q0, q1, u], got %s" % (kernel, nth - 2 * nq - nu,
                                                  aux_vals.shape))
    B, Tm1 = uss_ref.shape[:2]
    want = [(B, nx), (B, Tm1 + 1, nx), (B, Tm1, nu), (B, Tm1, nu, nx),
            (B, Tm1, nu), (B,)]
    got = [tuple(a.shape) for a in ins]
    if got != want or tuple(u_mask.shape) != (Tm1, nu):
        raise ValueError("fused_rollout: shapes %s, u_mask %s; want %s, "
                         "(%d, %d)" % (got, tuple(u_mask.shape), want, Tm1,
                                       nu))
    if B * Tm1 * nz >= 2 ** 31:
        raise ValueError("fused_rollout: batch too large for int32")
    ins = [a.contiguous() for a in ins]
    mask = u_mask.to(dtype).contiguous()      # no copy when already so
    xss = torch.empty((B, Tm1 + 1, nx), dtype=dtype, device=dev)
    uss = torch.empty((B, Tm1, nu), dtype=dtype, device=dev)
    wss = torch.empty((B, Tm1, nz), dtype=dtype, device=dev)
    stats = (torch.empty((B, Tm1, 4), dtype=dtype, device=dev)
             if return_stats else None)
    if B > 0:
        tile = B <= FUSED_IP_TILE_MAX_B.get(("fused_rollout", kernel), 0)
        symbol = fused_rollout_tile_symbol if tile else fused_rollout_symbol
        fn = getattr(load_library(), symbol(kernel, dtype))
        with torch.cuda.device(dev):
            err = fn(*(a.data_ptr() for a in ins), mask.data_ptr(),
                     xss.data_ptr(), uss.data_ptr(), wss.data_ptr(),
                     None if stats is None else stats.data_ptr(), B, Tm1,
                     model_params.ctypes.data, ip_params.ctypes.data,
                     aux_vals.ctypes.data,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("fused_rollout kernel launch failed: CUDA "
                               "error %d" % err)
        fused_rollout.launches += 1
        fused_rollout.tile_launches += tile
        fused_rollout.widths["tile" if tile else "thread", B] += 1
    return (xss, uss, wss, stats) if return_stats else (xss, uss, wss)


fused_rollout.launches = 0
fused_rollout.tile_launches = 0
fused_rollout.widths = Counter()


def _theta_tail(model, aux, device, dtype) -> np.ndarray:
    """The theta entries after ``[q0, q1, u]`` (the functor's ``aux``),
    from ``theta_fn`` itself, rounded to ``dtype`` as the plain path
    rounds them."""
    nq, nu = model.nq, model.nu
    if (tuple(model.th_q0) != tuple(range(nq))
            or tuple(model.th_q1) != tuple(range(nq, 2 * nq))
            or tuple(model.th_u) != tuple(range(2 * nq, 2 * nq + nu))):
        raise ValueError("fused rollout: theta must start [q0, q1, u]")
    z = lambda n: torch.zeros((1, n), dtype=dtype, device=device)
    th = model.theta_fn(z(nq), z(nq), z(nu), aux)
    return th[0, 2 * nq + nu:].to(torch.float64).cpu().numpy()


def _mask(u_mask, T: int, nu: int, device, dtype) -> torch.Tensor:
    if u_mask is None:
        return torch.ones((T - 1, nu), dtype=dtype, device=device)
    mask = torch.as_tensor(u_mask, device=device).to(dtype)
    if tuple(mask.shape) != (T - 1, nu):
        raise ValueError("fused rollout: u_mask %s, want (%d, %d)"
                         % (tuple(mask.shape), T - 1, nu))
    return mask


def make_fused_rollout_plain(model, opts: IPOptions, aux, T: int, u_mask,
                             device, dtype) -> Callable:
    """``rollout(x0s, xss_ref, uss_ref, Kss, kss, alphas) -> (xss, uss,
    wss, stats)`` through ``fused_rollout_plain`` on any device."""
    ip_solve = make_fused_ip_plain(model, opts, device, dtype)
    mask = _mask(u_mask, T, model.nu, device, dtype)

    def rollout(x0s, xss_ref, uss_ref, Kss, kss, alphas, u_mask=mask):
        return fused_rollout_plain(x0s, xss_ref, uss_ref, Kss, kss, alphas,
                                   u_mask, model, aux, ip_solve)

    return rollout


def make_fused_rollout(model, opts: IPOptions, aux, T: int, u_mask,
                       device, dtype) -> Callable:
    """Build ``rollout(x0s (B, nx), xss_ref (B, T, nx), uss_ref (B, T-1,
    nu), Kss (B, T-1, nu, nx), kss (B, T-1, nu), alphas (B,),
    return_stats=False) -> (xss (B, T, nx), uss (B, T-1, nu), wss (B,
    T-1, nz))``: the drop-in for ``closed_loop``'s rollout with cold
    per-step starts (``init_z(q1)``, the deploy ``ws_linesearch=False``
    policy). ``model`` is an ``ImplicitModel`` whose ``kernel`` names its
    device functor; ``opts`` are the eval IP options; ``u_mask`` (T-1, nu)
    bool or None (every control active)."""
    plain = make_fused_rollout_plain(model, opts, aux, T, u_mask, device,
                                     dtype)
    mask = _mask(u_mask, T, model.nu, device, dtype)
    model_params = np.asarray(model.kernel_params, np.float64)
    ip_params = _ip_params(opts)
    aux_vals = _theta_tail(model, aux, device, dtype)

    def rollout(x0s, xss_ref, uss_ref, Kss, kss, alphas,
                return_stats: bool = False):
        return fused_rollout(x0s, xss_ref, uss_ref, Kss, kss, alphas, mask,
                             model.kernel, model_params, ip_params,
                             aux_vals, plain, return_stats)

    return rollout
