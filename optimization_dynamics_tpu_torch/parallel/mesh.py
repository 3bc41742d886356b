"""Scenario parallelism over the visible devices.

Port of ``optimization_dynamics_tpu/parallel/mesh.py``. The mesh is a list
of ``torch.device``: the visible CUDA devices by default, or a list the
caller passes (``[torch.device("cpu")] * 8`` runs the split and merge on
one host with eight shards). The scenario axis is the leading dimension
of every tensor; ``shard_scenarios`` splits it across the mesh and
``sharded_map`` runs a lane-batched function on each device's chunk.
The scenario axis is embarrassingly parallel: no device talks to another
inside the map, and the results meet on the first device.

The reduction helpers (``convergence_summary``, ``quarantine``,
``merge_retry``) turn per-scenario flags into fleet statistics and merge
a retry pass; they return what the reference's return on the same
inputs.

Multi-host (the reference's ``jax.distributed`` mesh) is not ported.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["scenario_mesh", "shard_scenarios", "sharded_map",
           "device_count", "convergence_summary", "quarantine",
           "merge_retry"]


def device_count() -> int:
    """The visible CUDA devices."""
    return torch.cuda.device_count()


def scenario_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Iterable] = None) -> List[torch.device]:
    """1-D mesh over the scenario axis: ``devices`` (anything
    ``torch.device`` takes), else the first ``n_devices`` visible CUDA
    devices (all by default)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise RuntimeError("scenario_mesh: no CUDA device; pass devices, "
                           "e.g. [torch.device('cpu')]")
    return mesh


def shard_scenarios(mesh: List[torch.device], batch) -> list:
    """Split every tensor of ``batch`` (a tree of tensors with a leading
    scenario axis) into ``len(mesh)`` contiguous chunks, chunk i on
    ``mesh[i]``. Returns one tree a device. The reference requires the
    axis to divide by the mesh size; here the first chunks take one
    scenario more where it does not (``torch.tensor_split``). Leaves
    that are not tensors go to every chunk unchanged."""
    n = len(mesh)

    def chunk(i, dev):
        return pytree.tree_map(
            lambda a: (torch.tensor_split(a, n)[i].to(dev)
                       if isinstance(a, torch.Tensor) else a), batch)

    return [chunk(i, d) for i, d in enumerate(mesh)]


def _concat(chunks, device):
    """Chunks' trees joined along the leading axis on ``device``; leaves
    that are not tensors (``None`` fields) are taken from the first."""
    return pytree.tree_map(
        lambda *ts: (torch.cat([t.to(device) for t in ts])
                     if isinstance(ts[0], torch.Tensor) else ts[0]),
        *chunks)


def sharded_map(fn: Callable, mesh: List[torch.device]) -> Callable:
    """``run(*args)``: ``fn`` on each device's chunk of ``args`` (trees of
    tensors with a leading scenario axis), the results concatenated on
    ``mesh[0]``.

    ``fn`` is lane-batched (for example ``dyn.step_batched``): it takes
    and returns tensors with the scenario axis first. The reference
    ``vmap``s a per-scenario function instead; the port's steps are
    batched by construction, and its scalar solver has host control flow
    that ``torch.func.vmap`` cannot batch, so a per-scenario function
    loops over its chunk itself (``examples/sweep.py``). The devices run
    one after another from one host thread; CUDA calls are asynchronous,
    so the devices overlap as far as ``fn`` does not sync."""
    def run(*args):
        chunks = shard_scenarios(mesh, args)
        return _concat([fn(*a) for a in chunks], mesh[0])

    return run


def _mean(a: np.ndarray, dtype) -> float:
    """The reference's mean: the sum in ``dtype`` times the reciprocal of
    the count in ``dtype`` (its compiler turns the division by a constant
    count into that product)."""
    dtype = np.dtype(dtype).type
    return float(dtype(a.astype(dtype).sum(dtype=dtype))
                 * (dtype(1) / dtype(a.size)))


def convergence_summary(converged, iterations=None):
    """Aggregate per-scenario solve status across a batch: solver
    failures are per-scenario flags, reduced here to fleet statistics.
    The means round as the reference's do: ``fraction_converged`` in
    float32, ``mean_iterations`` in float32 for counts of up to 32 bits."""
    conv = np.asarray(_host(converged))
    n = conv.shape[0]
    out = {
        "n_scenarios": n,
        "n_converged": int(np.sum(conv)),
        "fraction_converged": _mean(conv, np.float32),
    }
    if iterations is not None:
        its = np.asarray(_host(iterations))
        wide = its.dtype.kind == "f" or its.dtype.itemsize > 4
        out["mean_iterations"] = _mean(
            its, its.dtype if its.dtype.kind == "f"
            else np.float64 if wide else np.float32)
        out["max_iterations"] = int(np.max(its))
    failed = quarantine(conv)
    if failed:
        out["failed_indices"] = failed[:32]
    return out


def quarantine(converged):
    """Indices of failed scenarios (a host list), so a sweep can leave
    them out of its aggregates or retry them (``examples/sweep.py``)."""
    return np.nonzero(~np.asarray(_host(converged)).astype(bool))[0].tolist()


def merge_retry(res, res_retry):
    """Merge a retry pass into a batched result: lanes that failed in
    ``res`` but converged in ``res_retry`` take the retry values, in
    every field (the mask broadcast over the trailing dimensions). Both
    must share shapes and carry a boolean leading-axis ``converged``
    (an ``ILQRResult`` or a dict)."""
    conv = res["converged"] if isinstance(res, dict) else res.converged
    conv_r = (res_retry["converged"] if isinstance(res_retry, dict)
              else res_retry.converged)
    take = torch.logical_and(torch.logical_not(conv), conv_r)

    def pick(a, b):
        if a is None:
            return None
        m = take.to(a.device).reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(m, b, a)

    return pytree.tree_map(pick, res, res_retry)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
