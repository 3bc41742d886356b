"""Scenario parallelism over the visible devices and across processes.

Port of ``optimization_dynamics_tpu/parallel/mesh.py``. The mesh is a list
of ``torch.device``: the visible CUDA devices by default, or a list the
caller passes (``[torch.device("cpu")] * 8`` runs the split and merge on
one host with eight shards). The scenario axis is the leading dimension
of every tensor; ``shard_scenarios`` splits it across the mesh and
``sharded_map`` runs a lane-batched function on each device's chunk.
The scenario axis is embarrassingly parallel: no device talks to another
inside the map, and the results meet on the first device.

Across processes (the reference's ``jax.distributed.initialize()``, after
which its mesh spans hosts): call ``initialize(address, n, rank)`` in
each of n processes first, each with the whole batch. The mesh then
spans the processes, each process's devices in rank order;
``shard_scenarios`` gives this process the contiguous rows its entries
own, as the reference's ``PartitionSpec("scenario")`` lays them out;
``sharded_map`` runs this process's chunks and gathers every process's
results, so each holds the whole batch, as the reference's worker's
``out_shardings=None`` replicates it; ``convergence_summary`` then gives
the same statistics on every process. The processes talk over
``torch.distributed``'s gloo backend, the one backend here (two NCCL
ranks cannot share one card, and gloo gathers CPU tensors only): the
gather copies each process's results to the host, gathers them and
moves the whole batch to this process's first device. The solves stay
on the devices. Without ``initialize`` every function runs in this
process alone.

The reduction helpers (``convergence_summary``, ``quarantine``,
``merge_retry``) turn per-scenario flags into fleet statistics and merge
a retry pass; they return what the reference's return on the same
inputs.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["scenario_mesh", "shard_scenarios", "sharded_map",
           "device_count", "convergence_summary", "quarantine",
           "merge_retry", "initialize", "process_count", "process_index",
           "shutdown", "Mesh"]

# under ``initialize``: "names", each process's mesh entries, by rank
_GROUP = {}


def device_count() -> int:
    """The visible CUDA devices."""
    return torch.cuda.device_count()


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(device_count())]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, devices: Optional[Iterable] = None) -> None:
    """Join a group of ``num_processes`` processes as rank ``process_id``
    (the reference's ``jax.distributed.initialize``): gloo over TCP at
    ``coordinator_address`` (``host:port``, rank 0 listens there).
    ``devices`` are this process's mesh entries (anything
    ``torch.device`` takes, e.g. ``["cpu"] * 4``); by default the visible
    CUDA devices, so on a one-card machine every rank uses ``cuda:0``."""
    import torch.distributed as dist

    local = (_cuda_devices() if devices is None
             else [torch.device(d) for d in devices])
    local = [torch.device("cuda", torch.cuda.current_device())
             if d.type == "cuda" and d.index is None else d for d in local]
    if not local:
        raise RuntimeError("initialize: no CUDA device; pass devices, "
                           "e.g. [torch.device('cpu')]")
    dist.init_process_group("gloo", init_method="tcp://" + coordinator_address,
                            rank=process_id, world_size=num_processes)
    names = [None] * num_processes
    dist.all_gather_object(names, [str(d) for d in local])
    _GROUP["names"] = names


def _grouped() -> bool:
    import torch.distributed as dist

    return bool(_GROUP) and dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes of the group, 1 without ``initialize``."""
    import torch.distributed as dist

    return dist.get_world_size() if _grouped() else 1


def process_index() -> int:
    """This process's rank, 0 without ``initialize``."""
    import torch.distributed as dist

    return dist.get_rank() if _grouped() else 0


def shutdown() -> None:
    """Leave the group (after which the mesh is this process's again)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP.clear()


class Mesh(list):
    """The scenario mesh: a list of ``torch.device`` in scenario order,
    and ``ranks[i]``, the process that owns entry i (entry i's device as
    that process names it). Without a group every entry is this
    process's."""

    def __init__(self, devices, ranks=None):
        super().__init__(devices)
        self.ranks = [0] * len(self) if ranks is None else list(ranks)

    def mine(self) -> List[int]:
        """The indices of this process's entries."""
        me = process_index()
        return [i for i, r in enumerate(self.ranks) if r == me]


def scenario_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Iterable] = None) -> Mesh:
    """1-D mesh over the scenario axis: ``devices`` (anything
    ``torch.device`` takes), else the first ``n_devices`` visible CUDA
    devices (all by default). Under ``initialize`` it spans the
    processes: each process's devices (``initialize``'s), in rank order,
    the first ``n_devices`` of them; ``devices`` is not taken there."""
    if _grouped():
        if devices is not None:
            raise ValueError("scenario_mesh: under initialize the mesh is "
                             "every process's initialize devices")
        entries = [(torch.device(d), r) for r, names in
                   enumerate(_GROUP["names"]) for d in names]
        entries = entries[:n_devices]
        return Mesh([d for d, _ in entries], [r for _, r in entries])
    if devices is None:
        devices = _cuda_devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = Mesh(torch.device(d) for d in devices)
    if not mesh:
        raise RuntimeError("scenario_mesh: no CUDA device; pass devices, "
                           "e.g. [torch.device('cpu')]")
    return mesh


def _owned(mesh) -> List[int]:
    return mesh.mine() if isinstance(mesh, Mesh) else list(range(len(mesh)))


def shard_scenarios(mesh: List[torch.device], batch) -> list:
    """Split every tensor of ``batch`` (a tree of tensors with a leading
    scenario axis) into ``len(mesh)`` contiguous chunks, chunk i on
    ``mesh[i]``. Returns one tree for each of this process's entries (all
    of them without a group). The reference requires the axis to divide
    by the mesh size; here the first chunks take one scenario more where
    it does not (``torch.tensor_split``). Leaves that are not tensors go
    to every chunk unchanged."""
    n = len(mesh)

    def chunk(i, dev):
        return pytree.tree_map(
            lambda a: (torch.tensor_split(a, n)[i].to(dev)
                       if isinstance(a, torch.Tensor) else a), batch)

    return [chunk(i, mesh[i]) for i in _owned(mesh)]


def _concat(chunks, device):
    """Chunks' trees joined along the leading axis on ``device``; leaves
    that are not tensors (``None`` fields) are taken from the first."""
    return pytree.tree_map(
        lambda *ts: (torch.cat([t.to(device) for t in ts])
                     if isinstance(ts[0], torch.Tensor) else ts[0]),
        *chunks)


def _rows(B: int, n: int) -> List[int]:
    """The chunk lengths ``torch.tensor_split`` gives B rows in n."""
    return [B // n + (i < B % n) for i in range(n)]


def _all_gather_rows(local, mesh, B: int, device):
    """Every process's rows of ``local`` (this process's chunks' results,
    joined), through the host, joined in rank order on ``device``."""
    import torch.distributed as dist

    sizes = _rows(B, len(mesh))
    per_rank = [0] * process_count()
    for i, r in enumerate(mesh.ranks):
        per_rank[r] += sizes[i]
    width = max(per_rank)

    def gather(t):
        if not isinstance(t, torch.Tensor):
            return t
        host = t.detach().cpu()
        as_u8 = host.dtype == torch.bool
        if as_u8:
            host = host.to(torch.uint8)
        pad = host.new_zeros((width,) + tuple(host.shape[1:]))
        pad[:host.shape[0]] = host
        parts = [torch.empty_like(pad) for _ in per_rank]
        dist.all_gather(parts, pad)
        out = torch.cat([p[:k] for p, k in zip(parts, per_rank)])
        return (out.bool() if as_u8 else out).to(device)

    return pytree.tree_map(gather, local)


def sharded_map(fn: Callable, mesh: List[torch.device]) -> Callable:
    """``run(*args)``: ``fn`` on each device's chunk of ``args`` (trees of
    tensors with a leading scenario axis), the results concatenated on
    ``mesh[0]``. Under ``initialize`` this process runs its own entries'
    chunks, and every process gets the whole batch, gathered, on its
    first entry's device.

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
        mine = _owned(mesh)
        if not mine:
            raise ValueError("sharded_map: this process owns no mesh entry")
        out = _concat([fn(*a) for a in chunks], mesh[mine[0]])
        if not _grouped():
            return out
        B = next(a.shape[0] for a in pytree.tree_leaves(args)
                 if isinstance(a, torch.Tensor))
        return _all_gather_rows(out, mesh, B, mesh[mine[0]])

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
