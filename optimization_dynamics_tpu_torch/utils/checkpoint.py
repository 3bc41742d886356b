"""Checkpoint / resume for long scenario sweeps.

Port of ``optimization_dynamics_tpu/utils/checkpoint.py``: solved batches
(and their metadata) saved as compressed ``.npz`` shards, so a preempted
sweep resumes from the last completed shard. The layout is the
reference's: the fields of a NamedTuple or dict, flattened under dotted
keys (``xs``, ``sol.z``), and ``__meta__`` as JSON bytes; a shard written
by either package loads in the other. Tensors are copied to host numpy
before saving; fields that are ``None`` are left out. ``completed_shards``
does not count the ``.tmp.npz`` of a save that was cut (the reference
counts it).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_result", "load_result", "SweepCheckpointer"]


def _flatten(tree, prefix=""):
    out = {}
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            if v is not None:
                out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip(".")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip(".")] = np.asarray(tree)
    return out


def save_result(path: str, result, meta: Dict[str, Any] | None = None):
    """Save a (possibly batched) solve result to ``.npz``."""
    arrays = _flatten(result)
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_result(path: str):
    """Load a saved result as (dict of numpy arrays, meta dict)."""
    data = dict(np.load(path))
    meta = None
    if "__meta__" in data:
        meta = json.loads(data.pop("__meta__").tobytes().decode())
    return data, meta


class SweepCheckpointer:
    """Shard-wise checkpointing for big scenario sweeps.

    >>> ck = SweepCheckpointer("runs/sweep1")
    >>> for i, batch in enumerate(batches):
    ...     if ck.done(i):
    ...         continue
    ...     res = run(batch)
    ...     ck.save(i, res, meta={"batch": i})
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, shard: int) -> str:
        return os.path.join(self.directory, f"shard_{shard:05d}.npz")

    def done(self, shard: int) -> bool:
        return os.path.exists(self._path(shard))

    def save(self, shard: int, result, meta=None):
        # np.savez appends ".npz" when missing: keep the tmp name valid;
        # the rename makes a shard appear whole or not at all
        tmp = self._path(shard)[:-4] + ".tmp.npz"
        save_result(tmp, result, meta)
        os.replace(tmp, self._path(shard))

    def load(self, shard: int):
        return load_result(self._path(shard))

    def completed_shards(self):
        return sorted(
            int(f[6:11]) for f in os.listdir(self.directory)
            if f.startswith("shard_") and f.endswith(".npz")
            and not f.endswith(".tmp.npz"))
