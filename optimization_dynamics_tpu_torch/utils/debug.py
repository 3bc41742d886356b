"""Debug checks: a NaN guard and per-lane finiteness.

Port of ``optimization_dynamics_tpu/utils/debug.py``:

* ``nan_guard()``: a context manager under which the first operator that
  produces a NaN raises, naming the operator (the reference turns on
  ``jax_debug_nans``);
* ``check_finite(tree)``: per-lane finiteness flags over a batched
  result (lane-batched solvers keep NaNs lane-local; this shows which
  lanes went bad);
* ``assert_finite(tree)``: raise, naming the fields that hold a
  non-finite value.
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["nan_guard", "check_finite", "assert_finite"]

# outputs whose memory is uninitialised: a NaN there is not a result
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


class _NanGuard(TorchDispatchMode):
    """Checks every floating output of every aten operator for NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        if any(isinstance(t, torch.Tensor) and t.is_floating_point()
               and bool(torch.isnan(t).any())
               for t in pytree.tree_leaves(out)):
            raise FloatingPointError("NaN produced by %s" % func)
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Raise ``FloatingPointError`` at the first aten operator whose
    floating output holds a NaN, within the block; outside it nothing is
    checked, and on exit the modes active before are restored.

    Typical use: re-run a failing CPU repro under the guard to get the
    first NaN's operator instead of a poisoned result. Like
    ``jax_debug_nans`` it reads every output back to the host, a sync an
    operator, so it is a repro tool and not for the card's hot path. It
    also raises on NaNs that a later ``torch.where`` would mask (the
    solvers make such NaNs on purpose, e.g. a failed Cholesky's gains)."""
    if not enable:
        yield
        return
    with _NanGuard():
        yield


def check_finite(tree, batch_axis: int = 0) -> torch.Tensor:
    """Per-lane all-finite flags over a batched tree.

    Every floating tensor with the leading batch axis contributes its
    lane's elements; scalars and tensors of another leading size are
    reduced over all their elements into every lane; integer and boolean
    fields are ignored. Returns a bool tensor of the common leading size
    (the largest), on the first floating field's device."""
    del batch_axis
    leaves = [l for l in pytree.tree_leaves(tree)
              if isinstance(l, torch.Tensor) and l.is_floating_point()]
    if not leaves:
        raise ValueError("no floating-point leaves to check")
    dev = leaves[0].device
    B = max(l.shape[0] for l in leaves if l.ndim > 0)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    for l in leaves:
        l = l.to(dev)
        if l.ndim > 0 and l.shape[0] == B:
            ok = ok & torch.isfinite(l.reshape(B, -1)).all(dim=1)
        else:
            ok = ok & torch.isfinite(l).all()
    return ok


def assert_finite(tree, names=None) -> None:
    """Raise ``FloatingPointError`` naming the non-finite fields (as
    ``jax.tree_util.keystr`` writes their paths: ``['xs']``, ``.us``;
    sorted, as JAX orders a dict's keys)."""
    del names
    bad = sorted(pytree.keystr(path)
                 for path, l in pytree.tree_flatten_with_path(tree)[0]
                 if isinstance(l, torch.Tensor) and l.is_floating_point()
                 and not bool(torch.isfinite(l).all()))
    if bad:
        raise FloatingPointError("non-finite values in: " + ", ".join(bad))
