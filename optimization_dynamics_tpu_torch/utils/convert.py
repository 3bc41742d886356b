"""Carry the JAX package's settings and solver state across to the port.

Both packages compute from identical settings when their parameters and
options come through here. The functions read plain fields (NamedTuple
or dataclass attributes) and numpy values, so this module imports
neither package's framework beyond torch and numpy; JAX arrays convert
through ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optimization_dynamics_tpu_torch.models.cartpole import (CartpoleAux,
                                                             CartpoleParams)
from optimization_dynamics_tpu_torch.solver.ilqr import ILQROptions
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions

__all__ = ["cartpole_params", "cartpole_aux", "ip_options", "ilqr_options",
           "al_state"]


def cartpole_params(p) -> CartpoleParams:
    """The port's ``CartpoleParams`` from the reference's."""
    return CartpoleParams(*(float(getattr(p, f))
                            for f in CartpoleParams._fields))


def cartpole_aux(a, device, dtype) -> CartpoleAux:
    """The port's ``CartpoleAux`` from the reference's (``friction`` may be
    None for the frictionless model)."""
    fr = None if a.friction is None else torch.as_tensor(
        np.array(a.friction), dtype=dtype, device=device)
    return CartpoleAux(h=float(np.asarray(a.h)), friction=fr)


def _options(src, cls, renames=None):
    """``cls`` from the same-named fields of the dataclass ``src``
    (``renames``: the port's name of a field named otherwise). A field
    the port does not have must be off in ``src``, or this raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    renames = renames or {}
    kw = {}
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        if renames.get(f.name) in names:
            kw[renames[f.name]] = v
        elif f.name in names:
            kw[f.name] = v
        elif v:
            raise ValueError("%s.%s=%r has no counterpart in the port"
                             % (type(src).__name__, f.name, v))
    return cls(**kw)


def ip_options(o) -> IPOptions:
    """The port's ``IPOptions`` from the reference's."""
    return _options(o, IPOptions)


def ilqr_options(o) -> ILQROptions:
    """The port's ``ILQROptions`` from the reference's: ``pallas_riccati``
    becomes ``riccati_kernel`` (K3); the scalar-solver switches must be
    off."""
    return _options(o, ILQROptions, {"pallas_riccati": "riccati_kernel"})


def al_state(res):
    """``(lam, lamT, rho)`` of an ``ILQRResult`` as numpy arrays, for the
    port's ``lam_init`` / ``lamT_init`` / ``rho_init`` warm starts."""
    return np.array(res.lam), np.array(res.lamT), np.array(res.rho)
