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

from optimization_dynamics_tpu_torch.models.acrobot import (AcrobotAux,
                                                            AcrobotParams)
from optimization_dynamics_tpu_torch.models.cartpole import (CartpoleAux,
                                                             CartpoleParams)
from optimization_dynamics_tpu_torch.models.hopper import (HopperAux,
                                                           HopperParams)
from optimization_dynamics_tpu_torch.models.planar_push import (
    PlanarPushAux,
    PlanarPushParams,
)
from optimization_dynamics_tpu_torch.models.rocket import RocketParams
from optimization_dynamics_tpu_torch.solver.direct import DirectOptions
from optimization_dynamics_tpu_torch.solver.ilqr import ILQROptions
from optimization_dynamics_tpu_torch.solver.interior_point import IPOptions

__all__ = ["cartpole_params", "cartpole_aux", "planar_push_params",
           "planar_push_aux", "acrobot_params", "acrobot_aux",
           "hopper_params", "hopper_aux", "rocket_params", "ip_options",
           "ilqr_options", "direct_options", "al_state"]


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


def planar_push_params(p) -> PlanarPushParams:
    """The port's ``PlanarPushParams`` from the reference's."""
    return PlanarPushParams(*(float(getattr(p, f))
                              for f in PlanarPushParams._fields))


def planar_push_aux(a) -> PlanarPushAux:
    """The port's ``PlanarPushAux`` from the reference's (the timestep as
    a Python float)."""
    return PlanarPushAux(h=float(np.asarray(a.h)))


def acrobot_params(p) -> AcrobotParams:
    """The port's ``AcrobotParams`` from the reference's."""
    return AcrobotParams(*(float(getattr(p, f))
                           for f in AcrobotParams._fields))


def acrobot_aux(a, device, dtype) -> AcrobotAux:
    """The port's ``AcrobotAux`` from the reference's: the timestep as a
    0-dim tensor of ``dtype`` on ``device``."""
    return AcrobotAux(h=torch.as_tensor(np.array(a.h), dtype=dtype,
                                        device=device))


def hopper_params(p) -> HopperParams:
    """The port's ``HopperParams`` from the reference's."""
    return HopperParams(*(float(getattr(p, f))
                          for f in HopperParams._fields))


def hopper_aux(a, device, dtype) -> HopperAux:
    """The port's ``HopperAux`` from the reference's: the timestep as a
    0-dim tensor and the friction coefficients (None: the params') as a
    (2,) tensor, both of ``dtype`` on ``device``."""
    fr = None if a.friction is None else torch.as_tensor(
        np.array(a.friction), dtype=dtype, device=device)
    return HopperAux(h=torch.as_tensor(np.array(a.h), dtype=dtype,
                                       device=device), friction=fr)


def rocket_params(p) -> RocketParams:
    """The port's ``RocketParams`` from the reference's (the rocket has
    no aux: its timestep and thrust limit are arguments of
    ``make_rocket_dynamics``)."""
    return RocketParams(mass=float(p.mass), length=float(p.length),
                        inertia=tuple(float(j) for j in p.inertia),
                        gravity=float(p.gravity))


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
    """The port's ``IPOptions`` from the reference's (``mehrotra`` and
    ``mehrotra_infeas_frac`` included; ``verbose`` must be off)."""
    return _options(o, IPOptions)


def ilqr_options(o) -> ILQROptions:
    """The port's ``ILQROptions`` from the reference's: ``pallas_riccati``
    becomes ``riccati_kernel`` (K3); the scalar solver's
    ``parallel_riccati``, ``parallel_linesearch`` and ``verbose`` carry
    across."""
    return _options(o, ILQROptions, {"pallas_riccati": "riccati_kernel"})


def direct_options(o) -> DirectOptions:
    """The port's ``DirectOptions`` from the reference's (the same
    fields)."""
    return _options(o, DirectOptions)


def al_state(res):
    """``(lam, lamT, rho)`` of an ``ILQRResult`` as numpy arrays, for the
    port's ``lam_init`` / ``lamT_init`` / ``rho_init`` warm starts."""
    return np.array(res.lam), np.array(res.lamT), np.array(res.rho)
