"""Acrobot (double pendulum, elbow-actuated) with hard elbow joint limits.

Port of ``optimization_dynamics_tpu/models/acrobot.py``: the smallest
optimization-based-dynamics problem (nz=6). The elbow limits
``-pi/2 <= q2 <= pi/2`` enter the step as an impact complementarity.

Variable layout (impact variant):
    z = [q2 (2), lambda (2), s (2)]          nz = 6
Problem data:
    theta = [q0 (2), q1 (2), u (1), h (1)]   ntheta = 6
Residual rows:
    [variational dynamics (2); s - phi(q2) (2); lambda * s - kappa (2)]

Every function works over the last dimension, so it takes one vector or a
batch (batch first) alike, and ``torch.func.jacfwd`` and the solver's
reverse-mode ``batched_jacobian`` differentiate it. Constants enter as
Python floats combined in the reference's order (a product of parameters
is folded in double before it meets a tensor), never as tensors made
with ``torch.tensor``, so a call on CUDA tensors copies nothing from the
host. The CUDA functor of the impact residual is
``ops/kernels/csrc/acrobot_impact.cuh``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from optimization_dynamics_tpu_torch.dynamics import ImplicitModel
from optimization_dynamics_tpu_torch.models.base import variational_dynamics
from optimization_dynamics_tpu_torch.ops.cones import ConeSpec

NQ, NU, NC = 2, 1, 2
NZ_IMPACT = NQ + 2 * NC          # 6
NZ_NOMINAL = NQ                  # 2
NTHETA = 2 * NQ + NU + 1         # 6
DAMPING = 0.5


class AcrobotParams(NamedTuple):
    m1: float = 1.0
    j1: float = 0.333
    l1: float = 1.0
    lc1: float = 0.5
    m2: float = 1.0
    j2: float = 0.333
    l2: float = 1.0
    lc2: float = 0.5
    gravity: float = 9.81


def kinematics(p: AcrobotParams, q):
    """The tip position (..., 2)."""
    return torch.stack([
        p.l1 * torch.sin(q[..., 0]) + p.l2 * torch.sin(q[..., 0] + q[..., 1]),
        -p.l1 * torch.cos(q[..., 0]) - p.l2 * torch.cos(q[..., 0]
                                                      + q[..., 1]),
    ], dim=-1)


def mass_matrix(p: AcrobotParams, q):
    c1 = torch.cos(q[..., 1])
    a = (p.j1 + p.j2 + p.m2 * p.l1 * p.l1
         + 2.0 * p.m2 * p.l1 * p.lc2 * c1)
    b = p.j2 + p.m2 * p.l1 * p.lc2 * c1
    return torch.stack([torch.stack([a, b], dim=-1),
                        torch.stack([b, torch.full_like(b, p.j2)], dim=-1)],
                       dim=-2)


def _tau(p: AcrobotParams, q):
    s0 = torch.sin(q[..., 0])
    s01 = torch.sin(q[..., 0] + q[..., 1])
    a = (-p.m1 * p.gravity * p.lc1 * s0
         - p.m2 * p.gravity * (p.l1 * s0 + p.lc2 * s01))
    b = -p.m2 * p.gravity * p.lc2 * s01
    return torch.stack([a, b], dim=-1)


def _coriolis(p: AcrobotParams, q, v):
    """C(q, v) v in the reference's scalar form."""
    k = p.m2 * p.l1 * p.lc2 * torch.sin(q[..., 1])
    v0, v1 = v[..., 0], v[..., 1]
    return torch.stack([-2.0 * k * v1 * v0 - k * v1 * v1, k * v0 * v0],
                       dim=-1)


def dynamics_bias(p: AcrobotParams, q, v):
    return _coriolis(p, q, v) - _tau(p, q)


def signed_distance(q):
    """Elbow joint limits: phi = [pi/2 - q2; q2 + pi/2] >= 0."""
    return torch.stack([0.5 * math.pi - q[..., 1], q[..., 1] + 0.5 * math.pi],
                       dim=-1)


def limit_jacobian():
    """d phi / d q, the reference's constant ``[[0, -1], [0, 1]]``."""
    return ((0.0, -1.0), (0.0, 1.0))


def limit_force(lam):
    """J^T lambda of the joint limits, (..., 2)."""
    (a, b), (c, d) = limit_jacobian()
    return torch.stack([a * lam[..., 0] + c * lam[..., 1],
                        b * lam[..., 0] + d * lam[..., 1]], dim=-1)


def control_force(u):
    return torch.stack([torch.zeros_like(u[..., 0]), u[..., 0]], dim=-1)


def unpack_theta(theta):
    return (theta[..., 0:NQ], theta[..., NQ:2 * NQ],
            theta[..., 2 * NQ:2 * NQ + NU], theta[..., 2 * NQ + NU])


def pack_theta(q0, q1, u, h):
    """[q0, q1, u, h] with ``h`` a 0-dim tensor repeated over the lanes."""
    return torch.cat([q0, q1, u, h.reshape(1).expand(q0.shape[:-1] + (1,))],
                     dim=-1)


def _dynamics_rows(p: AcrobotParams, z, theta, contact: bool):
    q0, q1, u, h = unpack_theta(theta)
    return variational_dynamics(
        lambda q: mass_matrix(p, q),
        lambda q, v: dynamics_bias(p, q, v),
        h, q0, q1, z[..., 0:NQ],
        control_force(u),
        contact_force=limit_force(z[..., NQ:NQ + NC]) if contact else None,
        damping=DAMPING,
    )


def residual_impact(p: AcrobotParams, z, theta, kappa):
    """The joint-limit impact residual."""
    q2 = z[..., 0:NQ]
    lam = z[..., NQ:NQ + NC]
    s = z[..., NQ + NC:NQ + 2 * NC]
    return torch.cat([
        _dynamics_rows(p, z, theta, True),
        s - signed_distance(q2),
        lam * s - kappa,
    ], dim=-1)


def residual_nominal(p: AcrobotParams, z, theta, kappa):
    """The smooth residual without joint limits."""
    return _dynamics_rows(p, z, theta, False)


def cone_spec_impact() -> ConeSpec:
    """Orthant pairs (lambda_i, s_i); rows 0..3 equality, 4..5 bilinear."""
    return ConeSpec(
        nz=NZ_IMPACT,
        ntheta=NTHETA,
        eq_rows=(0, 1, 2, 3),
        ort_prim=(2, 3),
        ort_dual=(4, 5),
        ort_rows=(4, 5),
    )


def cone_spec_nominal() -> ConeSpec:
    return ConeSpec(nz=NZ_NOMINAL, ntheta=NTHETA, eq_rows=(0, 1))


def init_z_impact(q):
    """Warm start: z = [q; 1; 1; 1; 1]."""
    return torch.cat([q, q.new_ones(q.shape[:-1] + (2 * NC,))], dim=-1)


def init_z_nominal(q):
    return q


class AcrobotAux(NamedTuple):
    """Scenario parameters threaded through theta: the timestep."""
    h: float


def _theta_fn(q0, q1, u, aux: AcrobotAux):
    h = (aux.h.to(q0) if isinstance(aux.h, torch.Tensor)
         else q0.new_full((), float(aux.h)))
    return pack_theta(q0, q1, u, h)


def impact_model(params: AcrobotParams = AcrobotParams()) -> ImplicitModel:
    """The joint-limit ``ImplicitModel``; its lane-batched solves run in
    the fused IP kernel's acrobot instantiation (K1a)."""
    def residual(z, theta, kappa):
        return residual_impact(params, z, theta, kappa)

    return ImplicitModel(
        nq=NQ, nu=NU, nz=NZ_IMPACT, ntheta=NTHETA,
        residual=residual,
        spec=cone_spec_impact(),
        init_z=init_z_impact,
        theta_fn=_theta_fn,
        q_sel=(0, 1),
        th_q0=(0, 1), th_q1=(2, 3), th_u=(4,),
        kernel="acrobot_impact",
        kernel_params=tuple(float(v) for v in params),
    )


def nominal_model(params: AcrobotParams = AcrobotParams()) -> ImplicitModel:
    """The smooth ``ImplicitModel`` (no joint limits, no device functor:
    ``make_solver_batched`` solves it, as the reference does)."""
    def residual(z, theta, kappa):
        return residual_nominal(params, z, theta, kappa)

    return ImplicitModel(
        nq=NQ, nu=NU, nz=NZ_NOMINAL, ntheta=NTHETA,
        residual=residual,
        spec=cone_spec_nominal(),
        init_z=init_z_nominal,
        theta_fn=_theta_fn,
        q_sel=(0, 1),
        th_q0=(0, 1), th_q1=(2, 3), th_u=(4,),
    )
