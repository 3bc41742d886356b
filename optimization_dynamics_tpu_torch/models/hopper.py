"""Raibert-style planar hopper with body/foot contact, friction and leg
length limits.

Port of ``optimization_dynamics_tpu/models/hopper.py``:

  * q = [x_body, z_body, theta (body/leg angle), r (leg length)];
  * u = [attitude torque, leg force];
  * four unilateral constraints: body-ground, foot-ground, leg max and
    min length;
  * friction on the body and foot contacts (nb = 2), the body's
    tangential force making a moment body_radius * b0 on theta;
  * foot kinematics [x + r sin(theta), z - r cos(theta)].

The reference differentiates the Lagrangian ``L = K - V`` by autodiff;
here its derivatives are written in closed form and fed to
``models/base.py::variational_dynamics``. With ``J_f`` the foot's
Jacobian ``[[1, 0, r cos, sin], [0, 1, r sin, -cos]]``:

  * ``M(q) = diag(m_b, m_b, I_b, 0) + m_f J_f^T J_f``;
  * ``V = m_b g z + m_f g (z - r cos(theta))``, and ``K`` depends on q
    only through ``m_f |J_f(q) v|^2 / 2``, so the bias
    ``-D1L = dV/dq - dK/dq`` has entries in theta and r from the foot.

The solver's ``batched_jacobian`` differentiates the residual on nz x B
replicas in one reverse pass; nested autodiff inside it would multiply
the derivative sweep's host dispatch, hence the closed form. A test
holds it against ``torch.func`` derivatives of the same Lagrangian and
against the reference. The direct transcription
(``examples/comparisons/hopper_direct.py``) differentiates
``lagrangian`` itself, as the reference's does.

Variable layout:
    z = [q2 (0:4), gamma (4:8), s_gamma (8:12), psi (12:14), b (14:16),
         s_psi (16:18), s_b (18:20)]                        nz = 20
Problem data (friction coefficients in theta):
    theta = [q0 (4), q1 (4), u (2), mu_body, mu_foot, h]    ntheta = 13

Every function works over the last dimension, so it takes one vector or a
batch (batch first) alike. Constants enter as Python floats, never as
tensors made with ``torch.tensor``, so a call on CUDA tensors copies
nothing from the host. Its CUDA device functor is
``ops/kernels/csrc/hopper.cuh`` (``model()``'s ``kernel="hopper"``, the
``HopperParams`` as ``kernel_params``): on the card every lane-batched
IP solve, eval and grad, runs in the fused IP kernel (K1), whose wrapper
takes its plain version (``make_solver_batched``'s loop with the Newton
steps through K2's plain QR) for CPU tensors; the IFT solves go through
the batched QR kernel (K2) at (20, 13).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from optimization_dynamics_tpu_torch.dynamics import ImplicitModel
from optimization_dynamics_tpu_torch.models.base import variational_dynamics
from optimization_dynamics_tpu_torch.ops.cones import ConeSpec, cone_product

NQ, NU, NC, NB = 4, 2, 4, 2
NZ = NQ + 2 * NC + 4 * NB      # 20
NTHETA = 2 * NQ + NU + 2 + 1   # 13


class HopperParams(NamedTuple):
    mass_body: float = 1.0
    mass_foot: float = 0.2
    inertia_body: float = 0.1
    body_radius: float = 0.1
    foot_radius: float = 0.05
    leg_len_max: float = 1.0
    leg_len_min: float = 0.1
    gravity: float = 9.81
    friction_body: float = 0.5
    friction_foot: float = 0.5


class HopperAux(NamedTuple):
    """Scenario parameters threaded through theta: the timestep and the
    friction coefficients ``[mu_body, mu_foot]`` (None: the params')."""
    h: float
    friction: Optional[torch.Tensor] = None


def kinematics_foot(p: HopperParams, q):
    """Foot position (..., 2)."""
    r, th = q[..., 3], q[..., 2]
    return torch.stack([q[..., 0] + r * torch.sin(th),
                        q[..., 1] - r * torch.cos(th)], dim=-1)


def mass_matrix(p: HopperParams, q):
    """``diag(m_b, m_b, I_b, 0) + m_f J_f^T J_f`` (..., 4, 4)."""
    c, s, r = torch.cos(q[..., 2]), torch.sin(q[..., 2]), q[..., 3]
    mf = p.mass_foot
    diag = torch.full_like(r, p.mass_body + mf)
    zero = torch.zeros_like(r)
    m02, m03 = mf * r * c, mf * s
    m12, m13 = mf * r * s, -mf * c
    return torch.stack([
        torch.stack([diag, zero, m02, m03], dim=-1),
        torch.stack([zero, diag, m12, m13], dim=-1),
        torch.stack([m02, m12, p.inertia_body + mf * r * r, zero], dim=-1),
        torch.stack([m03, m13, zero, torch.full_like(r, mf)], dim=-1),
    ], dim=-2)


def dynamics_bias(p: HopperParams, q, v):
    """``-D1L = dV/dq - dK/dq`` (..., 4)."""
    c, s, r = torch.cos(q[..., 2]), torch.sin(q[..., 2]), q[..., 3]
    v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    mf, g = p.mass_foot, p.gravity
    # the foot's velocity J_f v and its derivatives in theta and r
    w0 = v0 + r * c * v2 + s * v3
    w1 = v1 + r * s * v2 - c * v3
    dk_th = mf * (w0 * (c * v3 - r * s * v2) + w1 * (r * c * v2 + s * v3))
    dk_r = mf * v2 * (w0 * c + w1 * s)
    return torch.stack([
        torch.zeros_like(r),
        torch.full_like(r, (p.mass_body + mf) * g),
        mf * g * r * s - dk_th,
        -mf * g * c - dk_r,
    ], dim=-1)


def lagrangian(p: HopperParams, q, v):
    """``L = K - V`` (...), the reference's: the foot's velocity is the
    JVP of ``kinematics_foot`` along v. ``mass_matrix`` and
    ``dynamics_bias`` are its derivatives in closed form; the direct
    transcription (``examples/comparisons/hopper_direct.py``)
    differentiates it."""
    pf, pf_dot = torch.func.jvp(lambda q: kinematics_foot(p, q), (q,), (v,))
    ke = (0.5 * p.mass_body * (v[..., 0] ** 2 + v[..., 1] ** 2)
          + 0.5 * p.inertia_body * v[..., 2] ** 2
          + 0.5 * p.mass_foot * torch.sum(pf_dot * pf_dot, dim=-1))
    pe = (p.mass_body * p.gravity * q[..., 1]
          + p.mass_foot * p.gravity * pf[..., 1])
    return ke - pe


def signed_distance(p: HopperParams, q):
    """[body-ground, foot-ground, leg max, leg min] >= 0, (..., 4)."""
    foot_z = q[..., 1] - q[..., 3] * torch.cos(q[..., 2])
    return torch.stack([
        q[..., 1] - p.body_radius,
        foot_z - p.foot_radius,
        p.leg_len_max - q[..., 3],
        q[..., 3] - p.leg_len_min,
    ], dim=-1)


def contact_jacobian(p: HopperParams, q):
    """The force map J (..., 6, 4), rows (body_x, body_z, foot_x, foot_z,
    leg_max, leg_min)."""
    c, s, r = torch.cos(q[..., 2]), torch.sin(q[..., 2]), q[..., 3]
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    return torch.stack([
        torch.stack([one, zero, zero, zero], dim=-1),
        torch.stack([zero, one, zero, zero], dim=-1),
        torch.stack([one, zero, r * c, s], dim=-1),
        torch.stack([zero, one, r * s, -c], dim=-1),
        torch.stack([zero, zero, zero, -one], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ], dim=-2)


def contact_force(p: HopperParams, q, gam, b):
    """``J^T`` of the contact forces, (..., 4): tangential b on the body
    and foot x-rows, normal gamma on the z-rows, the leg-limit gammas on
    r, and the body friction's moment ``body_radius * b0`` on theta."""
    c, s, r = torch.cos(q[..., 2]), torch.sin(q[..., 2]), q[..., 3]
    return torch.stack([
        b[..., 0] + b[..., 1],
        gam[..., 0] + gam[..., 1],
        r * c * b[..., 1] + r * s * gam[..., 1] + p.body_radius * b[..., 0],
        s * b[..., 1] - c * gam[..., 1] - gam[..., 2] + gam[..., 3],
    ], dim=-1)


def input_matrix():
    """B (4, 2) as nested tuples: the torque on theta, the force on r."""
    return ((0.0, 0.0), (0.0, 0.0), (1.0, 0.0), (0.0, 1.0))


def control_force(u):
    """B u (..., 4)."""
    zero = torch.zeros_like(u[..., 0])
    return torch.stack([zero, zero, u[..., 0], u[..., 1]], dim=-1)


def slip_velocity(p: HopperParams, q1, q2, h):
    """Tangential slip velocities [body, foot] at q2, (..., 2): the body
    rolls at body_radius; the foot's is ``v0 + r cos v2 + sin v3``."""
    v = (q2 - q1) / h[..., None]
    c, s, r = torch.cos(q2[..., 2]), torch.sin(q2[..., 2]), q2[..., 3]
    return torch.stack([
        v[..., 0] + p.body_radius * v[..., 2],
        v[..., 0] + r * c * v[..., 2] + s * v[..., 3],
    ], dim=-1)


def unpack_z(z):
    return (z[..., 0:4], z[..., 4:8], z[..., 8:12], z[..., 12:14],
            z[..., 14:16], z[..., 16:18], z[..., 18:20])


def pack_theta(q0, q1, u, friction, h):
    """[q0, q1, u, friction, h]: ``friction`` (2,) or (..., 2), ``h`` a
    0-dim tensor, each repeated over the lanes."""
    lead = q0.shape[:-1]
    return torch.cat([q0, q1, u, friction.expand(lead + (2,)),
                      h.reshape(1).expand(lead + (1,))], dim=-1)


def residual(p: HopperParams, z, theta, kappa):
    q0 = theta[..., 0:4]
    q1 = theta[..., 4:8]
    u = theta[..., 8:10]
    mu_body = theta[..., 10]
    mu_foot = theta[..., 11]
    h = theta[..., 12]
    q2, gam, s_gam, psi, b, s_psi, s_b = unpack_z(z)

    d = variational_dynamics(
        lambda q: mass_matrix(p, q),
        lambda q, v: dynamics_bias(p, q, v),
        h, q0, q1, q2, control_force(u),
        contact_force=contact_force(p, q2, gam, b))

    kap = kappa * torch.ones_like(h)
    k2 = torch.stack([kap, torch.zeros_like(h)], dim=-1)
    pair = lambda a, i, c: torch.stack([a[..., i], c[..., i]], dim=-1)
    return torch.cat([
        d,
        s_gam - signed_distance(p, q2),
        torch.stack([psi[..., 0] - mu_body * gam[..., 0],
                     psi[..., 1] - mu_foot * gam[..., 1]], dim=-1),
        s_b - slip_velocity(p, q1, q2, h),
        gam * s_gam - kap[..., None],
        cone_product(pair(psi, 0, b), pair(s_psi, 0, s_b)) - k2,
        cone_product(pair(psi, 1, b), pair(s_psi, 1, s_b)) - k2,
    ], dim=-1)


def cone_spec() -> ConeSpec:
    """Four orthant pairs (gamma, s_gamma), two SOC(2) friction groups."""
    return ConeSpec(
        nz=NZ, ntheta=NTHETA,
        eq_rows=tuple(range(12)),
        ort_prim=(4, 5, 6, 7), ort_dual=(8, 9, 10, 11),
        ort_rows=(12, 13, 14, 15),
        soc_prim=((12, 14), (13, 15)),
        soc_dual=((16, 18), (17, 19)),
        soc_rows=((16, 17), (18, 19)),
    )


def init_z(q):
    """z = [q; gamma, s_gamma = 1; psi = 1; b = 0.1; s_psi = 1;
    s_b = 0.1]."""
    lead = q.shape[:-1]
    ones = lambda n: q.new_ones(lead + (n,))
    tenth = lambda n: q.new_full(lead + (n,), 0.1)
    return torch.cat([q, ones(8), ones(2), tenth(2), ones(2), tenth(2)],
                     dim=-1)


def model(params: HopperParams = HopperParams()) -> ImplicitModel:
    """The hopper's ``ImplicitModel``, with its CUDA device functor
    ``hopper`` and the params as its constants: the counterpart of the
    reference's ``make_implicit_dynamics(hopper.model(), fused=True)``
    (the reference's deploy runs ``make_solver_batched``; K1's plain
    version is that solver)."""
    def res(z, theta, kappa):
        return residual(params, z, theta, kappa)

    def theta_fn(q0, q1, u, aux: HopperAux):
        lead = q0.shape[:-1]
        if aux.friction is None:
            friction = torch.cat([
                q0.new_full(lead + (1,), params.friction_body),
                q0.new_full(lead + (1,), params.friction_foot)], dim=-1)
        else:
            friction = aux.friction.to(q0)
        h = (aux.h.to(q0) if isinstance(aux.h, torch.Tensor)
             else q0.new_full((), float(aux.h)))
        return pack_theta(q0, q1, u, friction, h)

    return ImplicitModel(
        nq=NQ, nu=NU, nz=NZ, ntheta=NTHETA,
        residual=res,
        spec=cone_spec(),
        init_z=init_z,
        theta_fn=theta_fn,
        q_sel=tuple(range(NQ)),
        th_q0=tuple(range(4)), th_q1=tuple(range(4, 8)),
        th_u=(8, 9),
        kernel="hopper",
        kernel_params=tuple(float(v) for v in params),
    )
