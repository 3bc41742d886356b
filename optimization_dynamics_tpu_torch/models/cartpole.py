"""Cartpole with joint friction on both the slider and the arm.

Port of ``optimization_dynamics_tpu/models/cartpole.py``. Each joint's
Coulomb friction is a 2-dim second-order-cone complementarity: the
friction impulse ``b_i`` is bounded by ``psi_i`` (= mu_i * normal-load
impulse) and opposes the joint slip velocity through the cone rows.

Variable layout (friction variant):
    z = [q2 (2), psi (2), b (2), s_psi (2), s_b (2)]          nz = 10
Problem data:
    theta = [q0 (2), q1 (2), u (1), mu_slider, mu_angle, h]   ntheta = 8
Residual rows:
    [dynamics (2);
     s_b1 - vT1; psi1 - mu_slider*(mp+mc)*g*h;
     s_b2 - vT2; psi2 - mu_angle*(mp*g*l)*h;
     cone([psi1,b1],[s_psi1,s_b1]) - [kappa,0];
     cone([psi2,b2],[s_psi2,s_b2]) - [kappa,0]]

Every function works over the last dimension, so it takes one vector or a
batch (batch first) alike. Small vectors are built with ``torch.stack``/
``torch.cat`` from the inputs, so the residual keeps the inputs' device
and dtype and ``torch.func.jacfwd`` traces through it. The CUDA functor
of the same residual is ``ops/kernels/csrc/cartpole_friction.cuh``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from optimization_dynamics_tpu_torch.dynamics import ImplicitModel
from optimization_dynamics_tpu_torch.models.base import variational_dynamics
from optimization_dynamics_tpu_torch.ops.cones import ConeSpec, cone_product

NQ, NU, NC = 2, 1, 2
NZ_FRICTION = NQ + 4 * NC        # 10
NZ_FRICTIONLESS = NQ             # 2
NTHETA_FRICTION = 2 * NQ + NU + 2 + 1   # 8
NTHETA_FRICTIONLESS = 2 * NQ + NU + 1   # 6


class CartpoleParams(NamedTuple):
    mc: float = 1.0    # cart mass
    mp: float = 0.2    # pole point mass
    length: float = 0.5
    gravity: float = 9.81


def mass_matrix(p: CartpoleParams, q):
    b = p.mp * p.length * torch.cos(q[..., 1])
    a = torch.full_like(b, p.mc + p.mp)
    c = torch.full_like(b, p.mp * p.length ** 2)
    return torch.stack([torch.stack([a, b], dim=-1),
                        torch.stack([b, c], dim=-1)], dim=-2)


def dynamics_bias(p: CartpoleParams, q, v):
    """-C v + G of the reference, with the sign ``variational_dynamics``
    expects (D1L = -bias)."""
    zero = torch.zeros_like(q[..., 1])
    c_times_v = torch.stack(
        [-p.mp * v[..., 1] * p.length * torch.sin(q[..., 1]) * v[..., 1],
         zero], dim=-1)
    g = torch.stack(
        [zero, p.mp * p.gravity * p.length * torch.sin(q[..., 1])], dim=-1)
    return -c_times_v + g


def control_force(u):
    return torch.stack([u[..., 0], torch.zeros_like(u[..., 0])], dim=-1)


def unpack_theta_friction(theta):
    q0 = theta[..., 0:2]
    q1 = theta[..., 2:4]
    u = theta[..., 4:5]
    mu_slider = theta[..., 5]
    mu_angle = theta[..., 6]
    h = theta[..., 7]
    return q0, q1, u, mu_slider, mu_angle, h


def _lanes(a, like, n):
    """``a`` (n values) repeated over the batch dimensions of ``like``."""
    return a.reshape(n).expand(like.shape[:-1] + (n,))


def pack_theta_friction(q0, q1, u, friction, h):
    return torch.cat([q0, q1, u, _lanes(friction, q0, 2),
                      _lanes(h, q0, 1)], dim=-1)


def pack_theta_frictionless(q0, q1, u, h):
    return torch.cat([q0, q1, u, _lanes(h, q0, 1)], dim=-1)


def residual_friction(p: CartpoleParams, z, theta, kappa):
    q0, q1, u, mu_slider, mu_angle, h = unpack_theta_friction(theta)
    q2 = z[..., 0:2]
    psi = z[..., 2:4]
    b = z[..., 4:6]
    s_psi = z[..., 6:8]
    s_b = z[..., 8:10]

    vT = (q2 - q1) / h[..., None]     # joint slip velocities (P = I)

    d = variational_dynamics(
        lambda q: mass_matrix(p, q),
        lambda q, v: dynamics_bias(p, q, v),
        h, q0, q1, q2,
        control_force(u),
        contact_force=b,   # P^T b with P = I
    )
    kvec = torch.stack([kappa * torch.ones_like(h), torch.zeros_like(h)],
                       dim=-1)
    pair = lambda a, b_: torch.stack([a, b_], dim=-1)
    return torch.cat([
        d,
        torch.stack([
            s_b[..., 0] - vT[..., 0],
            psi[..., 0] - mu_slider * (p.mp + p.mc) * p.gravity * h,
            s_b[..., 1] - vT[..., 1],
            psi[..., 1] - mu_angle * (p.mp * p.gravity * p.length) * h,
        ], dim=-1),
        cone_product(pair(psi[..., 0], b[..., 0]),
                     pair(s_psi[..., 0], s_b[..., 0])) - kvec,
        cone_product(pair(psi[..., 1], b[..., 1]),
                     pair(s_psi[..., 1], s_b[..., 1])) - kvec,
    ], dim=-1)


def residual_frictionless(p: CartpoleParams, z, theta, kappa):
    q0 = theta[..., 0:2]
    q1 = theta[..., 2:4]
    u = theta[..., 4:5]
    h = theta[..., 5]
    q2 = z[..., 0:2]
    return variational_dynamics(
        lambda q: mass_matrix(p, q),
        lambda q, v: dynamics_bias(p, q, v),
        h, q0, q1, q2,
        control_force(u),
    )


def cone_spec_friction() -> ConeSpec:
    """Two 2-dim SOC pairs."""
    return ConeSpec(
        nz=NZ_FRICTION,
        ntheta=NTHETA_FRICTION,
        eq_rows=(0, 1, 2, 3, 4, 5),
        soc_prim=((2, 4), (3, 5)),
        soc_dual=((6, 8), (7, 9)),
        soc_rows=((6, 7), (8, 9)),
    )


def cone_spec_frictionless() -> ConeSpec:
    return ConeSpec(nz=NZ_FRICTIONLESS, ntheta=NTHETA_FRICTIONLESS,
                    eq_rows=(0, 1))


def init_z_friction(q):
    """z = [q; psi=1; b=0.1; s_psi=1; s_b=0.1]."""
    tail = torch.tensor([1.0, 1.0, 0.1, 0.1, 1.0, 1.0, 0.1, 0.1],
                        dtype=q.dtype, device=q.device)
    return torch.cat([q, _lanes(tail, q, 8)], dim=-1)


def init_z_frictionless(q):
    return q


class CartpoleAux(NamedTuple):
    """Scenario parameters: timestep and the two friction coefficients
    (part of theta, so friction sweeps batch)."""
    h: float
    friction: Optional[torch.Tensor] = None  # (2,)


def friction_model(params: CartpoleParams = CartpoleParams()
                   ) -> ImplicitModel:
    def residual(z, theta, kappa):
        return residual_friction(params, z, theta, kappa)

    def theta_fn(q0, q1, u, aux: CartpoleAux):
        fr = torch.as_tensor(aux.friction, dtype=q0.dtype, device=q0.device)
        h = torch.as_tensor(aux.h, dtype=q0.dtype, device=q0.device)
        return pack_theta_friction(q0, q1, u, fr, h)

    return ImplicitModel(
        nq=NQ, nu=NU, nz=NZ_FRICTION, ntheta=NTHETA_FRICTION,
        residual=residual,
        spec=cone_spec_friction(),
        init_z=init_z_friction,
        theta_fn=theta_fn,
        q_sel=(0, 1),
        th_q0=(0, 1), th_q1=(2, 3), th_u=(4,),
        kernel="cartpole_friction",
        kernel_params=(params.mc, params.mp, params.length, params.gravity),
    )


def frictionless_model(params: CartpoleParams = CartpoleParams()
                       ) -> ImplicitModel:
    def residual(z, theta, kappa):
        return residual_frictionless(params, z, theta, kappa)

    def theta_fn(q0, q1, u, aux: CartpoleAux):
        h = torch.as_tensor(aux.h, dtype=q0.dtype, device=q0.device)
        return pack_theta_frictionless(q0, q1, u, h)

    return ImplicitModel(
        nq=NQ, nu=NU, nz=NZ_FRICTIONLESS, ntheta=NTHETA_FRICTIONLESS,
        residual=residual,
        spec=cone_spec_frictionless(),
        init_z=init_z_frictionless,
        theta_fn=theta_fn,
        q_sel=(0, 1),
        th_q0=(0, 1), th_q1=(2, 3), th_u=(4,),
    )
