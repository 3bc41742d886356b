"""Planar pushing: a box slider driven by a point pusher.

Port of ``optimization_dynamics_tpu/models/planar_push.py``: one impact
complementarity (pusher-box), four 3-dim surface-friction cones (one per
box corner, bounded by the quarter-weight friction budget) and one 2-dim
pusher friction cone (bounded by mu_pusher * impact force).

Variable layout, 0-based:
    z = [q2 (0:5), gamma1 (5), s1 (6), psi (7:12), b (12:21),
         s_psi (21:26), s_b (26:35)]                     nz = 35
Problem data: theta = [q0 (5), q1 (5), u (2), h (1)]    ntheta = 13
Residual rows:
    [dynamics (0:5); s1 - phi (5); psi_1..4 - mu m g h/4 (6:10);
     psi5 - mu_pusher*gamma1 (10); vT - s_b (11:20);
     gamma1*s1 - kappa (20); 4x cone3 (21:33); cone2 (33:35)]

The residual holds derivatives of the geometry: the contact normal is the
gradient of the signed distance ``phi`` and the corner rows of the
tangential Jacobian differentiate the corner positions. The reference
takes both by autodiff (``jax.grad``, ``jax.jacfwd``); here they are
written in closed form (``normal``, ``corner_jacobian``), the same
formulas as the CUDA functor ``ops/kernels/csrc/planar_push.cuh``, and a
test holds them against the reference's autodiff. The powers follow
``jnp``'s ``integer_pow`` (binary exponentiation by multiplication) and
the gradient of ``S ** (1/10)`` is taken as the reference's chain rule
forms it, ``0.1 * S ** (0.1 - 1) * (10 * delta ** 9)``.

Every function works over the last dimension, so it takes one vector or a
batch (batch first) alike, and ``torch.func.jacfwd`` and the solver's
reverse-mode ``batched_jacobian`` differentiate it. Constants enter as
Python floats, never as tensors made with ``torch.tensor``, so a call on
CUDA tensors copies nothing from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optimization_dynamics_tpu_torch.dynamics import ImplicitModel
from optimization_dynamics_tpu_torch.ops.cones import ConeSpec, cone_product

NQ, NU, NC = 5, 2, 5
NB = 9                      # 4 corners x 2 + pusher x 1
NZ = NQ + 2 + 2 * (NC + NB)  # 35
NTHETA = 2 * NQ + NU + 1     # 13

R_DIM = 0.1
_CORNERS = ((R_DIM, R_DIM), (-R_DIM, R_DIM),
            (R_DIM, -R_DIM), (-R_DIM, -R_DIM))
_P_NORM = 10                # the smooth-max norm of the signed distance


class PlanarPushParams(NamedTuple):
    mass_block: float = 1.0
    mass_pusher: float = 10.0
    inertia: float = 1.0 / 12.0 * 1.0 * (2 * R_DIM) ** 2 * 2
    mu_surface: float = 0.5
    mu_pusher: float = 0.5
    gravity: float = 9.81


def _ipow(x, n: int):
    """``x ** n`` for an integer n >= 1 by binary exponentiation, the
    multiplications of ``jnp``'s ``integer_pow``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _box_frame(q):
    """The pusher's position in the block frame: ``delta = rot(-theta)
    (p - pos)``, with ``c, s = cos(-theta), sin(-theta)``."""
    a = -q[..., 2]
    c, s = torch.cos(a), torch.sin(a)
    w0 = q[..., 3] - q[..., 0]
    w1 = q[..., 4] - q[..., 1]
    return c, s, c * w0 - s * w1, s * w0 + c * w1


def _norm_sum(d0, d1):
    return _ipow(d0, _P_NORM) + _ipow(d1, _P_NORM)


def phi(q):
    """Pusher-box signed distance: the p=10 smooth-max norm of delta
    minus the half-width."""
    _, _, d0, d1 = _box_frame(q)
    return _norm_sum(d0, d1) ** (1.0 / _P_NORM) - R_DIM


def normal(q):
    """The gradient of ``phi`` in closed form, (..., 5)."""
    c, s, d0, d1 = _box_frame(q)
    p = 1.0 / _P_NORM
    coef = p * _norm_sum(d0, d1) ** (p - 1.0)
    g0 = coef * (_P_NORM * _ipow(d0, _P_NORM - 1))
    g1 = coef * (_P_NORM * _ipow(d1, _P_NORM - 1))
    n3 = g0 * c + g1 * s            # d phi / d pusher position
    n4 = g1 * c - g0 * s
    n2 = g0 * d1 - g1 * d0          # d phi / d theta
    return torch.stack([-n3, -n4, n2, n3, n4], dim=-1)


def corner_positions(q):
    """World positions of the four contact corners, (..., 8)."""
    c, s = torch.cos(q[..., 2]), torch.sin(q[..., 2])
    out = []
    for a, b in _CORNERS:
        out += [q[..., 0] + (c * a - s * b), q[..., 1] + (s * a + c * b)]
    return torch.stack(out, dim=-1)


def corner_jacobian(q):
    """The Jacobian of ``corner_positions`` in closed form, (..., 8, 5)."""
    c, s = torch.cos(q[..., 2]), torch.sin(q[..., 2])
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rows = []
    for a, b in _CORNERS:
        rows.append(torch.stack([one, zero, -s * a - c * b, zero, zero],
                                dim=-1))
        rows.append(torch.stack([zero, one, c * a - s * b, zero, zero],
                                dim=-1))
    return torch.stack(rows, dim=-2)


def tangential_jacobian(q):
    """P (..., 9, 5): corner-velocity rows and the pusher's tangential row
    with its torsional moment arm."""
    n = normal(q)
    n0, n1 = n[..., 3], n[..., 4]
    nn = torch.sqrt(n0 * n0 + n1 * n1)
    t0, t1 = -(n1 / nn), n0 / nn
    r0 = q[..., 3] - q[..., 0]
    r1 = q[..., 4] - q[..., 1]
    m = r0 * t1 - r1 * t0
    p_pusher = torch.stack([t0, t1, m, -t0, -t1], dim=-1)
    return torch.cat([corner_jacobian(q), p_pusher[..., None, :]], dim=-2)


def mass_diag(p: PlanarPushParams):
    return (p.mass_block, p.mass_block, p.inertia, p.mass_pusher,
            p.mass_pusher)


def unpack_z(z):
    return (z[..., 0:5], z[..., 5], z[..., 6], z[..., 7:12], z[..., 12:21],
            z[..., 21:26], z[..., 26:35])


def pack_theta(q0, q1, u, h):
    return torch.cat([q0, q1, u, h.reshape(1).expand(q0.shape[:-1] + (1,))],
                     dim=-1)


def residual(p: PlanarPushParams, z, theta, kappa):
    q0 = theta[..., 0:5]
    q1 = theta[..., 5:10]
    u = theta[..., 10:12]
    h = theta[..., 12]
    q2, gamma1, s1, psi, b, s_psi, s_b = unpack_z(z)

    P = tangential_jacobian(q2)                         # (..., 9, 5)
    N = normal(q2)
    hh = h[..., None]
    vT = torch.sum(P * (q2 - q1)[..., None, :], dim=-1) / hh

    vm1 = (q1 - q0) / hh
    vm2 = (q2 - q1) / hh
    # D1L = 0, D2L = M v with M diagonal; the control enters rows 3:5
    md = mass_diag(p)
    ctrl = torch.cat([torch.zeros_like(u[..., :1]).expand(
        u.shape[:-1] + (3,)), u], dim=-1)
    d = (torch.stack([md[i] * (vm1[..., i] - vm2[..., i])
                      for i in range(NQ)], dim=-1)
         + ctrl + N * gamma1[..., None]
         + torch.sum(P * b[..., :, None], dim=-2))

    budget = p.mu_surface * p.mass_block * p.gravity * h * 0.25
    kap = kappa * torch.ones_like(h)
    zero = torch.zeros_like(h)
    k3 = torch.stack([kap, zero, zero], dim=-1)

    # four 3-dim corner cones [psi_i, b_2i, b_2i+1] o [s_psi_i, s_b..]
    lead = z.shape[:-1]
    prim = torch.cat([psi[..., 0:4, None], b[..., 0:8].reshape(
        lead + (4, 2))], dim=-1)
    dual = torch.cat([s_psi[..., 0:4, None], s_b[..., 0:8].reshape(
        lead + (4, 2))], dim=-1)
    cones3 = (cone_product(prim, dual) - k3[..., None, :]).reshape(
        lead + (12,))
    cone2 = cone_product(torch.stack([psi[..., 4], b[..., 8]], dim=-1),
                         torch.stack([s_psi[..., 4], s_b[..., 8]], dim=-1)) \
        - k3[..., :2]

    return torch.cat([
        d,
        (s1 - phi(q2))[..., None],
        psi[..., 0:4] - budget[..., None],
        (psi[..., 4] - p.mu_pusher * gamma1)[..., None],
        vT - s_b,
        (gamma1 * s1 - kap)[..., None],
        cones3,
        cone2,
    ], dim=-1)


def cone_spec() -> ConeSpec:
    """Orthant pair (gamma1, s1), four SOC(3) corner groups and one SOC(2)
    pusher group."""
    soc_prim = tuple(
        [(7 + i, 12 + 2 * i, 13 + 2 * i) for i in range(4)] + [(11, 20)])
    soc_dual = tuple(
        [(21 + i, 26 + 2 * i, 27 + 2 * i) for i in range(4)] + [(25, 34)])
    soc_rows = tuple(
        [(21 + 3 * i, 22 + 3 * i, 23 + 3 * i) for i in range(4)]
        + [(33, 34)])
    return ConeSpec(
        nz=NZ, ntheta=NTHETA,
        eq_rows=tuple(range(20)),
        ort_prim=(5,), ort_dual=(6,), ort_rows=(20,),
        soc_prim=soc_prim, soc_dual=soc_dual, soc_rows=soc_rows,
    )


def init_z(q):
    """gamma, s, psi, s_psi = 1; b, s_b = 0.1."""
    lead = q.shape[:-1]
    ones = lambda n: q.new_ones(lead + (n,))
    tenth = lambda n: q.new_full(lead + (n,), 0.1)
    return torch.cat([q, ones(2), ones(5), tenth(9), ones(5), tenth(9)],
                     dim=-1)


class PlanarPushAux(NamedTuple):
    h: float


def model(params: PlanarPushParams = PlanarPushParams()) -> ImplicitModel:
    def res(z, theta, kappa):
        return residual(params, z, theta, kappa)

    def theta_fn(q0, q1, u, aux: PlanarPushAux):
        h = (aux.h.to(q0) if isinstance(aux.h, torch.Tensor)
             else q0.new_full((), float(aux.h)))
        return pack_theta(q0, q1, u, h)

    return ImplicitModel(
        nq=NQ, nu=NU, nz=NZ, ntheta=NTHETA,
        residual=res,
        spec=cone_spec(),
        init_z=init_z,
        theta_fn=theta_fn,
        q_sel=tuple(range(NQ)),
        th_q0=tuple(range(5)), th_q1=tuple(range(5, 10)),
        th_u=(10, 11),
        kernel="planar_push",
        kernel_params=tuple(float(v) for v in params),
    )
