"""Cone algebra for the interior-point solver.

Port of ``optimization_dynamics_tpu/ops/cones.py``. The variable space of
each implicit-dynamics solve is partitioned into free (equality-only)
variables, nonnegative-orthant primal/dual pairs ``(y_i, s_i)`` with
``y_i * s_i = kappa``, and second-order-cone (SOC) groups ``(p, d)`` with
the Jordan-algebra complementarity ``p ∘ d = kappa * e``.

Every function works over the last dimension of its inputs, so it takes
one vector or a batch of them (batch first) alike, and is branch-free on
tensor values (``torch.func.jacfwd`` differentiates it); masks and index
tables are built on the input's device and dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = [
    "ConeSpec",
    "cone_product",
    "delta_products",
    "soc_step_to_boundary",
    "orthant_step_to_boundary",
    "step_to_boundary",
    "interior_init",
]

_BIG = 1e12


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Static index bundle describing the cone structure of one problem.

    Indices are 0-based. ``ort_prim[i]`` pairs with ``ort_dual[i]``.
    ``soc_prim[g]``/``soc_dual[g]`` are the variable indices of SOC group
    ``g`` (first entry is the cone axis, ``p0 >= |p1:|``). ``eq_rows`` /
    ``ort_rows`` / ``soc_rows`` partition the residual rows into equality
    rows and bilinear (complementarity) rows.
    """

    nz: int
    ntheta: int
    eq_rows: Tuple[int, ...] = ()
    ort_prim: Tuple[int, ...] = ()
    ort_dual: Tuple[int, ...] = ()
    ort_rows: Tuple[int, ...] = ()
    soc_prim: Tuple[Tuple[int, ...], ...] = ()
    soc_dual: Tuple[Tuple[int, ...], ...] = ()
    soc_rows: Tuple[Tuple[int, ...], ...] = ()

    @property
    def bil_rows(self) -> Tuple[int, ...]:
        rows = tuple(self.ort_rows)
        for g in self.soc_rows:
            rows = rows + tuple(g)
        return rows

    @property
    def num_cone_vars(self) -> int:
        n = 2 * len(self.ort_prim)
        for g in self.soc_prim:
            n += 2 * len(g)
        return n

    def validate(self) -> None:
        if not (len(self.ort_prim) == len(self.ort_dual)
                == len(self.ort_rows)):
            raise ValueError("orthant prim/dual/rows lengths differ")
        if not (len(self.soc_prim) == len(self.soc_dual)
                == len(self.soc_rows)):
            raise ValueError("SOC prim/dual/rows group counts differ")
        for p, d, r in zip(self.soc_prim, self.soc_dual, self.soc_rows):
            if not len(p) == len(d) == len(r):
                raise ValueError("SOC group sizes differ")
        all_rows = list(self.eq_rows) + list(self.bil_rows)
        if sorted(all_rows) != list(range(self.nz)):
            raise ValueError("residual rows must partition 0..nz-1")


def _idx(idx, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(list(idx), dtype=torch.long, device=like.device)


def cone_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Jordan-algebra product ``a ∘ b = [aᵀ b; a0 b[1:] + b0 a[1:]]`` over
    the last dimension."""
    head = torch.sum(a * b, dim=-1, keepdim=True)
    tail = a[..., :1] * b[..., 1:] + b[..., :1] * a[..., 1:]
    return torch.cat([head, tail], dim=-1)


def delta_products(spec: ConeSpec, d: torch.Tensor) -> torch.Tensor:
    """``Δw ∘ Δλ`` of a Newton direction on the bilinear rows, zeros
    elsewhere: the second-order term of the complementarity rows."""
    rows = [torch.zeros_like(d[..., 0])] * spec.nz
    for p, q, r in zip(spec.ort_prim, spec.ort_dual, spec.ort_rows):
        rows[r] = d[..., p] * d[..., q]
    for prim, dual, grp in zip(spec.soc_prim, spec.soc_dual,
                               spec.soc_rows):
        prod = cone_product(d[..., _idx(prim, d)], d[..., _idx(dual, d)])
        for j, r in enumerate(grp):
            rows[r] = prod[..., j]
    return torch.stack(rows, dim=-1)


def _pos_root_step(z0, z1, d0, d1):
    """Largest alpha in [0, BIG] with ``z - alpha d`` in the SOC: the
    smallest positive root of ``A a^2 + B a + C = 0`` (``A = d0^2 -
    d1.d1``, ``B = -2 (z0 d0 - z1.d1)``, ``C = z0^2 - z1.z1``), capped by
    the axis bound ``z0 - a d0 >= 0``. ``z1``/``d1`` carry the cone tail
    in their last dimension."""
    A = d0 * d0 - torch.sum(d1 * d1, dim=-1)
    B = -2.0 * (z0 * d0 - torch.sum(z1 * d1, dim=-1))
    C = z0 * z0 - torch.sum(z1 * z1, dim=-1)
    big = torch.full_like(z0, _BIG)
    one = torch.ones_like(z0)

    a_axis = torch.where(d0 > 0, z0 / torch.where(d0 > 0, d0, one), big)

    disc = B * B - 4.0 * A * C
    sqrt_disc = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_A = torch.where(torch.abs(A) > 1e-30, A, one)
    r1 = (-B - sqrt_disc) / (2.0 * safe_A)
    r2 = (-B + sqrt_disc) / (2.0 * safe_A)
    lo = torch.minimum(r1, r2)
    hi = torch.maximum(r1, r2)
    quad_root = torch.where(lo > 0, lo, torch.where(hi > 0, hi, big))
    lin_root = torch.where(
        torch.abs(B) > 1e-30, -C / torch.where(torch.abs(B) > 1e-30, B, one),
        big)
    lin_root = torch.where(lin_root > 0, lin_root, big)
    root = torch.where(torch.abs(A) > 1e-30, quad_root, lin_root)
    root = torch.where(disc >= 0, root, big)
    return torch.minimum(root, a_axis)


def soc_step_to_boundary(z_g: torch.Tensor, d_g: torch.Tensor
                         ) -> torch.Tensor:
    """Max step alpha so that ``z_g - alpha * d_g`` stays in the SOC (the
    cone over the last dimension)."""
    return _pos_root_step(z_g[..., 0], z_g[..., 1:], d_g[..., 0],
                          d_g[..., 1:])


def orthant_step_to_boundary(z_o: torch.Tensor, d_o: torch.Tensor
                             ) -> torch.Tensor:
    """Max step alpha so that ``z_o - alpha * d_o`` stays elementwise
    >= 0 (over the last dimension)."""
    if z_o.shape[-1] == 0:
        return torch.full(z_o.shape[:-1], _BIG, dtype=z_o.dtype,
                          device=z_o.device)
    ratio = torch.where(d_o > 0,
                        z_o / torch.where(d_o > 0, d_o, torch.ones_like(d_o)),
                        torch.full_like(z_o, _BIG))
    return torch.amin(ratio, dim=-1)


def step_to_boundary(spec: ConeSpec, z: torch.Tensor, d: torch.Tensor,
                     tau: float = 0.99) -> torch.Tensor:
    """Fraction-to-boundary step ``min(1, tau * alpha_max)`` for the update
    ``z_new = z - alpha * d``: ``alpha_max`` keeps every orthant pair
    positive and every SOC group in its cone."""
    alpha = torch.full_like(z[..., 0], _BIG)
    ort_idx = list(spec.ort_prim) + list(spec.ort_dual)
    if ort_idx:
        i = _idx(ort_idx, z)
        alpha = torch.minimum(alpha, orthant_step_to_boundary(z[..., i],
                                                              d[..., i]))
    for prim, dual in zip(spec.soc_prim, spec.soc_dual):
        p = _idx(prim, z)
        q = _idx(dual, z)
        alpha = torch.minimum(alpha, soc_step_to_boundary(z[..., p],
                                                          d[..., p]))
        alpha = torch.minimum(alpha, soc_step_to_boundary(z[..., q],
                                                          d[..., q]))
    return torch.clamp_max(tau * alpha, 1.0)


def interior_init(spec: ConeSpec, z: torch.Tensor,
                  ort_val: float = 1.0, soc_axis: float = 1.0,
                  soc_tail: float = 0.1) -> torch.Tensor:
    """Push the cone variables of ``z`` to a strictly interior point."""
    mask = [False] * spec.nz
    tmpl = [0.0] * spec.nz
    for i in list(spec.ort_prim) + list(spec.ort_dual):
        mask[i], tmpl[i] = True, ort_val
    for grp in list(spec.soc_prim) + list(spec.soc_dual):
        mask[grp[0]], tmpl[grp[0]] = True, soc_axis
        for i in grp[1:]:
            mask[i], tmpl[i] = True, soc_tail
    m = torch.as_tensor(mask, device=z.device)
    t = torch.as_tensor(tmpl, dtype=z.dtype, device=z.device)
    return torch.where(m, t, z)
