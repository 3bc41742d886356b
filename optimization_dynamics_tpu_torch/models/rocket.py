"""6-DoF rocket with implicit-midpoint dynamics and a differentiable
second-order-cone thrust projection.

Port of ``optimization_dynamics_tpu/models/rocket.py``. Two IP solves a
step, chained (the projection-in-the-dynamics construction):

  1. the thrust projection: u_hat = argmin ||u - u_bar|| subject to
     ||u_xy|| <= u_z <= u_max, a 10-variable KKT system with two orthant
     pairs and one SOC(3) group, solved from its cold start every time;
  2. the dynamics: implicit midpoint y = x + h f((x + y) / 2, u_hat), a
     12-variable equality-only system, warm-started from y = x or from
     the previous solve of the same step.

Chain rule: ``fu = dz_dyn[:, u-cols] @ dproj/du``.

State x = [position (3), MRP attitude (3), velocity (3), body rates (3)].

Every function works over the last dimension, so it takes one vector or
a batch (batch first) alike. Constants enter as Python floats, never as
tensors made with ``torch.tensor``, so a call on CUDA tensors copies
nothing from the host. The projection has a CUDA device functor,
``ops/kernels/csrc/rocket_projection.cuh`` (``projection_model()``): on
the card each projection solve runs whole in the fused IP kernel (K1),
whose wrapper takes its plain version (``make_solver_batched``'s loop
with the Newton steps through K2's plain QR) for CPU tensors; its IFT
solve goes through the batched QR kernel (K2) at (10, 4). The midpoint
solve has no functor: it runs ``make_solver_batched``, its Newton and IFT
solves through K2 at (12, 1) and (12, 16).

The yaw-rate equation divides the z-component of ``cross(w, J w)`` by
an inertia of 1e-5; that component is zero in exact arithmetic, and in
float32 its rounding is amplified 1e5-fold. ``ode`` keeps the
reference's expression and its order of operations for it.

``make_rocket_dynamics`` gives the lane-batched members (``step_batched``,
``step_jac_batched``, their warm-started variants, ``ws_init_batched``,
``project_batched`` and ``project_jac_batched``) and the scalar ``step``,
``step_jac``, ``project`` and ``project_jac``, which are the batched
members on a batch of one: on the card a scalar step runs K1 at width 1
for its projection and the midpoint solve's Newton steps in K2 at (12,
1), width 1.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from optimization_dynamics_tpu_torch.ops.cones import ConeSpec, cone_product
from optimization_dynamics_tpu_torch.ops.kernels.fused_ip import (
    make_fused_ip_solver,
)
from optimization_dynamics_tpu_torch.solver.interior_point import (
    IPOptions,
    make_sensitivity_batched,
    make_solver_batched,
)

NX, NU = 12, 3
NZ_DYN = NX
NTHETA_DYN = NX + NU + 1      # 16
NZ_PROJ = 10
NTHETA_PROJ = 4


class RocketParams(NamedTuple):
    mass: float = 1.0
    length: float = 1.0        # COM-to-thruster
    inertia: tuple = (1.0 / 12.0, 1.0 / 12.0, 1.0e-5)
    gravity: float = 9.81


def _skew(v):
    """(..., 3) -> (..., 3, 3)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def mrp_rotation(p):
    """Rotation matrix (..., 3, 3) of Modified Rodrigues Parameters
    (..., 3): ``I + (4 (1 - p.p) S + 8 S S) / (1 + p.p)^2``, S = skew(p)."""
    pp = _dot(p, p)[..., None, None]
    S = _skew(p)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    return eye + (4.0 * (1.0 - pp) * S + 8.0 * S @ S) / (1.0 + pp) ** 2


def ode(params: RocketParams, x, u):
    """Continuous dynamics ``[v, rdot, vdot, wdot]`` (..., 12)."""
    r = x[..., 3:6]
    v = x[..., 6:9]
    w = x[..., 9:12]
    J = params.inertia
    zero = torch.zeros_like(u[..., 0])
    tau = torch.stack([params.length * u[..., 1],
                       -params.length * u[..., 0], zero], dim=-1)
    Jw = torch.stack([J[0] * w[..., 0], J[1] * w[..., 1], J[2] * w[..., 2]],
                     dim=-1)
    rdot = 0.25 * ((1.0 - _dot(r, r))[..., None] * w
                   - 2.0 * torch.linalg.cross(w, r, dim=-1)
                   + 2.0 * _dot(w, r)[..., None] * r)
    g = torch.stack([zero, zero, zero - params.gravity], dim=-1)
    vdot = g + (mrp_rotation(r) @ u[..., 0:3, None])[..., 0] / params.mass
    num = tau - torch.linalg.cross(w, Jw, dim=-1)
    wdot = torch.stack([num[..., 0] / J[0], num[..., 1] / J[1],
                        num[..., 2] / J[2]], dim=-1)
    return torch.cat([v, rdot, vdot, wdot], dim=-1)


# ---------------------------------------------------------------------------
# implicit-midpoint dynamics residual (equality-only)


def residual_dyn(params: RocketParams, z, theta, kappa):
    """``y - x - h f((x + y) / 2, u)``; theta = [x (12), u (3), h]."""
    del kappa
    y = z
    x = theta[..., 0:NX]
    u = theta[..., NX:NX + NU]
    h = theta[..., NX + NU:NX + NU + 1]
    return y - x - h * ode(params, 0.5 * (x + y), u)


def cone_spec_dyn() -> ConeSpec:
    return ConeSpec(nz=NZ_DYN, ntheta=NTHETA_DYN,
                    eq_rows=tuple(range(NZ_DYN)))


# ---------------------------------------------------------------------------
# thrust-cone projection residual


def residual_proj(z, theta, kappa):
    """KKT of min ||u - u_bar|| s.t. ||u_xy|| <= u_z, u_z <= u_max.
    z = [u (3), p, s, w, y, v (3)]; theta = [u_bar (3), u_max]."""
    u = z[..., 0:3]
    p = z[..., 3]
    s = z[..., 4]
    w = z[..., 5]
    y = z[..., 6]
    v = z[..., 7:10]
    u_bar = theta[..., 0:3]
    u_max = theta[..., 3]

    d = u - u_bar - v
    kap = kappa * torch.ones_like(p)
    zero = torch.zeros_like(p)
    # the cone axis first: [u3, u1, u2] and [v3, v1, v2]
    axis_first = lambda a: torch.stack([a[..., 2], a[..., 0], a[..., 1]],
                                       dim=-1)
    return torch.cat([
        d[..., 0:2],
        (d[..., 2] - (y + p))[..., None],
        torch.stack([u_max - u[..., 2] - s,
                     -y - w,
                     w * s - kap,
                     p * u[..., 2] - kap], dim=-1),
        cone_product(axis_first(u), axis_first(v))
        - torch.stack([kap, zero, zero], dim=-1),
    ], dim=-1)


def cone_spec_proj() -> ConeSpec:
    """Orthant pairs (s, w), (u_z, p); one SOC(3) of u and v, axis
    first."""
    return ConeSpec(
        nz=NZ_PROJ, ntheta=NTHETA_PROJ,
        eq_rows=(0, 1, 2, 3, 4),
        ort_prim=(4, 2), ort_dual=(5, 3), ort_rows=(5, 6),
        soc_prim=((2, 0, 1),), soc_dual=((9, 7, 8),),
        soc_rows=((7, 8, 9),),
    )


def init_z_proj(device, dtype):
    """The projection's cold start (10,): every entry 0.1, the cone axes
    1.1, y = 0."""
    z = torch.full((NZ_PROJ,), 0.1, dtype=dtype, device=device)
    z[2] += 1.0
    z[9] += 1.0
    z[6] = 0.0
    return z


class ProjectionModel(NamedTuple):
    """What the fused IP solver reads of the thrust projection: its
    residual and cone spec (the plain version's) and its device functor
    with its constants (none: u_max arrives in theta)."""

    residual: Callable
    spec: ConeSpec
    kernel: str = "rocket_projection"
    kernel_params: tuple = ()


def projection_model() -> ProjectionModel:
    return ProjectionModel(residual=residual_proj, spec=cone_spec_proj())


# ---------------------------------------------------------------------------
# assembled lane-batched rocket dynamics


class RocketDynamics(NamedTuple):
    """The scalar and lane-batched members. The projection always starts
    cold; the dynamics from y = x (``ws_init_batched``) or from the
    threaded ws, and the warm-started members return ys as the next ws."""

    step: Callable                  # (x, u) -> y
    step_jac: Callable              # (x, u) -> (y, fx, fu)
    project: Callable               # (u,) -> u_hat
    project_jac: Callable           # (u,) -> (u_hat, du_hat/du)
    step_batched: Callable          # (xs, us) -> ys
    step_jac_batched: Callable      # (xs, us) -> (ys, fxs, fus)
    step_batched_ws: Callable       # (xs, us, zs) -> (ys, zs')
    step_jac_batched_ws: Callable   # (xs, us, zs) -> (ys, fxs, fus, zs')
    ws_init_batched: Callable       # (xs,) -> zs
    project_batched: Callable       # (us,) -> u_hats
    project_jac_batched: Callable   # (us,) -> (u_hats, du_hat/du)


def make_rocket_dynamics(params: RocketParams = RocketParams(),
                         u_max: float = 12.5, h: float = 0.05,
                         projection: bool = True, r_tol: float = 1.0e-8,
                         proj_kappa_tol: float = 1.0e-4, device="cuda",
                         dtype=torch.float64) -> RocketDynamics:
    """The (optionally projected) implicit-midpoint stepper on ``device``
    in ``dtype``: the dynamics solved as an equality-only Newton system,
    the projection from its cold start to ``proj_kappa_tol`` in the fused
    IP kernel (K1; its plain version on CPU tensors), IFT gradients at
    the relaxed point."""
    device = torch.device(device)

    def dyn_res(z, th, kappa):
        return residual_dyn(params, z, th, kappa)

    dyn_solve = make_solver_batched(
        dyn_res, cone_spec_dyn(), IPOptions(r_tol=r_tol, kappa_tol=1.0),
        device, dtype)
    dyn_sens = make_sensitivity_batched(dyn_res, cone_spec_dyn())
    proj_solve = make_fused_ip_solver(
        projection_model(), IPOptions(r_tol=r_tol, kappa_tol=proj_kappa_tol),
        device, dtype)
    proj_sens = make_sensitivity_batched(residual_proj, cone_spec_proj())
    z0_proj = init_z_proj(device, dtype)

    def _project(us):
        thetas = torch.cat([us, us.new_full((us.shape[0], 1), u_max)],
                           dim=1)
        z0s = z0_proj.expand(us.shape[0], NZ_PROJ)
        return proj_solve(z0s, thetas), thetas

    def project_batched(us):
        return _project(us)[0].z[:, 0:3]

    def project_jac_batched(us):
        sol, thetas = _project(us)
        return sol.z[:, 0:3], proj_sens(sol.z, thetas)[:, 0:3, 0:3]

    def _dyn(xs, u_hats, z0s):
        thetas = torch.cat([xs, u_hats, xs.new_full((xs.shape[0], 1), h)],
                           dim=1)
        return dyn_solve(z0s, thetas).z, thetas

    def _u_hats(us):
        return project_batched(us) if projection else us

    def step_batched(xs, us):
        return _dyn(xs, _u_hats(us), xs)[0]

    def step_batched_ws(xs, us, zs):
        ys = _dyn(xs, _u_hats(us), zs)[0]
        return ys, ys

    def _jac(xs, us, z0s):
        if projection:
            u_hats, dprojs = project_jac_batched(us)
        else:
            u_hats = us
        ys, thetas = _dyn(xs, u_hats, z0s)
        dzs = dyn_sens(ys, thetas)
        fxs = dzs[:, :, 0:NX]
        fus = dzs[:, :, NX:NX + NU]
        if projection:
            fus = torch.einsum("biu,buv->biv", fus, dprojs)
        return ys, fxs, fus

    def step_jac_batched(xs, us):
        return _jac(xs, us, xs)

    def step_jac_batched_ws(xs, us, zs):
        ys, fxs, fus = _jac(xs, us, zs)
        return ys, fxs, fus, ys

    def ws_init_batched(xs):
        return xs                 # warm start y = x

    # the scalar members: the batched ones on a batch of one
    def step(x, u):
        return step_batched(x[None], u[None])[0]

    def step_jac(x, u):
        return tuple(a[0] for a in step_jac_batched(x[None], u[None]))

    def project(u):
        return project_batched(u[None])[0]

    def project_jac(u):
        return tuple(a[0] for a in project_jac_batched(u[None]))

    return RocketDynamics(step=step, step_jac=step_jac, project=project,
                          project_jac=project_jac,
                          step_batched=step_batched,
                          step_jac_batched=step_jac_batched,
                          step_batched_ws=step_batched_ws,
                          step_jac_batched_ws=step_jac_batched_ws,
                          ws_init_batched=ws_init_batched,
                          project_batched=project_batched,
                          project_jac_batched=project_jac_batched)
