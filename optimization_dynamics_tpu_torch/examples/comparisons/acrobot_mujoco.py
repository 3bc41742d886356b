"""Comparison oracle: acrobot swing-up via MuJoCo + finite differences.

Port of ``optimization_dynamics_tpu/examples/comparisons/acrobot_mujoco.py``:
the same swing-up solved with a general-purpose simulator (MuJoCo's soft
joint limits) and central-difference Jacobians feeding the same scalar
AL-iLQR (``solver/ilqr.py::solve``). The paper uses it to show where
smooth, soft-contact gradients struggle against the relaxed-IFT
gradients of optimization-based dynamics.

MuJoCo is host-side C: each step and each FD Jacobian runs on the host
in numpy (the reference enters it through ``jax.pure_callback``), while
the solver's tensors live on ``--device`` (default ``cuda``). It is a
baseline, not a fast path, and no kernel of the port runs in it. It
needs the ``mujoco`` package, which the card's machine lacks: there the
import fails with a message naming the package, so in practice this
runs with ``--device cpu``.

``mjData`` carries warm-start state (``qacc_warmstart``) from one
``mj_step`` to the next, so two simulators agree bit for bit only from
fresh instances and the same sequence of calls.

The initial controls are ``1e-3 N(0, 1)`` from numpy seed 1 (the
reference draws them with ``jax.random``); ``us_init`` takes others.

Usage:

    python -m optimization_dynamics_tpu_torch.examples.comparisons.acrobot_mujoco \\
        --device cpu [--study [--save PATH]]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    solve,
)

H = 0.05
T = 101
NQ, NU = 2, 1
NX = 2 * NQ

_XML = f"""
<mujoco>
  <option timestep="{H}" integrator="implicitfast" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="upper" pos="0 0 0">
      <joint name="shoulder" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0 0 -1" size="0.05" mass="1"/>
      <body name="lower" pos="0 0 -1">
        <joint name="elbow" type="hinge" axis="0 1 0" limited="true"
               range="-90 90"/>
        <geom type="capsule" fromto="0 0 0 0 0 -1" size="0.05" mass="1"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="elbow" gear="1"/></actuator>
</mujoco>
"""


def _import_mujoco():
    try:
        import mujoco
    except ImportError as e:
        raise ImportError(
            "acrobot_mujoco needs the 'mujoco' Python package, which is "
            "not installed here") from e
    return mujoco


class MuJoCoAcrobot:
    """Host-side stepper with central-difference Jacobians (the Julia
    package's ``comparisons/acrobot/mujoco_model.jl:62-74`` pattern).
    ``step``/``step_jac`` take and return tensors on the caller's device
    and dtype; the ``*_batched`` members run a batch's rows in order."""

    def __init__(self, eps: float = 1.0e-6):
        mujoco = _import_mujoco()
        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(_XML)
        self.data = mujoco.MjData(self.model)
        self.eps = eps

    def _step_np(self, x, u):
        mujoco, m, d = self._mujoco, self.model, self.data
        d.qpos[:] = x[:NQ]
        d.qvel[:] = x[NQ:]
        d.ctrl[:] = u
        mujoco.mj_step(m, d)
        return np.concatenate([d.qpos, d.qvel]).astype(x.dtype)

    def _jac_np(self, x, u):
        y0 = self._step_np(x, u)
        fx = np.zeros((NX, NX), x.dtype)
        fu = np.zeros((NX, NU), x.dtype)
        for j in range(NX):
            xp = x.copy(); xp[j] += self.eps
            xm = x.copy(); xm[j] -= self.eps
            fx[:, j] = (self._step_np(xp, u)
                        - self._step_np(xm, u)) / (2 * self.eps)
        for j in range(NU):
            up = u.copy(); up[j] += self.eps
            um = u.copy(); um[j] -= self.eps
            fu[:, j] = (self._step_np(x, up)
                        - self._step_np(x, um)) / (2 * self.eps)
        return y0, fx, fu

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        y = self._step_np(self._host(x), self._host(u))
        return torch.as_tensor(y, dtype=x.dtype, device=x.device)

    def step_jac(self, x: torch.Tensor, u: torch.Tensor):
        out = self._jac_np(self._host(x), self._host(u))
        return tuple(torch.as_tensor(a, dtype=x.dtype, device=x.device)
                     for a in out)

    def step_batched(self, xs: torch.Tensor, us: torch.Tensor):
        xh, uh = self._host(xs), self._host(us)
        ys = np.stack([self._step_np(xh[i], uh[i])
                       for i in range(xh.shape[0])])
        return torch.as_tensor(ys, dtype=xs.dtype, device=xs.device)

    def step_jac_batched(self, xs: torch.Tensor, us: torch.Tensor):
        xh, uh = self._host(xs), self._host(us)
        outs = [self._jac_np(xh[i], uh[i]) for i in range(xh.shape[0])]
        return tuple(torch.as_tensor(np.stack(a), dtype=xs.dtype,
                                     device=xs.device)
                     for a in zip(*outs))


def build_problem(dtype=torch.float64, T: int = T, device="cuda",
                  us_init=None, seed: int = 1):
    """Returns (prob, x0, us_init, opts): the swing-up from rest to the
    upright state through ``MuJoCoAcrobot``, the derivative sweep's T-1
    Jacobians one after another on the host. ``us_init`` (T-1, 1), else
    ``1e-3 N(0, 1)`` from numpy ``seed``."""
    device = torch.device(device)
    sim = MuJoCoAcrobot()
    xT = torch.tensor([np.pi, 0.0, 0.0, 0.0], dtype=dtype,
                      device=device)   # velocity-state form

    def stage_cost(t, x, u):
        v = x[NQ:]
        return 0.5 * 0.1 * v @ v + 0.5 * u @ u

    def terminal_cost(x):
        v = x[NQ:]
        return 0.5 * 0.1 * v @ v

    prob = ILQRProblem(
        T=T, nx=NX, nu=NU, ncon=0, nconT=NX,
        dynamics=lambda t, x, u: sim.step(x, u),
        dynamics_jac=lambda t, x, u: sim.step_jac(x, u),
        dynamics_batched=lambda t, xs, us: sim.step_batched(xs, us),
        dynamics_jac_batched=lambda ts, xs, us: sim.step_jac_batched(xs, us),
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        terminal_con=lambda x: x - xT,
    )
    opts = ILQROptions(
        obj_tol=1.0e-5, grad_tol=1.0e-5, max_iter=50, max_al_iter=20,
        con_tol=0.001)
    x0 = torch.zeros(NX, dtype=dtype, device=device)
    if us_init is None:
        us_init = 1.0e-3 * np.random.default_rng(seed).standard_normal(
            (T - 1, NU))
    us0 = torch.as_tensor(np.array(us_init), dtype=dtype, device=device)
    return prob, x0, us0, opts


def run(device="cuda", us_init=None):
    prob, x0, us0, opts = build_problem(device=device, us_init=us_init)
    return prob, solve(prob, x0, us0, opts)


def study(artifact_path: str | None = None, device="cuda", us_init=None):
    """The paper's comparison study (the Julia package's
    ``examples/comparisons/acrobot/acrobot.jl:93-102``): the full T=101
    swing-up through MuJoCo soft limits and FD Jacobians, recording
    whether the smooth-gradient path converges. ``artifact_path``: write
    the outcome there as JSON (the reference's committed outcome is
    ``docs/mujoco_study.json``: stuck, the elbow limit violated)."""
    _, res = run(device, us_init)
    xs = res.xs.cpu().numpy()
    out = {
        "study": "acrobot swing-up via MuJoCo soft limits + FD Jacobians",
        "reference": "examples/comparisons/acrobot/acrobot.jl:93-102",
        "T": T, "h": H, "con_tol": 0.001,
        "converged": bool(res.converged),
        "objective": float(res.objective),
        "constraint_violation": float(res.constraint_violation),
        "iterations": int(res.iterations),
        "al_iterations": int(res.al_iterations),
        "gradient_norm": float(res.gradient_norm),
        "max_abs_elbow": float(np.abs(xs[:, 1]).max()),
        "elbow_hard_limit": float(np.pi / 2),
        "xT": xs[-1].tolist(),
    }
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--study", action="store_true",
                    help="record the study's outcome")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="with --study: write the outcome to PATH (JSON)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.save and not args.study:
        ap.error("--save needs --study")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("acrobot_mujoco: no CUDA device; pass --device cpu")
    _import_mujoco()
    if args.study:
        out = study(artifact_path=args.save, device=device)
        print({k: v for k, v in out.items() if k != "xT"})
        return out
    _, res = run(device)
    print("converged:", bool(res.converged),
          "obj:", float(res.objective),
          "vio:", float(res.constraint_violation),
          "iters:", int(res.iterations))
    return res


if __name__ == "__main__":
    main()
