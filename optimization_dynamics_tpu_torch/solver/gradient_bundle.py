"""Gradient bundle: sampled Jacobians of the implicit dynamics.

Port of ``optimization_dynamics_tpu/solver/gradient_bundle.py``, the
paper's sampled alternative to the relaxed-IFT gradients: perturb the
inputs ``(q1, q2, u)`` by ``N`` single-coordinate perturbations ``eta``,
run the N perturbed steps beside the unperturbed one, and fit the linear
model ``f(eta) ~ f(0) + M eta`` by least squares; ``M`` gives fx and fu.

The draws are data, not a key: ``draws = (coords, mags)``, the input
coordinate each sample perturbs and its size (``GradientBundle.sample``
draws them from a numpy generator, ``mags = eps N(0, 1)``, as the
reference does from its ``jax.random`` key). The horizon-batched
``gb_jac_batched`` sends every lane's unperturbed step and its N
perturbed steps to one ``dyn.step_batched`` call, B (N + 1) IP solves in
one launch of the model's fused IP kernel on the card.

``fitter="lstsq"``: every ``eta`` has one nonzero entry, so
``etas^T etas`` is diagonal and the least-squares fit is the closed form
``M[:, j] = sum_{i: c_i = j} m_i dF_i / sum_{i: c_i = j} m_i^2``, and 0
for a coordinate no sample perturbs: the minimum-norm fit, which the
reference's ``jnp.linalg.lstsq`` returns (a solver that assumes full
rank would not). ``fitter="gauss_newton"`` runs
``solver/least_squares.fit`` on the same linear model, lane by lane, as
the reference's does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from optimization_dynamics_tpu_torch.dynamics import ImplicitDynamics
from optimization_dynamics_tpu_torch.solver import least_squares

__all__ = ["GradientBundle", "make_gradient_bundle", "bundle_inputs",
           "fit_lstsq"]


class GradientBundle(NamedTuple):
    """``gb_jac(x, u, aux, draws) -> (y, fx, fu)`` with ``draws`` (N,)
    each; ``gb_jac_batched(xs, us, aux, draws) -> (ys, fxs, fus)`` with
    ``draws`` (B, N) each; ``sample(rng, shape, device, dtype)`` the
    draws ``shape + (N,)`` from a ``numpy.random.Generator``."""

    gb_jac: Callable
    gb_jac_batched: Callable
    sample: Callable


def bundle_inputs(xs, us, draws, nq: int):
    """The bundle's step inputs: ``(xs_all, us_all, etas)``, each lane's
    unperturbed input first and its N perturbed ones after it, flattened
    to B (N + 1) lanes; ``etas`` (B, N, 2 nq + nu)."""
    coords, mags = draws
    B, N = coords.shape
    nx, nu = xs.shape[1], us.shape[1]
    etas = torch.zeros((B, N, nx + nu), dtype=xs.dtype, device=xs.device)
    etas.scatter_(2, coords[..., None], mags[..., None].to(xs.dtype))
    xs_all = torch.cat([xs[:, None], xs[:, None] + etas[..., :2 * nq]], 1)
    us_all = torch.cat([us[:, None], us[:, None] + etas[..., 2 * nq:]], 1)
    return xs_all.reshape(-1, nx), us_all.reshape(-1, nu), etas


def fit_lstsq(etas, dF):
    """The minimum-norm least-squares ``M`` (B, nq, n_in) of ``etas @ M^T
    ~ dF`` for single-coordinate ``etas`` (B, N, n_in), ``dF`` (B, N,
    nq): the normal equations with their diagonal Gram matrix, a zero
    column where no sample falls."""
    num = dF.transpose(1, 2) @ etas                  # (B, nq, n_in)
    den = torch.sum(etas * etas, dim=1)[:, None]     # (B, 1, n_in)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def make_gradient_bundle(dyn: ImplicitDynamics, n_samples: int = 100,
                         eps: float = 1.0e-4,
                         fitter: str = "lstsq") -> GradientBundle:
    """The bundle of ``n_samples`` perturbations of size ``eps N(0, 1)``
    on uniformly chosen coordinates of ``(q1, q2, u)`` (the reference's
    sampling scheme). ``fitter``: "lstsq" (the closed form) or
    "gauss_newton"."""
    if fitter not in ("lstsq", "gauss_newton"):
        raise ValueError(f"unknown fitter {fitter!r}")
    nq, nu = dyn.model.nq, dyn.model.nu
    n_in = 2 * nq + nu

    def sample(rng: np.random.Generator, shape=(), device="cpu",
               dtype=torch.float64):
        shape = tuple(shape) + (n_samples,)
        coords = rng.integers(0, n_in, shape)
        mags = eps * rng.standard_normal(shape)
        return (torch.as_tensor(coords, dtype=torch.int64, device=device),
                torch.as_tensor(mags, dtype=dtype, device=device))

    def fit_gauss_newton(etas, dF):
        def resid(theta, s):
            eta_i, df_i = s
            return df_i - theta.reshape(nq, n_in) @ eta_i

        # no damping: the model is linear in vec(M) and its normal matrix
        # scales like eps^2, so any absolute damping would bias the fit
        theta0 = etas.new_zeros(nq * n_in)
        return torch.stack([
            least_squares.fit(resid, theta0, (e, d)).theta.reshape(nq, n_in)
            for e, d in zip(etas, dF)])

    fit = fit_lstsq if fitter == "lstsq" else fit_gauss_newton

    def gb_jac_batched(xs, us, aux, draws):
        """One step and its sampled Jacobians for each of B lanes."""
        B = xs.shape[0]
        xs_all, us_all, etas = bundle_inputs(xs, us, draws, nq)
        ys = dyn.step_batched(xs_all, us_all, aux).reshape(B, n_samples + 1,
                                                           2 * nq)
        dF = ys[:, 1:, nq:] - ys[:, :1, nq:]          # (B, N, nq)
        M = fit(etas, dF)                              # (B, nq, n_in)
        eye = torch.eye(nq, dtype=xs.dtype, device=xs.device).expand(
            B, nq, nq)
        zero = xs.new_zeros((B, nq, nq))
        fxs = torch.cat([torch.cat([zero, eye], 2),
                         torch.cat([M[:, :, :nq], M[:, :, nq:2 * nq]], 2)],
                        1)
        fus = torch.cat([xs.new_zeros((B, nq, nu)), M[:, :, 2 * nq:]], 1)
        return ys[:, 0], fxs, fus

    def gb_jac(x, u, aux, draws):
        """``gb_jac_batched`` on a batch of one."""
        coords, mags = draws
        return tuple(a[0] for a in gb_jac_batched(
            x[None], u[None], aux, (coords[None], mags[None])))

    return GradientBundle(gb_jac=gb_jac, gb_jac_batched=gb_jac_batched,
                          sample=sample)
