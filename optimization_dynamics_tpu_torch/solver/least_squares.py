"""Gauss-Newton least-squares fitter.

Port of ``optimization_dynamics_tpu/solver/least_squares.py``: fit the
parameters ``theta`` minimising ``sum_i ||r(theta; sample_i)||^2`` by
Newton steps on the total cost, with the reference's semantics: stop
when ``max|grad| <= tol`` (1e-8) or after ``max_iter`` (100) steps,
optional absolute ``damping`` on the Hessian. The sample sum is a
``torch.func.vmap`` over the samples' leading dimension, the gradient
and Hessian come from ``torch.func.grad`` and ``torch.func.hessian``,
and the Newton loop is a host loop (the reference's ``lax.while_loop``).

The gradient bundle's linear fit has a closed form
(``solver/gradient_bundle.py``); this is the general nonlinear tool, and
the bundle's ``fitter="gauss_newton"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, vmap

__all__ = ["LSResult", "fit"]


class LSResult(NamedTuple):
    theta: torch.Tensor
    iterations: int
    grad_norm: torch.Tensor
    converged: bool


def fit(residual_fn: Callable, theta0: torch.Tensor, samples,
        tol: float = 1.0e-8, max_iter: int = 100,
        damping: float = 0.0) -> LSResult:
    """Minimise ``sum_i ||residual_fn(theta, sample_i)||^2``.

    ``samples`` is a tensor or a tuple of tensors, each with a leading
    sample dimension."""

    def total_cost(theta):
        r = vmap(lambda s: residual_fn(theta, s))(samples)
        return torch.sum(r * r)

    grad_fn = grad(total_cost)
    hess_fn = hessian(total_cost)
    eye = torch.eye(theta0.shape[0], dtype=theta0.dtype,
                    device=theta0.device)

    theta = theta0
    gnorm = grad_fn(theta).abs().max()
    it = 0
    while it < max_iter and float(gnorm) > tol:
        H = hess_fn(theta)
        if damping > 0.0:
            H = H + damping * eye
        theta = theta - torch.linalg.solve(H, grad_fn(theta))
        it += 1
        gnorm = grad_fn(theta).abs().max()
    return LSResult(theta=theta, iterations=it, grad_norm=gnorm,
                    converged=float(gnorm) <= tol)
