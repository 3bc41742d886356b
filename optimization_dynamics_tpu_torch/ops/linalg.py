"""Linear-solve entry point of the batched interior-point solver.

Port of ``optimization_dynamics_tpu/ops/linalg.py::batched_newton_solve``.
The reference routes to its Pallas QR kernel only under
``use_pallas_solver(True)``; here the batched QR (K2) is the one path:
its kernel for CUDA tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
)

__all__ = ["batched_newton_solve"]


def batched_newton_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a stack of systems: A (B, n, n), b (B, n, k) -> (B, n, k)."""
    return batched_solve(A, b)
