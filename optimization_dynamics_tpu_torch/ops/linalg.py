"""Linear-solve entry points of the interior-point solvers.

Port of ``optimization_dynamics_tpu/ops/linalg.py``. The reference solves
with XLA's LU and routes to its Pallas QR kernel only under
``use_pallas_solver(True)``; here the batched QR (K2) is the one path:
its kernel for CUDA tensors, its plain version for CPU tensors. So the
port has no ``use_pallas_solver``: there is no second path to switch to.
"""

from __future__ import annotations

import torch

from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
)

__all__ = ["newton_solve", "batched_newton_solve"]


def newton_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for one (n, n) system and b (n,): K2 on a batch of
    one, at (n, 1) (on the card the route ``_build.batched_solve_route``
    picks for that shape)."""
    return batched_solve(A[None], b[None, :, None])[0, :, 0]


def batched_newton_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a stack of systems: A (B, n, n), b (B, n, k) -> (B, n, k)."""
    return batched_solve(A, b)
