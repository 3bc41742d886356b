"""optimization_dynamics_tpu_torch — the PyTorch + CUDA port of
``optimization_dynamics_tpu``.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's layout and names, and the parity tests
(``tests/test_torch_*.py``) feed the same inputs through both. Vectors
are tensors with the batch dimension first. The hand-written Hopper
kernels live in ``ops/kernels``: a CUDA tensor goes through its kernel
(or raises), a CPU tensor through the kernel's plain PyTorch version.

The port covers the reference's five contact models and their cone
specs, the interior-point solvers with their IFT sensitivities, the
implicit dynamics, the scalar and lane-batched AL-iLQR solvers (the
lockstep ``solve_batched`` and the segmented executor with all its
options), the gradient bundle, least squares, the direct solver, the
examples and their tooling. The top-level names are the reference's.
"""

from optimization_dynamics_tpu_torch.dynamics import (
    ImplicitDynamics,
    ImplicitModel,
    make_implicit_dynamics,
    simulate,
    state_to_configuration,
)
from optimization_dynamics_tpu_torch.ops.cones import ConeSpec, cone_product
from optimization_dynamics_tpu_torch.solver.ilqr import (
    ILQROptions,
    ILQRProblem,
    ILQRResult,
)
from optimization_dynamics_tpu_torch.solver.ilqr import rollout as ilqr_rollout
from optimization_dynamics_tpu_torch.solver.ilqr import solve as ilqr_solve
from optimization_dynamics_tpu_torch.solver.interior_point import (
    IPOptions,
    IPSolution,
    make_sensitivity,
    make_solver,
)

__version__ = "0.1.0"

__all__ = [
    "ImplicitDynamics", "ImplicitModel", "make_implicit_dynamics",
    "simulate", "state_to_configuration",
    "ConeSpec", "cone_product",
    "ILQROptions", "ILQRProblem", "ILQRResult", "ilqr_solve",
    "ilqr_rollout",
    "IPOptions", "IPSolution", "make_sensitivity", "make_solver",
    "__version__",
]
