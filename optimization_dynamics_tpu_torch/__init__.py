"""optimization_dynamics_tpu_torch — the PyTorch + CUDA port of
``optimization_dynamics_tpu``.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's layout and names, and the parity tests
(``tests/test_torch_*.py``) feed the same inputs through both. Vectors
are tensors with the batch dimension first. The hand-written Hopper
kernels live in ``ops/kernels``: a CUDA tensor goes through its kernel
(or raises), a CPU tensor through the kernel's plain PyTorch version.

This slice covers the cartpole deploy solve: cones, the cartpole model,
the lane-batched interior-point solver, the implicit dynamics, the
batched AL-iLQR phases and the segmented executor.
"""

__version__ = "0.1.0"
