"""Hand-written Hopper kernels of the port and their plain versions.

``batched_solve`` (K2) and ``fused_ip`` (K1) each hold a CUDA kernel's
wrapper, its plain PyTorch version and a ``launches`` counter; the
sources are under ``csrc/`` and ``_build.py`` compiles them at first use.
"""
