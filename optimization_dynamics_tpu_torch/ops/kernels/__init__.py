"""Hand-written Hopper kernels of the port and their plain versions.

``fused_ip`` (K1, with its functor instantiations K1n and K1a),
``batched_solve`` (K2), ``riccati`` (K3), ``fused_rollout`` (K4) and
``loop_overhead`` (K5) each hold a CUDA kernel's wrapper, its plain
PyTorch version and a ``launches`` counter; the sources are under
``csrc/`` and ``_build.py`` compiles them at first use.
"""
