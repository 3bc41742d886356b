"""The port's top-level names are the reference's: ``__all__`` lists the
same names, each bound to the port's own counterpart (the module it
comes from is the reference's module's twin), and the package imports
nothing of JAX."""

import subprocess
import sys

import optimization_dynamics_tpu as ref
import optimization_dynamics_tpu_torch as port


def test_all_matches_the_reference():
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        if name == "__version__":
            continue
        obj, twin = getattr(port, name), getattr(ref, name)
        assert obj.__name__ == twin.__name__, name
        assert obj.__module__ == twin.__module__.replace(
            "optimization_dynamics_tpu", "optimization_dynamics_tpu_torch",
            1), name


def test_import_loads_no_jax():
    code = ("import sys; before = set(sys.modules); "
            "import optimization_dynamics_tpu_torch; "
            "import optimization_dynamics_tpu_torch.solver.ilqr_segmented; "
            "import optimization_dynamics_tpu_torch.solver.ilqr_batched; "
            "import optimization_dynamics_tpu_torch.parallel.mesh; "
            "import optimization_dynamics_tpu_torch.scripts.multihost_worker; "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'optimization_dynamics_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
