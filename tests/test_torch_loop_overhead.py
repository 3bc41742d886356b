"""Port parity: K5's plain version (the loop-overhead probe) against the
reference's Pallas kernel bodies.

The reference script (scripts/loop_overhead_r5.py) builds its three
kernels inside ``main()``, so they cannot be imported; this file writes
the same bodies (``fori_loop`` of N trips, of N/8 trips of eight, and a
``while_loop``) and runs them through ``pl.pallas_call(...,
interpret=True)`` on the CPU. Same input, made with numpy from a seed.

Tolerance: float32 atol 1e-4. The two sides round differently (XLA on
the CPU contracts ``z * 0.999 + 0.001``, the port rounds each product and
sum), which moves the result by about 1e-5 after 1000 iterations; the
port's three variants run the same arithmetic and agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from optimization_dynamics_tpu_torch.ops.kernels.loop_overhead import (
    N_ITER,
    SHAPE,
    VARIANTS,
    loop_overhead,
    loop_overhead_plain,
)
from optimization_dynamics_tpu_torch.scripts import loop_overhead as script

torch.set_num_threads(1)


def _one(z):
    z = z * 0.999 + 0.001
    return z + jnp.max(z, axis=0, keepdims=True) * 1e-6


def _pallas(variant):
    """The reference script's kernel of ``variant`` in interpret mode."""
    def fori_kernel(reps):
        def kernel(x_ref, o_ref):
            def body(i, z):
                for _ in range(reps):
                    z = _one(z)
                return z
            o_ref[...] = jax.lax.fori_loop(0, N_ITER // reps, body,
                                           x_ref[...], unroll=1)
        return kernel

    def while_kernel(x_ref, o_ref):
        _, z = jax.lax.while_loop(
            lambda c: c[0] < N_ITER, lambda c: (c[0] + 1, _one(c[1])),
            (jnp.asarray(0, jnp.int32), x_ref[...]))
        o_ref[...] = z

    kernel = {"plain": fori_kernel(1), "reps8": fori_kernel(8),
              "while": while_kernel}[variant]
    return jax.jit(lambda x: pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(SHAPE, jnp.float32),
        interpret=True)(x))


@pytest.fixture(scope="module")
def probe():
    x = script.probe_input("cpu")
    assert x.dtype == torch.float32 and tuple(x.shape) == SHAPE
    return x


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_interpret(probe, variant):
    ref = np.asarray(_pallas(variant)(jnp.asarray(probe.numpy())))
    before = loop_overhead.launches
    got = loop_overhead(probe, variant)
    assert loop_overhead.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # the probe moved the carry: every value rose towards 1
    assert bool((got > probe).all()) and float((got - probe).max()) > 0.5


def test_variants_agree_and_while_stops_early(probe):
    outs = [loop_overhead_plain(probe, v) for v in VARIANTS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    short = loop_overhead_plain(probe, "while", n_iter=10)
    z = probe.clone()
    for _ in range(10):
        z = z * 0.999 + 0.001
        z = z + torch.amax(z, dim=0, keepdim=True) * 1e-6
    assert torch.equal(short, z)
    # a column whose max is not finite stops after that trip; the other
    # columns run on
    bad = probe.clone()
    bad[3, 5] = float("inf")
    out = loop_overhead_plain(bad, "while", n_iter=5)
    five = loop_overhead_plain(probe, "while", n_iter=5)
    keep = [c for c in range(SHAPE[1]) if c != 5]
    assert torch.equal(out[:, keep], five[:, keep])
    one = bad[:, 5:6] * 0.999 + 0.001
    one = one + torch.amax(one, dim=0, keepdim=True) * 1e-6
    assert torch.equal(out[:, 5:6], one)
    with pytest.raises(ValueError):
        loop_overhead_plain(probe, "unrolled")


def test_entry_point_on_cpu(capsys):
    """The entry point prints the reference script's line per variant;
    ``--device cpu`` runs the plain version on the host clock."""
    out = script.main(["--device", "cpu", "--reps", "1"])
    assert sorted(out) == sorted(VARIANTS)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(VARIANTS)
    assert all("us per logical iteration" in ln for ln in lines)
