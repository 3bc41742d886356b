"""Port parity: K2's plain version (batch-first Householder QR) against the
JAX package's ``batched_solve_reference`` and its Pallas kernel in
interpret mode, on the systems of tests/test_pallas_solve.py.

The port and the reference run the same unpivoted QR; in float64 they
agree to round-off (atol 1e-10 on well-conditioned systems). The float32
Pallas kernel is held at the reference tests' tolerance (1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_dynamics_tpu.ops.pallas.batched_solve import (
    batched_solve as jax_batched_solve,
    batched_solve_reference,
)
from optimization_dynamics_tpu_torch.ops.kernels.batched_solve import (
    batched_solve,
    batched_solve_plain,
)

torch.set_num_threads(1)


def _random_systems(B=24, n=9, k=2, seed=0, cond_boost=3.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)) + cond_boost * np.eye(n)
    b = rng.normal(size=(B, n, k))
    return A, b


def _saddle_systems(B=16, m=5, k=1, seed=1):
    """Unsymmetric KKT-style matrices with a zero lower-right block."""
    rng = np.random.default_rng(seed)
    n = 2 * m
    A = np.zeros((B, n, n))
    for i in range(B):
        H = rng.normal(size=(m, m))
        H = H @ H.T + 0.5 * np.eye(m)
        C = rng.normal(size=(m, m))
        A[i, :m, :m] = H
        A[i, :m, m:] = C.T
        A[i, m:, :m] = C
    b = rng.normal(size=(B, n, k))
    return A, b


@pytest.mark.parametrize("shape", [(24, 9, 2), (16, 10, 8), (7, 10, 1)])
def test_plain_matches_jax_reference_f64(shape):
    A, b = _random_systems(*shape)
    ref = np.asarray(batched_solve_reference(jnp.asarray(A),
                                             jnp.asarray(b)))
    got = batched_solve_plain(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, b),
                               atol=1e-10)


@pytest.mark.parametrize("k", [1, 8])
def test_plain_matches_jax_on_saddle_systems(k):
    A, b = _saddle_systems(k=k)
    ref = np.asarray(batched_solve_reference(jnp.asarray(A),
                                             jnp.asarray(b)))
    got = batched_solve_plain(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    res = np.einsum("bij,bjk->bik", A, got.numpy()) - b
    assert np.max(np.abs(res)) < 1e-10
    # the float32 plain version at the reference test's residual bound
    g32 = batched_solve_plain(torch.as_tensor(A, dtype=torch.float32),
                              torch.as_tensor(b, dtype=torch.float32))
    res32 = np.einsum("bij,bjk->bik", A, g32.double().numpy()) - b
    assert np.max(np.abs(res32)) < 2e-3


def test_plain_matches_pallas_interpret_f32():
    A, b = _random_systems(B=130, n=10, k=8, seed=3)
    A32, b32 = A.astype(np.float32), b.astype(np.float32)
    ref = np.asarray(jax_batched_solve(jnp.asarray(A32), jnp.asarray(b32),
                                       interpret=True))
    got = batched_solve(torch.as_tensor(A32), torch.as_tensor(b32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_wrapper_takes_plain_only_on_cpu():
    """CPU tensors run the plain version and launch nothing; a tensor on
    any other device is refused, never computed by the plain version."""
    A, b = _random_systems(B=4, n=10, k=1)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    before = batched_solve.launches
    np.testing.assert_array_equal(batched_solve(At, bt).numpy(),
                                  batched_solve_plain(At, bt).numpy())
    assert batched_solve.launches == before
    with pytest.raises(ValueError):
        batched_solve(At.to("meta"), bt.to("meta"))
