"""Shared model-layer helpers.

Port of ``optimization_dynamics_tpu/models/base.py``. A model provides a
residual ``residual(z, theta, kappa)`` written in plain torch over the
last dimension, so it takes one vector or a batch (batch first) alike
and ``torch.func.jacfwd`` differentiates it; a static cone spec; an
interior warm start ``init_z`` and a ``theta`` packing, batched the same
way.
"""

from __future__ import annotations

import torch

__all__ = ["variational_dynamics"]


def variational_dynamics(mass_matrix, dynamics_bias, h, q0, q1, q2, control,
                         contact_force=None, damping=0.0):
    """Midpoint variational integrator residual rows.

    ``mass_matrix(q) (..., nq, nq)`` and ``dynamics_bias(q, v) (..., nq)``
    define the smooth mechanics; ``h (...)`` is the timestep; ``control``
    is the generalized control force at the second midpoint;
    ``contact_force`` is ``P(q2)^T lambda`` in generalized coordinates;
    ``damping`` adds ``-h * damping * vm2``.

    D1L(q, v) = -dynamics_bias(q, v); D2L(q, v) = M(q) v.
    Residual: ``0.5 h D1L1 + D2L1 + 0.5 h D1L2 - D2L2 + control [+ contact]``.
    """
    h = h[..., None]
    qm1 = 0.5 * (q0 + q1)
    vm1 = (q1 - q0) / h
    qm2 = 0.5 * (q1 + q2)
    vm2 = (q2 - q1) / h

    # matvec as multiply-reduce, the same arithmetic as the reference
    mv = lambda A, v: torch.sum(A * v[..., None, :], dim=-1)

    d1l1 = -dynamics_bias(qm1, vm1)
    d2l1 = mv(mass_matrix(qm1), vm1)
    d1l2 = -dynamics_bias(qm2, vm2)
    d2l2 = mv(mass_matrix(qm2), vm2)

    d = 0.5 * h * d1l1 + d2l1 + 0.5 * h * d1l2 - d2l2 + control
    if contact_force is not None:
        d = d + contact_force
    if damping != 0.0:
        d = d - h * damping * vm2
    return d
