"""Infeasibility detection (OSQP-paper §3.4) — a capability the reference
C++ library lacks entirely: on an infeasible problem it can only burn
``max_iter`` and report MAX_ITER_EXCEEDED (``src/qp.cpp:147-149``).

Here the ADMM iterate deltas are checked against the primal/dual
certificate conditions at termination-check cadence (on every tier),
so an infeasible problem is
diagnosed within a few checks — and a batch can mix feasible and
infeasible instances without cross-contamination.

Run: python examples/infeasible_qp.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from _common import example_setup
from sqp_solver_tpu.qp import QPSettings, QPStatus, QuadraticProblem, qp_solve
from sqp_solver_tpu.parallel.batch import qp_solve_batch


def main():
    quick = example_setup()  # smoke-mode flag
    # detection fires within a few termination checks either way; quick
    # mode just caps the budget an undetected case could burn
    settings = QPSettings(eps_abs=1e-4, eps_rel=1e-4,
                          max_iter=200 if quick else 1000,
                          check_termination=25, adaptive_rho=True)

    # --- primal infeasible: x <= -1 AND x >= 1 --------------------------
    qp_pinf = QuadraticProblem(
        P=jnp.eye(1), q=jnp.zeros(1),
        A=jnp.array([[1.0], [1.0]]),
        l=jnp.array([-jnp.inf, 1.0]),
        u=jnp.array([-1.0, jnp.inf]),
    )
    res = qp_solve(qp_pinf, settings)
    print(f"primal-infeasible QP: status={QPStatus(int(res.info.status)).name} "
          f"after {int(res.info.iter)} iterations (reference: 1000 + MAX_ITER)")

    # --- dual infeasible (unbounded): min -x s.t. x >= 0 ----------------
    qp_dinf = QuadraticProblem(
        P=jnp.zeros((1, 1)), q=jnp.array([-1.0]),
        A=jnp.array([[1.0]]), l=jnp.array([0.0]), u=jnp.array([jnp.inf]),
    )
    res = qp_solve(qp_dinf, settings)
    print(f"dual-infeasible QP:   status={QPStatus(int(res.info.status)).name} "
          f"after {int(res.info.iter)} iterations")

    # --- mixed batch: feasible problems are unaffected ------------------
    B = 4
    P = jnp.broadcast_to(jnp.eye(1), (B, 1, 1))
    q = jnp.zeros((B, 1))
    A = jnp.broadcast_to(jnp.asarray([[1.0], [1.0]]), (B, 2, 1))
    l = jnp.asarray([[-1e30, -1.0]] * 3 + [[-1e30, 1.0]])
    u = jnp.asarray([[1.0, 1e30]] * 3 + [[-1.0, 1e30]])
    batch = QuadraticProblem(P=P, q=q, A=A, l=l, u=u)
    res = qp_solve_batch(batch, settings, impl="fused")
    names = [QPStatus(int(s)).name for s in np.asarray(res.info.status)]
    print(f"mixed batch statuses: {names}")


if __name__ == "__main__":
    main()
