"""sqp_solver_tpu — a batched SQP / QP solver framework for accelerators.

A from-scratch JAX re-design of the capabilities of the reference
C++/Eigen library (msplr/sqp_solver): an OSQP-style ADMM QP solver and a
Nocedal-&-Wright Algorithm-18.3 SQP solver with damped BFGS and an l1
exact-penalty merit line search — built for batched accelerator solves:

* whole solves are single fused XLA programs (``lax.while_loop`` bodies);
* gradients/Jacobians come from ``jax.grad`` / ``jax.jacfwd``;
* thousands of independent problems batch through ``jax.vmap`` and shard
  across chips with ``jax.sharding`` / ``shard_map``;
* hot linear algebra is batched XLA (cuBLAS/cuSOLVER on a GPU).
"""

from sqp_solver_tpu.qp import (
    QPInfo,
    QPResult,
    QPSettings,
    QPSolver,
    QPState,
    QPStatus,
    QuadraticProblem,
    qp_solve,
)

__version__ = "0.1.0"

__all__ = [
    "qp_solve",
    "QPSolver",
    "QuadraticProblem",
    "QPSettings",
    "QPStatus",
    "QPInfo",
    "QPState",
    "QPResult",
    "__version__",
]
