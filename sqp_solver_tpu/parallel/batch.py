"""Batched solves: vmap over problem instances.

This is the data-parallel core of the framework (SURVEY.md §2: "the core
batching story") — thousands of independent QPs/NLPs run in lockstep
through one fused solver.  Per-problem termination comes from JAX's
batching of ``lax.while_loop`` (converged instances are masked while
stragglers finish); per-problem status codes isolate failures.
"""

from __future__ import annotations

from typing import Optional

import jax

from sqp_solver_tpu.qp.admm import qp_solve
from sqp_solver_tpu.qp.types import QPResult, QPSettings, QuadraticProblem
from sqp_solver_tpu.sqp.solver import sqp_solve
from sqp_solver_tpu.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = ["qp_solve_batch", "sqp_solve_batch"]


def qp_solve_batch(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state=None,
    impl: str = "vmap",
) -> QPResult:
    """Solve a batch of QPs (leading batch axis on every problem leaf).

    ``impl="vmap"`` is the semantics-defining path; ``impl="fused"`` is the
    production path (scalar loop counters, explicit convergence masks, the
    fused ADMM chunk) — same algorithm, tested-identical optima.
    """
    if settings.scaling > 0:
        # equilibrate per problem, solve scaled through whichever tier,
        # then rescore against the ORIGINAL problem (see qp.scaling)
        from sqp_solver_tpu.qp.scaling import solve_with_scaling

        return solve_with_scaling(
            lambda p, s_, st_: qp_solve_batch(p, s_, st_, impl=impl),
            qp,
            settings,
            state,
        )
    if impl == "fused":
        from sqp_solver_tpu.qp.admm_batched import qp_solve_fused

        return qp_solve_fused(qp, settings, state)
    if state is None:
        return jax.vmap(lambda p: qp_solve(p, settings))(qp)
    return jax.vmap(lambda p, s: qp_solve(p, settings, s))(qp, state)


def sqp_solve_batch(
    problem: NonlinearProblem,
    x0: jax.Array,
    lam0: Optional[jax.Array] = None,
    settings: SQPSettings = SQPSettings(),
    impl: str = "vmap",
) -> SQPResult:
    """Solve a batch of NLPs.

    ``x0`` has shape (B, n).  The problem's data leaves (l, u, params) are
    either unbatched (shared across instances) or batched with leading B —
    detected from ``l`` vs ``x0``'s batch dim.

    ``impl="vmap"`` is the semantics-defining path; ``impl="fused"`` the
    production path (see sqp.solver_batched).
    """
    if impl == "fused":
        from sqp_solver_tpu.sqp.solver_batched import sqp_solve_fused

        return sqp_solve_fused(problem, x0, lam0, settings)
    batched_problem = problem.l.ndim == x0.ndim  # l:(B,m) alongside x0:(B,n)
    if batched_problem:
        if lam0 is None:
            return jax.vmap(lambda p, x: sqp_solve(p, x, None, settings))(problem, x0)
        return jax.vmap(lambda p, x, lm: sqp_solve(p, x, lm, settings))(
            problem, x0, lam0
        )
    if lam0 is None:
        return jax.vmap(lambda x: sqp_solve(problem, x, None, settings))(x0)
    return jax.vmap(lambda x, lm: sqp_solve(problem, x, lm, settings))(x0, lam0)
