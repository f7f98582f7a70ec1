"""Sustained (receding-horizon) NLP serving: K dependent, warm-started
batch SQP solves inside ONE compiled program.

The nonlinear twin of :func:`sqp_solver_tpu.qp.sequence.qp_solve_sequence`
(see that module for the performance argument — one `lax.scan` pays the
dispatch floor once per K solves, and warm-started steps re-converge in a
few outer iterations because consecutive control steps are small problem
perturbations).  Between steps the scan carries the previous step's
primal/dual solution as the next step's (x0, lam0): the standard
receding-horizon SQP warm start.  The reference's serving loop is one
host-side ``solve()`` per step (``src/sqp.cpp:13-41`` has no multi-step
analog); its warm start is whatever the caller left in ``solver.x_``.

Use a small fixed ``max_iter`` (2-4 outers): warm-started MPC steps
track the optimum without re-running a cold budget.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = ["sqp_solve_sequence"]


def sqp_solve_sequence(
    make_nlp: Callable[[Any], Tuple[NonlinearProblem, jax.Array]],
    advance: Callable[[Any, SQPResult], Tuple[Any, Any]],
    carry0: Any,
    num_steps: int,
    settings: SQPSettings = SQPSettings(),
    impl: str = "fused",
    warm0: Optional[Tuple[jax.Array, jax.Array]] = None,
):
    """Run ``num_steps`` dependent, warm-started batch NLP solves in one
    compiled program.

    Args:
      make_nlp: ``carry -> (NonlinearProblem, x0)``.  The returned ``x0``
        (B, n) seeds the FIRST step only (unless ``warm0`` is given);
        later steps start from the previous step's solution.  Callables
        on the problem are traced once.
      advance: ``(carry, result) -> (next_carry, output)`` — consume the
        step's :class:`SQPResult`, produce the next carry plus a per-step
        output (stacked along a new leading axis).
      carry0: initial carry pytree.
      num_steps: number of solves (static).
      settings: shared :class:`SQPSettings` for every step.
      impl: ``"vmap" | "fused"`` —
        :func:`~sqp_solver_tpu.parallel.batch.sqp_solve_batch` tier.
      warm0: optional ``(x0, lam0)`` overriding the first step's start
        (resume a longer horizon from a previous call's return).

    Returns:
      ``(outputs, final_carry, (x_f, lam_f))`` — stacked per-step
      outputs, the carry after the last step, and the last solution pair
      (pass back as ``warm0`` to continue the horizon).
    """
    from sqp_solver_tpu.parallel.batch import sqp_solve_batch

    if warm0 is None:
        prob0, x00 = make_nlp(carry0)
        B, n = x00.shape
        m = prob0.l.shape[-1] if prob0.l.ndim > 1 else prob0.l.shape[0]
        warm0 = (x00, jnp.zeros((B, m), x00.dtype))

    def step(sc, _):
        carry, (xw, lamw) = sc
        prob, _ = make_nlp(carry)
        res = sqp_solve_batch(prob, xw, lamw, settings, impl=impl)
        carry2, out = advance(carry, res)
        return (carry2, (res.x, res.lam)), out

    (carry_f, warm_f), outs = lax.scan(
        step, (carry0, warm0), None, length=num_steps
    )
    return outs, carry_f, warm_f
