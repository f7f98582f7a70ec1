"""Sustained (receding-horizon) QP serving: K dependent, warm-started
batch solves inside ONE compiled program.

The production MPC pattern the one-shot API cannot express efficiently:
each control step rebuilds the QP (vectors, and matrices if needed) from
a user-defined carry (e.g. the plant state), solves the batch
warm-started from the previous step's iterate, consumes the result, and
advances the carry.  Running the K steps as one :func:`jax.lax.scan`:

- the fixed dispatch cost is paid once per K solves instead of once per
  solve, and
- warm-started steps converge in a single check-termination chunk
  (cold ~77 ADMM iterations vs warm ~25 on the double-integrator fleet).

Reference counterpart: the reference's serving loop is host-side (one
``solve()`` call per control step, ``tests/qp_solver_test.cpp`` usage)
and its warm-start flag's cold-start reset is a no-op (quirk Q1,
``src/qp.cpp:78-82``); it has no analog of a compiled multi-step
program.  Here warm starting is explicit state threading — the scan
carries :class:`~sqp_solver_tpu.qp.types.QPState` between steps (the
pytree contract pinned by
``tests/test_fused_qp.py::TestFusedTierBehaviour::test_qpstate_is_a_scan_carry``).

All tiers are supported; semantics are identical to calling
:func:`~sqp_solver_tpu.parallel.batch.qp_solve_batch` K times with the
state threaded by hand (pinned by tests/test_sequence.py).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.qp.types import QPResult, QPSettings, QPState, QuadraticProblem

__all__ = ["qp_solve_sequence"]


def qp_solve_sequence(
    make_qp: Callable[[Any], QuadraticProblem],
    advance: Callable[[Any, QPResult], Tuple[Any, Any]],
    carry0: Any,
    num_steps: int,
    settings: QPSettings = QPSettings(),
    impl: str = "fused",
    state0: Optional[QPState] = None,
):
    """Run ``num_steps`` dependent, warm-started batch QP solves in one
    compiled program.

    Args:
      make_qp: ``carry -> QuadraticProblem`` (batched: leading batch axis
        on every leaf).  Traced once; matrices that do not depend on the
        carry are closed-over constants.
      advance: ``(carry, result) -> (next_carry, output)`` — consume the
        step's :class:`QPResult` (apply the control, step the plant,
        record diagnostics) and produce the next carry plus a per-step
        output; outputs are stacked along a new leading axis of length
        ``num_steps``.
      carry0: initial carry pytree.
      num_steps: number of solves (static).
      settings: shared :class:`QPSettings` for every step.
      impl: ``"vmap" | "fused"`` —
        :func:`~sqp_solver_tpu.parallel.batch.qp_solve_batch` tier.
      state0: optional initial warm-start state; defaults to zeros of the
        first QP's shape (a cold first step, warm thereafter).

    Returns:
      ``(outputs, final_carry, final_state)`` — the stacked per-step
      outputs, the carry after the last step, and the last step's
      :class:`QPState` (resume a longer horizon by passing it back in as
      ``state0``).
    """
    from sqp_solver_tpu.parallel.batch import qp_solve_batch

    if state0 is None:
        qp0 = make_qp(carry0)
        B, n = qp0.q.shape
        m = qp0.l.shape[-1]
        dtype = qp0.q.dtype
        state0 = QPState(
            x=jnp.zeros((B, n), dtype),
            z=jnp.zeros((B, m), dtype),
            y=jnp.zeros((B, m), dtype),
        )

    def step(sc, _):
        carry, qstate = sc
        res = qp_solve_batch(make_qp(carry), settings, state=qstate, impl=impl)
        carry2, out = advance(carry, res)
        return (carry2, res.state), out

    (carry_f, state_f), outs = lax.scan(
        step, (carry0, state0), None, length=num_steps
    )
    return outs, carry_f, state_f
