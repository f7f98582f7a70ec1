#!/usr/bin/env python
"""Differentiable QP layer demo: learn cost weights by gradient descent
THROUGH the solver.

A batch of box-constrained QPs is treated as a layer x*(q): we recover
the linear cost q that makes the solver's output match target solutions,
by plain gradient descent on ||x*(q) - x_target||^2 — the gradient flows
through the converged KKT system (qp.diff.qp_solve_diff, the OptNet
scheme).  The reference C++ library has no autodiff of any kind; here
the backward pass reuses the polish machinery.

Run: python examples/diff_qp_learning.py     (CPU or GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _common import example_setup

_quick = example_setup()  # smoke-mode flag

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)

from sqp_solver_tpu.models.mpc import random_qp_batch  # noqa: E402
from sqp_solver_tpu.qp import QPSettings, qp_solve_diff  # noqa: E402
import dataclasses  # noqa: E402


def main():
    # SQP_EXAMPLE_QUICK=1 (the test-suite smoke mode) shrinks the descent
    # budget; the full demo runs 300 Adam steps
    quick = _quick
    B, n, m = 8, 6, 9
    qp = random_qp_batch(batch=B, n=n, m=m, seed=3, dtype=jnp.float64)
    # widen the boxes so most rows are inactive at the optimum: x*(q) is
    # PIECEWISE smooth (kinks where the active set flips), and a landscape
    # dominated by clamped coordinates cannot be steered through q — the
    # honest caveat of differentiating any active-set solution.  A few
    # rows stay active, so the KKT adjoint still does real work.
    qp = dataclasses.replace(qp, l=qp.l - 1.5, u=qp.u + 1.5)
    settings = QPSettings(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000,
                          adaptive_rho=True, polish=True)

    # ground-truth costs and the targets they produce
    q_true = qp.q
    x_target = qp_solve_diff(qp, settings)

    def loss(q_param):
        x = qp_solve_diff(dataclasses.replace(qp, q=q_param), settings)
        return jnp.mean(jnp.sum((x - x_target) ** 2, axis=-1))

    import optax

    gfn = jax.jit(jax.value_and_grad(loss))
    q_param = q_true + 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), q_true.shape, jnp.float64
    )
    loss0 = float(loss(q_param))
    opt = optax.adam(5e-2)
    opt_state = opt.init(q_param)
    n_steps = 25 if quick else 300
    for step in range(n_steps):
        val, grad = gfn(q_param)
        updates, opt_state = opt.update(grad, opt_state)
        q_param = optax.apply_updates(q_param, updates)
        if step % 50 == 0 or step == n_steps - 1:
            print(f"step {step:3d}: loss={float(val):.3e}", file=sys.stderr)

    final = float(loss(q_param))
    print(f"loss: {loss0:.3e} -> {final:.3e}", file=sys.stderr)
    # a residual floor can remain when an instance's target lies on a
    # different active-set piece than the perturbed start (x*(q) is only
    # piecewise smooth); the demo's contract is a large reduction
    reduction = 0.5 if quick else 0.05
    assert final < reduction * loss0, (
        "gradient descent through the QP failed to make progress"
    )
    print("learned cost approaches the target solutions; gradients flowed "
          "through the active-set KKT system", file=sys.stderr)


if __name__ == "__main__":
    main()
