#!/usr/bin/env python
"""Batched nonlinear portfolio optimization with the SQP solver.

min_w  -mu'w + gamma * w'S w + c * sum(w_i^(3/2))   (nonlinear impact cost)
s.t.   sum(w) = 1,  0 <= w <= w_cap

Each batch element has its own expected-return vector mu — one fused
batched SQP solve for the whole book.

Run: python examples/portfolio_nlp.py [--batch 256] [--assets 32]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from _common import example_setup


def main():
    quick = example_setup()  # smoke-mode flag
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32 if quick else 256)
    ap.add_argument("--assets", type=int, default=16 if quick else 32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu.qp import QPSettings
    from sqp_solver_tpu.sqp import NonlinearProblem, SQPSettings

    B, N = args.batch, args.assets
    rng = np.random.default_rng(0)
    F = rng.normal(size=(N, N)) / np.sqrt(N)
    Sigma = jnp.asarray(F @ F.T + 0.05 * np.eye(N), jnp.float32)
    mu = jnp.asarray(rng.uniform(0.0, 0.1, (B, N)), jnp.float32)
    gamma, c_impact, w_cap = 5.0, 0.05, 0.2

    def objective(w, mu_i):
        risk = w @ (Sigma @ w)
        # smoothed market-impact cost (w^1.5 has an unbounded second
        # derivative at 0, which is hostile to any Newton-type method)
        impact = jnp.sum((jnp.maximum(w, 0.0) + 1e-3) ** 1.5)
        return -mu_i @ w + gamma * risk + c_impact * impact

    def constraint(w, mu_i):
        return jnp.concatenate([jnp.array([jnp.sum(w)]), w])

    problem = NonlinearProblem(
        l=jnp.concatenate([jnp.ones((B, 1)), jnp.zeros((B, N))], axis=1).astype(jnp.float32),
        u=jnp.concatenate([jnp.ones((B, 1)), jnp.full((B, N), w_cap)], axis=1).astype(jnp.float32),
        params=mu,
        objective=objective,
        constraint=constraint,
    )
    settings = SQPSettings(
        max_iter=12 if quick else 25,
        eps_prim=1e-2, eps_dual=1e-2, termination="kkt",
        schedule="fixed", polish=True,
        qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=150,
                      check_termination=25, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50, schedule="fixed"),
    )
    x0 = jnp.full((B, N), 1.0 / N, jnp.float32)
    res = jax.jit(lambda p, x: sqp_solve_batch(p, x, None, settings, impl="fused"))(
        problem, x0
    )
    w = np.asarray(res.x)
    status = np.asarray(res.info.status)
    print(f"solved {np.mean(status == 0):.1%} of {B} portfolios")
    print(f"budget residual max: {np.abs(w.sum(axis=1) - 1).max():.2e}")
    print(f"cap violations: {(w > w_cap + 1e-4).sum()} / bounds: {(w < -1e-4).sum()}")
    i = 0
    print(f"portfolio 0: top weights {np.sort(w[i])[-5:][::-1].round(4)}")


if __name__ == "__main__":
    main()
