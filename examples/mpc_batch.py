#!/usr/bin/env python
"""Receding-horizon MPC: solve 4096 independent condensed MPC QPs per step.

The north-star embedded-MPC pattern (BASELINE configs[3]): a fleet of
double-integrator plants, each with its own state, tracked to the origin
under input and velocity constraints.  P and A are shared across the
fleet; q, l, u vary with each plant's state — one fused batched solve per
control step, warm-started from the previous step.

Run: python examples/mpc_batch.py [--steps 20] [--batch 512]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from _common import example_setup


def main():
    quick = example_setup()  # smoke-mode flag
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3 if quick else 10)
    ap.add_argument("--batch", type=int, default=64 if quick else 512)
    ap.add_argument("--horizon", type=int, default=8 if quick else 16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.models.mpc import _double_integrator_condensed
    from sqp_solver_tpu.parallel.batch import qp_solve_batch
    from sqp_solver_tpu.qp import QPSettings, QuadraticProblem

    B, H, dt = args.batch, args.horizon, 0.1
    Sx, Su = _double_integrator_condensed(H, dt)
    Sp_x, Sp_u = Sx[:, 0, :], Su[:, 0, :]
    Sv_x, Sv_u = Sx[:, 1, :], Su[:, 1, :]
    P = jnp.asarray(Sp_u.T @ Sp_u + 0.1 * np.eye(H), jnp.float32)
    A = jnp.asarray(np.concatenate([np.eye(H), Sv_u], axis=0), jnp.float32)
    u_max, v_max = 2.0, 1.5

    settings = QPSettings(
        alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200,
        check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
        schedule="fixed",
    )

    Ad = jnp.asarray([[1.0, dt], [0.0, 1.0]], jnp.float32)
    Bd = jnp.asarray([[0.5 * dt * dt], [dt]], jnp.float32)

    @jax.jit
    def control_step(state, qp_state):
        """state: (B, 2) plant states -> control + next warm-start."""
        q = (state @ jnp.asarray(Sp_x.T, jnp.float32)) @ jnp.asarray(Sp_u, jnp.float32)
        vel_off = state @ jnp.asarray(Sv_x.T, jnp.float32)
        l = jnp.concatenate([jnp.full((state.shape[0], H), -u_max), -v_max - vel_off], axis=1)
        u = jnp.concatenate([jnp.full((state.shape[0], H), u_max), v_max - vel_off], axis=1)
        qp = QuadraticProblem(
            P=jnp.broadcast_to(P, (state.shape[0], H, H)), q=q,
            A=jnp.broadcast_to(A, (state.shape[0], 2 * H, H)), l=l, u=u,
        )
        res = qp_solve_batch(qp, settings, state=qp_state, impl="fused")
        u0 = res.x[:, 0]  # first input of the optimal sequence
        next_state = state @ Ad.T + u0[:, None] * Bd[:, 0]
        return next_state, res.state, u0, res.info

    rng = np.random.default_rng(0)
    state = jnp.asarray(rng.uniform(-1, 1, (B, 2)), jnp.float32)
    qp_state = None
    print(f"fleet of {B} plants, horizon {H}")
    for k in range(args.steps):
        t0 = time.perf_counter()
        state, qp_state, u0, info = control_step(state, qp_state)
        jax.block_until_ready(state)
        dt_ms = (time.perf_counter() - t0) * 1e3
        pos_rms = float(jnp.sqrt(jnp.mean(state[:, 0] ** 2)))
        solved = float(np.mean(np.asarray(info.status) == 0))
        print(
            f"step {k:2d}: {dt_ms:7.1f} ms  solved={solved:.3f}  pos_rms={pos_rms:.4f}"
        )


if __name__ == "__main__":
    main()
