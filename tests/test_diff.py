"""Differentiable QP layer: implicit-function-theorem gradients vs
finite differences on every problem leaf."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.qp import QPSettings, QuadraticProblem, qp_solve_diff

# tight forward solve so the finite-difference baseline is clean
S = QPSettings(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000,
               adaptive_rho=True, adaptive_rho_interval=50, polish=True)


def _loss(qp, gvec):
    x = qp_solve_diff(qp, S)
    return jnp.sum(gvec * x)


def test_qp_grads_match_finite_differences():
    qp = random_qp_batch(batch=3, n=6, m=9, seed=5, dtype=jnp.float64)
    key = jax.random.PRNGKey(0)
    gvec = jax.random.normal(key, qp.q.shape, jnp.float64)

    grads = jax.grad(lambda q_: _loss(q_, gvec))(qp)

    eps = 1e-6
    rng = np.random.default_rng(1)
    for leaf in ("P", "q", "A", "l", "u"):
        base = np.asarray(getattr(qp, leaf))
        # probe 5 random coordinates per leaf (full FD would be slow)
        flat_idx = rng.choice(base.size, size=min(5, base.size), replace=False)
        for fi in flat_idx:
            idx = np.unravel_index(fi, base.shape)
            # skip rows whose bound is infinite (gradient trivially 0,
            # and FD on inf is meaningless)
            if leaf in ("l", "u") and not np.isfinite(base[idx]):
                continue
            pert = np.zeros_like(base)
            pert[idx] = eps
            if leaf == "P":
                # keep P symmetric under perturbation, like the gradient
                pert = 0.5 * (pert + np.swapaxes(pert, -1, -2))
                pert *= 2.0  # e_ij + e_ji perturbation; grad is symmetrized
            qp_p = dataclasses.replace(qp, **{leaf: jnp.asarray(base + pert)})
            qp_m = dataclasses.replace(qp, **{leaf: jnp.asarray(base - pert)})
            fd = (
                float(_loss(qp_p, gvec)) - float(_loss(qp_m, gvec))
            ) / (2 * eps)
            if leaf == "P":
                ij = idx
                ji = idx[:-2] + (idx[-1], idx[-2])
                an = float(
                    np.asarray(getattr(grads, leaf))[ij]
                    + np.asarray(getattr(grads, leaf))[ji]
                )
            else:
                an = float(np.asarray(getattr(grads, leaf))[idx])
            assert abs(fd - an) < 1e-4 * (1.0 + abs(fd)), (
                leaf, idx, fd, an,
            )


def test_inactive_bounds_zero_gradient():
    """Inactive constraints do not influence x* locally: their l/u
    gradients are exactly zero, and a loose row's A gradient is zero."""
    qp = random_qp_batch(batch=2, n=5, m=7, seed=9, dtype=jnp.float64)
    # widen the last row's bounds so it is strictly inactive
    l = qp.l.at[:, -1].set(-1e4)
    u = qp.u.at[:, -1].set(1e4)
    qp = dataclasses.replace(qp, l=l, u=u)
    gvec = jnp.ones_like(qp.q)
    grads = jax.grad(lambda q_: _loss(q_, gvec))(qp)
    np.testing.assert_array_equal(np.asarray(grads.l[:, -1]), 0.0)
    np.testing.assert_array_equal(np.asarray(grads.u[:, -1]), 0.0)
    np.testing.assert_array_equal(np.asarray(grads.A[:, -1, :]), 0.0)


def test_single_problem_and_jit():
    """Shape-polymorphic: a single (unbatched) problem differentiates
    under jit, and the equality-row l/u gradients split 50/50."""
    import jax.scipy  # noqa: F401

    P = jnp.array([[4.0, 1.0], [1.0, 2.0]])
    q = jnp.array([1.0, 1.0])
    A = jnp.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    l = jnp.array([1.0, 0.0, 0.0])
    u = jnp.array([1.0, 0.7, 0.7])
    qp = QuadraticProblem(
        P=P.astype(jnp.float64), q=q.astype(jnp.float64),
        A=A.astype(jnp.float64), l=l.astype(jnp.float64),
        u=u.astype(jnp.float64),
    )
    gvec = jnp.array([1.0, -2.0], jnp.float64)
    gfn = jax.jit(jax.grad(lambda q_: _loss(q_, gvec)))
    grads = gfn(qp)
    # row 0 is the equality row: gradient splits equally between l and u
    np.testing.assert_allclose(
        np.asarray(grads.l[0]), np.asarray(grads.u[0]), rtol=1e-12
    )
    # finite-difference check on q (the simplest leaf)
    eps = 1e-6
    for i in range(2):
        qp_p = dataclasses.replace(qp, q=qp.q.at[i].add(eps))
        qp_m = dataclasses.replace(qp, q=qp.q.at[i].add(-eps))
        fd = (float(_loss(qp_p, gvec)) - float(_loss(qp_m, gvec))) / (2 * eps)
        assert abs(fd - float(grads.q[i])) < 1e-5, (i, fd, float(grads.q[i]))


class TestSQPDiff:
    """Differentiable NLP layer: IFT gradients at the converged SQP
    solution vs finite differences, on params AND bounds."""

    def _problem(self):
        from sqp_solver_tpu.sqp.types import NonlinearProblem

        B, n = 3, 4
        key = jax.random.PRNGKey(2)
        theta = 1.0 + 0.2 * jax.random.normal(key, (B, n), jnp.float64)

        def objective(x, th):
            return -jnp.sum(th * x)

        def constraint(x, th):
            del th
            return jnp.concatenate([jnp.array([x @ x]), x])

        r = jnp.array([1.2, 1.5, 0.9], jnp.float64)
        l = jnp.zeros((B, n + 1), jnp.float64)
        u = jnp.concatenate(
            [(r**2)[:, None], jnp.full((B, n), 2.0, jnp.float64)], axis=1
        )
        problem = NonlinearProblem(
            l=l, u=u, params=theta, objective=objective, constraint=constraint
        )
        x0 = jnp.full((B, n), 0.3, jnp.float64)
        return problem, x0

    def _settings(self):
        from sqp_solver_tpu.sqp import SQPSettings
        from sqp_solver_tpu.qp import QPSettings

        return SQPSettings(
            max_iter=40, eps_prim=1e-9, eps_dual=1e-9, termination="kkt",
            polish=True, polish_passes=2,
            qp=QPSettings(alpha=1.6, eps_abs=1e-10, eps_rel=1e-10,
                          max_iter=20000, check_termination=25,
                          warm_start=True, adaptive_rho=True),
        )

    def test_sqp_grads_match_finite_differences(self):
        from sqp_solver_tpu.sqp import sqp_solve_diff

        problem, x0 = self._problem()
        settings = self._settings()
        gvec = jax.random.normal(jax.random.PRNGKey(7), x0.shape, jnp.float64)

        def loss_on(p):
            return jnp.sum(gvec * sqp_solve_diff(p, x0, None, settings, "vmap"))

        grads = jax.grad(loss_on)(problem)

        eps = 1e-6
        rng = np.random.default_rng(3)
        for leaf in ("params", "u"):
            base = np.asarray(getattr(problem, leaf))
            for fi in rng.choice(base.size, size=4, replace=False):
                idx = np.unravel_index(fi, base.shape)
                pert = np.zeros_like(base)
                pert[idx] = eps
                p_p = dataclasses.replace(
                    problem, **{leaf: jnp.asarray(base + pert)}
                )
                p_m = dataclasses.replace(
                    problem, **{leaf: jnp.asarray(base - pert)}
                )
                fd = (float(loss_on(p_p)) - float(loss_on(p_m))) / (2 * eps)
                an = float(np.asarray(getattr(grads, leaf))[idx])
                assert abs(fd - an) < 1e-4 * (1.0 + abs(fd)), (
                    leaf, idx, fd, an,
                )

    def test_x0_gradient_is_zero(self):
        from sqp_solver_tpu.sqp import sqp_solve_diff

        problem, x0 = self._problem()
        settings = self._settings()
        g = jax.grad(
            lambda xx: jnp.sum(sqp_solve_diff(problem, xx, None, settings, "vmap"))
        )(x0)
        np.testing.assert_array_equal(np.asarray(g), 0.0)
