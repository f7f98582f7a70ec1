"""Edge cases: infinite/loose bounds through every solver path, equality
rows, large-n problems (BASELINE configs[4] scaled for CPU CI)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus, QuadraticProblem, qp_solve
from sqp_solver_tpu.qp.admm_batched import qp_solve_fused
from sqp_solver_tpu.sqp import SQPSettings, sqp_solve

S = QPSettings(
    eps_abs=1e-6, eps_rel=1e-6, max_iter=1000, check_termination=25,
    adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
)


def _mixed_bounds_qp(dtype):
    """Equality row + one-sided row + loose row."""
    return QuadraticProblem(
        P=jnp.array([[4.0, 1.0], [1.0, 2.0]], dtype),
        q=jnp.array([1.0, 1.0], dtype),
        A=jnp.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]], dtype),
        l=jnp.array([1.0, -jnp.inf, -1e18], dtype),
        u=jnp.array([1.0, 0.7, 1e18], dtype),
    )


class TestMixedBounds:
    def test_all_paths_agree(self):
        qp = _mixed_bounds_qp(jnp.float64)
        ref = qp_solve(qp, S)
        assert int(ref.info.status) == QPStatus.SOLVED
        bc = lambda a: jnp.broadcast_to(a, (8,) + a.shape)
        qp_b = QuadraticProblem(*(bc(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u)))
        fused = qp_solve_fused(qp_b, S)
        qp_f32 = jax.tree.map(lambda v: v.astype(jnp.float32), qp_b)
        kern = qp_solve_fused(qp_f32, S)
        np.testing.assert_allclose(np.asarray(fused.x[0]), np.asarray(ref.x), atol=1e-9)
        np.testing.assert_allclose(np.asarray(kern.x[0]), np.asarray(ref.x), atol=1e-4)


class TestLargeN:
    @pytest.mark.parametrize("solver", ["schur_cholesky", "schur_cholesky_tri"])
    def test_qp_n512(self, solver):
        """Large-n config (BASELINE configs[4], CPU-scaled): Schur Cholesky
        at n=512, explicit-inverse and back-substitution variants."""
        qp = random_qp_batch(batch=1, n=512, m=600, seed=0, dtype=jnp.float64)
        res = jax.vmap(
            lambda p: qp_solve(
                p,
                QPSettings(
                    eps_abs=1e-5, eps_rel=1e-5, max_iter=1000, linear_solver=solver
                ),
            )
        )(qp)
        assert int(res.info.status[0]) == QPStatus.SOLVED

    def test_sqp_n256_jacfwd(self):
        """SQP with autodiff Jacobians at n=256 (scaled-down configs[4])."""
        n = 256
        from sqp_solver_tpu.sqp.types import NonlinearProblem

        target = jnp.linspace(-0.5, 1.5, n)
        prob = NonlinearProblem(
            l=jnp.zeros(n), u=jnp.ones(n),
            objective=lambda x: jnp.sum((x - target) ** 2),
            constraint=lambda x: x,
        )
        res = sqp_solve(
            prob, jnp.full((n,), 0.5),
            settings=SQPSettings(termination="kkt", eps_prim=1e-6, eps_dual=1e-6),
        )
        expect = np.clip(np.asarray(target), 0, 1)
        np.testing.assert_allclose(np.asarray(res.x), expect, atol=1e-5)


class TestM0Edge:
    def test_equality_only_qp(self):
        """All-equality constraints (rho -> RHO_EQ_FACTOR branch)."""
        qp = QuadraticProblem(
            P=jnp.eye(2), q=jnp.array([-1.0, -2.0]),
            A=jnp.array([[1.0, 1.0]]), l=jnp.array([1.0]), u=jnp.array([1.0]),
        )
        res = qp_solve(qp, S)
        # min .5||x||^2 - [1,2]x st x0+x1=1 -> x = [0, 1]
        np.testing.assert_allclose(np.asarray(res.x), [0.0, 1.0], atol=1e-5)
