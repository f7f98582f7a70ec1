"""QP solver tests — reference parity (tests/qp_solver_test.cpp) plus
batched/multi-solver coverage the reference lacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.qp import (
    EQUALITY_CONSTRAINT,
    INEQUALITY_CONSTRAINT,
    LOOSE_BOUNDS,
    QPSettings,
    QPSolver,
    QPStatus,
    QuadraticProblem,
    constr_type_init,
    qp_solve,
)

from fixtures import SIMPLE_QP_SOLUTION, simple_qp


class TestSimpleQP:
    """Reference: QPSolverTest.testSimpleQP (tests/qp_solver_test.cpp:43-56)."""

    def test_solves(self):
        qp = simple_qp()
        res = jax.jit(qp_solve)(qp, QPSettings(max_iter=1000))
        np.testing.assert_allclose(np.asarray(res.x), SIMPLE_QP_SOLUTION, atol=1e-2)
        assert int(res.info.status) == QPStatus.SOLVED
        assert int(res.info.iter) < 1000

    def test_tight_tolerance_hits_1e6(self):
        qp = simple_qp()
        res = qp_solve(qp, QPSettings(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000))
        np.testing.assert_allclose(np.asarray(res.x), SIMPLE_QP_SOLUTION, atol=1e-6)

    @pytest.mark.parametrize(
        "method",
        ["schur_cholesky", "kkt_ldlt", "cg", "schur_cholesky_blocked"],
    )
    def test_linear_solvers_agree(self, method):
        qp = simple_qp()
        res = qp_solve(qp, QPSettings(linear_solver=method))
        np.testing.assert_allclose(np.asarray(res.x), SIMPLE_QP_SOLUTION, atol=1e-2)
        assert int(res.info.status) == QPStatus.SOLVED


class TestSinglePrecision:
    """Reference: testSinglePrecisionFloat (tests/qp_solver_test.cpp:58-69)."""

    def test_float32(self):
        qp = simple_qp(dtype=jnp.float32)
        res = qp_solve(qp)
        assert res.x.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(res.x), SIMPLE_QP_SOLUTION, atol=1e-2)
        assert int(res.info.status) == QPStatus.SOLVED

    def test_float32_with_refinement(self):
        qp = simple_qp(dtype=jnp.float32)
        res = qp_solve(qp, QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000, refine_steps=1))
        np.testing.assert_allclose(np.asarray(res.x), SIMPLE_QP_SOLUTION, atol=1e-4)


class TestConstraintViolation:
    """Reference: testConstraintViolation (tests/qp_solver_test.cpp:71-87)."""

    def test_feasibility_margin(self):
        qp = simple_qp()
        res = qp_solve(qp, QPSettings(eps_rel=1e-4, eps_abs=1e-4))
        x = np.asarray(res.x)
        Ax = np.asarray(qp.A) @ x
        assert (Ax - np.asarray(qp.l)).min() >= -1e-3
        assert (Ax - np.asarray(qp.u)).max() <= 1e-3


class TestAdaptiveRho:
    """Reference: testAdaptiveRho + testAdaptiveRhoImprovesConvergence
    (tests/qp_solver_test.cpp:89-125)."""

    def test_solves(self):
        qp = simple_qp()
        res = qp_solve(qp, QPSettings(adaptive_rho=True, adaptive_rho_interval=10))
        assert int(res.info.status) == QPStatus.SOLVED

    def test_improves_convergence(self):
        qp = simple_qp()
        res_plain = qp_solve(qp, QPSettings(rho=0.1, max_iter=1000))
        res_adapt = qp_solve(
            qp, QPSettings(rho=0.1, max_iter=1000, adaptive_rho=True, adaptive_rho_interval=10)
        )
        assert int(res_adapt.info.status) == QPStatus.SOLVED
        assert int(res_adapt.info.iter) < 1000
        assert int(res_adapt.info.iter) < int(res_plain.info.iter)
        assert int(res_adapt.info.rho_updates) >= 1


class TestConstraintClassification:
    """Reference: TestConstraint (tests/qp_solver_test.cpp:127-156)."""

    def test_truth_table(self):
        T = 1e16
        l = jnp.array([-10 * T, -1.0, -10 * T, -3.0, 42.0])
        u = jnp.array([10 * T, 10 * T, 2.0, 4.0, 42.0])
        expect = [
            LOOSE_BOUNDS,
            INEQUALITY_CONSTRAINT,
            INEQUALITY_CONSTRAINT,
            INEQUALITY_CONSTRAINT,
            EQUALITY_CONSTRAINT,
        ]
        got = np.asarray(constr_type_init(l, u))
        np.testing.assert_array_equal(got, expect)

    def test_static_method_parity(self):
        got = QPSolver.constr_type_init(np.array([42.0]), np.array([42.0]))
        assert got[0] == EQUALITY_CONSTRAINT


class TestStatefulWrapper:
    """Reference OO workflow: setup / solve / update_qp / repeat-solve
    (tests/qp_solver_sparse_test.cpp:68-98)."""

    def test_multiple_solve(self):
        qp = simple_qp()
        solver = QPSolver()
        solver.setup(qp)
        solver.solve()
        assert solver._status == QPStatus.SOLVED
        solver.solve()
        assert solver._status == QPStatus.SOLVED
        np.testing.assert_allclose(
            np.asarray(solver.primal_solution()), SIMPLE_QP_SOLUTION, atol=1e-2
        )

    def test_update_qp(self):
        qp = simple_qp()
        solver = QPSolver()
        solver.setup(qp)
        solver.solve()
        np.testing.assert_allclose(
            np.asarray(solver.primal_solution()), SIMPLE_QP_SOLUTION, atol=1e-2
        )
        # change P -> identity, q -> 0: new solution [0.5, 0.5]
        qp2 = QuadraticProblem(
            P=jnp.eye(2, dtype=qp.P.dtype),
            q=jnp.zeros(2, dtype=qp.P.dtype),
            A=qp.A,
            l=qp.l,
            u=qp.u,
        )
        solver.update_qp(qp2)
        solver.solve()
        np.testing.assert_allclose(
            np.asarray(solver.primal_solution()), [0.5, 0.5], atol=1e-2
        )

    def test_warm_start_reuses_state(self):
        qp = simple_qp()
        solver = QPSolver(QPSettings(warm_start=True))
        solver.setup(qp)
        r1 = solver.solve()
        r2 = solver.solve()
        # warm-started resolve converges at (or before) the first check
        assert int(r2.info.iter) <= int(r1.info.iter)


class TestBatched:
    """vmap over a batch of QPs — per-problem termination via batched
    while_loop (no reference analog; this is the batching story)."""

    def test_vmap_batch(self):
        qp = simple_qp()
        B = 16
        scale = jnp.linspace(0.5, 2.0, B, dtype=qp.P.dtype)
        batch = QuadraticProblem(
            P=jnp.broadcast_to(qp.P, (B, 2, 2)),
            q=scale[:, None] * qp.q,
            A=jnp.broadcast_to(qp.A, (B, 3, 2)),
            l=jnp.broadcast_to(qp.l, (B, 3)),
            u=jnp.broadcast_to(qp.u, (B, 3)),
        )
        settings = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=5000)
        res = jax.jit(jax.vmap(lambda p: qp_solve(p, settings)))(batch)
        assert res.x.shape == (B, 2)
        # every problem solved
        assert np.all(np.asarray(res.info.status) == QPStatus.SOLVED)
        # batch element with scale=1.0 must match the single solve
        single = qp_solve(qp, settings)
        i = int(np.argmin(np.abs(np.asarray(scale) - 1.0)))
        if abs(float(scale[i]) - 1.0) < 1e-12:
            np.testing.assert_allclose(
                np.asarray(res.x[i]), np.asarray(single.x), atol=1e-9
            )
        # all must be feasible
        Ax = np.einsum("bmn,bn->bm", np.asarray(batch.A), np.asarray(res.x))
        assert (Ax - np.asarray(batch.l)).min() >= -1e-4
        assert (Ax - np.asarray(batch.u)).max() <= 1e-4

    def test_failed_problem_does_not_poison_batch(self):
        qp = simple_qp()
        B = 4
        P = jnp.broadcast_to(qp.P, (B, 2, 2))
        # poison problem 2 with a NaN cost
        q = jnp.broadcast_to(qp.q, (B, 2)).at[2, 0].set(jnp.nan)
        batch = QuadraticProblem(
            P=P,
            q=q,
            A=jnp.broadcast_to(qp.A, (B, 3, 2)),
            l=jnp.broadcast_to(qp.l, (B, 3)),
            u=jnp.broadcast_to(qp.u, (B, 3)),
        )
        res = jax.vmap(lambda p: qp_solve(p))(batch)
        status = np.asarray(res.info.status)
        ok = [0, 1, 3]
        assert np.all(status[ok] == QPStatus.SOLVED)
        for i in ok:
            np.testing.assert_allclose(np.asarray(res.x[i]), SIMPLE_QP_SOLUTION, atol=1e-2)


class TestLinearSolverHardening:
    """Failure injection on the CG and LDLT backends (no silent success)."""

    def test_cg_ill_conditioned_converges(self):
        # wide rho spread (equality + loose rows) exercises the Jacobi
        # preconditioner; unpreconditioned CG stalls in f64 tolerance here
        rng = np.random.default_rng(7)
        n, m = 12, 16
        G = rng.normal(size=(n, n))
        P = jnp.asarray(G @ G.T + np.diag(10.0 ** rng.uniform(-3, 3, n)))
        A = jnp.asarray(rng.normal(size=(m, n)))
        x_feas = rng.normal(size=n)
        Ax = np.asarray(A) @ x_feas
        l = jnp.asarray(np.where(np.arange(m) % 3 == 0, Ax, Ax - 1.0))
        u = jnp.asarray(np.where(np.arange(m) % 3 == 0, Ax, Ax + 1.0))
        qp = QuadraticProblem(P=P, q=jnp.asarray(rng.normal(size=n)), A=A, l=l, u=u)
        ref = qp_solve(qp, QPSettings(adaptive_rho=True, max_iter=4000))
        res = qp_solve(qp, QPSettings(adaptive_rho=True, max_iter=4000, linear_solver="cg"))
        assert int(res.info.status) == QPStatus.SOLVED
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-2)

    def test_cg_nan_input_reports_numerical_issues(self):
        qp = simple_qp()
        bad = QuadraticProblem(
            P=qp.P.at[0, 0].set(jnp.nan), q=qp.q, A=qp.A, l=qp.l, u=qp.u
        )
        res = qp_solve(bad, QPSettings(linear_solver="cg"))
        assert int(res.info.status) != QPStatus.SOLVED

    def test_kkt_pivot_threshold(self):
        from sqp_solver_tpu.ops.linear_solver import _kkt_is_failure

        floor = jnp.asarray(5e-7)  # 0.5 * min(sigma=1e-6, 1/rho_max)
        healthy = {"d": jnp.asarray([2.0, 1.0, -0.5, -3.0]), "pivot_floor": floor}
        assert not bool(_kkt_is_failure(healthy))
        tiny_pivot = {"d": jnp.asarray([2.0, 1e-20, -0.5, -3.0]), "pivot_floor": floor}
        assert bool(_kkt_is_failure(tiny_pivot))
        nan_pivot = {"d": jnp.asarray([2.0, jnp.nan, -0.5, -3.0]), "pivot_floor": floor}
        assert bool(_kkt_is_failure(nan_pivot))
        # pivots spanning a huge range are LEGITIMATE for a quasi-definite
        # KKT (huber spans [1e-6, 3e6] in f32): a sigma-level pivot next to
        # a large one must NOT be flagged (regression: the old threshold
        # was relative to the largest pivot and false-failed huber)
        wide = {"d": jnp.asarray([1e-6, 3e6, -0.5, -3.0]), "pivot_floor": floor}
        assert not bool(_kkt_is_failure(wide))

    def test_kkt_ldlt_solves_equality_heavy_f32(self):
        """End-to-end regression for the huber false NUMERICAL_ISSUES."""
        from sqp_solver_tpu.models.families import huber_qp_batch
        from sqp_solver_tpu.parallel.batch import qp_solve_batch

        problem, _ = huber_qp_batch(2, dtype=jnp.float32)
        res = qp_solve_batch(
            problem,
            QPSettings(eps_abs=1e-3, eps_rel=1e-3, max_iter=500,
                       adaptive_rho=True, linear_solver="kkt_ldlt",
                       scaling=10),
        )
        st = np.asarray(res.info.status)
        assert (st != QPStatus.NUMERICAL_ISSUES).all(), st

    def test_kkt_ldlt_nan_reports_numerical_issues(self):
        qp = simple_qp()
        bad = QuadraticProblem(
            P=qp.P.at[0, 0].set(jnp.nan), q=qp.q, A=qp.A, l=qp.l, u=qp.u
        )
        res = qp_solve(bad, QPSettings(linear_solver="kkt_ldlt"))
        assert int(res.info.status) == QPStatus.NUMERICAL_ISSUES


class TestBlockedCholesky:
    """Large-n blocked Cholesky backend (SURVEY C6 north-star kernel)."""

    def test_blocked_factor_matches_default(self):
        from sqp_solver_tpu.models.mpc import random_qp_batch

        qp = random_qp_batch(batch=1, n=40, m=50, seed=1, dtype=jnp.float64)
        qp1 = jax.tree.map(lambda v: v[0], qp)
        ref = qp_solve(qp1, QPSettings(adaptive_rho=True, max_iter=2000))
        out = qp_solve(
            qp1,
            QPSettings(
                adaptive_rho=True, max_iter=2000,
                linear_solver="schur_cholesky_blocked",
            ),
        )
        assert int(out.info.status) == QPStatus.SOLVED
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-8)

    def test_blocked_pieces(self):
        from sqp_solver_tpu.ops.linear_solver import (
            _blocked_cholesky,
            _blocked_tri_inv,
        )

        rng = np.random.default_rng(0)
        n = 200
        G = rng.normal(size=(n, n))
        M = jnp.asarray(G @ G.T + n * np.eye(n))
        L = _blocked_cholesky(M, bs=64)
        np.testing.assert_allclose(
            np.asarray(L @ L.T), np.asarray(M), rtol=1e-10, atol=1e-8
        )
        Li = _blocked_tri_inv(L, bs=64)
        np.testing.assert_allclose(np.asarray(Li @ L), np.eye(n), atol=1e-10)
