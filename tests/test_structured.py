"""Structured (block-tridiagonal) KKT path + reference sparse-test port.

The reference's sparse QP support lives in a disabled test file and a
broken macro combination (SURVEY quirk Q2); its *capability* obligation —
structure-exploiting factorization, exercised by
``tests/qp_solver_sparse_test.cpp`` — is met here by the
``schur_block_tridiag`` backend on stage-wise MPC problems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import mpc_qp_stagewise_batch
from sqp_solver_tpu.models.problems import simple_qp
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus, qp_solve
from sqp_solver_tpu.qp.types import QuadraticProblem

SIMPLE_QP_SOLUTION = np.array([0.3, 0.7])


class TestBlockTridiagonal:
    def _problem(self, batch=4, horizon=12):
        return mpc_qp_stagewise_batch(batch, horizon=horizon, dtype=jnp.float64)

    def test_schur_matrix_is_block_tridiagonal(self):
        from sqp_solver_tpu.ops.linear_solver import _schur_matrix
        from sqp_solver_tpu.qp.classify import constr_type_init, rho_vec_from_type

        qp, b = self._problem(batch=1)
        P, A = qp.P[0], qp.A[0]
        ctype = constr_type_init(qp.l[0], qp.u[0])
        rho_vec = rho_vec_from_type(ctype, 0.1, jnp.float64)
        M = np.asarray(_schur_matrix(P, A, 1e-6, rho_vec))
        T = M.shape[0] // b
        for i in range(T):
            for j in range(T):
                if abs(i - j) > 1:
                    blk = M[i * b : (i + 1) * b, j * b : (j + 1) * b]
                    np.testing.assert_allclose(blk, 0.0, atol=1e-12)

    def test_matches_dense_path(self):
        qp, b = self._problem()
        dense = qp_solve_batch(qp, QPSettings(adaptive_rho=True, max_iter=2000))
        structured = qp_solve_batch(
            qp,
            QPSettings(
                adaptive_rho=True,
                max_iter=2000,
                linear_solver="schur_block_tridiag",
                block_size=b,
            ),
        )
        assert np.all(np.asarray(structured.info.status) == QPStatus.SOLVED)
        np.testing.assert_allclose(
            np.asarray(structured.x), np.asarray(dense.x), atol=1e-6
        )
        # identical iterate math => identical iteration counts
        np.testing.assert_array_equal(
            np.asarray(structured.info.iter), np.asarray(dense.info.iter)
        )

    def test_dynamics_satisfied(self):
        qp, b = self._problem(batch=2, horizon=8)
        res = qp_solve_batch(
            qp,
            QPSettings(
                eps_abs=1e-7, eps_rel=1e-7, adaptive_rho=True, max_iter=4000,
                linear_solver="schur_block_tridiag", block_size=b, polish=True,
            ),
        )
        # equality (dynamics) rows must hold tightly after polish
        viol = np.einsum(
            "bmn,bn->bm", np.asarray(qp.A), np.asarray(res.x)
        ) - np.asarray(qp.u)
        dyn = viol[:, :16]  # nx * horizon = 16 dynamics rows
        assert np.abs(dyn).max() < 1e-6

    def test_validation(self):
        with pytest.raises(ValueError):
            QPSettings(linear_solver="schur_block_tridiag").validate()


class TestArrow:
    """Arrow-structured (bordered block-diagonal) Schur backend on the
    multi-agent rendezvous family — the border-coupled structure the
    block-tridiagonal backend cannot express (VERDICT round-2 "missing"
    item 2: arrow-structured KKTs, common in MPC with coupling
    constraints)."""

    def _problem(self, batch=4, agents=6, horizon=4, meet_points=2):
        from sqp_solver_tpu.models.mpc import mpc_qp_coupled_batch

        return mpc_qp_coupled_batch(
            batch, agents=agents, horizon=horizon, meet_points=meet_points,
            dtype=jnp.float64,
        )

    def test_schur_matrix_is_arrow(self):
        from sqp_solver_tpu.ops.linear_solver import _schur_matrix
        from sqp_solver_tpu.qp.classify import constr_type_init, rho_vec_from_type

        qp, b, c = self._problem(batch=1)
        P, A = qp.P[0], qp.A[0]
        ctype = constr_type_init(qp.l[0], qp.u[0])
        rho_vec = rho_vec_from_type(ctype, 0.1, jnp.float64)
        M = np.asarray(_schur_matrix(P, A, 1e-6, rho_vec))
        nd = M.shape[0] - c
        T = nd // b
        for i in range(T):
            for j in range(T):
                if i != j:
                    blk = M[i * b : (i + 1) * b, j * b : (j + 1) * b]
                    np.testing.assert_allclose(blk, 0.0, atol=1e-12)

    def test_matches_dense_path(self):
        qp, b, c = self._problem()
        dense = qp_solve_batch(qp, QPSettings(adaptive_rho=True, max_iter=2000))
        arrow = qp_solve_batch(
            qp,
            QPSettings(
                adaptive_rho=True, max_iter=2000,
                linear_solver="schur_arrow", block_size=b, arrow_width=c,
            ),
        )
        assert np.all(np.asarray(arrow.info.status) == QPStatus.SOLVED)
        np.testing.assert_allclose(
            np.asarray(arrow.x), np.asarray(dense.x), atol=1e-6
        )
        # identical iterate math => identical iteration counts
        np.testing.assert_array_equal(
            np.asarray(arrow.info.iter), np.asarray(dense.info.iter)
        )

    def test_rendezvous_semantics(self):
        """Agents sharing a meet point end at the SAME (optimized)
        terminal position."""
        qp, b, c = self._problem(batch=2)
        res = qp_solve_batch(
            qp,
            QPSettings(
                eps_abs=1e-8, eps_rel=1e-8, adaptive_rho=True, max_iter=4000,
                linear_solver="schur_arrow", block_size=b, arrow_width=c,
                polish=True,
            ),
        )
        assert np.all(np.asarray(res.info.status) == QPStatus.SOLVED)
        # the rendezvous equality rows must hold tightly after polish
        viol = np.einsum(
            "bmn,bn->bm", np.asarray(qp.A), np.asarray(res.x)
        ) - np.asarray(qp.u)
        S = 6
        eq_rows = [k * (2 * b + 1) + 2 * b for k in range(S)]
        assert np.abs(viol[:, eq_rows]).max() < 1e-6

    def test_fused_arrow_matches_vmap(self):
        qp, b, c = self._problem()
        s = QPSettings(
            eps_abs=1e-8, eps_rel=1e-8, max_iter=2000, adaptive_rho=True,
            linear_solver="schur_arrow", block_size=b, arrow_width=c,
        )
        ref = qp_solve_batch(qp, s, impl="vmap")
        out = qp_solve_batch(qp, s, impl="fused")
        np.testing.assert_array_equal(
            np.asarray(ref.info.status), np.asarray(out.info.status)
        )
        assert (np.asarray(out.info.status) == 0).all()
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-6)

    def test_f32_large_blocks_converge(self):
        """f32 robustness at b=32 blocks: the composed bordered inverse
        without Newton-Schulz correction (per block + border + once
        against full M) stalled ADMM outright (solved 0.58 at n=770 —
        see _arrow_factor_factory docstring).
        Pin that the corrected factorization matches the dense backend's
        convergence in f32."""
        from sqp_solver_tpu.models.mpc import mpc_qp_coupled_batch

        qp, b, c = mpc_qp_coupled_batch(
            8, agents=6, horizon=32, dtype=jnp.float32
        )
        s = QPSettings(
            adaptive_rho=True, max_iter=1000,
            linear_solver="schur_arrow", block_size=b, arrow_width=c,
        )
        dense = qp_solve_batch(
            qp, QPSettings(adaptive_rho=True, max_iter=1000)
        )
        arrow = qp_solve_batch(qp, s)
        assert np.all(np.asarray(arrow.info.status) == QPStatus.SOLVED)
        # convergence speed must match dense (the stall showed up as a
        # 8-16x iteration blowup long before outright failure)
        assert np.all(
            np.asarray(arrow.info.iter) <= 2 * np.asarray(dense.info.iter)
        )
        # at h=32 the long-horizon tracking objective is nearly flat in
        # the rendezvous coordinates, so eps=1e-3 solves from different
        # iterate paths land at visibly different near-optima — compare
        # objective value + feasibility, not iterates
        def objective(x):
            Px = np.einsum("bij,bj->bi", np.asarray(qp.P, np.float64), x)
            return 0.5 * np.sum(x * Px, -1) + np.sum(np.asarray(qp.q) * x, -1)

        xa = np.asarray(arrow.x, np.float64)
        xd = np.asarray(dense.x, np.float64)
        np.testing.assert_allclose(objective(xa), objective(xd), rtol=1e-2, atol=1e-3)
        Ax = np.einsum("bmn,bn->bm", np.asarray(qp.A, np.float64), xa)
        viol = np.maximum(Ax - np.asarray(qp.u), np.asarray(qp.l) - Ax)
        assert viol.max() < 5e-3

    def test_validation(self):
        with pytest.raises(ValueError):
            QPSettings(linear_solver="schur_arrow", block_size=4).validate()
        with pytest.raises(ValueError):
            QPSettings(linear_solver="schur_arrow", arrow_width=2).validate()


class TestReferenceSparsePort:
    """Port of the disabled reference sparse tests
    (tests/qp_solver_sparse_test.cpp:51-98) onto our structured/CG paths."""

    def test_sparse_simple_qp_cg(self):
        # qp_solver_sparse_test.cpp:51-66 (ConjugateGradient linear solver)
        qp = simple_qp()
        res = qp_solve(qp, QPSettings(linear_solver="cg"))
        np.testing.assert_allclose(np.asarray(res.x), SIMPLE_QP_SOLUTION, atol=1e-2)
        assert int(res.info.status) == QPStatus.SOLVED

    def test_repeat_solve_idempotent(self):
        # qp_solver_sparse_test.cpp:68-78 (testSolveRepeat)
        qp = simple_qp()
        s = QPSettings()
        first = qp_solve(qp, s)
        again = qp_solve(qp, s)
        np.testing.assert_array_equal(np.asarray(first.x), np.asarray(again.x))
        assert int(again.info.status) == QPStatus.SOLVED

    def test_update_qp_changed_P_q(self):
        # qp_solver_sparse_test.cpp:80-98 (testCanUpdateQP): new P, q with
        # the same structure re-solves correctly
        qp = simple_qp()
        res1 = qp_solve(qp, QPSettings())
        qp2 = QuadraticProblem(
            P=2.0 * qp.P, q=jnp.asarray([1.0, -1.0]), A=qp.A, l=qp.l, u=qp.u
        )
        res2 = qp_solve(qp2, QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000))
        assert int(res2.info.status) == QPStatus.SOLVED
        assert not np.allclose(np.asarray(res1.x), np.asarray(res2.x))
        # verify against direct KKT check: feasibility
        Ax = np.asarray(qp2.A) @ np.asarray(res2.x)
        assert (Ax - np.asarray(qp2.l)).min() > -1e-3
        assert (Ax - np.asarray(qp2.u)).max() < 1e-3


class TestStructuredFusedTier:
    """schur_block_tridiag on the FUSED tier (VERDICT round-2 item 3):
    the structured backend runs inside the fixed-schedule batch-explicit
    loop (XLA chunk with vmapped block-Thomas sweeps), so MPC configs
    stop paying the vmap tier's per-condition host-sync floor."""

    def test_fused_structured_matches_vmap_structured(self):
        import dataclasses

        from sqp_solver_tpu.parallel.batch import qp_solve_batch

        qp, b = mpc_qp_stagewise_batch(4, horizon=12, dtype=jnp.float64)
        s = QPSettings(
            eps_abs=1e-8, eps_rel=1e-8, max_iter=2000, adaptive_rho=True,
            linear_solver="schur_block_tridiag", block_size=b,
        )
        ref = qp_solve_batch(qp, s, impl="vmap")
        out = qp_solve_batch(qp, s, impl="fused")
        np.testing.assert_array_equal(
            np.asarray(ref.info.status), np.asarray(out.info.status)
        )
        assert (np.asarray(out.info.status) == 0).all()
        np.testing.assert_allclose(
            np.asarray(out.x), np.asarray(ref.x), atol=1e-6
        )

    def test_fused_structured_fixed_schedule(self):
        """schedule='fixed' + structured backend: zero dynamic loop
        conditions (the production configuration for the bench)."""
        qp, b = mpc_qp_stagewise_batch(3, horizon=8, dtype=jnp.float64)
        s = QPSettings(
            eps_abs=1e-7, eps_rel=1e-7, max_iter=500, adaptive_rho=True,
            linear_solver="schur_block_tridiag", block_size=b,
            schedule="fixed",
        )
        from sqp_solver_tpu.qp.admm_batched import qp_solve_fused

        out = qp_solve_fused(qp, s)
        assert (np.asarray(out.info.status) == 0).all()
        # accuracy vs the dense fused path
        s_dense = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=500,
                             adaptive_rho=True, schedule="fixed")
        ref = qp_solve_fused(qp, s_dense)
        np.testing.assert_allclose(
            np.asarray(out.x), np.asarray(ref.x), atol=1e-5
        )

    def test_fused_structured_with_anderson(self):
        """Anderson acceleration composes with the structured fused path."""
        import dataclasses

        qp, b = mpc_qp_stagewise_batch(3, horizon=8, dtype=jnp.float64)
        s = QPSettings(
            eps_abs=1e-8, eps_rel=1e-8, max_iter=2000, adaptive_rho=False,
            linear_solver="schur_block_tridiag", block_size=b,
            acceleration="anderson",
        )
        from sqp_solver_tpu.qp.admm_batched import qp_solve_fused

        out = qp_solve_fused(qp, s)
        plain = qp_solve_fused(qp, dataclasses.replace(s, acceleration="none"))
        assert (np.asarray(out.info.status) == 0).all()
        # AA must not be slower in iterations (safeguarded)
        assert np.asarray(out.info.iter).mean() <= np.asarray(plain.info.iter).mean()
        np.testing.assert_allclose(
            np.asarray(out.x), np.asarray(plain.x), atol=1e-5
        )
