"""Ruiz equilibration (qp/scaling.py): scaled-problem equivalence, warm
start mapping, the rescore contract, and the f32 rescue it provides on
badly-scaled families (the capability OSQP has and the reference dropped)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.families import huber_qp_batch
from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus, QuadraticProblem
from sqp_solver_tpu.qp.scaling import (
    rescore,
    ruiz_equilibrate,
    scale_state,
    unscale_result,
)
from sqp_solver_tpu.runtime.native import native_available, native_qp_solve_batch


def _kkt_cols(problem):
    """Per-variable / per-constraint KKT column norms (equilibration target)."""
    P = np.asarray(problem.P, np.float64)
    A = np.asarray(problem.A, np.float64)
    col = np.maximum(np.abs(P).max(axis=-2), np.abs(A).max(axis=-2))
    row = np.abs(A).max(axis=-1)
    return col, row


class TestEquilibration:
    def test_norm_spread_shrinks(self):
        problem, _ = huber_qp_batch(4, dtype=jnp.float64)
        scaled, s = ruiz_equilibrate(problem, 10)
        col0, row0 = _kkt_cols(problem)
        col1, row1 = _kkt_cols(scaled)
        spread = lambda c, r: np.log10(
            np.concatenate([c, r], axis=1).max(axis=1)
            / np.concatenate([c, r], axis=1).min(axis=1)
        )
        assert (spread(col1, row1) < spread(col0, row0) - 0.5).all()
        # equilibrated columns are O(1)
        assert np.abs(np.concatenate([col1, row1], axis=1) - 1.0).max() < 0.5

    def test_scaled_problem_equivalence_f64(self):
        """Solving the scaled problem and unscaling == solving the original."""
        qp = random_qp_batch(batch=8, n=8, m=12, seed=3, dtype=jnp.float64)
        settings = QPSettings(eps_abs=1e-9, eps_rel=1e-9, max_iter=4000,
                              adaptive_rho=True)
        ref = qp_solve_batch(qp, settings)
        scaled, s = ruiz_equilibrate(qp, 10)
        res = unscale_result(qp_solve_batch(scaled, settings), s)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-6)
        np.testing.assert_allclose(np.asarray(res.y), np.asarray(ref.y), atol=1e-6)

    def test_loose_bounds_preserved(self):
        qp = random_qp_batch(batch=4, n=6, m=9, seed=1, dtype=jnp.float64)
        l = np.asarray(qp.l).copy()
        u = np.asarray(qp.u).copy()
        l[:, 0] = -1e20
        u[:, 0] = 1e20
        qp = QuadraticProblem(P=qp.P, q=qp.q, A=qp.A,
                              l=jnp.asarray(l), u=jnp.asarray(u))
        scaled, _ = ruiz_equilibrate(qp, 10)
        # sentinel must stay beyond the classifier threshold on loose rows
        assert np.asarray(scaled.l)[:, 0].max() <= -1e16
        assert np.asarray(scaled.u)[:, 0].min() >= 1e16

    def test_warm_start_roundtrip(self):
        qp = random_qp_batch(batch=4, n=6, m=9, seed=2, dtype=jnp.float64)
        settings = QPSettings(eps_abs=1e-8, eps_rel=1e-8, max_iter=2000,
                              adaptive_rho=True, scaling=10)
        first = qp_solve_batch(qp, settings)
        again = qp_solve_batch(qp, settings, state=first.state)
        # warm start from the solution: immediate re-convergence
        assert (np.asarray(again.info.iter) <= 50).all()
        np.testing.assert_allclose(np.asarray(again.x), np.asarray(first.x),
                                   atol=1e-7)


class TestRescore:
    def test_status_from_true_residuals(self):
        """rescore must not report SOLVED when the unscaled residuals miss
        the tolerance (scaled termination can be optimistic)."""
        qp = random_qp_batch(batch=4, n=6, m=9, seed=4, dtype=jnp.float64)
        settings = QPSettings(eps_abs=1e-9, eps_rel=1e-9, max_iter=2000)
        loose = qp_solve_batch(qp, QPSettings(eps_abs=1e-2, eps_rel=1e-2,
                                              max_iter=2000))
        scored = rescore(qp, loose, settings)
        # a 1e-2-accurate point cannot pass a 1e-9 bar
        assert (np.asarray(scored.info.status) == QPStatus.MAX_ITER_EXCEEDED).all()
        tight = qp_solve_batch(qp, QPSettings(eps_abs=1e-10, eps_rel=1e-10,
                                              max_iter=8000, adaptive_rho=True))
        scored2 = rescore(qp, tight, settings)
        assert (np.asarray(scored2.info.status) == QPStatus.SOLVED).all()


@pytest.mark.skipif(not native_available(), reason="native oracle unavailable")
class TestF32Rescue:
    def test_huber_f32_scaling_polish(self):
        """The headline capability: huber stalls unscaled in f32 (~1e-2
        residuals at max_iter); scaling + ideal-refined polish reaches
        ~1e-6 vs the long-double oracle."""
        problem, _ = huber_qp_batch(6, dtype=jnp.float32)
        x_ref, _, st_ref, _ = native_qp_solve_batch(
            np.asarray(problem.P, np.float64),
            np.asarray(problem.q, np.float64),
            np.asarray(problem.A, np.float64),
            np.asarray(problem.l, np.float64),
            np.asarray(problem.u, np.float64),
            QPSettings(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000,
                       adaptive_rho=True),
        )
        assert (st_ref == QPStatus.SOLVED).all()
        settings = QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000,
                              adaptive_rho=True, scaling=10, polish=True)
        for impl in ("vmap", "fused"):
            res = qp_solve_batch(problem, settings, impl=impl)
            assert (np.asarray(res.info.status) == QPStatus.SOLVED).all()
            err = np.abs(np.asarray(res.x, np.float64) - x_ref).max()
            assert err < 5e-5, err

    def test_huber_f32_unscaled_stalls(self):
        """Documents WHY scaling exists: without it the same f32 solve
        cannot reach tolerance (guards against silently weakening the
        fixture into one that doesn't need scaling)."""
        problem, _ = huber_qp_batch(6, dtype=jnp.float32)
        settings = QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000,
                              adaptive_rho=True)
        res = qp_solve_batch(problem, settings)
        assert (np.asarray(res.info.status) == QPStatus.MAX_ITER_EXCEEDED).any()


class TestClassificationInvariance:
    def test_row_scaling_cannot_cross_class_boundaries(self):
        """Equilibration must not turn an inequality into an equality
        (scaled gap < RHO_TOL) or a finite bound into a loose one
        (past LOOSE_BOUNDS_THRESH) — the solver classifies FROM THE DATA,
        so a crossing silently solves a different problem."""
        from sqp_solver_tpu.qp import constr_type_init

        rng = np.random.default_rng(0)
        n, m = 6, 5
        A = rng.normal(size=(m, n))
        A[0] *= 1e8   # huge row -> e ~ 1e-4 sweeps, gap shrinks hard
        A[1] *= 1e-9  # tiny row -> e grows, finite bounds blow up
        P = np.eye(n)
        q = rng.normal(size=n)
        l = np.array([0.0, -1e15, -1e20, 0.0, 1.0])
        u = np.array([1.0, 1e15, 2.0, 1e20, 1.0 + 1e-5])  # last row: equality
        qp = QuadraticProblem(
            P=jnp.asarray(P), q=jnp.asarray(q), A=jnp.asarray(A),
            l=jnp.asarray(l), u=jnp.asarray(u),
        )
        scaled, _ = ruiz_equilibrate(qp, 10)
        np.testing.assert_array_equal(
            np.asarray(constr_type_init(scaled.l, scaled.u)),
            np.asarray(constr_type_init(qp.l, qp.u)),
        )

    def test_scaled_solve_still_correct_after_correction(self):
        from sqp_solver_tpu.qp import constr_type_init

        rng = np.random.default_rng(1)
        n, m = 6, 4
        M = rng.normal(size=(n, n))
        P = M @ M.T + np.eye(n)
        A = rng.normal(size=(m, n))
        A[0] *= 1e7
        q = rng.normal(size=n)
        l = -np.abs(rng.normal(size=m)) * np.array([1e7, 1, 1, 1])
        u = np.abs(rng.normal(size=m)) * np.array([1e7, 1, 1, 1])
        qp = QuadraticProblem(
            P=jnp.asarray(P)[None].repeat(2, 0), q=jnp.asarray(q)[None].repeat(2, 0),
            A=jnp.asarray(A)[None].repeat(2, 0), l=jnp.asarray(l)[None].repeat(2, 0),
            u=jnp.asarray(u)[None].repeat(2, 0),
        )
        # NOTE: the UNSCALED solver cannot converge on this problem
        # (res_dual stalls at ~0.6 after 8000 iters — which is the point
        # of equilibration), so correctness is judged by the rescored
        # TRUE residuals: SOLVED at 1e-9 on the ORIGINAL problem.
        res = qp_solve_batch(qp, QPSettings(eps_abs=1e-9, eps_rel=1e-9,
                                            max_iter=8000, adaptive_rho=True,
                                            scaling=10))
        assert (np.asarray(res.info.status) == QPStatus.SOLVED).all()
        assert np.asarray(res.info.res_prim).max() < 1e-8
        assert np.asarray(res.info.res_dual).max() < 1e-8


class TestSQPInnerScaling:
    """Inner-QP scaling + acceleration on the batched SQP tiers (the
    round-2 ValueError guards are gone: VERDICT item 2)."""

    def _settings(self, **qpkw):
        from sqp_solver_tpu.sqp import SQPSettings

        QS = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
                  warm_start=True, adaptive_rho=True, adaptive_rho_interval=50)
        QS.update(qpkw)
        return SQPSettings(
            max_iter=12, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", qp=QPSettings(**QS),
        )

    def test_fused_and_vmap_tiers_accept_scaling(self):
        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch
        from sqp_solver_tpu.sqp.solver_batched import sqp_solve_fused

        problem, x0 = sphere_cap_nlp_batch(12, 6, seed=4, dtype=jnp.float32)
        s = self._settings(scaling=6)
        fus = sqp_solve_fused(problem, x0, None, s)
        per = sqp_solve_batch(problem, x0, None, s, impl="vmap")
        st_f = np.asarray(fus.info.status)
        st_p = np.asarray(per.info.status)
        # cross-tier agreement with scaling ON in both inner QPs
        assert (st_f == 0).sum() >= 9
        ok = (st_f == 0) & (st_p == 0)
        assert ok.sum() >= 9
        np.testing.assert_allclose(
            np.asarray(fus.x)[ok], np.asarray(per.x)[ok], atol=1e-4
        )

    def test_fused_tier_accepts_anderson(self):
        from sqp_solver_tpu.models.benchmark import (
            sphere_cap_nlp_batch,
            sphere_cap_solution,
        )
        from sqp_solver_tpu.sqp.solver_batched import sqp_solve_fused

        problem, x0 = sphere_cap_nlp_batch(12, 6, seed=4, dtype=jnp.float64)
        s = self._settings(acceleration="anderson", eps_abs=1e-6,
                           eps_rel=1e-6, max_iter=1000)
        s = dataclasses.replace(s, max_iter=40, eps_prim=1e-6, eps_dual=1e-6,
                                schedule="early_exit")
        res = sqp_solve_fused(problem, x0, None, s)
        st = np.asarray(res.info.status)
        assert (st == 0).mean() >= 0.9
        err = np.abs(np.asarray(res.x) - sphere_cap_solution(problem))[st == 0]
        assert err.max() < 1e-5

    def test_soc_reuses_scale_factors(self):
        """SOC re-solve under scaling reuses the first solve's (d, e, c)
        together with its factor — must run without NaNs."""
        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.sqp.solver_batched import sqp_solve_fused

        problem, x0 = sphere_cap_nlp_batch(8, 6, seed=4, dtype=jnp.float32)
        s = dataclasses.replace(
            self._settings(scaling=6), second_order_correction=True
        )
        res = sqp_solve_fused(problem, x0, None, s)
        st = np.asarray(res.info.status)
        # unconditional SOC stalls some sphere-active instances (quirk Q6);
        # the contract is: no NaNs, no NUMERICAL_ISSUES, some solve
        assert not np.isnan(np.asarray(res.x)).any()
        assert (st == 3).sum() == 0
        assert (st == 0).sum() >= 4


class TestCompSlackRescore:
    """QPSettings.check_comp_slack (round 5): on degenerate families the
    rp/rd-only criterion can declare SOLVED at a non-fixed-point whose y
    is supported on interior rows (huber: objective up to 0.4 above
    optimal at rp/rd ~1e-7).  The flag scores the TRUE comp-slack
    violation at the unscaled rescore (scaled-space violations are
    sub-threshold — unscaling amplifies ~1e4x, measured) and demotes
    such lanes to MAX_ITER_EXCEEDED instead of a false SOLVED."""

    def _solve(self, flag):
        import dataclasses

        from sqp_solver_tpu.models import families as fam
        from sqp_solver_tpu.parallel.batch import qp_solve_batch

        s = QPSettings(
            alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300,
            check_termination=25, adaptive_rho=True,
            adaptive_rho_interval=50, polish=True, scaling=10,
            schedule="fixed", check_comp_slack=flag,
        )
        prob = jax.jit(
            lambda k: fam.huber_qp_batch_device(k, 128, 8, 16)
        )(jax.random.PRNGKey(7))
        return prob, qp_solve_batch(prob, s, impl="fused")

    @staticmethod
    def _dsv(prob, res):
        z = np.asarray(res.z, np.float64)
        y = np.asarray(res.y, np.float64)
        l = np.asarray(prob.l, np.float64)
        u = np.asarray(prob.u, np.float64)
        # unscaled z matches its bound only to f32 roundoff — same
        # at-bound band as the production rescore (qp.scaling)
        btol = 64.0 * np.finfo(np.float32).eps
        at_l = z <= l + btol * (1.0 + np.abs(l))
        at_u = z >= u - btol * (1.0 + np.abs(u))
        return (
            np.where(~at_u, np.maximum(y, 0.0), 0.0)
            + np.where(~at_l, np.maximum(-y, 0.0), 0.0)
        ).max(axis=1)

    def test_flag_eliminates_false_solved(self):
        prob, res0 = self._solve(False)
        dsv0 = self._dsv(prob, res0)
        solved0 = np.asarray(res0.info.status) == 0
        # the phenomenon exists: without the flag, some SOLVED lane
        # grossly violates complementary slackness
        assert (dsv0[solved0] > 1e-2).any(), dsv0[solved0].max()

        prob, res1 = self._solve(True)
        dsv1 = self._dsv(prob, res1)
        solved1 = np.asarray(res1.info.status) == 0
        ytol = 1e-4 * (1.0 + np.abs(np.asarray(res1.y)).max(axis=1))
        assert (dsv1[solved1] <= 1.01 * ytol[solved1]).all(), dsv1[solved1].max()
        # the flag only demotes statuses, never changes iterates
        assert solved1.sum() < solved0.sum()

    def test_fused_tier_supported_under_scaling(self):
        """Under the scaling pipeline the flag is stripped from the inner
        solve (the scaled-space violation is sub-threshold anyway) and
        applied at the unscaled rescore — the fused tier's SOLVED lanes
        pass the true comp-slack bar too."""
        import dataclasses

        from sqp_solver_tpu.models import families as fam
        from sqp_solver_tpu.parallel.batch import qp_solve_batch

        s = QPSettings(
            alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300,
            check_termination=25, adaptive_rho=True,
            adaptive_rho_interval=50, polish=True, scaling=10,
            schedule="fixed", check_comp_slack=True,
        )
        prob = jax.jit(
            lambda k: fam.huber_qp_batch_device(k, 32, 8, 16)
        )(jax.random.PRNGKey(7))
        res = qp_solve_batch(prob, s, impl="fused")
        solved = np.asarray(res.info.status) == 0
        assert solved.any()
        dsv = self._dsv(prob, res)
        ytol = 1e-4 * (1.0 + np.abs(np.asarray(res.y)).max(axis=1))
        assert (dsv[solved] <= 1.01 * ytol[solved]).all(), dsv[solved].max()

    def test_vmap_tier_flag(self):
        """The per-problem tier (vmapped) shares the same in-loop term and
        rescore demotion: no SOLVED lane may violate true comp slack."""
        from sqp_solver_tpu.models import families as fam
        from sqp_solver_tpu.parallel.batch import qp_solve_batch

        s = QPSettings(
            alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300,
            check_termination=25, adaptive_rho=True,
            adaptive_rho_interval=50, polish=True, scaling=10,
            schedule="fixed", check_comp_slack=True,
        )
        prob = jax.jit(
            lambda k: fam.huber_qp_batch_device(k, 32, 8, 16)
        )(jax.random.PRNGKey(7))
        res = qp_solve_batch(prob, s, impl="vmap")
        solved = np.asarray(res.info.status) == 0
        assert solved.any()
        dsv = self._dsv(prob, res)
        ytol = 1e-4 * (1.0 + np.abs(np.asarray(res.y)).max(axis=1))
        assert (dsv[solved] <= 1.01 * ytol[solved]).all(), dsv[solved].max()
