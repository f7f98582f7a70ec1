"""Safeguarded Anderson acceleration (QPSettings.acceleration="anderson").

Type-II AA on the ADMM chunk map with true-residual safeguarding: must
cut iteration counts substantially at fixed rho (the literature's 2-5x —
PAPERS.md), never change solutions or statuses, and compose with
adaptive rho (buffers reset on re-factorization)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.families import huber_qp_batch
from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus

BASE = QPSettings(eps_abs=1e-9, eps_rel=1e-9, max_iter=4000, check_termination=25)


class TestAnderson:
    def test_iteration_reduction_fixed_rho(self):
        qp = random_qp_batch(batch=8, n=12, m=18, seed=3, dtype=jnp.float64)
        plain = qp_solve_batch(qp, BASE)
        acc = qp_solve_batch(
            qp, dataclasses.replace(BASE, acceleration="anderson")
        )
        i0 = np.asarray(plain.info.iter).astype(float)
        i1 = np.asarray(acc.info.iter).astype(float)
        assert i1.mean() < 0.5 * i0.mean(), (i0.mean(), i1.mean())
        np.testing.assert_allclose(
            np.asarray(acc.x), np.asarray(plain.x), atol=1e-6
        )
        assert (np.asarray(acc.info.status) == QPStatus.SOLVED).all()

    def test_composes_with_adaptive_rho(self):
        problem, _ = huber_qp_batch(6, dtype=jnp.float64)
        s0 = dataclasses.replace(BASE, adaptive_rho=True)
        s1 = dataclasses.replace(s0, acceleration="anderson")
        plain = qp_solve_batch(problem, s0)
        acc = qp_solve_batch(problem, s1)
        assert (
            np.asarray(acc.info.status) == np.asarray(plain.info.status)
        ).all()
        # safeguarded: never slower in iterations than plain + one chunk
        assert (
            np.asarray(acc.info.iter) <= np.asarray(plain.info.iter) + 25
        ).all()
        np.testing.assert_allclose(
            np.asarray(acc.x), np.asarray(plain.x), atol=1e-6
        )

    def test_f32_safeguard_never_degrades(self):
        problem, _ = huber_qp_batch(4, dtype=jnp.float32)
        s = QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=1000,
                       adaptive_rho=True, scaling=10)
        plain = qp_solve_batch(problem, s)
        acc = qp_solve_batch(
            problem, dataclasses.replace(s, acceleration="anderson")
        )
        # residuals of the accelerated run are no worse (safeguard accepts
        # the extrapolation only when the true residual improves)
        assert (
            np.asarray(acc.info.res_prim)
            <= np.asarray(plain.info.res_prim) * 3 + 1e-6
        ).all()
        assert not np.isnan(np.asarray(acc.x)).any()

    def test_validation(self):
        with pytest.raises(ValueError):
            QPSettings(acceleration="nope").validate()
        with pytest.raises(ValueError):
            QPSettings(anderson_memory=0).validate()

    def test_fused_tier_matches_vmap_tier(self):
        """The batched AA implementation must reproduce the per-problem
        one: same iterate reductions, same optima."""
        qp = random_qp_batch(batch=8, n=10, m=15, seed=6, dtype=jnp.float64)
        s = dataclasses.replace(BASE, acceleration="anderson")
        ref = qp_solve_batch(qp, s, impl="vmap")
        out = qp_solve_batch(qp, s, impl="fused")
        assert (np.asarray(out.info.status) == QPStatus.SOLVED).all()
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-6)
        # both accelerate: well under the plain iteration count
        plain = qp_solve_batch(qp, BASE, impl="fused")
        assert np.asarray(out.info.iter).mean() < 0.6 * np.asarray(
            plain.info.iter
        ).mean()


class TestAndersonEdgeCases:
    @pytest.mark.parametrize("mem", [1, 8])
    def test_memory_sizes_consistent_across_tiers(self, mem):
        qp = random_qp_batch(batch=4, n=8, m=12, seed=2, dtype=jnp.float64)
        s = dataclasses.replace(BASE, eps_abs=1e-8, eps_rel=1e-8,
                                max_iter=2000, acceleration="anderson",
                                anderson_memory=mem)
        ref = qp_solve_batch(qp, s, impl="vmap")
        out = qp_solve_batch(qp, s, impl="fused")
        assert (np.asarray(ref.info.status) == QPStatus.SOLVED).all()
        np.testing.assert_array_equal(
            np.asarray(out.info.iter), np.asarray(ref.info.iter)
        )
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x),
                                   atol=1e-7)

    def test_check_zero_semantics_preserved(self):
        """check_termination=0 means 'never check' in the reference
        (src/qp.cpp:105); acceleration must not change that."""
        qp = random_qp_batch(batch=4, n=8, m=12, seed=2, dtype=jnp.float64)
        s = dataclasses.replace(BASE, max_iter=200, check_termination=0,
                                acceleration="anderson")
        res = qp_solve_batch(qp, s)
        assert (np.asarray(res.info.status) == QPStatus.MAX_ITER_EXCEEDED).all()
        assert (np.asarray(res.info.iter) == 200).all()


class TestFusedTierAnderson:
    """Anderson on the production batched tier in f32, where ADMM's
    linear tail is longest (fixed schedule, tight tolerance)."""

    S32 = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000,
                     check_termination=25, schedule="fixed")

    def test_fused_aa_cuts_iterations_f32(self):
        qp = random_qp_batch(batch=32, n=8, m=12, seed=1, dtype=jnp.float32)
        plain = qp_solve_batch(qp, self.S32, impl="fused")
        aa = qp_solve_batch(
            qp, dataclasses.replace(self.S32, acceleration="anderson"), impl="fused"
        )
        it_p = np.asarray(plain.info.iter).mean()
        it_a = np.asarray(aa.info.iter).mean()
        assert it_a < 0.6 * it_p, (it_p, it_a)
        ok = (np.asarray(plain.info.status) == 0) & (np.asarray(aa.info.status) == 0)
        assert ok.mean() > 0.9
        np.testing.assert_allclose(
            np.asarray(aa.x)[ok], np.asarray(plain.x)[ok], atol=5e-4
        )

    def test_sqp_fused_tier_accepts_anderson(self):
        """The SQP fused tier's inner QP runs AA."""
        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch
        from sqp_solver_tpu.sqp import SQPSettings

        problem, x0 = sphere_cap_nlp_batch(8, 6, seed=4, dtype=jnp.float32)
        s = SQPSettings(
            max_iter=12, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", polish=True,
            qp=QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=200,
                          check_termination=25, warm_start=True,
                          adaptive_rho=True, adaptive_rho_interval=50,
                          acceleration="anderson"),
        )
        res = sqp_solve_batch(problem, x0, None, s, impl="fused")
        st = np.asarray(res.info.status)
        assert (st == 0).sum() >= 6
        assert not np.isnan(np.asarray(res.x)).any()
