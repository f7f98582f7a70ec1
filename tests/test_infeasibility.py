"""OSQP §3.4 infeasibility certificates (qp/infeasibility.py) — the
capability the reference lacks entirely: it can only burn max_iter on an
infeasible problem (``src/qp.cpp:147-149``).  Detection must fire on all
tiers, with matching statuses, and never fire on feasible problems."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus, QuadraticProblem, qp_solve

S = QPSettings(
    eps_abs=1e-4, eps_rel=1e-4, max_iter=1000, check_termination=25,
    adaptive_rho=True,
)


def _primal_infeasible_batch(B=6, dtype=jnp.float64):
    """x <= -1 AND x >= 1 (plus benign extra rows), batched."""
    n, m = 2, 3
    P = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (B, n, n))
    q = jnp.zeros((B, n), dtype)
    A = jnp.broadcast_to(
        jnp.asarray([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], dtype), (B, m, n)
    )
    l = jnp.broadcast_to(jnp.asarray([-1e30, 1.0, -1.0], dtype), (B, m))
    u = jnp.broadcast_to(jnp.asarray([-1.0, 1e30, 1.0], dtype), (B, m))
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)


def _dual_infeasible_batch(B=6, dtype=jnp.float64):
    """min -x1 with x1 >= 0 only: unbounded below (P singular)."""
    n, m = 2, 2
    P = jnp.zeros((B, n, n), dtype).at[:, 1, 1].set(1.0)
    q = jnp.broadcast_to(jnp.asarray([-1.0, 0.0], dtype), (B, n))
    A = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (B, m, n))
    l = jnp.broadcast_to(jnp.asarray([0.0, -1.0], dtype), (B, m))
    u = jnp.broadcast_to(jnp.asarray([1e30, 1.0], dtype), (B, m))
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)


class TestCertificates:
    @pytest.mark.parametrize("impl", ["vmap", "fused", "fused-f32"])
    def test_primal_infeasible_all_tiers(self, impl):
        dtype = jnp.float32 if impl.endswith("f32") else jnp.float64
        impl = impl.split("-")[0]
        qp = _primal_infeasible_batch(dtype=dtype)
        res = qp_solve_batch(qp, S, impl=impl)
        st = np.asarray(res.info.status)
        assert (st == QPStatus.PRIMAL_INFEASIBLE).all(), st
        # detection is fast: far below the iteration budget
        assert np.asarray(res.info.iter).max() < 200

    @pytest.mark.parametrize("impl", ["vmap", "fused", "fused-f32"])
    def test_dual_infeasible_all_tiers(self, impl):
        dtype = jnp.float32 if impl.endswith("f32") else jnp.float64
        impl = impl.split("-")[0]
        qp = _dual_infeasible_batch(dtype=dtype)
        res = qp_solve_batch(qp, S, impl=impl)
        st = np.asarray(res.info.status)
        assert (st == QPStatus.DUAL_INFEASIBLE).all(), st
        assert np.asarray(res.info.iter).max() < 200

    def test_mixed_batch_isolation(self):
        """Feasible batch-mates of an infeasible problem still solve."""
        feas = random_qp_batch(batch=4, n=2, m=3, seed=0, dtype=jnp.float64)
        inf = _primal_infeasible_batch(B=2)
        qp = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), feas, inf)
        res = qp_solve_batch(qp, S, impl="fused")
        st = np.asarray(res.info.status)
        assert (st[:4] == QPStatus.SOLVED).all(), st
        assert (st[4:] == QPStatus.PRIMAL_INFEASIBLE).all(), st

    def test_feasible_families_never_flagged(self):
        """No false positives on the standard feasible families."""
        qp = random_qp_batch(batch=32, n=8, m=12, seed=1, dtype=jnp.float64)
        for impl in ("vmap", "fused"):
            res = qp_solve_batch(qp, S, impl=impl)
            st = np.asarray(res.info.status)
            assert (st == QPStatus.SOLVED).all(), (impl, st)

    def test_opt_out_flag(self):
        """check_infeasibility=False restores reference semantics
        (MAX_ITER_EXCEEDED on infeasible problems)."""
        s_off = dataclasses.replace(S, check_infeasibility=False, max_iter=200)
        qp = _primal_infeasible_batch()
        res = qp_solve_batch(qp, s_off, impl="vmap")
        st = np.asarray(res.info.status)
        assert (st == QPStatus.MAX_ITER_EXCEEDED).all(), st

    def test_scaling_preserves_certificate(self):
        """A certificate found on the scaled problem passes through
        rescore (it certifies the original problem)."""
        s_sc = dataclasses.replace(S, scaling=6)
        qp = _primal_infeasible_batch()
        res = qp_solve_batch(qp, s_sc, impl="vmap")
        st = np.asarray(res.info.status)
        assert (st == QPStatus.PRIMAL_INFEASIBLE).all(), st


class TestSQPSubproblemCertificates:
    def test_sqp_tiers_ignore_inner_qp_certificates(self):
        """Subproblem infeasibility certificates are disabled BY
        CONSTRUCTION on every SQP tier: a user passing
        check_infeasibility=True in the inner settings must get the same
        trajectory as with it off."""
        import dataclasses

        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.sqp import SQPSettings
        from sqp_solver_tpu.sqp.solver_batched import sqp_solve_fused

        problem, x0 = sphere_cap_nlp_batch(12, 6, seed=4, dtype=jnp.float32)
        qp_cfg = QPSettings(
            eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
            warm_start=True, adaptive_rho=True, adaptive_rho_interval=50,
            check_infeasibility=True,  # the footgun the tiers must ignore
        )
        s = SQPSettings(
            max_iter=10, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", qp=qp_cfg,
        )
        s_off = dataclasses.replace(
            s, qp=dataclasses.replace(qp_cfg, check_infeasibility=False)
        )
        r_on = sqp_solve_fused(problem, x0, None, s)
        r_off = sqp_solve_fused(problem, x0, None, s_off)
        # the flag must be a no-op inside the SQP loop: identical
        # statuses AND identical iterates
        np.testing.assert_array_equal(
            np.asarray(r_on.info.status), np.asarray(r_off.info.status)
        )
        np.testing.assert_array_equal(
            np.asarray(r_on.x), np.asarray(r_off.x)
        )
