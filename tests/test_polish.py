"""Solution polish: accuracy gain vs the long-double oracle, never-worse
acceptance, all dtypes and solver paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, qp_solve
from sqp_solver_tpu.qp.polish import polish_qp
from sqp_solver_tpu.runtime import native_available, native_qp_solve_batch

pytestmark = pytest.mark.skipif(not native_available(), reason="g++ unavailable")

S = QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=500, adaptive_rho=True,
               adaptive_rho_interval=50)
ORACLE = QPSettings(eps_abs=1e-12, eps_rel=1e-12, max_iter=200000, adaptive_rho=True)


@pytest.fixture(scope="module")
def oracle():
    qp64 = random_qp_batch(batch=24, n=10, m=14, seed=11, dtype=jnp.float64)
    x_ref, *_ = native_qp_solve_batch(
        *(np.asarray(v) for v in (qp64.P, qp64.q, qp64.A, qp64.l, qp64.u)), ORACLE
    )
    return qp64, x_ref


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_polish_improves_accuracy(oracle, dtype):
    qp64, x_ref = oracle
    qp = jax.tree.map(lambda a: a.astype(dtype), qp64)
    res = qp_solve_batch(qp, S)
    pol = polish_qp(qp, res, S)
    err0 = np.abs(np.asarray(res.x, np.float64) - x_ref).max(axis=1)
    err1 = np.abs(np.asarray(pol.x, np.float64) - x_ref).max(axis=1)
    # strong median gain, and never meaningfully worse
    assert np.percentile(err1, 50) < 0.25 * np.percentile(err0, 50)
    assert err1.max() < max(2e-5, 1.2 * err0.max())


def test_polish_flag_in_settings(oracle):
    qp64, x_ref = oracle
    qp = jax.tree.map(lambda a: a.astype(jnp.float32), qp64)
    import dataclasses

    res = qp_solve_batch(qp, dataclasses.replace(S, polish=True))
    err = np.abs(np.asarray(res.x, np.float64) - x_ref).max(axis=1)
    assert np.percentile(err, 50) < 2e-5


def test_polish_single_problem(oracle):
    qp64, x_ref = oracle
    one = jax.tree.map(lambda a: a[0], qp64)
    res = qp_solve(one, S)
    pol = polish_qp(one, res, S)
    assert np.abs(np.asarray(pol.x) - x_ref[0]).max() <= max(
        1e-7, np.abs(np.asarray(res.x) - x_ref[0]).max()
    )


def test_sqp_polish_parity_per_problem_vs_batched():
    """The per-problem tier's polish epilogue is the SAME text as the
    batched tiers' (sqp.common.polish_nlp): it must honor polish_passes
    and the status-refresh rescue identically.  Round-2 review found
    sqp_solve silently single-pass — a user migrating tiers got different
    rescue behavior on degenerate instances."""
    import dataclasses

    from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu.sqp import SQPSettings, sqp_solve
    from sqp_solver_tpu.sqp.solver_batched import sqp_solve_fused
    from sqp_solver_tpu.qp import QPSettings

    # stress distribution includes degenerate r ~ sqrt(n) instances where
    # multi-pass polish (re-guessed active sets) is what rescues
    problem, x0 = sphere_cap_nlp_batch(16, 8, dtype=jnp.float64, r_range=(0.5, 1.2))
    settings = SQPSettings(
        max_iter=30, eps_prim=1e-6, eps_dual=1e-6, termination="kkt",
        polish=True, polish_passes=3,
        qp=QPSettings(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=2000,
                      check_termination=25, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50),
    )
    fused = sqp_solve_fused(problem, x0, None, settings)
    per = jax.vmap(lambda pr, x: sqp_solve(pr, x, None, settings))(problem, x0)
    st_f = np.asarray(fused.info.status)
    st_p = np.asarray(per.info.status)
    # both tiers rescue the same way: the per-problem tier may not be a
    # strict subset anymore (it polishes multi-pass + refreshes status)
    assert (st_p == 0).mean() >= (st_f == 0).mean() - 1e-9
    both = (st_f == 0) & (st_p == 0)
    np.testing.assert_allclose(
        np.asarray(per.x)[both], np.asarray(fused.x)[both], atol=2e-5
    )


def test_polish_hyperparams_thread_through_settings():
    """QPSettings.polish_delta / polish_sweeps reach the polish solve: one
    sweep leaves a visibly larger delta-bias than the default six, and
    invalid values are rejected eagerly."""
    import dataclasses

    qp = random_qp_batch(batch=8, n=10, m=14, seed=21, dtype=jnp.float64)
    res = qp_solve_batch(qp, S)
    # pin passes=1 to isolate the sweeps knob: with >= 2 passes, the
    # warm-started second pass converges 1- and 6-sweep runs to the same
    # fixed point (each sweep contracts the remaining error ~1e-4 here)
    S1 = dataclasses.replace(S, polish_passes=1)
    pol6 = polish_qp(qp, res, S1)
    pol1 = polish_qp(qp, res, dataclasses.replace(S1, polish_sweeps=1))
    assert not np.allclose(np.asarray(pol1.x), np.asarray(pol6.x), atol=1e-12)

    with pytest.raises(ValueError, match="polish_delta"):
        dataclasses.replace(S, polish_delta=0.0).validate()
    with pytest.raises(ValueError, match="polish_sweeps"):
        dataclasses.replace(S, polish_sweeps=0).validate()
    with pytest.raises(ValueError, match="polish_passes"):
        dataclasses.replace(S, polish_passes=0).validate()

    from sqp_solver_tpu.sqp import SQPSettings

    with pytest.raises(ValueError, match="polish_delta"):
        SQPSettings(polish_delta=-1.0).validate()


def test_polish_pass2_repairs_degenerate_active_set():
    """A weakly-active row (multiplier below the dual-sign tolerance) is
    dropped by the pass-1 guess; the polished x then crosses its bound by
    a CURVATURE-AMPLIFIED visible amount, and the second polish pass
    promotes it back (qp.polish.reclassify_active_set).  This is the
    OSQP-paper portfolio family's accuracy outlier reduced to its core.

    Construction: x0 has tiny curvature p0 and a lower bound at 0 whose
    true multiplier 2e-5 sits BELOW ytol = 1e-5*(1+|y|_inf) once x1's
    bound carries a large multiplier (5.0).  The unconverged iterate fed
    to polish has a zeroed dual on row 0 (what ADMM's degenerate lanes
    look like) -- so pass 1 drops the
    row and lands at -q0/p0 = -1e-3, which the guard rejects; pass 2
    sees the violation, promotes the row, and solves exactly.
    """
    import dataclasses

    from sqp_solver_tpu.qp.types import QPInfo, QPResult, QuadraticProblem

    B = 4
    p0 = 0.02
    P = jnp.tile(jnp.diag(jnp.array([p0, 1.0]))[None], (B, 1, 1))
    q = jnp.tile(jnp.array([2e-5, 5.0])[None], (B, 1))
    A = jnp.tile(jnp.eye(2)[None], (B, 1, 1))
    l = jnp.zeros((B, 2))
    u = jnp.full((B, 2), jnp.inf)
    qp = QuadraticProblem(P=P, q=q, A=A, l=l, u=u)
    # x* = (0, 0), y* = (-2e-5, -5); feed an eps~5e-4-converged iterate
    # whose dual on the weakly-active row is 0 (degenerate-lane shape)
    x_raw = jnp.tile(jnp.array([-5e-4, 1e-6])[None], (B, 1))
    y_raw = jnp.tile(jnp.array([0.0, -5.0])[None], (B, 1))
    z_raw = jnp.clip(jnp.einsum("bij,bj->bi", A, x_raw), l, u)
    info = QPInfo(
        status=jnp.zeros(B, jnp.int32), iter=jnp.full(B, 100, jnp.int32),
        rho_updates=jnp.zeros(B, jnp.int32), rho_estimate=jnp.ones(B),
        res_prim=jnp.full(B, 5e-4), res_dual=jnp.full(B, 5e-4),
    )
    raw = QPResult(x=x_raw, y=y_raw, z=z_raw, info=info)

    pol1 = polish_qp(qp, raw, S, passes=1)
    pol2 = polish_qp(qp, raw, S, passes=2)
    x1 = np.asarray(pol1.x)
    x2 = np.asarray(pol2.x)
    # pass 1 alone: the dropped-row candidate (x0 = -1e-3) scores WORSE
    # than the raw iterate, so the guard keeps raw -- err stays ~5e-4
    assert np.all(np.abs(x1[:, 0]) > 1e-5), x1[:, 0]
    # pass 2: violation-promoted row solves to the exact optimum
    assert np.all(np.abs(x2[:, 0]) < 1e-7), x2[:, 0]
    assert np.all(np.abs(x2[:, 1]) < 1e-7), x2[:, 1]
    # and the repaired dual is the true weakly-active multiplier
    y2 = np.asarray(pol2.y)
    np.testing.assert_allclose(y2[:, 0], -2e-5, atol=1e-9)
