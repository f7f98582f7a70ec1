"""Fused batch-explicit QP solver vs the vmapped reference implementation,
and its ADMM chunk vs a plain numpy float64 reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import mpc_qp_batch, random_qp_batch
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus, QuadraticProblem
from sqp_solver_tpu.qp.admm_batched import qp_solve_fused


SETTINGS = QPSettings(
    alpha=1.6,
    eps_abs=1e-6,
    eps_rel=1e-6,
    max_iter=2000,
    check_termination=25,
    adaptive_rho=True,
    adaptive_rho_interval=50,
)


class TestFusedMatchesVmap:
    @pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
    def test_random_qps(self, dtype):
        qp = random_qp_batch(batch=24, n=8, m=12, seed=5, dtype=dtype)
        ref = qp_solve_batch(qp, SETTINGS)
        out = jax.jit(lambda p: qp_solve_fused(p, SETTINGS))(qp)
        # identical math modulo chunk-boundary freezing -> same optima
        tol = 1e-8 if dtype == jnp.float64 else 1e-4
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=tol)
        mismatch = np.sum(
            np.asarray(out.info.status) != np.asarray(ref.info.status)
        )
        # f32 accumulation-order differences between the residual paths can
        # flip a borderline problem's convergence at exactly the tolerance
        allowed = 0 if dtype == jnp.float64 else 1
        assert mismatch <= allowed, f"{mismatch} status mismatches"

    def test_mpc_batch(self):
        qp = mpc_qp_batch(batch=16, horizon=8, dtype=jnp.float64)
        ref = qp_solve_batch(qp, SETTINGS)
        out = qp_solve_fused(qp, SETTINGS)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-8)

    def test_batch_padding(self):
        # B=13: no batch-size assumption anywhere in the fused tier
        qp = random_qp_batch(batch=13, n=6, m=9, seed=7, dtype=jnp.float64)
        ref = qp_solve_batch(qp, SETTINGS)
        out = qp_solve_fused(qp, SETTINGS)
        assert out.x.shape == (13, 6)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-8)

    def test_warm_start_state(self):
        qp = random_qp_batch(batch=8, n=6, m=9, seed=9, dtype=jnp.float64)
        first = qp_solve_fused(qp, SETTINGS)
        again = qp_solve_fused(qp, SETTINGS, state=first.state)
        assert np.asarray(again.info.iter).max() <= np.asarray(first.info.iter).max()


def numpy_chunk(W, P, A, qv, sc, ri, rp, lp, up, s, yp, alpha, seg):
    """The chunk's iteration and residuals written out plainly in float64
    numpy (reference src/qp.cpp:84-103 on the padded vectors).  Also
    chip_smoke.py's reference for the chunk on the card."""
    W, P, A, qv, sc, ri, rp, lp, up, s, yp = (
        np.asarray(v, np.float64) for v in (W, P, A, qv, sc, ri, rp, lp, up, s, yp)
    )
    n = P.shape[-1]
    for _ in range(seg):
        rhs = sc * s - qv - ri * rp * yp
        xz = np.einsum("bij,bj->bi", W, rhs)
        pre = alpha * xz + (1.0 - alpha) * s
        s_new = np.clip(pre + ri * yp, lp, up)
        yp = yp + rp * (pre - s_new)
        s = s_new
    x, z, y = s[:, :n], s[:, n:], yp[:, n:]
    Ax = np.einsum("bmn,bn->bm", A, x)
    Px = np.einsum("bij,bj->bi", P, x)
    ATy = np.einsum("bmn,bm->bn", A, y)
    linf = lambda v: np.abs(v).max(axis=-1)
    q = qv[:, :n]
    stats = np.stack([
        linf(Ax - z), linf(Px + q + ATy), np.maximum(linf(Ax), linf(z)),
        np.maximum(linf(Px), np.maximum(linf(ATy), linf(q))),
    ], axis=-1)
    return s, yp, stats


def chunk_inputs(B, n, m, seed, dtype):
    """Chunk operands as the fused solver builds them, from a real QP."""
    from sqp_solver_tpu.ops.linear_solver import get_linear_solver

    qp = random_qp_batch(batch=B, n=n, m=m, seed=seed, dtype=dtype)
    rho = jnp.full((B, m), 0.1, dtype)
    sigma = jnp.asarray(1e-6, dtype)
    W = get_linear_solver("schur_cholesky").factor(qp.P, qp.A, sigma, rho)["W"]
    zn = jnp.zeros((B, n), dtype)
    inf = jnp.full((B, n), jnp.inf, dtype)
    rng = np.random.default_rng(seed)
    lp = jnp.concatenate([-inf, qp.l], -1)
    up = jnp.concatenate([inf, qp.u], -1)
    s = jnp.clip(jnp.asarray(rng.normal(size=(B, n + m)), dtype), lp, up)
    yp = jnp.concatenate([zn, jnp.asarray(rng.normal(size=(B, m)), dtype)], -1)
    return (
        W, qp.P, qp.A,
        jnp.concatenate([qp.q, jnp.zeros((B, m), dtype)], -1),
        jnp.concatenate([jnp.full((B, n), 1e-6, dtype), rho], -1),
        jnp.concatenate([zn, 1.0 / rho], -1),
        jnp.concatenate([zn, rho], -1),
        lp, up, s, yp,
    )


class TestAdmmChunk:
    @pytest.mark.parametrize("seg", [1, 10])
    @pytest.mark.parametrize("alpha", [1.0, 1.6])
    @pytest.mark.parametrize("nm", [(8, 8), (6, 11), (32, 33)])
    def test_chunk_matches_numpy_reference(self, nm, alpha, seg):
        from sqp_solver_tpu.qp.admm_batched import admm_chunk

        n, m = nm
        args = chunk_inputs(5, n, m, seed=n + m, dtype=jnp.float64)
        out = jax.jit(
            lambda *a: admm_chunk(*a, alpha=alpha, seg=seg)
        )(*args)
        ref = numpy_chunk(*args, alpha=alpha, seg=seg)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)

    def test_chunk_keeps_the_padded_x_rows_free(self):
        """The x rows of the padded dual stay exactly 0 and the z rows of
        the state stay inside [l, u] — the invariants the padded
        formulation relies on."""
        from sqp_solver_tpu.qp.admm_batched import admm_chunk

        n, m = 6, 9
        args = chunk_inputs(4, n, m, seed=2, dtype=jnp.float32)
        s, yp, _ = admm_chunk(*args, alpha=1.6, seg=7)
        lp, up = args[7], args[8]
        assert np.all(np.asarray(yp[:, :n]) == 0.0)
        assert np.all(np.asarray(s) >= np.asarray(lp))
        assert np.all(np.asarray(s) <= np.asarray(up))


S_FIXED = QPSettings(
    alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
    adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
)


class TestFusedTierBehaviour:
    """Behavioural contracts of the production batched QP tier."""

    def test_simple_qp_fixture(self):
        from sqp_solver_tpu.models.problems import simple_qp

        qp = simple_qp(dtype=jnp.float64)
        batch = jax.tree.map(lambda v: jnp.broadcast_to(v, (4,) + v.shape), qp)
        out = qp_solve_fused(batch, S_FIXED)
        assert np.all(np.asarray(out.info.status) == QPStatus.SOLVED)
        np.testing.assert_allclose(
            np.asarray(out.x), np.tile([0.3, 0.7], (4, 1)), atol=1e-4
        )

    def test_warm_start(self):
        qp = random_qp_batch(batch=8, n=6, m=9, seed=9, dtype=jnp.float32)
        first = qp_solve_fused(qp, S_FIXED)
        again = qp_solve_fused(qp, S_FIXED, state=first.state)
        assert np.asarray(again.info.iter).max() <= np.asarray(first.info.iter).max()

    def test_indefinite_P_reports_numerical_issues(self):
        # a failed Cholesky must surface as NUMERICAL_ISSUES for the
        # poisoned problem only — not silently return garbage, and not
        # poison batch-mates
        qp = random_qp_batch(batch=4, n=6, m=9, seed=3, dtype=jnp.float32)
        P_bad = qp.P.at[1].set(-10.0 * jnp.eye(6, dtype=jnp.float32))
        bad = QuadraticProblem(P=P_bad, q=qp.q, A=qp.A, l=qp.l, u=qp.u)
        status = np.asarray(qp_solve_fused(bad, S_FIXED).info.status)
        assert status[1] == QPStatus.NUMERICAL_ISSUES
        assert np.all(status[[0, 2, 3]] == QPStatus.SOLVED)

    def test_info_fidelity_vs_vmap(self):
        # rho_updates / rho_estimate are real values, drop-in equivalent
        # with the per-problem tier
        qp = random_qp_batch(batch=8, n=6, m=9, seed=11, dtype=jnp.float64)
        ref = qp_solve_batch(qp, S_FIXED, impl="vmap")
        out = qp_solve_fused(qp, S_FIXED)
        # the reference counts the setup rho_vec_update: always >= 1
        assert np.asarray(out.info.rho_updates).min() >= 1
        for field in ("status", "iter", "rho_updates"):
            np.testing.assert_array_equal(
                np.asarray(getattr(out.info, field)),
                np.asarray(getattr(ref.info, field)),
            )
        est = np.asarray(out.info.rho_estimate)
        assert np.all(np.isfinite(est) & (est > 0))

    def test_single_problem_batch(self):
        qp = random_qp_batch(batch=1, n=5, m=7, seed=4, dtype=jnp.float64)
        ref = qp_solve_batch(qp, SETTINGS, impl="vmap")
        out = qp_solve_fused(qp, SETTINGS)
        assert out.x.shape == (1, 5)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-8)

    def test_fixed_and_early_exit_schedules_agree(self):
        import dataclasses

        qp = random_qp_batch(batch=12, n=6, m=9, seed=6, dtype=jnp.float64)
        fixed = qp_solve_fused(qp, S_FIXED)
        early = qp_solve_fused(qp, dataclasses.replace(S_FIXED, schedule="early_exit"))
        np.testing.assert_array_equal(
            np.asarray(fixed.info.status), np.asarray(early.info.status)
        )
        np.testing.assert_allclose(np.asarray(fixed.x), np.asarray(early.x), atol=1e-12)

    def test_structured_btd_matches_dense(self):
        """The fused tier with the block-tridiagonal Schur backend reaches
        the dense backend's optima on stage-wise MPC."""
        import dataclasses

        from sqp_solver_tpu.models.mpc import mpc_qp_stagewise_batch

        qp, blk = mpc_qp_stagewise_batch(4, horizon=4, dtype=jnp.float64)
        s = dataclasses.replace(S_FIXED, eps_abs=1e-7, eps_rel=1e-7, max_iter=2000)
        dense = qp_solve_fused(qp, s)
        btd = qp_solve_fused(
            qp, dataclasses.replace(s, linear_solver="schur_block_tridiag", block_size=blk)
        )
        assert np.all(np.asarray(btd.info.status) == QPStatus.SOLVED)
        np.testing.assert_allclose(np.asarray(btd.x), np.asarray(dense.x), atol=1e-5)

    def test_qpstate_is_a_scan_carry(self):
        """Sustained MPC chains K warm-started fused solves inside one
        lax.scan, carrying QPState between steps; warm-started steps must
        keep solving and the controller must regulate."""
        from sqp_solver_tpu.models.mpc import _double_integrator_condensed
        from sqp_solver_tpu.qp.types import QPState

        B, H, K, dt = 8, 4, 3, 0.1
        Sx, Su = _double_integrator_condensed(H, dt)
        P1 = jnp.asarray(Su[:, 0, :].T @ Su[:, 0, :] + 0.1 * np.eye(H), jnp.float32)
        A1 = jnp.asarray(np.concatenate([np.eye(H), Su[:, 1, :]], axis=0), jnp.float32)
        Spx_x = jnp.asarray(Sx[:, 0, :].T, jnp.float32)
        Spx_u = jnp.asarray(Su[:, 0, :], jnp.float32)
        Svx_x = jnp.asarray(Sx[:, 1, :].T, jnp.float32)
        Ad = jnp.asarray([[1.0, dt], [0.0, 1.0]], jnp.float32)
        Bd = jnp.asarray([[0.5 * dt * dt], [dt]], jnp.float32)
        s = QPSettings(
            alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200,
            check_termination=25, adaptive_rho=True,
            adaptive_rho_interval=50, schedule="fixed",
        )

        def rollout(x0):
            qs0 = QPState(
                x=jnp.zeros((B, H), jnp.float32),
                z=jnp.zeros((B, 2 * H), jnp.float32),
                y=jnp.zeros((B, 2 * H), jnp.float32),
            )

            def step(carry, _):
                st_, qs_ = carry
                voff = st_ @ Svx_x
                qp = QuadraticProblem(
                    P=jnp.broadcast_to(P1, (B, H, H)), q=(st_ @ Spx_x) @ Spx_u,
                    A=jnp.broadcast_to(A1, (B, 2 * H, H)),
                    l=jnp.concatenate([jnp.full((B, H), -2.0), -1.5 - voff], axis=1),
                    u=jnp.concatenate([jnp.full((B, H), 2.0), 1.5 - voff], axis=1),
                )
                r = qp_solve_batch(qp, s, state=qs_, impl="fused")
                nxt = st_ @ Ad.T + r.x[:, 0][:, None] * Bd[:, 0]
                return (nxt, r.state), (
                    jnp.mean((r.info.status == 0).astype(jnp.float32)),
                    jnp.sqrt(jnp.mean(nxt[:, 0] ** 2)),
                )

            _, ys = jax.lax.scan(step, (x0, qs0), None, length=K)
            return ys

        x0 = jax.random.uniform(jax.random.PRNGKey(3), (B, 2), jnp.float32, -1.0, 1.0)
        solved, pos = (np.asarray(v) for v in jax.jit(rollout)(x0))
        assert (solved == 1.0).all(), solved
        # the controller regulates: fleet position RMS decreases
        assert pos[-1] < pos[0], pos


@pytest.mark.gpu
class TestOnCard:
    """The fused tier's chunk as XLA compiles it for the GPU, against the
    float64 numpy reference (skips without a GPU)."""

    @pytest.mark.parametrize("nm", [(32, 33), (128, 129)])
    def test_chunk_on_card_matches_numpy_f64(self, nm):
        from sqp_solver_tpu.qp.admm_batched import admm_chunk

        n, m = nm
        args = chunk_inputs(256, n, m, seed=1, dtype=jnp.float32)
        out = jax.jit(lambda *a: admm_chunk(*a, alpha=1.6, seg=10))(*args)
        ref = numpy_chunk(*args, alpha=1.6, seg=10)
        for got, want in zip(out, ref):
            np.testing.assert_allclose(
                np.asarray(got, np.float64), want, rtol=1e-4, atol=1e-4
            )
