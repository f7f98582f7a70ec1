"""Multi-device tests on the virtual 8-CPU mesh (the reference has nothing
to distribute; this coverage is new)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.mpc import mpc_qp_batch, random_qp_batch
from sqp_solver_tpu.models.problems import simple_nlp
from sqp_solver_tpu.parallel import (
    make_mesh,
    qp_solve_batch,
    shard_batch,
    sharded_qp_solve_batch,
    sharded_sqp_solve_batch,
    sqp_solve_batch,
)
from sqp_solver_tpu.qp import QPSettings, QPStatus
from sqp_solver_tpu.sqp import SQPSettings, SQPStatus


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh()


class TestShardedQP:
    def test_matches_unsharded(self, mesh):
        qp = random_qp_batch(batch=32, n=8, m=12, dtype=jnp.float64)
        settings = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=4000)
        ref = qp_solve_batch(qp, settings)
        qp_sharded = shard_batch(qp, mesh)
        out = sharded_qp_solve_batch(qp_sharded, settings, mesh)
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-12)
        # bitwise-identical control flow: statuses and iteration counts match
        np.testing.assert_array_equal(
            np.asarray(out.info.status), np.asarray(ref.info.status)
        )
        np.testing.assert_array_equal(
            np.asarray(out.info.iter), np.asarray(ref.info.iter)
        )
        assert np.mean(np.asarray(out.info.status) == QPStatus.SOLVED) > 0.9

    def test_output_sharding(self, mesh):
        qp = shard_batch(mpc_qp_batch(batch=16, horizon=4, dtype=jnp.float64), mesh)
        out = sharded_qp_solve_batch(qp, QPSettings(), mesh)
        # result stays sharded over the mesh (no gather back to one device)
        assert len(out.x.sharding.device_set) == 8


class TestShardedSQP:
    def test_matches_unsharded(self, mesh):
        B = 16
        prob = simple_nlp()
        prob_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), prob)
        rng = np.random.default_rng(0)
        x0 = jnp.asarray(rng.uniform(0.5, 1.5, (B, 2)))
        settings = SQPSettings()
        ref = sqp_solve_batch(prob_b, x0, None, settings)
        out = sharded_sqp_solve_batch(
            shard_batch(prob_b, mesh), shard_batch(x0, mesh), None, settings, mesh
        )
        np.testing.assert_allclose(np.asarray(out.x), np.asarray(ref.x), atol=1e-12)
        assert np.all(np.asarray(out.info.status) == SQPStatus.SOLVED)


class TestShardedFusedPath:
    """The production tier (fused) under shard_map: every device runs the
    whole fused pipeline on its local batch shard."""

    def test_sqp_fused_impl_sharded(self, mesh):
        from sqp_solver_tpu.models.benchmark import (
            sphere_cap_nlp_batch,
            sphere_cap_solution,
        )

        B, N = 32, 8
        problem, x0 = sphere_cap_nlp_batch(B, N, dtype=jnp.float32)
        s = SQPSettings(
            max_iter=15, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", polish=True,
            qp=QPSettings(
                alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200,
                check_termination=25, adaptive_rho=True,
                adaptive_rho_interval=50, schedule="fixed",
            ),
        )
        res = sharded_sqp_solve_batch(
            shard_batch(problem, mesh), shard_batch(x0, mesh), None, s,
            mesh, impl="fused",
        )
        assert len(res.x.sharding.device_set) == 8
        x_star = sphere_cap_solution(problem)
        st = np.asarray(res.info.status)
        ok = st == SQPStatus.SOLVED
        assert ok.mean() > 0.9
        assert np.abs(np.asarray(res.x) - x_star)[ok].max() < 1e-4

    def test_qp_fused_impl_sharded(self, mesh):
        qp = random_qp_batch(batch=32, n=6, m=9, seed=4, dtype=jnp.float32)
        s = QPSettings(
            alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200,
            check_termination=25, adaptive_rho=True,
            adaptive_rho_interval=50, schedule="fixed",
        )
        ref = qp_solve_batch(qp, s)
        res = sharded_qp_solve_batch(shard_batch(qp, mesh), s, mesh, impl="fused")
        assert len(res.x.sharding.device_set) == 8
        ok = (np.asarray(ref.info.status) == 0) & (np.asarray(res.info.status) == 0)
        np.testing.assert_allclose(
            np.asarray(res.x)[ok], np.asarray(ref.x)[ok], atol=1e-3
        )


class TestShardedTrace:
    def test_record_trace_axis_not_garbled(self):
        """record_trace ring buffers are (max_iter, B, ...): the sharded
        out_spec must shard their SECOND axis (a blanket batch-leading
        spec would concatenate device shards along max_iter)."""
        import dataclasses

        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.sharding import (
            make_mesh,
            shard_batch,
            sharded_sqp_solve_batch,
        )
        from sqp_solver_tpu.sqp import SQPSettings

        mesh = make_mesh()
        B, N, T = 16, 4, 5
        problem, x0 = sphere_cap_nlp_batch(B, N, dtype=jnp.float32)
        settings = SQPSettings(
            max_iter=T, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", record_trace=True,
        )
        res = sharded_sqp_solve_batch(
            shard_batch(problem, mesh), shard_batch(x0, mesh), None,
            settings, mesh, impl="fused",
        )
        assert res.trace["x"].shape == (T, B, N)
        # must equal the unsharded trace exactly
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch

        ref = sqp_solve_batch(problem, x0, None, settings, impl="fused")
        np.testing.assert_allclose(
            np.asarray(res.trace["x"]), np.asarray(ref.trace["x"]), atol=1e-6
        )
