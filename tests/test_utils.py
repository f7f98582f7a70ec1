"""Utility modules: debug printers, profiling summaries, precision helpers."""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.problems import simple_qp
from sqp_solver_tpu.qp import QPSettings, qp_solve
from sqp_solver_tpu.utils import hdot, hmat, is_psd, print_qp
from sqp_solver_tpu.utils.profiling import summarize_info, time_solve


def test_print_qp_and_is_psd():
    qp = simple_qp()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_qp(qp)
    out = buf.getvalue()
    assert "P =" in out and "u =" in out
    assert is_psd(qp.P)
    assert not is_psd(jnp.array([[1.0, 0.0], [0.0, -1.0]]))


def test_precision_helpers():
    a = jnp.ones((3, 4))
    b = jnp.ones((4, 2))
    np.testing.assert_allclose(np.asarray(hmat(a, b)), 4.0)
    np.testing.assert_allclose(float(hdot(jnp.ones(4), jnp.ones(4))), 4.0)


def test_summarize_info():
    res = qp_solve(simple_qp(), QPSettings())
    s = summarize_info(res.info)
    assert s["solved_frac"] == 1.0
    assert s["iter_p50"] > 0
    assert 0 in s["status_counts"]


def test_time_solve():
    import jax

    f = jax.jit(lambda qp: qp_solve(qp, QPSettings()))
    dt, out = time_solve(f, simple_qp(), reps=2)
    assert dt > 0
    assert int(out.info.status) == 0
def test_verbose_runs():
    """QPSettings.verbose prints the reference-format iteration table via
    jax.debug.print without breaking the solve."""
    import jax

    from sqp_solver_tpu.models.problems import simple_qp
    from sqp_solver_tpu.qp import QPSettings, qp_solve

    res = qp_solve(simple_qp(), QPSettings(verbose=True))
    jax.effects_barrier()
    assert int(res.info.status) == 0


class TestSettingsInfoDumps:
    """Reference verbose dumps: QPSolverSettings::print (qp.hpp:56-66),
    QPSolverInfo::print (qp.hpp:82-106), sqp::Info (sqp.hpp:40-59)."""

    def test_print_settings(self, capsys):
        from sqp_solver_tpu.qp import QPSettings
        from sqp_solver_tpu.sqp import SQPSettings
        from sqp_solver_tpu.utils.debug import print_settings

        print_settings(QPSettings(rho=0.25))
        out = capsys.readouterr().out
        assert "QPSettings" in out and "rho = 0.25" in out and "max_iter" in out
        print_settings(SQPSettings())
        out = capsys.readouterr().out
        assert "SQPSettings" in out and "qp:" in out and "eps_prim" in out

    def test_print_info_scalar_and_batched(self, capsys):
        import jax
        from sqp_solver_tpu.models.problems import simple_qp
        from sqp_solver_tpu.qp import QPSettings, qp_solve
        from sqp_solver_tpu.utils.debug import print_info

        res = qp_solve(simple_qp(), QPSettings())
        print_info(res.info)
        out = capsys.readouterr().out
        assert "status = SOLVED" in out and "iter" in out

        batched = jax.vmap(lambda _: qp_solve(simple_qp(), QPSettings()))(
            jnp.arange(4)
        )
        print_info(batched.info)
        out = capsys.readouterr().out
        assert "status[SOLVED] = 4/4" in out and "p50" in out


class TestTraceRingBuffer:
    """Batched-path observability: the on-device replacement for the
    reference's per-iteration callback (sqp.hpp:23, src/sqp.cpp:89-91)."""

    def test_record_trace_fused(self):
        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch
        from sqp_solver_tpu.sqp import SQPSettings

        prob, x0 = sphere_cap_nlp_batch(4, 6, dtype=jnp.float32)
        s = SQPSettings(
            max_iter=8, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", record_trace=True,
        )
        res = sqp_solve_batch(prob, x0, None, s, impl="fused")
        assert res.trace is not None
        assert res.trace["x"].shape == (8, 4, 6)
        assert res.trace["alpha"].shape == (8, 4)
        # iterates move then stabilize at the solution
        x_tr = np.asarray(res.trace["x"])
        assert not np.allclose(x_tr[0], x_tr[1])
        np.testing.assert_allclose(x_tr[-1], np.asarray(res.x), atol=1e-5)


class TestStatusNamesFromEnums:
    def test_print_info_labels_derive_from_enums(self):
        """Status labels must come from the QPStatus/SQPStatus enums (the
        old hand-copied dicts could drift from the codes)."""
        import io

        from sqp_solver_tpu.qp import QPSettings, QPStatus, qp_solve
        from sqp_solver_tpu.models.problems import simple_qp
        from sqp_solver_tpu.utils.debug import print_info

        res = qp_solve(simple_qp(), QPSettings(eps_abs=1e-6, eps_rel=1e-6))
        buf = io.StringIO()
        print_info(res.info, file=buf)
        text = buf.getvalue()
        assert QPStatus(int(res.info.status)).name in text


class TestPerProblemScaling:
    def test_qp_solve_scaling_single_problem(self):
        """The per-problem entry point routes through solve_with_scaling
        (shape-polymorphic: no batch axis)."""
        import numpy as np

        from sqp_solver_tpu.models.problems import simple_qp
        from sqp_solver_tpu.qp import QPSettings, QPStatus, qp_solve

        res = qp_solve(
            simple_qp(),
            QPSettings(eps_abs=1e-8, eps_rel=1e-8, max_iter=4000,
                       adaptive_rho=True, scaling=10, polish=True),
        )
        assert int(res.info.status) == QPStatus.SOLVED
        np.testing.assert_allclose(
            np.asarray(res.x), [0.3, 0.7], atol=1e-6
        )


class TestBatchedIterationCallback:
    """Live iteration_callback on the BATCHED tier: fires whole-batch per
    outer iteration; replay_trace replays a recorded solve offline."""

    def _solve(self, cb):
        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch
        from sqp_solver_tpu.sqp import SQPSettings

        prob, x0 = sphere_cap_nlp_batch(4, 6, dtype=jnp.float32)
        s = SQPSettings(
            max_iter=6, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", iteration_callback=cb,
        )
        res = sqp_solve_batch(prob, x0, None, s, impl="fused")
        jax.block_until_ready(res.x)
        jax.effects_barrier()
        return res

    def test_fused_tier_callback_fires(self):
        seen = []

        def cb(x, lam, it):
            seen.append((int(it), np.asarray(x).shape))

        self._solve(cb)
        its = [k for k, _ in seen]
        assert its[0] == 0 and len(its) == 7  # initial + 6 fixed iters
        assert all(shape == (4, 6) for _, shape in seen)

    def test_replay_trace_mirrors_callback(self):
        """record_trace + replay_trace reproduces the live callback's
        (x, lam, k) sequence over the executed iterations."""
        import dataclasses

        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch
        from sqp_solver_tpu.sqp import SQPSettings
        from sqp_solver_tpu.sqp.common import replay_trace

        live = []

        def cb_live(x, lam, it):
            if int(it) > 0:  # replay has no initial-state call
                live.append((int(it), np.asarray(x).copy(), np.asarray(lam).copy()))

        prob, x0 = sphere_cap_nlp_batch(4, 6, dtype=jnp.float32)
        s = SQPSettings(
            max_iter=6, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
            schedule="fixed", record_trace=True, iteration_callback=cb_live,
        )
        res = sqp_solve_batch(prob, x0, None, s, impl="fused")
        jax.block_until_ready(res.x)
        jax.effects_barrier()

        replayed = []
        replay_trace(res, lambda x, lam, k: replayed.append((k, x, lam)))
        assert [k for k, *_ in replayed] == [k for k, *_ in live]
        for (kl, xl, ll), (kr, xr, lr) in zip(live, replayed):
            np.testing.assert_allclose(xl, xr, atol=1e-6)
            np.testing.assert_allclose(ll, lr, atol=1e-6)

    def test_replay_without_trace_raises(self):
        from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
        from sqp_solver_tpu.parallel.batch import sqp_solve_batch
        from sqp_solver_tpu.sqp import SQPSettings
        from sqp_solver_tpu.sqp.common import replay_trace

        prob, x0 = sphere_cap_nlp_batch(2, 4, dtype=jnp.float32)
        s = SQPSettings(max_iter=3, termination="kkt", eps_prim=1e-2,
                        eps_dual=1e-2, schedule="fixed")
        res = sqp_solve_batch(prob, x0, None, s, impl="fused")
        with pytest.raises(ValueError):
            replay_trace(res, lambda *a: None)
