"""Device-side family generators (models/families.py *_device twins) and
the bench's NLP stress families (models/benchmark.py).

The device twins feed the bench rows (bench.py families leg); these
tests pin (a) that every generated class solves and agrees with the
long-double C++ oracle, (b) that the exp-chain family genuinely needs a
multi-outer budget (the bench row's honesty claim), and (c) that the
independent f64 KKT-residual certifiers accept converged solutions and
reject unconverged ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.benchmark import (
    exp_chain_kkt_residuals,
    exp_chain_nlp_batch_device,
    rosenbrock_kkt_residuals,
    rosenbrock_nlp_batch_device,
)
from sqp_solver_tpu.models.families import (
    huber_qp_batch_device,
    lasso_qp_batch_device,
    portfolio_qp_batch_device,
    random_qp_batch_device,
    svm_qp_batch_device,
)
from sqp_solver_tpu.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus
from sqp_solver_tpu.runtime.native import native_available, native_qp_solve_batch
from sqp_solver_tpu.sqp import SQPSettings

B = 4

SETTINGS = QPSettings(
    alpha=1.6, eps_abs=1e-7, eps_rel=1e-7, max_iter=4000,
    check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
    polish=True,
)


@pytest.mark.skipif(not native_available(), reason="native oracle unavailable")
@pytest.mark.parametrize(
    "build",
    [
        lambda k: random_qp_batch_device(k, B, 16, 24, jnp.float64),
        lambda k: lasso_qp_batch_device(k, B, 6, 10, dtype=jnp.float64),
        lambda k: huber_qp_batch_device(k, B, 6, 10, dtype=jnp.float64),
        lambda k: svm_qp_batch_device(k, B, 6, 10, dtype=jnp.float64),
        lambda k: portfolio_qp_batch_device(k, B, 10, 3, dtype=jnp.float64),
    ],
    ids=["random", "lasso", "huber", "svm", "portfolio"],
)
def test_device_family_solves_and_agrees_with_oracle(build):
    problem = jax.jit(build)(jax.random.PRNGKey(0))
    res = jax.jit(lambda p: qp_solve_batch(p, SETTINGS, impl="vmap"))(problem)
    assert (np.asarray(res.info.status) == QPStatus.SOLVED).all()
    x_or, _, st_or, _ = native_qp_solve_batch(
        np.asarray(problem.P), np.asarray(problem.q), np.asarray(problem.A),
        np.asarray(problem.l), np.asarray(problem.u),
        QPSettings(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000,
                   adaptive_rho=True),
    )
    assert (st_or == QPStatus.SOLVED).all()
    np.testing.assert_allclose(np.asarray(res.x), x_or, atol=5e-7)


class TestExpChain:
    def _solve(self, n=16, batch=8, max_iter=60):
        problem, x0 = jax.jit(
            lambda k: exp_chain_nlp_batch_device(k, batch, n, jnp.float64)
        )(jax.random.PRNGKey(1))
        s = SQPSettings(
            max_iter=max_iter, eps_prim=1e-4, eps_dual=1e-4,
            termination="kkt", line_search_max_iter=10, polish=True,
            polish_passes=3,
            qp=QPSettings(alpha=1.6, eps_abs=1e-8, eps_rel=1e-8,
                          max_iter=300, check_termination=10,
                          warm_start=True, adaptive_rho=True,
                          adaptive_rho_interval=50),
        )
        res = jax.jit(
            lambda p, x: sqp_solve_batch(p, x, None, s, impl="vmap")
        )(problem, x0)
        return problem, res

    def test_needs_multi_outer_budget_and_solves(self):
        """The bench row's honesty claim: every instance takes >= 8 outer
        iterations (no 2-3-outer tuned regime) yet the batch fully
        solves, certified by independent f64 KKT residuals."""
        problem, res = self._solve()
        status = np.asarray(res.info.status)
        iters = np.asarray(res.info.iter)
        assert (status == 0).all(), status
        assert (iters >= 8).all(), iters
        assert np.percentile(iters, 50) >= 15
        pv, dr = exp_chain_kkt_residuals(problem, res.x, res.lam)
        assert pv.max() <= 1e-6
        assert dr.max() <= 1e-6

    def test_certifier_rejects_unconverged(self):
        """The f64 certifier is independent of solver statuses: a 2-outer
        truncation must FAIL its 1e-4 bar even though polish refreshes
        some statuses."""
        problem, res = self._solve(max_iter=2)
        pv, dr = exp_chain_kkt_residuals(problem, res.x, res.lam)
        assert (np.maximum(pv, dr) > 1e-4).any()


class TestRosenbrock:
    def test_residual_helper_matches_autodiff(self):
        """The hand-coded f64 gradient inside rosenbrock_kkt_residuals
        must equal jax.grad of the problem's own objective."""
        problem, x0 = jax.jit(
            lambda k: rosenbrock_nlp_batch_device(k, 4, 8, jnp.float64)
        )(jax.random.PRNGKey(2))
        x = np.asarray(x0, np.float64) * 1.3
        lam = np.zeros((4, 9))
        _, dr = rosenbrock_kkt_residuals(problem, x, lam)
        g_ad = jax.vmap(jax.grad(lambda xx: problem.objective(xx, None)))(
            jnp.asarray(x)
        )
        np.testing.assert_allclose(
            dr, np.abs(np.asarray(g_ad)).max(axis=1), rtol=1e-12
        )

    def test_solves_with_long_budget(self):
        """The stress family converges (slowly — BFGS valley crawl) and
        the certifier confirms the KKT point."""
        problem, x0 = jax.jit(
            lambda k: rosenbrock_nlp_batch_device(k, 4, 8, jnp.float64)
        )(jax.random.PRNGKey(3))
        s = SQPSettings(
            max_iter=150, eps_prim=1e-6, eps_dual=1e-6, termination="kkt",
            line_search_max_iter=12, polish=True, polish_passes=3,
            qp=QPSettings(alpha=1.6, eps_abs=1e-8, eps_rel=1e-8,
                          max_iter=500, check_termination=10,
                          warm_start=True, adaptive_rho=True,
                          adaptive_rho_interval=50),
        )
        res = jax.jit(
            lambda p, x: sqp_solve_batch(p, x, None, s, impl="vmap")
        )(problem, x0)
        pv, dr = rosenbrock_kkt_residuals(problem, res.x, res.lam)
        # the family has a heavy tail; require the majority certified and
        # every certified lane to be genuinely at a KKT point
        ok = (pv <= 1e-6) & (dr <= 1e-6)
        assert ok.mean() >= 0.5, (pv, dr)
