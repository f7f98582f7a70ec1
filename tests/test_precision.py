"""Precision pin and the independent f64 certificate.

On Hopper an f32 contraction at DEFAULT precision may run in TF32 (~3
decimal digits).  Every solver entry point traces under HIGHEST, user
callables included; these tests read the lowered program and require
every dot_general in it to carry HIGHEST.  The lowering is the same for
every platform, so a CPU run checks what the GPU compiler receives.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.models.benchmark import (
    sphere_cap_kkt_residuals,
    sphere_cap_nlp_batch,
    sphere_cap_solution,
)
from sqp_solver_tpu.models.mpc import random_qp_batch
from sqp_solver_tpu.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu.qp import QPSettings
from sqp_solver_tpu.sqp import SQPSettings
from sqp_solver_tpu.sqp.types import NonlinearProblem

_DOT = re.compile(r"stablehlo\.dot_general.*?precision = \[(\w+), (\w+)\]")


def _dot_precisions(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    n_dots = text.count("stablehlo.dot_general")
    found = _DOT.findall(text)
    assert n_dots > 0 and len(found) == n_dots, "a dot_general without precision"
    return found


def _quadratic_nlp(B, n):
    """An NLP whose user callables contain matmuls of their own."""
    Q = jnp.asarray(np.eye(n) + 0.1 * np.ones((n, n)), jnp.float32)
    C = jnp.asarray(np.ones((1, n)) / n, jnp.float32)
    problem = NonlinearProblem(
        l=jnp.full((B, 1), -1.0, jnp.float32),
        u=jnp.full((B, 1), 1.0, jnp.float32),
        params=jnp.linspace(0.5, 1.5, B, dtype=jnp.float32),
        objective=lambda x, p: 0.5 * x @ Q @ x - p * jnp.sum(x),
        constraint=lambda x, p: C @ x,
    )
    return problem, jnp.zeros((B, n), jnp.float32)


QS = QPSettings(max_iter=50, check_termination=10, polish=True)
SS = SQPSettings(max_iter=3, polish=True,
                 qp=QPSettings(max_iter=50, check_termination=10))


@pytest.mark.parametrize("impl", ["vmap", "fused"])
def test_qp_solve_contractions_are_highest(impl):
    qp = random_qp_batch(batch=4, n=5, m=7, seed=0, dtype=jnp.float32)
    found = _dot_precisions(lambda p: qp_solve_batch(p, QS, impl=impl), qp)
    assert set(found) == {("HIGHEST", "HIGHEST")}, set(found)


@pytest.mark.parametrize("impl", ["vmap", "fused"])
def test_sqp_solve_contractions_are_highest_user_callables_included(impl):
    problem, x0 = _quadratic_nlp(4, 5)
    found = _dot_precisions(
        lambda p, x: sqp_solve_batch(p, x, None, SS, impl=impl), problem, x0
    )
    assert set(found) == {("HIGHEST", "HIGHEST")}, set(found)


def test_qp_diff_backward_contractions_are_highest():
    from sqp_solver_tpu.qp.diff import qp_solve_diff

    qp = random_qp_batch(batch=4, n=5, m=7, seed=1, dtype=jnp.float32)
    grad = jax.grad(lambda q: jnp.sum(qp_solve_diff(q, QS, "fused") ** 2))
    found = _dot_precisions(grad, qp)
    assert set(found) == {("HIGHEST", "HIGHEST")}, set(found)


class TestSphereCapCertificate:
    def _exact(self, r_range):
        problem, _ = sphere_cap_nlp_batch(16, 8, seed=3, dtype=jnp.float64,
                                          r_range=r_range)
        x = sphere_cap_solution(problem)
        lam = np.zeros((16, 9))
        inside = x[:, 0] < 1.0
        lam[inside, 0] = 1.0 / (2.0 * x[inside, 0])  # sphere active
        lam[~inside, 1:] = 1.0  # upper box active
        return problem, x, lam

    @pytest.mark.parametrize("r_range", [(0.55, 0.9), (1.05, 1.2)])
    def test_exact_kkt_point_certifies(self, r_range):
        problem, x, lam = self._exact(r_range)
        pv, dr = sphere_cap_kkt_residuals(problem, x, lam)
        assert pv.max() < 1e-12 and dr.max() < 1e-12

    def test_perturbed_point_fails(self):
        problem, x, lam = self._exact((0.55, 0.9))
        pv, dr = sphere_cap_kkt_residuals(problem, x * 1.001, lam)
        assert (pv > 1e-4).all()
        pv, dr = sphere_cap_kkt_residuals(problem, x, lam * 1.001)
        assert (dr > 1e-4).all()


@pytest.mark.gpu
class TestOnCard:
    """Precision and accuracy as the GPU computes them (skip without one)."""

    def test_pinned_f32_matmul_is_not_tf32(self):
        from sqp_solver_tpu.utils.precision import hmat

        rng = np.random.default_rng(0)
        a = rng.standard_normal((256, 256)).astype(np.float32)
        b = rng.standard_normal((256, 256)).astype(np.float32)
        got = np.asarray(jax.jit(hmat)(jnp.asarray(a), jnp.asarray(b)), np.float64)
        want = a.astype(np.float64) @ b.astype(np.float64)
        # full f32 accumulates to ~1e-6 relative; TF32 would be ~1e-3
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    def test_fused_sqp_f32_on_card_meets_closed_form(self):
        problem, x0 = sphere_cap_nlp_batch(512, 32, seed=5, dtype=jnp.float32)
        s = SQPSettings(
            max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt",
            schedule="fixed", polish=True, polish_passes=2,
            line_search_max_iter=5,
            qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                          check_termination=10, warm_start=True,
                          adaptive_rho=True, adaptive_rho_interval=50,
                          schedule="fixed"),
        )
        res = jax.jit(lambda p, x: sqp_solve_batch(p, x, None, s, impl="fused"))(
            problem, x0
        )
        assert (np.asarray(res.info.status) == 0).all()
        err = np.abs(np.asarray(res.x, np.float64) - sphere_cap_solution(problem))
        assert err.max() < 1e-5, err.max()
