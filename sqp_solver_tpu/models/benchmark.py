"""Flagship benchmark problem family.

A batched smooth NLP sized to the north-star config (BASELINE.md: batched
SQP throughput at n <= 128): maximize Σx inside a per-problem sphere cap
with box bounds —

    min -Σx   s.t.   ||x||^2 <= r_b^2,   0 <= x <= 1

(an n-dimensional generalization of the reference's SimpleNLP fixture,
``tests/sqp_test.cpp:8-44``).  The optimum is x* = min(1, r_b/sqrt(n)) * 1,
giving a closed-form accuracy check for every batch element.  The sphere
radius r is the batched parameter, so the batch exercises heterogeneous
active sets and per-problem convergence masking.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from sqp_solver_tpu.sqp.types import NonlinearProblem

__all__ = [
    "ball_box_constraint",
    "sphere_cap_nlp_batch",
    "sphere_cap_solution",
    "sphere_cap_kkt_residuals",
    "rosenbrock_nlp_batch_device",
    "rosenbrock_kkt_residuals",
    "exp_chain_nlp_batch_device",
    "exp_chain_kkt_residuals",
]


def _pairwise_sum(v, block=8):
    """Sum over the last axis by numpy's scheme: plain sums of ``block``
    terms, then the block sums added pairwise.  Rounding grows like
    log2(n) instead of n."""
    n = v.shape[-1]
    if n <= block:
        return jnp.sum(v, axis=-1)
    k = -(-n // block)
    v = jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, k * block - n)])
    v = jnp.sum(v.reshape(v.shape[:-1] + (k, block)), axis=-1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = jnp.concatenate([v[..., :h] + v[..., h : 2 * h], v[..., 2 * h :]], axis=-1)
    return v[..., 0]


def ball_box_constraint(x, params=None):
    """c(x) = [||x||^2; x], the constraint of every family here: a ball
    row ``||x||^2 <= r^2`` and a box on x.

    Below float64, ||x||^2 is summed pairwise.  In float32 at n=128
    (r^2 ~ 100) a plain dot or reduction rounds by up to 1.6e-4, above
    the 1e-4 KKT certificate, and the solver converges to where its own
    rounded row says the ball is tight: 1% of a B=1024 batch missed the
    certificate, on an H100 and on CPU alike.  Summed pairwise, the worst
    primal violation was 2.2e-5 on the H100.  In float64 the dot's
    rounding is ~1e-14 and it stays, so float64 runs keep their exact
    trajectories.
    """
    del params
    if jnp.finfo(x.dtype).bits >= 64:
        return jnp.concatenate([jnp.array([x @ x]), x])
    return jnp.concatenate([_pairwise_sum(x * x)[None], x])


def sphere_cap_nlp_batch(
    batch: int, n: int, seed: int = 0, dtype=jnp.float32, r_range=(0.55, 0.9)
):
    """Returns (problem with batched leaves, x0 batch (B, n)).

    ``r_range`` scales the sphere radii relative to sqrt(n): the default
    keeps the sphere constraint active and away from the degenerate
    r ~ sqrt(n) boundary (where sphere and box are simultaneously active
    and the KKT point is ill-conditioned); pass (0.5, 1.2) for the
    stress distribution that includes degenerate instances.
    """
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_range[0] * np.sqrt(n), r_range[1] * np.sqrt(n), size=(batch,))
    l = np.concatenate([np.zeros((batch, 1)), np.zeros((batch, n))], axis=1)
    u = np.concatenate([(r**2)[:, None], np.ones((batch, n))], axis=1)

    def objective(x, params):
        del params
        return -jnp.sum(x)

    problem = NonlinearProblem(
        l=jnp.asarray(l, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
        params=jnp.asarray(r, dtype=dtype),
        objective=objective,
        constraint=ball_box_constraint,
    )
    x0 = jnp.asarray(
        np.full((batch, n), 0.25) + rng.uniform(0, 0.05, size=(batch, n)), dtype=dtype
    )
    return problem, x0


def sphere_cap_solution(problem) -> np.ndarray:
    """Closed-form optimum per batch element: min(1, r/sqrt(n)) * ones."""
    r = np.sqrt(np.asarray(problem.u[:, 0], np.float64))
    n = problem.l.shape[1] - 1
    scale = np.minimum(1.0, r / np.sqrt(n))
    return np.broadcast_to(scale[:, None], (r.shape[0], n)) * np.ones((1, n))


def sphere_cap_kkt_residuals(problem, x, lam):
    """Float64 host-side KKT residuals for the sphere-cap family — the
    certificate at the reference SQP's own tolerance (eps 1e-4,
    src/sqp.cpp:19-20).

    Returns (primal_viol, dual_res) per batch element: primal_viol is the
    max violation of ||x||² ≤ r² and 0 ≤ x ≤ 1; dual_res is the exact
    stationarity ||−1 + 2λ₀x + λ_rest||_inf.  Evaluated in numpy float64
    with no solver code on the path.
    """
    x = np.asarray(x, np.float64)
    lam = np.asarray(lam, np.float64)
    r2 = np.asarray(problem.u[:, 0], np.float64)
    dual_res = np.abs(-1.0 + 2.0 * lam[:, 0:1] * x + lam[:, 1:]).max(axis=1)
    ball = np.maximum(np.sum(x * x, axis=1) - r2, 0.0)
    box = np.maximum(np.maximum(x - 1.0, -x), 0.0).max(axis=1)
    return np.maximum(ball, box), dual_res


def rosenbrock_nlp_batch_device(key, batch: int, n: int, dtype=jnp.float32):
    """Batched ball-constrained Rosenbrock NLP, generated ON DEVICE.

        min Σᵢ 100 (x_{i+1} − x_i²)² + (1 − x_i)²
        s.t. ||x||² ≤ r_b²,   −2 ≤ x ≤ 2

    The unconstrained optimum x = 1 has ||x||² = n; radii r ∈
    [0.6√n, 0.85√n] keep the ball ACTIVE at the solution with a curved,
    genuinely nonconvex path to it.  Unlike the sphere-cap family (which
    damped Newton solves in 2-3 outer iterations), SQP from the classic
    staggered start (−1.2, 1, −1.2, …) needs an honest multi-iteration
    budget (typically 10-30 outers with BFGS) — the multi-outer stress row
    the single-family benchmark lacks (reference analog: the curvature of
    ``tests/sqp_test.cpp``'s constrained fixtures, scaled up).

    There is no closed form; certify via :func:`rosenbrock_kkt_residuals`.
    Returns (problem, x0) with batched (l, u, params=r) leaves.
    """
    import jax

    k1, k2 = jax.random.split(key)
    sqn = jnp.sqrt(jnp.asarray(n, dtype))
    r = jax.random.uniform(k1, (batch,), dtype, 0.6 * sqn, 0.85 * sqn)
    l = jnp.concatenate(
        [jnp.zeros((batch, 1), dtype), jnp.full((batch, n), -2.0, dtype)], axis=1
    )
    u = jnp.concatenate(
        [(r**2)[:, None], jnp.full((batch, n), 2.0, dtype)], axis=1
    )

    def objective(x, params):
        del params
        d = x[1:] - x[:-1] ** 2
        return jnp.sum(100.0 * d * d) + jnp.sum((1.0 - x[:-1]) ** 2)

    problem = NonlinearProblem(
        l=l, u=u, params=r, objective=objective, constraint=ball_box_constraint
    )
    base = jnp.where(jnp.arange(n) % 2 == 0, -1.2, 1.0).astype(dtype)
    x0 = base[None, :] + 0.05 * jax.random.uniform(k2, (batch, n), dtype)
    return problem, x0


def rosenbrock_kkt_residuals(problem, x, lam):
    """Float64 host-side KKT residuals for the Rosenbrock family.

    Returns (primal_viol, dual_res) per batch element: primal_viol is the
    max constraint violation of ||x||² ≤ r² and the box; dual_res is the
    stationarity residual ||∇f + J'λ||_inf with the exact gradient.
    Evaluated in numpy float64 — an independent certification of an f32
    solve, no solver code on the path.
    """
    x = np.asarray(x, np.float64)
    lam = np.asarray(lam, np.float64)
    r2 = np.asarray(problem.u[:, 0], np.float64)
    lo = np.asarray(problem.l[:, 1:], np.float64)
    hi = np.asarray(problem.u[:, 1:], np.float64)

    d = x[:, 1:] - x[:, :-1] ** 2
    g = np.zeros_like(x)
    g[:, :-1] += -400.0 * d * x[:, :-1] - 2.0 * (1.0 - x[:, :-1])
    g[:, 1:] += 200.0 * d
    # J = [2x'; I]: stationarity adds 2 lam_0 x + lam_{1:}
    st = g + 2.0 * lam[:, 0:1] * x + lam[:, 1:]
    dual_res = np.abs(st).max(axis=1)

    ball = np.maximum(np.sum(x * x, axis=1) - r2, 0.0)
    box = np.maximum(np.maximum(x - hi, lo - x), 0.0).max(axis=1)
    primal_viol = np.maximum(ball, box)
    return primal_viol, dual_res


def exp_chain_nlp_batch_device(key, batch: int, n: int, dtype=jnp.float32):
    """Batched exponential-chain NLP, generated ON DEVICE.

        min Σᵢ exp(cᵢxᵢ) − bᵢxᵢ + ½ Σᵢ (x_{i+1} − xᵢ)²
        s.t. ||x||² ≤ r_b²,   −3 ≤ x ≤ 3

    (an exponential resource-allocation chain: per-problem prices b and
    rates c, a smoothing coupling, and a budget ball that is ACTIVE at the
    optimum for the sampled radii r ∈ [0.35√n, 0.6√n]).  Strictly convex
    objective, but the Lagrangian Hessian is genuinely x-dependent —
    damped BFGS takes ~20-35 outer iterations from the cold start
    (measured p50 = 24 at n = 32), an order of magnitude more than the
    sphere-cap family: this is the multi-outer benchmark row that
    exercises the full two-phase budget instead of a 2-3-outer tuned
    regime.  No closed form; certify with
    :func:`exp_chain_kkt_residuals` (independent f64 evaluation).

    Returns (problem, x0); params = concat(c, b) per problem.
    """
    import jax

    k1, k2, k3, k4 = jax.random.split(key, 4)
    sqn = jnp.sqrt(jnp.asarray(n, dtype))
    r = jax.random.uniform(k1, (batch,), dtype, 0.35 * sqn, 0.6 * sqn)
    c = jax.random.uniform(k2, (batch, n), dtype, 0.5, 1.5)
    b = jax.random.uniform(k3, (batch, n), dtype, 1.0, 3.0)
    l = jnp.concatenate(
        [jnp.zeros((batch, 1), dtype), jnp.full((batch, n), -3.0, dtype)], axis=1
    )
    u = jnp.concatenate(
        [(r**2)[:, None], jnp.full((batch, n), 3.0, dtype)], axis=1
    )
    params = jnp.concatenate([c, b], axis=1)

    def objective(x, p):
        cc, bb = p[: x.shape[0]], p[x.shape[0] :]
        d = x[1:] - x[:-1]
        return jnp.sum(jnp.exp(cc * x) - bb * x) + 0.5 * jnp.sum(d * d)

    problem = NonlinearProblem(
        l=l, u=u, params=params, objective=objective, constraint=ball_box_constraint
    )
    x0 = jnp.zeros((batch, n), dtype) + 0.01 * jax.random.uniform(
        k4, (batch, n), dtype
    )
    return problem, x0


def exp_chain_kkt_residuals(problem, x, lam):
    """Float64 host-side KKT residuals for the exponential-chain family.

    Returns (primal_viol, dual_res) per batch element — exact gradient of
    the objective plus J'λ with J = [2x'; I], evaluated in numpy float64:
    an independent certification of an f32 solve.
    """
    x = np.asarray(x, np.float64)
    lam = np.asarray(lam, np.float64)
    p = np.asarray(problem.params, np.float64)
    n = x.shape[1]
    c, b = p[:, :n], p[:, n:]

    g = c * np.exp(c * x) - b
    d = x[:, 1:] - x[:, :-1]
    g[:, :-1] -= d
    g[:, 1:] += d
    st = g + 2.0 * lam[:, 0:1] * x + lam[:, 1:]
    dual_res = np.abs(st).max(axis=1)

    r2 = np.asarray(problem.u[:, 0], np.float64)
    lo = np.asarray(problem.l[:, 1:], np.float64)
    hi = np.asarray(problem.u[:, 1:], np.float64)
    ball = np.maximum(np.sum(x * x, axis=1) - r2, 0.0)
    box = np.maximum(np.maximum(x - hi, lo - x), 0.0).max(axis=1)
    primal_viol = np.maximum(ball, box)
    return primal_viol, dual_res
