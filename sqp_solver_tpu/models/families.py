"""OSQP-paper benchmark problem families as batched dense QPs.

The reference library is an OSQP re-implementation (reference README.md:6),
and the OSQP paper (Stellato et al., "OSQP: An Operator Splitting Solver
for Quadratic Programs", arXiv:1711.08013, §5 — see PAPERS.md) defines the
canonical problem classes such a solver is expected to handle: random QPs,
equality-constrained QPs, portfolio optimization, lasso, huber fitting and
support-vector machines.  This module provides on-host batched generators
for each class in this framework's standard form

    min ½ zᵀPz + qᵀz   s.t.   l ≤ Az ≤ u,

with every problem leaf batched on the leading axis (the data-parallel
contract of :func:`sqp_solver_tpu.parallel.batch.qp_solve_batch`).
Equality rows are encoded as l == u (classified by the solver's
constraint classification, reference src/qp.cpp:284-314).

These are model/problem builders, not hot-path code: generation is NumPy
on host, returned as device arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from sqp_solver_tpu.qp.types import QuadraticProblem

__all__ = [
    "equality_qp_batch",
    "lasso_qp_batch",
    "huber_qp_batch",
    "svm_qp_batch",
    "portfolio_qp_batch",
    "random_qp_batch_device",
    "lasso_qp_batch_device",
    "huber_qp_batch_device",
    "svm_qp_batch_device",
    "portfolio_qp_batch_device",
]

_INF = 1e20  # loose bound beyond the classifier's LOOSE_BOUNDS_THRESH (1e16)


def _as_problem(P, q, A, l, u, dtype) -> QuadraticProblem:
    return QuadraticProblem(
        P=jnp.asarray(P, dtype),
        q=jnp.asarray(q, dtype),
        A=jnp.asarray(A, dtype),
        l=jnp.asarray(l, dtype),
        u=jnp.asarray(u, dtype),
    )


def equality_qp_batch(
    batch: int, n: int = 16, p: int = 8, seed: int = 0, dtype=jnp.float32
) -> Tuple[QuadraticProblem, np.ndarray]:
    """Equality-constrained QP: min ½xᵀPx + qᵀx s.t. Ax = b (OSQP §5.2).

    P = MMᵀ + 1e-2·I strictly convex, A Gaussian with full row rank,
    b = A x_feas.  Returns (problem, x_star) where x_star is the exact
    KKT solution [[P, Aᵀ],[A, 0]] [x; ν] = [−q; b], computed in float64 —
    a closed-form accuracy oracle for the whole solver stack.
    """
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n)) / np.sqrt(n)
    P = M @ M.transpose(0, 2, 1) + 1e-2 * np.eye(n)
    q = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, p, n)) / np.sqrt(n)
    b = np.einsum("bpn,bn->bp", A, rng.normal(size=(batch, n)))

    K = np.zeros((batch, n + p, n + p))
    K[:, :n, :n] = P
    K[:, :n, n:] = A.transpose(0, 2, 1)
    K[:, n:, :n] = A
    rhs = np.concatenate([-q, b], axis=1)
    x_star = np.linalg.solve(K, rhs[..., None])[:, :n, 0]

    problem = _as_problem(P, q, A, b, b, dtype)
    return problem, x_star


def lasso_qp_batch(
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    seed: int = 0,
    lam_frac: float = 0.1,
    dtype=jnp.float32,
) -> Tuple[QuadraticProblem, dict]:
    """Lasso regression as a QP (OSQP §5.3):  min ½‖Fx − b‖² + λ‖x‖₁.

    Lifted variable z = (x, y, t) with the residual y = Fx − b kept
    explicit (the paper's conditioning trick) and t the l1 envelope:

        min ½yᵀy + λ1ᵀt
        s.t. Fx − y = b          (n_samples equality rows)
             −t ≤ x ≤ t          (2·n_features inequality rows)

    λ = lam_frac · ‖Fᵀb‖∞ (a fraction of the smallest λ that zeroes x).
    Returns (problem, meta) with meta = dict(F, b, lam, n_features,
    n_samples) for objective evaluation in tests.
    """
    rng = np.random.default_rng(seed)
    nf, ns = n_features, n_samples
    F = rng.normal(size=(batch, ns, nf)) / np.sqrt(nf)
    x_true = rng.normal(size=(batch, nf)) * (rng.random(size=(batch, nf)) < 0.5)
    b = np.einsum("bsn,bn->bs", F, x_true) + 0.1 * rng.normal(size=(batch, ns))
    lam = lam_frac * np.max(
        np.abs(np.einsum("bsn,bs->bn", F, b)), axis=1, keepdims=True
    )  # (B, 1)

    nz = nf + ns + nf
    P = np.zeros((batch, nz, nz))
    P[:, nf : nf + ns, nf : nf + ns] = np.eye(ns)
    q = np.zeros((batch, nz))
    q[:, nf + ns :] = lam

    m = ns + 2 * nf
    A = np.zeros((batch, m, nz))
    A[:, :ns, :nf] = F
    A[:, :ns, nf : nf + ns] = -np.eye(ns)
    # x − t ≤ 0
    A[:, ns : ns + nf, :nf] = np.eye(nf)
    A[:, ns : ns + nf, nf + ns :] = -np.eye(nf)
    # x + t ≥ 0
    A[:, ns + nf :, :nf] = np.eye(nf)
    A[:, ns + nf :, nf + ns :] = np.eye(nf)

    l = np.concatenate(
        [b, np.full((batch, nf), -_INF), np.zeros((batch, nf))], axis=1
    )
    u = np.concatenate(
        [b, np.zeros((batch, nf)), np.full((batch, nf), _INF)], axis=1
    )
    meta = dict(F=F, b=b, lam=lam[:, 0], n_features=nf, n_samples=ns)
    return _as_problem(P, q, A, l, u, dtype), meta


def huber_qp_batch(
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    seed: int = 0,
    M: float = 1.0,
    dtype=jnp.float32,
) -> Tuple[QuadraticProblem, dict]:
    """Huber fitting as a QP (OSQP §5.4):  min Σᵢ φ_M(fᵢᵀx − bᵢ) with
    φ_M(w) = w² for |w| ≤ M, M(2|w| − M) otherwise.

    Splitting z = (x, u, r, s): the residual w = u + r − s with the
    quadratic part u and the linear excess r, s ≥ 0:

        min uᵀu + 2M·1ᵀ(r + s)
        s.t. Fx − u − r + s = b;  r ≥ 0;  s ≥ 0.

    Data includes outliers so the linear branch is active.  Returns
    (problem, meta) with meta = dict(F, b, M, n_features, n_samples).
    """
    rng = np.random.default_rng(seed)
    nf, ns = n_features, n_samples
    F = rng.normal(size=(batch, ns, nf)) / np.sqrt(nf)
    x_true = rng.normal(size=(batch, nf))
    noise = 0.1 * rng.normal(size=(batch, ns))
    outlier = (rng.random(size=(batch, ns)) < 0.2) * rng.normal(
        size=(batch, ns)
    ) * 5.0
    b = np.einsum("bsn,bn->bs", F, x_true) + noise + outlier

    nz = nf + 3 * ns
    P = np.zeros((batch, nz, nz))
    P[:, nf : nf + ns, nf : nf + ns] = 2.0 * np.eye(ns)
    q = np.zeros((batch, nz))
    q[:, nf + ns :] = 2.0 * M

    m = 3 * ns
    A = np.zeros((batch, m, nz))
    A[:, :ns, :nf] = F
    A[:, :ns, nf : nf + ns] = -np.eye(ns)
    A[:, :ns, nf + ns : nf + 2 * ns] = -np.eye(ns)
    A[:, :ns, nf + 2 * ns :] = np.eye(ns)
    A[:, ns : 2 * ns, nf + ns : nf + 2 * ns] = np.eye(ns)
    A[:, 2 * ns :, nf + 2 * ns :] = np.eye(ns)

    l = np.concatenate([b, np.zeros((batch, 2 * ns))], axis=1)
    u = np.concatenate([b, np.full((batch, 2 * ns), _INF)], axis=1)
    meta = dict(F=F, b=b, M=M, n_features=nf, n_samples=ns)
    return _as_problem(P, q, A, l, u, dtype), meta


def svm_qp_batch(
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    seed: int = 0,
    lam: float = 1.0,
    dtype=jnp.float32,
) -> Tuple[QuadraticProblem, dict]:
    """Support-vector machine as a QP (OSQP §5.5):

        min ½‖x‖² + λ·1ᵀt
        s.t. t ≥ 1 − diag(b)Fx   (hinge),   t ≥ 0

    encoded as [diag(b)F, I] z ∈ [1, ∞) and [0, I] z ∈ [0, ∞) over
    z = (x, t).  Labels b ∈ {−1, +1} from a planted separator with flip
    noise so both hinge branches are exercised.  Returns (problem, meta)
    with meta = dict(F, b, lam).
    """
    rng = np.random.default_rng(seed)
    nf, ns = n_features, n_samples
    F = rng.normal(size=(batch, ns, nf))
    w_true = rng.normal(size=(batch, nf))
    margin = np.einsum("bsn,bn->bs", F, w_true)
    flip = np.where(rng.random(size=(batch, ns)) < 0.1, -1.0, 1.0)
    b_lab = np.sign(margin + 1e-12) * flip

    nz = nf + ns
    P = np.zeros((batch, nz, nz))
    P[:, :nf, :nf] = np.eye(nf)
    q = np.zeros((batch, nz))
    q[:, nf:] = lam

    m = 2 * ns
    A = np.zeros((batch, m, nz))
    A[:, :ns, :nf] = b_lab[:, :, None] * F
    A[:, :ns, nf:] = np.eye(ns)
    A[:, ns:, nf:] = np.eye(ns)
    l = np.concatenate([np.ones((batch, ns)), np.zeros((batch, ns))], axis=1)
    u = np.full((batch, m), _INF)
    meta = dict(F=F, b=b_lab, lam=lam)
    return _as_problem(P, q, A, l, u, dtype), meta


def portfolio_qp_batch(
    batch: int,
    n_assets: int = 16,
    n_factors: int = 4,
    seed: int = 0,
    gamma: float = 1.0,
    dtype=jnp.float32,
) -> Tuple[QuadraticProblem, dict]:
    """Markowitz portfolio with a factor risk model (OSQP §5.6):

        max μᵀx − γ xᵀΣx,  Σ = FFᵀ + D,  1ᵀx = 1,  0 ≤ x ≤ 1.

    Lifted z = (x, y) with y = Fᵀx so the quadratic stays diagonal:

        min γ(xᵀDx + yᵀy) − μᵀx
        s.t. Fᵀx − y = 0;  1ᵀx = 1;  0 ≤ x ≤ 1.

    Returns (problem, meta) with meta = dict(mu, F, D, gamma).
    """
    rng = np.random.default_rng(seed)
    na, nk = n_assets, n_factors
    F = rng.normal(size=(batch, na, nk)) / np.sqrt(nk)
    D = rng.random(size=(batch, na)) * np.sqrt(nk) * 0.1 + 1e-2
    mu = rng.normal(size=(batch, na)) * 0.1

    nz = na + nk
    P = np.zeros((batch, nz, nz))
    idx = np.arange(na)
    P[:, idx, idx] = 2.0 * gamma * D
    kdx = np.arange(na, nz)
    P[:, kdx, kdx] = 2.0 * gamma
    q = np.concatenate([-mu, np.zeros((batch, nk))], axis=1)

    m = nk + 1 + na
    A = np.zeros((batch, m, nz))
    A[:, :nk, :na] = F.transpose(0, 2, 1)
    A[:, :nk, na:] = -np.eye(nk)
    A[:, nk, :na] = 1.0
    A[:, nk + 1 :, :na] = np.eye(na)
    l = np.concatenate(
        [np.zeros((batch, nk)), np.ones((batch, 1)), np.zeros((batch, na))],
        axis=1,
    )
    u = np.concatenate(
        [np.zeros((batch, nk)), np.ones((batch, 1)), np.ones((batch, na))],
        axis=1,
    )
    meta = dict(mu=mu, F=F, D=D, gamma=gamma)
    return _as_problem(P, q, A, l, u, dtype), meta


# ---------------------------------------------------------------------------
# Device-side (jit-traceable) generators
#
# Benchmark counterparts of the host builders above: identical problem
# distributions, generated ON DEVICE from a PRNG key so a timing harness
# can fuse generation + solve into one program with a fresh key per rep
# (keeping the host->device upload of a B>=1024 batch out of the timed
# program).  Each returns only the
# QuadraticProblem; accuracy oracles fetch the generated leaves to host.
# ---------------------------------------------------------------------------


def _beye(n, dtype):
    return jnp.eye(n, dtype=dtype)


def random_qp_batch_device(
    key, batch: int, n: int = 32, m: int = 48, dtype=jnp.float32
) -> QuadraticProblem:
    """Device-side twin of :func:`sqp_solver_tpu.models.mpc.random_qp_batch`:
    random strictly-convex QPs with guaranteed-feasible bounds."""
    import jax

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    M = jax.random.normal(k1, (batch, n, n), dtype) / jnp.sqrt(
        jnp.asarray(n, dtype)
    )
    P = jnp.einsum("bij,bkj->bik", M, M) + 0.1 * _beye(n, dtype)
    q = jax.random.normal(k2, (batch, n), dtype)
    A = jax.random.normal(k3, (batch, m, n), dtype) / jnp.sqrt(
        jnp.asarray(n, dtype)
    )
    x_feas = jax.random.normal(k4, (batch, n), dtype)
    Ax = jnp.einsum("bmn,bn->bm", A, x_feas)
    width = jax.random.uniform(k5, (batch, m), dtype, 0.1, 2.0)
    return QuadraticProblem(P=P, q=q, A=A, l=Ax - width, u=Ax + width)


def lasso_qp_batch_device(
    key,
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    lam_frac: float = 0.1,
    dtype=jnp.float32,
) -> QuadraticProblem:
    """Device-side twin of :func:`lasso_qp_batch` (same lifting/scales)."""
    import jax

    nf, ns = n_features, n_samples
    k1, k2, k3, k4 = jax.random.split(key, 4)
    F = jax.random.normal(k1, (batch, ns, nf), dtype) / jnp.sqrt(
        jnp.asarray(nf, dtype)
    )
    x_true = jax.random.normal(k2, (batch, nf), dtype) * (
        jax.random.uniform(k3, (batch, nf), dtype) < 0.5
    )
    b = jnp.einsum("bsn,bn->bs", F, x_true) + 0.1 * jax.random.normal(
        k4, (batch, ns), dtype
    )
    lam = lam_frac * jnp.max(
        jnp.abs(jnp.einsum("bsn,bs->bn", F, b)), axis=1, keepdims=True
    )

    nz = nf + ns + nf
    P = jnp.zeros((batch, nz, nz), dtype)
    P = P.at[:, nf : nf + ns, nf : nf + ns].set(_beye(ns, dtype))
    q = jnp.concatenate(
        [jnp.zeros((batch, nf + ns), dtype), jnp.broadcast_to(lam, (batch, nf))],
        axis=1,
    )

    m = ns + 2 * nf
    A = jnp.zeros((batch, m, nz), dtype)
    A = A.at[:, :ns, :nf].set(F)
    A = A.at[:, :ns, nf : nf + ns].set(-_beye(ns, dtype))
    A = A.at[:, ns : ns + nf, :nf].set(_beye(nf, dtype))
    A = A.at[:, ns : ns + nf, nf + ns :].set(-_beye(nf, dtype))
    A = A.at[:, ns + nf :, :nf].set(_beye(nf, dtype))
    A = A.at[:, ns + nf :, nf + ns :].set(_beye(nf, dtype))

    inf = jnp.full((batch, nf), _INF, dtype)
    zero = jnp.zeros((batch, nf), dtype)
    l = jnp.concatenate([b, -inf, zero], axis=1)
    u = jnp.concatenate([b, zero, inf], axis=1)
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)


def huber_qp_batch_device(
    key,
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    M: float = 1.0,
    dtype=jnp.float32,
) -> QuadraticProblem:
    """Device-side twin of :func:`huber_qp_batch` (outliers included)."""
    import jax

    nf, ns = n_features, n_samples
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    F = jax.random.normal(k1, (batch, ns, nf), dtype) / jnp.sqrt(
        jnp.asarray(nf, dtype)
    )
    x_true = jax.random.normal(k2, (batch, nf), dtype)
    noise = 0.1 * jax.random.normal(k3, (batch, ns), dtype)
    outlier = (
        (jax.random.uniform(k4, (batch, ns), dtype) < 0.2)
        * jax.random.normal(k5, (batch, ns), dtype)
        * 5.0
    )
    b = jnp.einsum("bsn,bn->bs", F, x_true) + noise + outlier

    nz = nf + 3 * ns
    P = jnp.zeros((batch, nz, nz), dtype)
    P = P.at[:, nf : nf + ns, nf : nf + ns].set(2.0 * _beye(ns, dtype))
    q = jnp.concatenate(
        [
            jnp.zeros((batch, nf + ns), dtype),
            jnp.full((batch, 2 * ns), 2.0 * M, dtype),
        ],
        axis=1,
    )

    m = 3 * ns
    A = jnp.zeros((batch, m, nz), dtype)
    A = A.at[:, :ns, :nf].set(F)
    A = A.at[:, :ns, nf : nf + ns].set(-_beye(ns, dtype))
    A = A.at[:, :ns, nf + ns : nf + 2 * ns].set(-_beye(ns, dtype))
    A = A.at[:, :ns, nf + 2 * ns :].set(_beye(ns, dtype))
    A = A.at[:, ns : 2 * ns, nf + ns : nf + 2 * ns].set(_beye(ns, dtype))
    A = A.at[:, 2 * ns :, nf + 2 * ns :].set(_beye(ns, dtype))

    l = jnp.concatenate([b, jnp.zeros((batch, 2 * ns), dtype)], axis=1)
    u = jnp.concatenate([b, jnp.full((batch, 2 * ns), _INF, dtype)], axis=1)
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)


def svm_qp_batch_device(
    key,
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    lam: float = 1.0,
    dtype=jnp.float32,
) -> QuadraticProblem:
    """Device-side twin of :func:`svm_qp_batch` (flip-noise labels)."""
    import jax

    nf, ns = n_features, n_samples
    k1, k2, k3 = jax.random.split(key, 3)
    F = jax.random.normal(k1, (batch, ns, nf), dtype)
    w_true = jax.random.normal(k2, (batch, nf), dtype)
    margin = jnp.einsum("bsn,bn->bs", F, w_true)
    flip = jnp.where(jax.random.uniform(k3, (batch, ns), dtype) < 0.1, -1.0, 1.0)
    b_lab = jnp.where(margin >= 0, 1.0, -1.0).astype(dtype) * flip

    nz = nf + ns
    P = jnp.zeros((batch, nz, nz), dtype)
    P = P.at[:, :nf, :nf].set(_beye(nf, dtype))
    q = jnp.concatenate(
        [jnp.zeros((batch, nf), dtype), jnp.full((batch, ns), lam, dtype)],
        axis=1,
    )

    m = 2 * ns
    A = jnp.zeros((batch, m, nz), dtype)
    A = A.at[:, :ns, :nf].set(b_lab[:, :, None] * F)
    A = A.at[:, :ns, nf:].set(_beye(ns, dtype))
    A = A.at[:, ns:, nf:].set(_beye(ns, dtype))
    l = jnp.concatenate(
        [jnp.ones((batch, ns), dtype), jnp.zeros((batch, ns), dtype)], axis=1
    )
    u = jnp.full((batch, m), _INF, dtype)
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)


def portfolio_qp_batch_device(
    key,
    batch: int,
    n_assets: int = 16,
    n_factors: int = 4,
    gamma: float = 1.0,
    dtype=jnp.float32,
) -> QuadraticProblem:
    """Device-side twin of :func:`portfolio_qp_batch` (factor risk model)."""
    import jax

    na, nk = n_assets, n_factors
    k1, k2, k3 = jax.random.split(key, 3)
    F = jax.random.normal(k1, (batch, na, nk), dtype) / jnp.sqrt(
        jnp.asarray(nk, dtype)
    )
    D = (
        jax.random.uniform(k2, (batch, na), dtype)
        * jnp.sqrt(jnp.asarray(nk, dtype))
        * 0.1
        + 1e-2
    )
    mu = jax.random.normal(k3, (batch, na), dtype) * 0.1

    nz = na + nk
    P = jnp.zeros((batch, nz, nz), dtype)
    idx = jnp.arange(na)
    P = P.at[:, idx, idx].set(2.0 * gamma * D)
    kdx = jnp.arange(na, nz)
    P = P.at[:, kdx, kdx].set(2.0 * gamma)
    q = jnp.concatenate([-mu, jnp.zeros((batch, nk), dtype)], axis=1)

    m = nk + 1 + na
    A = jnp.zeros((batch, m, nz), dtype)
    A = A.at[:, :nk, :na].set(F.transpose(0, 2, 1))
    A = A.at[:, :nk, na:].set(-_beye(nk, dtype))
    A = A.at[:, nk, :na].set(1.0)
    A = A.at[:, nk + 1 :, :na].set(_beye(na, dtype))
    l = jnp.concatenate(
        [
            jnp.zeros((batch, nk), dtype),
            jnp.ones((batch, 1), dtype),
            jnp.zeros((batch, na), dtype),
        ],
        axis=1,
    )
    u = jnp.concatenate(
        [
            jnp.zeros((batch, nk), dtype),
            jnp.ones((batch, 1), dtype),
            jnp.ones((batch, na), dtype),
        ],
        axis=1,
    )
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)
