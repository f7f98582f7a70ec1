"""Pluggable KKT linear solvers for the ADMM inner loop.

The reference factorizes the quasi-definite KKT matrix

    K = [[P + sigma*I,  A'        ],
         [A,            -diag(1/rho)]]

with Eigen LDL^T and back-solves it once per ADMM iteration (C5/C6,
``src/qp.cpp:160-259``).  For batched accelerator solves we *redesign*
rather than translate:

* ``schur_cholesky`` (default) — eliminate the dual block analytically.
  From the second KKT row, ``nu = rho .* (A x̃ − rhs2)``, so the system
  reduces to the SPD *Schur form* ``(P + sigma*I + A' diag(rho) A) x̃ =
  rhs1 + A' (rho .* rhs2)``, and the auxiliary iterate is simply
  ``z̃ = A x̃``.  SPD means a pivot-free Cholesky: batched cleanly by vmap,
  assembled by batched matmuls, and half the system size.  This is the
  batched equivalent of the LDL^T path, with identical exact-arithmetic
  iterates.

* ``kkt_ldlt`` — factor the full quasi-definite KKT matrix with our own
  pivot-free LDL^T (quasi-definiteness guarantees existence).  Matches the
  reference's linear-algebra structure; used for cross-validation and for
  problems where forming A' diag(rho) A is undesirable.

* ``cg`` — matrix-free conjugate gradient on the Schur operator.  Parity
  with the reference's pluggable ``Eigen::ConjugateGradient`` option
  (``include/unsupported/qp_solver.hpp:135-142``,
  ``tests/qp_solver_sparse_test.cpp:51-66``).

All solvers support ``refine_steps`` rounds of iterative refinement, which
recovers near-f64 solve accuracy from f32 factorizations.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.utils.precision import hdot, hmat

__all__ = ["get_linear_solver", "ldlt_factor", "ldlt_solve"]


def _mv(M, v):
    """Batch-polymorphic matvec at HIGHEST precision: (..., i, j) @ (..., j).
    Accepts a BlockSparse M (ops/block_sparse.py) for the matrix-free
    backends — arbitrary unstructured sparsity at block granularity."""
    if hasattr(M, "mv"):  # BlockSparse
        return M.mv(v)
    return jnp.einsum("...ij,...j->...i", M, v, precision=lax.Precision.HIGHEST)


def _rmv(M, w):
    """M' w, polymorphic over dense / BlockSparse."""
    if hasattr(M, "rmv"):
        return M.rmv(w)
    return jnp.einsum("...ij,...i->...j", M, w, precision=lax.Precision.HIGHEST)


def _diag(M):
    """Dense diagonal, polymorphic over dense / BlockSparse."""
    if hasattr(M, "diag"):
        return M.diag()
    return jnp.diagonal(M, axis1=-2, axis2=-1)


def _sq_col_sums(A, w):
    """sum_r w_r A[r, :]^2 — the Gram diagonal, polymorphic."""
    if hasattr(A, "rmv"):
        from sqp_solver_tpu.ops.block_sparse import BlockSparse

        A2 = BlockSparse(A.data * A.data, A.rows, A.cols, A.shape, A.bs)
        return A2.rmv(w)
    return jnp.sum(w[..., :, None] * A * A, axis=-2)


class LinearSolver(NamedTuple):
    """factor(P, A, sigma, rho_vec) -> factor pytree;
    solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps) -> x_tilde;
    solve_xz(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps)
      -> (x_tilde, z_tilde) — the fused per-ADMM-iteration op;
    is_failure(factor) -> bool scalar (factorization broke down)."""

    factor: Callable[..., Any]
    solve: Callable[..., jnp.ndarray]
    solve_xz: Callable[..., Tuple[jnp.ndarray, jnp.ndarray]]
    is_failure: Callable[[Any], jnp.ndarray]


# ---------------------------------------------------------------------------
# Schur-complement Cholesky (default)
# ---------------------------------------------------------------------------


def _schur_matrix(P, A, sigma, rho_vec):
    n = P.shape[-1]
    eye = jnp.eye(n, dtype=P.dtype)
    # A' diag(rho) A via one scaled batched matmul
    return P + sigma * eye + hmat(A.mT, rho_vec[..., :, None] * A)


def _schur_factor(P, A, sigma, rho_vec):
    """Cholesky + *explicit inverse* of the Schur matrix.

    The per-ADMM-iteration solve is the hot op.  A batched
    triangular_solve is a sequential substitution (slow for thousands of
    small systems), so we pay one extra n^3 at factorization time — L^-1
    by triangular solve against I, then M^-1 = L^-T L^-1 — and every
    subsequent solve is a single batched matvec.  Factorizations happen
    only on rho epochs; solves happen every iteration.  Accuracy loss vs a
    backsolve is O(kappa * eps) either way; ``refine_steps`` (with the
    exact M kept alongside) recovers backsolve-grade residuals in f32.
    """
    # Cholesky / triangular_solve are XLA HLOs whose *internal* blocked
    # matmuls follow the ambient precision config — pin it here or f32
    # silently degrades to TF32 passes and ADMM stops converging.
    with jax.default_matmul_precision("highest"):
        M = _schur_matrix(P, A, sigma, rho_vec)
        L = jnp.linalg.cholesky(M)
        n = M.shape[-1]
        Li = jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape), lower=True
        )
        Minv = hmat(Li.mT, Li)
        # One Newton–Schulz step, X <- X(2I - MX): inverse error contracts
        # quadratically, recovering near-backsolve accuracy in f32 for two
        # cheap batched matmuls (factorization is per-rho-epoch, amortized).
        n_eye = jnp.eye(n, dtype=M.dtype)
        Minv = hmat(Minv, 2.0 * n_eye - hmat(M, Minv))
        # Fused ADMM iteration operator: with G1 = M^-1 and G2 = M^-1 A',
        #   [x_tilde; z_tilde] = [[G1, G2], [A G1, A G2]] @ [rhs1; rho.*z - y]
        # — the entire per-iteration linear algebra in ONE batched matvec
        # (per-op dispatch overhead inside lax loops is ~2x the matvec
        # itself at these sizes, so op count is the metric that matters).
        # CRITICAL: rho must stay in the *vector* operand.  Folding diag(rho)
        # into the precomputed operator (G2 = M^-1 A' rho) bakes entries of
        # magnitude rho (up to RHO_MAX = 1e6 under adaptive rho) into W and
        # destroys the cancellation structure of z - y/rho — measured 4e-2
        # final error on the tight Rosenbrock conformance run vs 1e-13 with
        # the rho-free fusion.
        W = _fused_admm_operator(Minv, A)
    return {"W": W, "Minv": Minv, "M": M, "diag_nan": jnp.any(jnp.isnan(L))}


def _fused_admm_operator(Minv, A):
    """[[G1, G2], [A G1, A G2]] with G1 = M^-1, G2 = M^-1 A' — see the
    comment in :func:`_schur_factor`.  Shared by every backend that keeps
    an explicit Minv (dense default, ``schur_arrow``)."""
    G2 = hmat(Minv, A.mT)
    W_top = jnp.concatenate([Minv, G2], axis=-1)
    W_bot = jnp.concatenate([hmat(A, Minv), hmat(A, G2)], axis=-1)
    return jnp.concatenate([W_top, W_bot], axis=-2)


def _schur_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    b = rhs1 + _mv(A.mT, rho_vec * rhs2)
    x = _mv(factor["Minv"], b)
    for _ in range(refine_steps):
        r = b - _mv(factor["M"], x)
        x = x + _mv(factor["Minv"], r)
    return x


def _schur_solve_xz(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    if refine_steps > 0:
        # refinement needs the residual against M — take the 2-op path
        x = _schur_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps)
        return x, _mv(A, x)
    n = rhs1.shape[-1]
    xz = _mv(factor["W"], jnp.concatenate([rhs1, rho_vec * rhs2], axis=-1))
    return xz[..., :n], xz[..., n:]


def _schur_is_failure(factor):
    return factor["diag_nan"] | jnp.any(jnp.isnan(factor["Minv"]))


# ---------------------------------------------------------------------------
# Full-KKT pivot-free LDL^T
# ---------------------------------------------------------------------------


def ldlt_factor(K: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pivot-free LDL^T of a symmetric quasi-definite matrix (batch-
    polymorphic: K is (..., N, N)).

    Right-looking rank-1 updates under ``lax.fori_loop`` — sequential in
    columns but each step is a full-width (batched) vector op.  Returns
    (unit-lower L, diagonal d)."""
    N = K.shape[-1]
    idx = jnp.arange(N)

    def body(j, carry):
        W, L, d = carry
        dj = W[..., :, j].take(j, axis=-1)  # (...,)
        col = W[..., :, j] / dj[..., None]
        col = jnp.where(idx > j, col, 0.0)
        W = W - dj[..., None, None] * (col[..., :, None] * col[..., None, :])
        L = lax.dynamic_update_index_in_dim(L, col, j, axis=-1)
        d = lax.dynamic_update_index_in_dim(d, dj, j, axis=-1)
        return W, L, d

    L0 = jnp.zeros_like(K)
    d0 = jnp.zeros(K.shape[:-1], K.dtype)
    _, L, d = lax.fori_loop(0, N, body, (K, L0, d0))
    return L + jnp.eye(N, dtype=K.dtype), d


def ldlt_solve(L: jnp.ndarray, d: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    w = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True, unit_diagonal=True)[..., 0]
    w = w / d
    return jax.scipy.linalg.solve_triangular(
        L.mT, w[..., None], lower=False, unit_diagonal=True
    )[..., 0]


def _kkt_matrix(P, A, sigma, rho_vec):
    n = P.shape[-1]
    m = A.shape[-2]
    dtype = P.dtype
    top = jnp.concatenate([P + sigma * jnp.eye(n, dtype=dtype), A.T], axis=1)
    bot = jnp.concatenate([A, -jnp.diag(1.0 / rho_vec)], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _kkt_factor(P, A, sigma, rho_vec):
    K = _kkt_matrix(P, A, sigma, rho_vec)
    L, d = ldlt_factor(K)
    # quasi-definite pivot lower bound: LDL' of [[E, B'],[B, -F]] with
    # E >= sigma I, F >= diag(1/rho) has |d_i| >= min(sigma, 1/rho_max)
    # (Vanderbei 1995).  The exact-arithmetic bound is loosened 20x:
    # f32 roundoff on sigma-level pivots (cancellation ~ n*eps*|row|)
    # can legitimately land below the bound while the factorization —
    # with iterative refinement — is still serviceable; only order-of-
    # magnitude collapses (or NaN) mark a breakdown
    pivot_floor = 0.05 * jnp.minimum(
        jnp.asarray(sigma, d.dtype), 1.0 / jnp.max(rho_vec)
    )
    return {"L": L, "d": d, "K": K, "pivot_floor": pivot_floor}


def _kkt_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    n = rhs1.shape[0]
    b = jnp.concatenate([rhs1, rhs2])
    s = ldlt_solve(factor["L"], factor["d"], b)
    for _ in range(refine_steps):
        r = b - hdot(factor["K"], s)
        s = s + ldlt_solve(factor["L"], factor["d"], r)
    return s[:n]


def _kkt_is_failure(factor):
    # float-sensible pivot test against the quasi-definite LOWER BOUND
    # min(sigma, 1/rho_max) recorded at factor time.  (A threshold
    # relative to the LARGEST pivot is wrong: legitimate KKT factors span
    # [sigma, growth * rho_max] — e.g. the huber family spans [1e-6, 3e6]
    # in f32 — and the relative test flags the valid sigma pivots.)
    d = factor["d"]
    return jnp.any(jnp.isnan(d)) | jnp.any(jnp.abs(d) < factor["pivot_floor"])


# ---------------------------------------------------------------------------
# Matrix-free conjugate gradient on the Schur operator
# ---------------------------------------------------------------------------


def _cg_factor(P, A, sigma, rho_vec):
    # "Factorization" = the Jacobi preconditioner: diag(M) for the Schur
    # operator M = P + sigma I + A' diag(rho) A.  O(n*m) to form, and it
    # flattens the rho-induced scale spread (rho spans [1e-6, 1e6] under
    # adaptive rho), typically several-fold fewer CG iterations.
    # Polymorphic over dense / BlockSparse P, A (ops/block_sparse.py):
    # with BlockSparse this is the ARBITRARY-SPARSITY backend — fully
    # matrix-free, no Gram, no factorization, no fill-in (the batched
    # answer to the reference's Eigen::SimplicialLDLT ambition,
    # include/solvers/qp.hpp:126-129).
    diag_M = _diag(P) + sigma + _sq_col_sums(A, rho_vec)
    factor = {"jacobi": jnp.maximum(diag_M, jnp.finfo(diag_M.dtype).tiny)}
    # BlockSparse operands: build the strip arrays HERE, outside the CG
    # loop, so per-iteration matvecs are single contractions with no
    # gather/transpose riding the iteration (ops/block_sparse.prepare)
    if hasattr(P, "prepare"):
        factor["P_mv"] = P.prepare(False)
    if hasattr(A, "prepare"):
        factor["A_mv"] = A.prepare(False)
        factor["A_rmv"] = A.prepare(True)
    return factor


def _cg_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    del refine_steps
    n = rhs1.shape[0]
    dinv = 1.0 / factor["jacobi"]

    def _Pmv(v):
        if hasattr(P, "mv"):
            return P.mv(v, prepared=factor.get("P_mv"))
        return _mv(P, v)

    def _Amv(v):
        if hasattr(A, "mv"):
            return A.mv(v, prepared=factor.get("A_mv"))
        return _mv(A, v)

    def _Armv(w):
        if hasattr(A, "rmv"):
            return A.rmv(w, prepared=factor.get("A_rmv"))
        return _rmv(A, w)

    def mv(v):
        return _Pmv(v) + sigma * v + _Armv(rho_vec * _Amv(v))

    b = rhs1 + _Armv(rho_vec * rhs2)
    eps = jnp.finfo(b.dtype).eps
    tol2 = (10.0 * eps) ** 2 * jnp.maximum(b @ b, eps)

    def cond(s):
        x, r, p, zr, k = s
        return (r @ r > tol2) & (k < 4 * n)

    def body(s):
        x, r, p, zr, k = s
        Ap = mv(p)
        pAp = p @ Ap
        # breakdown guard: pAp <= 0 on an SPD operator means numerical
        # collapse — poison the iterate so the failure is visible
        # downstream (NaN residuals can never satisfy the termination
        # criteria, so a broken solve can never report SOLVED)
        alpha = zr / jnp.where(pAp > 0.0, pAp, jnp.nan)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        zr_new = r @ z
        p = z + (zr_new / zr) * p
        return x, r, p, zr_new, k + 1

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = dinv * r0
    x, *_ = lax.while_loop(cond, body, (x0, r0, z0, r0 @ z0, jnp.int32(0)))
    return x


def _cg_is_failure(factor):
    # CG cannot produce a *false* SOLVED: the ADMM termination residuals
    # are computed from exact matvecs, independent of solve quality.  An
    # unconverged or broken-down CG surfaces as MAX_ITER_EXCEEDED (or
    # NaN-poisoned residuals), never silent success.
    return jnp.any(jnp.isnan(factor["jacobi"]))


# ---------------------------------------------------------------------------
# Schur Cholesky with per-iteration back-substitution (large-n variant)
# ---------------------------------------------------------------------------


def _schur_tri_factor(P, A, sigma, rho_vec):
    """Large-n variant: store L and back-solve per iteration.  The explicit
    inverse (default path) is the right trade at small n (batched
    triangular solves are slow, matvecs cheap), but its triangular solve
    against a full identity is an XLA compile hog and an O(n^3) memory
    writer at n in the thousands."""
    with jax.default_matmul_precision("highest"):
        M = _schur_matrix(P, A, sigma, rho_vec)
        L = jnp.linalg.cholesky(M)
    return {"L": L, "M": M, "diag_nan": jnp.any(jnp.isnan(L))}


def _schur_tri_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    b = rhs1 + _mv(A.mT, rho_vec * rhs2)
    L = factor["L"]

    def cho(v):
        w = jax.scipy.linalg.solve_triangular(L, v[..., None], lower=True)[..., 0]
        return jax.scipy.linalg.solve_triangular(L.mT, w[..., None], lower=False)[..., 0]

    x = cho(b)
    for _ in range(refine_steps):
        x = x + cho(b - _mv(factor["M"], x))
    return x


def _schur_tri_is_failure(factor):
    return factor["diag_nan"]


# ---------------------------------------------------------------------------
# Blocked Cholesky with explicit inverse (large-n single-problem path)
# ---------------------------------------------------------------------------


def _blocked_cholesky(M, bs=512):
    """Right-looking blocked Cholesky: python-unrolled 128x-aligned blocks
    so the panel solve and the rank-bs trailing update are plain GEMMs
    (XLA's own `cholesky` HLO at n ~ 4096 spends its time in sequential
    triangular solves; this formulation keeps >95% of the flops in
    matmuls).  Returns lower L."""
    n = M.shape[-1]
    dtype = M.dtype
    cols = []
    T = M
    for k in range(0, n, bs):
        b = min(bs, n - k)
        eye_b = jnp.eye(b, dtype=dtype)
        L_kk = jnp.linalg.cholesky(T[:b, :b])
        Lkk_invT = jax.scipy.linalg.solve_triangular(L_kk, eye_b, lower=True).T
        colblk = jnp.concatenate(
            [L_kk, hmat(T[b:, :b], Lkk_invT)], axis=0
        )  # (n - k, b)
        if k:
            colblk = jnp.concatenate(
                [jnp.zeros((k, b), dtype), colblk], axis=0
            )
        cols.append(colblk)
        panel = colblk[k + b :, :]
        T = T[b:, b:] - hmat(panel, panel.T)  # rank-bs GEMM update
    return cols[0] if len(cols) == 1 else jnp.concatenate(cols, axis=1)


def _blocked_tri_inv(L, bs=512):
    """Li = L^-1 for lower-triangular L via block forward substitution —
    the off-diagonal work is GEMMs (XLA's triangular_solve against a
    full identity is a sequential-substitution compile hog at large n)."""
    n = L.shape[-1]
    dtype = L.dtype
    nb = -(-n // bs)
    # block grid of Li, built column-block by column-block
    inv_diag = []
    for i in range(nb):
        i0, i1 = i * bs, min((i + 1) * bs, n)
        eye_b = jnp.eye(i1 - i0, dtype=dtype)
        inv_diag.append(
            jax.scipy.linalg.solve_triangular(L[i0:i1, i0:i1], eye_b, lower=True)
        )
    blocks = [[None] * nb for _ in range(nb)]
    for j in range(nb):
        j0, j1 = j * bs, min((j + 1) * bs, n)
        blocks[j][j] = inv_diag[j]
        for i in range(j + 1, nb):
            i0, i1 = i * bs, min((i + 1) * bs, n)
            # X_ij = -L_ii^-1 sum_{j<=k<i} L_ik X_kj
            acc = hmat(L[i0:i1, j0:j1], blocks[j][j])
            for k in range(j + 1, i):
                k0, k1 = k * bs, min((k + 1) * bs, n)
                acc = acc + hmat(L[i0:i1, k0:k1], blocks[k][j])
            blocks[i][j] = -hmat(inv_diag[i], acc)
    rows = []
    for i in range(nb):
        i0, i1 = i * bs, min((i + 1) * bs, n)
        row = [
            blocks[i][j]
            if j <= i
            else jnp.zeros((i1 - i0, min((j + 1) * bs, n) - j * bs), dtype)
            for j in range(nb)
        ]
        rows.append(row[0] if len(row) == 1 else jnp.concatenate(row, axis=1))
    return rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=0)


def _schur_blocked_factor(P, A, sigma, rho_vec):
    """Large-n factor: blocked Cholesky + blocked triangular inverse +
    one GEMM for the explicit M^-1 — every per-ADMM-iteration solve is
    then a single matvec.  The SURVEY's "north-star native kernel" (C6,
    reference include/solvers/qp.hpp:126-129) realized as GEMMs."""
    with jax.default_matmul_precision("highest"):
        M = _schur_matrix(P, A, sigma, rho_vec)
        n = M.shape[-1]
        bs = 512 if n >= 1024 else max(128, n // 4)
        L = _blocked_cholesky(M, bs=bs)
        Li = _blocked_tri_inv(L, bs=bs)
        Minv = hmat(Li.T, Li)
        # one Newton–Schulz refinement step for f32 accuracy
        Minv = hmat(Minv, 2.0 * jnp.eye(n, dtype=M.dtype) - hmat(M, Minv))
    return {"Minv": Minv, "M": M, "diag_nan": jnp.any(jnp.isnan(L))}


def _schur_blocked_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    b = rhs1 + _mv(A.mT, rho_vec * rhs2)
    x = _mv(factor["Minv"], b)
    for _ in range(refine_steps):
        r = b - _mv(factor["M"], x)
        x = x + _mv(factor["Minv"], r)
    return x


# ---------------------------------------------------------------------------
# Block-tridiagonal Schur Cholesky (structured KKT — the batched
# equivalent of the reference's sparse path, src/qp.cpp:161-270 under
# QP_SOLVER_USE_SPARSE + include/unsupported/qp_solver.hpp)
# ---------------------------------------------------------------------------


def _btd_blocks(M, b):
    """Extract diagonal blocks D (T, b, b) and sub-diagonal blocks E
    (T, b, b; last entry zero) from a block-tridiagonal matrix."""
    n = M.shape[-1]
    T = n // b
    Mb = M.reshape(T, b, T, b)
    idx = jnp.arange(T)
    D = Mb[idx, :, idx, :]  # (T, b, b)
    E = Mb[jnp.arange(1, T), :, jnp.arange(T - 1), :]  # (T-1, b, b)
    E = jnp.concatenate([E, jnp.zeros((1, b, b), M.dtype)], axis=0)
    return D, E


def _btd_factor_factory(b: int):
    def factor(P, A, sigma, rho_vec):
        """Block-Thomas Cholesky of the Schur matrix: M = L L' with block-
        bidiagonal L (diag blocks L_k, sub blocks F_k = E_k L_k^-T).
        O(T b^3) instead of O((T b)^3); per-iteration solves are two
        O(T b^2) block-bidiagonal sweeps of batched small matmuls.

        The ADMM iterate math never sees the structure — this is the
        "block-masked dense" realization planned in SURVEY C5: M is formed
        densely (correct for any A), and only the factorization/solve
        exploit the band.  Entries of M outside the band are *ignored*, so
        the caller must guarantee block-tridiagonal structure (e.g. the
        stage-wise MPC form, models/mpc.py:mpc_qp_stagewise_batch).
        """
        with jax.default_matmul_precision("highest"):
            M = _schur_matrix(P, A, sigma, rho_vec)
            D, E = _btd_blocks(M, b)
            eye_b = jnp.eye(b, dtype=M.dtype)

            def step(carry, inp):
                Fo_prev = carry  # F_{k-1} F_{k-1}'
                Dk, Ek = inp
                Sk = Dk - Fo_prev
                Lk = jnp.linalg.cholesky(Sk)
                Lk_inv = jax.scipy.linalg.solve_triangular(Lk, eye_b, lower=True)
                Fk = Ek @ Lk_inv.T  # E_k L_k^-T
                return Fk @ Fk.T, (Lk_inv, Fk)

            _, (Li, F) = lax.scan(step, jnp.zeros((b, b), M.dtype), (D, E))
        return {
            "Li": Li,
            "F": F,
            "M": M,
            "diag_nan": jnp.any(jnp.isnan(Li)),
        }

    def solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
        bvec = rhs1 + _mv(A.mT, rho_vec * rhs2)
        n = bvec.shape[-1]
        T = n // b
        Li, F = factor["Li"], factor["F"]

        def btd_solve(v):
            vb = v.reshape(T, b)
            F_prev = jnp.concatenate([jnp.zeros((1, b, b), v.dtype), F[:-1]], axis=0)

            def fwd(w_prev, inp):
                Li_k, Fp_k, b_k = inp
                w_k = Li_k @ (b_k - Fp_k @ w_prev)
                return w_k, w_k

            _, W = lax.scan(fwd, jnp.zeros((b,), v.dtype), (Li, F_prev, vb), unroll=8)

            def bwd(x_next, inp):
                Li_k, F_k, w_k = inp
                x_k = Li_k.T @ (w_k - F_k.T @ x_next)
                return x_k, x_k

            _, X = lax.scan(bwd, jnp.zeros((b,), v.dtype), (Li, F, W), reverse=True, unroll=8)
            return X.reshape(n)

        x = btd_solve(bvec)
        for _ in range(refine_steps):
            x = x + btd_solve(bvec - _mv(factor["M"], x))
        return x

    def is_failure(factor):
        return factor["diag_nan"]

    return LinearSolver(factor, solve, _fallback_solve_xz(solve), is_failure)


# ---------------------------------------------------------------------------
# Arrow-structured Schur Cholesky (block-diagonal + dense coupling border —
# MPC with coupling constraints, factor-model portfolios).  Completes the
# reference's sparse ambition (include/solvers/qp.hpp:126-128,
# tests/qp_solver_sparse_test.cpp:51-98) for the border-structured KKTs the
# block-tridiagonal backend cannot express.
# ---------------------------------------------------------------------------


def _arrow_factor_factory(b: int, c: int):
    """Schur matrix assumed arrow-structured:

        M = [[D, B], [B', C]]   with D = blkdiag(D_1..D_T), D_k (b, b),
                                 C (c, c) dense (the coupling border).

    Entries of M outside the arrow pattern are IGNORED (the
    block-masked-dense contract, same as ``schur_block_tridiag``): the
    caller must guarantee the structure — e.g. stage-wise problems whose
    only cross-stage coupling runs through the trailing ``c`` variables.

    Design: an earlier version kept the factorization in block form and
    ran the hot ADMM solve as a chain of per-block einsums (Dinv matvec
    -> border correction -> back-substitution); at b >= 32 the
    uncorrected f32 block inverses degraded convergence outright (solved
    0.58 at n=770).  The
    structure is therefore exploited ONLY where it mathematically matters
    — the factorization — via the closed-form bordered inverse

        Dinv = blkdiag(D_k^-1)        (batched (T,b,b) Cholesky: the
                                       sequential dependency depth drops
                                       from n to b)
        W    = Dinv B,  S = C - B' W,  X = W Sinv
        M^-1 = [[Dinv + X W', -X], [-X', Sinv]]

    assembled into the SAME dense explicit-inverse + fused-operator form
    the default backend uses (one full Newton-Schulz against M restores
    near-backsolve f32 accuracy).  The hot loop is then the identical
    single-matvec fast path — arrow pays dense iteration cost but
    O(T b^3 + n^2 c) + matmul factor cost instead of a depth-n
    Cholesky/triangular-inverse chain.
    """

    def factor(P, A, sigma, rho_vec):
        with jax.default_matmul_precision("highest"):
            M = _schur_matrix(P, A, sigma, rho_vec)
            n = M.shape[-1]
            T = (n - c) // b
            nd = T * b
            hp = lax.Precision.HIGHEST
            Dblk = M[:nd, :nd].reshape(T, b, T, b)[
                jnp.arange(T), :, jnp.arange(T), :
            ]  # (T, b, b)
            Bblk = M[:nd, nd:].reshape(T, b, c)  # (T, b, c)
            C = M[nd:, nd:]  # (c, c)

            Ld = jnp.linalg.cholesky(Dblk)  # batched (T, b, b)
            eye_b = jnp.eye(b, dtype=M.dtype)
            Li = jax.vmap(
                lambda Lk: jax.scipy.linalg.solve_triangular(Lk, eye_b, lower=True)
            )(Ld)
            Dinv = jnp.einsum("tij,tik->tjk", Li, Li, precision=hp)
            # per-block Newton-Schulz (batched (T,b,b) matmuls, cheap):
            # the composed bordered inverse inherits every block's error,
            # so each factor is corrected before composition AND the
            # assembled whole is corrected once more below
            Dinv = jnp.einsum(
                "tij,tjk->tik",
                Dinv,
                2.0 * eye_b
                - jnp.einsum("tij,tjk->tik", Dblk, Dinv, precision=hp),
                precision=hp,
            )
            W = jnp.einsum("tij,tjc->tic", Dinv, Bblk, precision=hp)
            S = C - jnp.einsum("tbc,tbd->cd", Bblk, W, precision=hp)
            Ls = jnp.linalg.cholesky(S)
            Lsi = jax.scipy.linalg.solve_triangular(
                Ls, jnp.eye(c, dtype=M.dtype), lower=True
            )
            Sinv = hmat(Lsi.T, Lsi)
            Sinv = hmat(Sinv, 2.0 * jnp.eye(c, dtype=M.dtype) - hmat(S, Sinv))
            X = jnp.einsum("tbc,cd->tbd", W, Sinv, precision=hp)  # W Sinv

            # assemble the dense bordered inverse
            TL = (
                jnp.zeros((T, b, T, b), M.dtype)
                .at[jnp.arange(T), :, jnp.arange(T), :]
                .set(Dinv)
                .reshape(nd, nd)
            )
            TL = TL + jnp.einsum("tic,ujc->tiuj", X, W, precision=hp).reshape(
                nd, nd
            )
            Xf = X.reshape(nd, c)
            Minv = jnp.concatenate(
                [
                    jnp.concatenate([TL, -Xf], axis=-1),
                    jnp.concatenate([-Xf.T, Sinv], axis=-1),
                ],
                axis=-2,
            )
            # One full Newton-Schulz step against M (two matmuls):
            # contracts the composed block-inverse error quadratically —
            # without it, f32 runs at b >= 32 stall (see docstring).
            Minv = hmat(Minv, 2.0 * jnp.eye(n, dtype=M.dtype) - hmat(M, Minv))
            Wop = _fused_admm_operator(Minv, A)
        return {
            "W": Wop,
            "Minv": Minv,
            "M": M,
            "diag_nan": jnp.any(jnp.isnan(Ld)) | jnp.any(jnp.isnan(Ls)),
        }

    return LinearSolver(factor, _schur_solve, _schur_solve_xz, _schur_is_failure)


def _fallback_solve_xz(solve):
    def solve_xz(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
        x = solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps)
        return x, _mv(A, x)

    return solve_xz


_REGISTRY = {
    "schur_cholesky": LinearSolver(
        _schur_factor, _schur_solve, _schur_solve_xz, _schur_is_failure
    ),
    "kkt_ldlt": LinearSolver(
        _kkt_factor, _kkt_solve, _fallback_solve_xz(_kkt_solve), _kkt_is_failure
    ),
    "cg": LinearSolver(
        _cg_factor, _cg_solve, _fallback_solve_xz(_cg_solve), _cg_is_failure
    ),
    "schur_cholesky_tri": LinearSolver(
        _schur_tri_factor,
        _schur_tri_solve,
        _fallback_solve_xz(_schur_tri_solve),
        _schur_tri_is_failure,
    ),
    "schur_cholesky_blocked": LinearSolver(
        _schur_blocked_factor,
        _schur_blocked_solve,
        _fallback_solve_xz(_schur_blocked_solve),
        _schur_tri_is_failure,
    ),
}


def get_linear_solver(
    name: str, block_size: int = 0, arrow_width: int = 0
) -> LinearSolver:
    if name == "schur_block_tridiag":
        if block_size <= 0:
            raise ValueError(
                "linear_solver='schur_block_tridiag' requires settings.block_size > 0"
            )
        return _btd_factor_factory(block_size)
    if name == "schur_arrow":
        if block_size <= 0 or arrow_width <= 0:
            raise ValueError(
                "linear_solver='schur_arrow' requires settings.block_size > 0 "
                "and settings.arrow_width > 0"
            )
        return _arrow_factor_factory(block_size, arrow_width)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown linear_solver {name!r}; available: "
            f"{sorted(_REGISTRY) + ['schur_arrow', 'schur_block_tridiag']}"
        ) from None
