"""Batch-explicit fused ADMM solver — the production batched QP path.

``qp_solve`` + ``vmap`` is the semantics-defining implementation; this
module re-implements the same algorithm with an *explicit* leading batch
axis so that:

* the iteration counter is a true scalar, so epoch predicates like
  ``k % adaptive_rho_interval == 0`` are scalar branches (a vmapped
  counter turns them into selects that execute both sides every chunk);
* per-problem convergence is an explicit ``done`` mask (a converged
  problem's iterates freeze at chunk granularity while stragglers run);
* the `seg`-iteration inner chunk (:func:`admm_chunk`) is a scan of
  batched matvecs with the termination residuals at its end;
* the whole solve is a single flat ``lax.while_loop`` (one sync per chunk).

The chunk runs `seg` iterations of

    rhs  = [sigma*x - q ; rho.*z - y]
    xz   = W @ rhs                      # W = fused iteration operator
    pre  = alpha*xz + (1-alpha)*[x; z]
    s'   = clip(pre + [0; y/rho], [-inf; l], [+inf; u])
    y'   = y + rho * (pre - s')[n:]

on padded D = n+m vectors (state s = [x; z], y_pad = [0; y], bounds
[-inf; l] / [+inf; u], rho_pad = [0; rho]), so the x-update and the box
projection are the same clip and the chunk contains no per-iteration
slicing.  The chunk-end residuals are the reference's termination terms
(``src/qp.cpp:317-331``).

Supported linear solver: ``schur_cholesky`` (the production configuration).
Semantics match the vmapped solver — same iterate math, same termination
cadence; tests assert element-wise agreement of the optima.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.ops.linear_solver import get_linear_solver
from sqp_solver_tpu.qp.classify import (
    RHO_MAX,
    RHO_MIN,
    constr_type_init,
    rho_vec_from_type,
)
from sqp_solver_tpu.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)
from sqp_solver_tpu.utils.precision import pin_precision

__all__ = ["qp_solve_fused", "admm_chunk"]


def _chunk_stats(P, A, q, x, z, y):
    """Residuals + norm caches, per problem: (B, 4) =
    [res_prim, res_dual, max_Ax_z, max_Px_ATy_q]."""
    Ax = jnp.sum(A * x[:, None, :], axis=-1)
    Px = jnp.sum(P * x[:, None, :], axis=-1)
    ATy = jnp.sum(A.mT * y[:, None, :], axis=-1)
    linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
    return jnp.stack(
        [
            linf(Ax - z),
            linf(Px + q + ATy),
            jnp.maximum(linf(Ax), linf(z)),
            jnp.maximum(linf(Px), jnp.maximum(linf(ATy), linf(q))),
        ],
        axis=-1,
    )


def admm_chunk(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg,
               unroll=8):
    """`seg` padded ADMM iterations (module docstring) + the chunk-end
    residual stats.  Returns ``(s, yp, stats (B, 4))``."""
    n = P.shape[-1]
    ysel = rhoip * rhop  # [0_n; 1_m]

    def body(carry, _):
        s, yp = carry
        # rhs = [sigma*x - q ; rho.*z - y]: the rho-free fused operator W
        # takes the well-scaled dual form (see linear_solver._schur_factor)
        rhs = scale1 * s - qv - ysel * yp
        xz = jnp.einsum("bij,bj->bi", W, rhs, precision=lax.Precision.HIGHEST)
        pre = alpha * xz + (1.0 - alpha) * s
        s_new = jnp.clip(pre + rhoip * yp, lp, up)
        return (s_new, yp + rhop * (pre - s_new)), None

    (s, yp), _ = lax.scan(body, (s, yp), None, length=seg, unroll=min(unroll, seg))
    return s, yp, _chunk_stats(P, A, qv[:, :n], s[:, :n], s[:, n:], yp[:, n:])


class _Carry(NamedTuple):
    s: jax.Array  # (B, D) padded state [x; z]
    yp: jax.Array  # (B, D) padded dual [0; y]
    rho: jax.Array  # (B,)
    rho_vec: jax.Array  # (B, m)
    factor: dict
    k: jax.Array  # scalar int32 — lockstep iteration counter
    iter: jax.Array  # (B,) int32 — per-problem iteration count
    done: jax.Array  # (B,) bool
    failed: jax.Array  # (B,) bool
    res_prim: jax.Array  # (B,)
    res_dual: jax.Array  # (B,)
    max_Ax_z: jax.Array
    max_Px_ATy_q: jax.Array
    rho_estimate: jax.Array
    rho_updates: jax.Array  # (B,) int32
    infeas: jax.Array  # (B,) int32: 0 none, 1 primal cert, 2 dual cert
    aa: object  # batched Anderson state dict, or None (static shape)


@pin_precision
def qp_solve_fused(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state: Optional[QPState] = None,
) -> QPResult:
    """Solve a batch of QPs (every leaf of ``qp`` has leading dim B).

    ``linear_solver="schur_cholesky"`` (default) runs the dense chunk
    (:func:`admm_chunk`); the structured backends
    (``"schur_block_tridiag"``, ``"schur_arrow"``) run the same fused loop
    with the chunk at the XLA level — vmapped block-Thomas sweeps / arrow
    block elimination (batched small GEMMs) instead of the dense Minv
    matvec, so structured MPC problems get the O(T b^3) factorization AND
    the fused tier's one-sync-per-chunk schedule.
    """
    settings.validate()
    structured = settings.linear_solver in ("schur_block_tridiag", "schur_arrow")
    if settings.linear_solver != "schur_cholesky" and not structured:
        raise ValueError(
            "qp_solve_fused supports linear_solver='schur_cholesky', "
            "'schur_block_tridiag', or 'schur_arrow'"
        )
    if settings.scaling > 0:
        raise ValueError(
            "call qp_solve_fused through qp_solve_batch for scaling support"
        )
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    dtype = P.dtype
    B, n = q.shape
    m = A.shape[-2]
    D = n + m

    if structured:
        _s1 = get_linear_solver(
            settings.linear_solver, settings.block_size, settings.arrow_width
        )
        # batch-explicit wrappers: the backend is written per problem (its
        # factor/solve scan over stage blocks); vmap lifts each scan step
        # to a batched small GEMM
        solver = type(_s1)(
            factor=jax.vmap(_s1.factor, in_axes=(0, 0, None, 0)),
            solve=None,
            solve_xz=jax.vmap(
                lambda f, P_, A_, rho_, r1, r2: _s1.solve_xz(
                    f, P_, A_, None, rho_, r1, r2, settings.refine_steps
                ),
                in_axes=(0, 0, 0, 0, 0, 0),
            ),
            is_failure=lambda f: f["diag_nan"],
        )
    else:
        solver = get_linear_solver("schur_cholesky")
    sigma = jnp.asarray(settings.sigma, dtype)
    eps_abs = jnp.asarray(settings.eps_abs, dtype)
    eps_rel = jnp.asarray(settings.eps_rel, dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    ctype = constr_type_init(l, u)
    rho_vec0 = rho_vec_from_type(ctype, settings.rho, dtype)

    if state is None:
        x0 = jnp.zeros((B, n), dtype)
        z0 = jnp.zeros((B, m), dtype)
        y0 = jnp.zeros((B, m), dtype)
    else:
        x0, z0, y0 = state.x, state.z, state.y

    check = settings.check_termination
    interval0 = settings.adaptive_rho_interval if settings.adaptive_rho else settings.max_iter
    seg = check if check > 0 else min(interval0, settings.max_iter)
    # epoch boundaries are detected as k % interval == 0 — round the interval
    # up to a multiple of the chunk length
    interval = -(-interval0 // seg) * seg

    # ---- padded constant vectors (see the module docstring) ----------------
    zeros_n = jnp.zeros((B, n), dtype)
    inf = jnp.asarray(jnp.inf, dtype)
    qv = jnp.concatenate([q, jnp.zeros((B, m), dtype)], axis=-1)
    sigma_n = jnp.full((B, n), settings.sigma, dtype)
    lp = jnp.concatenate([jnp.full((B, n), -inf), l], axis=-1)
    up = jnp.concatenate([jnp.full((B, n), inf), u], axis=-1)
    alpha = float(settings.alpha)

    def padded_rho(rho_vec):
        rhop = jnp.concatenate([zeros_n, rho_vec], axis=-1)
        rhoip = jnp.concatenate([zeros_n, 1.0 / rho_vec], axis=-1)
        return rhop, rhoip

    use_aa = settings.acceleration == "anderson"
    m_aa = settings.anderson_memory
    D2 = 2 * D

    def _stats(s_, yp_):
        """:func:`_chunk_stats` with the products as batched contractions
        (the structured chunk and the Anderson safeguard score with these).
        The two forms round differently, and the tests pin the
        trajectories each one gives."""
        hp = lax.Precision.HIGHEST
        x, z, y = s_[:, :n], s_[:, n:], yp_[:, n:]
        Ax = jnp.einsum("bmn,bn->bm", A, x, precision=hp)
        Px = jnp.einsum("bij,bj->bi", P, x, precision=hp)
        ATy = jnp.einsum("bmn,bm->bn", A, y, precision=hp)
        linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
        return jnp.stack(
            [
                linf(Ax - z),
                linf(Px + q + ATy),
                jnp.maximum(linf(Ax), linf(z)),
                jnp.maximum(linf(Px), jnp.maximum(linf(ATy), linf(q))),
            ],
            axis=-1,
        )

    def _anderson_step(c, s_new, yp_new, stats):
        """Batched safeguarded type-II AA on the chunk map (same scheme as
        qp/admm.py, per-problem accept masks).  See qp/admm.py for the
        algorithm notes; buffers reset per problem on rho refactors."""
        from sqp_solver_tpu.qp.anderson import anderson_extrapolate

        u_in = jnp.concatenate([c.s, c.yp], axis=-1)  # (B, 2D)
        u_T = jnp.concatenate([s_new, yp_new], axis=-1)
        u_aa, pairs, aa_new = anderson_extrapolate(c.aa, u_in, u_T, m_aa)
        x_a = u_aa[:, :n]
        z_a = jnp.clip(u_aa[:, n:D], l, u)  # keep the box invariant
        y_a = u_aa[:, D + n :]
        s_a = jnp.concatenate([x_a, z_a], axis=-1)
        yp_a = jnp.concatenate([zeros_n, y_a], axis=-1)

        rp_p, rd_p, mz_p, mq_p = stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3]
        stats_a = _stats(s_a, yp_a)
        rp_a, rd_a, mz_a, mq_a = (stats_a[:, j] for j in range(4))
        comb = lambda rp, rd, mz, mq: rp / (mz + tiny) + rd / (mq + tiny)
        term = lambda rp, rd, mz, mq: (rp <= eps_abs + eps_rel * mz) & (
            rd <= eps_abs + eps_rel * mq
        )
        comb_a = comb(rp_a, rd_a, mz_a, mq_a)
        accept = (
            (pairs > 0)
            & jnp.isfinite(comb_a)
            & (comb_a < comb(rp_p, rd_p, mz_p, mq_p))
            & (term(rp_a, rd_a, mz_a, mq_a) | ~term(rp_p, rd_p, mz_p, mq_p))
        )
        sel_v = lambda a, p: jnp.where(accept[:, None], a, p)
        stats_out = jnp.where(accept[:, None], stats_a, stats)
        return sel_v(s_a, s_new), sel_v(yp_a, yp_new), stats_out, aa_new

    def rho_epoch_update(c: _Carry) -> _Carry:
        """Adaptive rho estimate + masked re-factorization
        (reference src/qp.cpp:125-144)."""
        active = (~c.done) & (~c.failed) & (c.infeas == 0)
        rp = c.res_prim / (c.max_Ax_z + tiny)
        rd = c.res_dual / (c.max_Px_ATy_q + tiny)
        new_rho = jnp.clip(c.rho * jnp.sqrt(rp / (rd + tiny)), RHO_MIN, RHO_MAX)
        tol = settings.adaptive_rho_tolerance
        changed = ((new_rho < c.rho / tol) | (new_rho > c.rho * tol)) & active
        rho = jnp.where(changed, new_rho, c.rho)
        rho_vec = jnp.where(
            changed[:, None], rho_vec_from_type(ctype, new_rho[:, None], dtype), c.rho_vec
        )

        def refactor():
            fresh = solver.factor(P, A, sigma, rho_vec)
            return jax.tree.map(
                lambda new, old: jnp.where(
                    changed.reshape((B,) + (1,) * (new.ndim - 1)), new, old
                )
                if new.ndim > 0
                else new,
                fresh,
                c.factor,
            )

        factor = lax.cond(jnp.any(changed), refactor, lambda: c.factor)
        c = c._replace(
            rho=rho,
            rho_vec=rho_vec,
            factor=factor,
            rho_estimate=jnp.where(active, new_rho, c.rho_estimate),
            rho_updates=c.rho_updates + changed.astype(jnp.int32),
        )
        if use_aa:
            # the chunk map changed for re-factored problems: stale AA
            # pairs would extrapolate through a different fixed point
            c = c._replace(
                aa=dict(
                    c.aa,
                    prev_ok=c.aa["prev_ok"] & ~changed,
                    pairs=jnp.where(changed, 0, c.aa["pairs"]),
                )
            )
        return c

    def chunk_structured(factor, rho_vec, s, yp):
        """Fixed-length ADMM chunk at the XLA level with the structured
        solve: same iterate math as the dense chunk (and as qp/admm.py),
        batched explicitly."""
        x, z = s[:, :n], s[:, n:]
        y = yp[:, n:]
        rho_inv = 1.0 / rho_vec

        def one_iter(_, xzy):
            x, z, y = xzy
            rhs1 = sigma * x - q
            rhs2 = z - rho_inv * y
            xt, zt = solver.solve_xz(factor, P, A, rho_vec, rhs1, rhs2)
            xn = alpha * xt + (1.0 - alpha) * x
            z_pre = alpha * zt + (1.0 - alpha) * z
            zn = jnp.clip(z_pre + rho_inv * y, l, u)
            yn = y + rho_vec * (z_pre - zn)
            return xn, zn, yn

        x, z, y = lax.fori_loop(0, seg, one_iter, (x, z, y))
        s_out = jnp.concatenate([x, z], axis=-1)
        yp_out = jnp.concatenate([zeros_n, y], axis=-1)
        return s_out, yp_out, _stats(s_out, yp_out)

    def body(c: _Carry) -> _Carry:
        if structured:
            s_new, yp_new, stats = chunk_structured(c.factor, c.rho_vec, c.s, c.yp)
        else:
            rhop, rhoip = padded_rho(c.rho_vec)
            # scale1 = [sigma*1_n ; rho] — the fused operator takes rho.*z - y
            scale1 = jnp.concatenate([sigma_n, c.rho_vec], axis=-1)
            s_new, yp_new, stats = admm_chunk(
                c.factor["W"], P, A, qv, scale1, rhoip, rhop, lp, up, c.s, c.yp,
                alpha=alpha, seg=seg,
            )
        if use_aa:
            s_new, yp_new, stats, aa_new = _anderson_step(c, s_new, yp_new, stats)
            c = c._replace(aa=aa_new)
        active = (~c.done) & (~c.failed) & (c.infeas == 0)
        if check > 0 and settings.check_infeasibility:
            # OSQP §3.4: deltas between termination checks (qp.infeasibility)
            from sqp_solver_tpu.qp.infeasibility import infeasibility_certificates

            prim_inf, dual_inf = infeasibility_certificates(
                P, A, q, l, u,
                s_new[:, :n] - c.s[:, :n], yp_new[:, n:] - c.yp[:, n:],
                settings.eps_pinf, settings.eps_dinf,
            )
            cert = jnp.where(prim_inf, 1, jnp.where(dual_inf, 2, 0)).astype(
                jnp.int32
            )
            # the certified lane still commits THIS chunk's iterates/count
            # (matching the per-problem tier, which detects after the
            # chunk ran); only future chunks are masked off
            c = c._replace(infeas=jnp.where(active & (cert > 0), cert, c.infeas))
        s = jnp.where(active[:, None], s_new, c.s)
        yp = jnp.where(active[:, None], yp_new, c.yp)
        k = c.k + seg

        res_prim, res_dual = stats[:, 0], stats[:, 1]
        max_Ax_z, max_Px_ATy_q = stats[:, 2], stats[:, 3]
        c = c._replace(
            s=s,
            yp=yp,
            k=k,
            iter=jnp.where(active, k, c.iter),
            res_prim=jnp.where(active, res_prim, c.res_prim),
            res_dual=jnp.where(active, res_dual, c.res_dual),
            max_Ax_z=jnp.where(active, max_Ax_z, c.max_Ax_z),
            max_Px_ATy_q=jnp.where(active, max_Px_ATy_q, c.max_Px_ATy_q),
        )
        if check > 0:
            conv = (res_prim <= eps_abs + eps_rel * max_Ax_z) & (
                res_dual <= eps_abs + eps_rel * max_Px_ATy_q
            )
            if settings.check_comp_slack:
                # see QPSettings.check_comp_slack (per-problem tier has
                # the same term; z = s[:, n:] is the projected iterate)
                z_b, y_b = s[:, n:], yp[:, n:]
                # z is the PROJECTED iterate: clamped rows sit EXACTLY at the
                # bound, so the at-bound test can be razor thin (a loose
                # eps_abs-wide band hides the violation in scaled space
                # — measured)
                btol = 64.0 * jnp.finfo(z_b.dtype).eps
                at_l = z_b <= l + btol * (1.0 + jnp.abs(l))
                at_u = z_b >= u - btol * (1.0 + jnp.abs(u))
                dsv = jnp.max(
                    jnp.where(~at_u, jnp.maximum(y_b, 0.0), 0.0)
                    + jnp.where(~at_l, jnp.maximum(-y_b, 0.0), 0.0),
                    axis=-1,
                )
                conv = conv & (
                    dsv <= eps_abs + eps_rel * jnp.max(jnp.abs(y_b), axis=-1)
                )
            c = c._replace(done=c.done | (active & conv))
            if settings.verbose:
                # batched analog of the reference's per-check iteration
                # table (src/qp.cpp:374-382): batch summaries per check
                jax.debug.print(
                    "{k:4d}  active {na:5d}  rp_p50 {rp:.2e}  rd_p50 {rd:.2e}",
                    k=k,
                    na=jnp.sum(active).astype(jnp.int32),
                    rp=jnp.median(res_prim),
                    rd=jnp.median(res_dual),
                )
        if settings.adaptive_rho:
            c = lax.cond((k % interval) == 0, rho_epoch_update, lambda c: c, c)
        return c

    def cond(c: _Carry):
        return jnp.any((~c.done) & (~c.failed) & (c.infeas == 0)) & (
            c.k < settings.max_iter
        )

    factor0 = solver.factor(P, A, sigma, rho_vec0)
    failed0 = (
        factor0["diag_nan"]
        if structured
        else jnp.isnan(factor0["W"]).any(axis=(-1, -2))
    )
    zeros_b = jnp.zeros((B,), dtype)
    init = _Carry(
        s=jnp.concatenate([x0, z0], axis=-1),
        yp=jnp.concatenate([jnp.zeros((B, n), dtype), y0], axis=-1),
        rho=jnp.full((B,), settings.rho, dtype),
        rho_vec=rho_vec0,
        factor=factor0,
        k=jnp.zeros((), jnp.int32),
        iter=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), jnp.bool_),
        failed=failed0,
        res_prim=zeros_b,
        res_dual=zeros_b,
        max_Ax_z=zeros_b,
        max_Px_ATy_q=zeros_b,
        # before any adaptive evaluation the best estimate IS the current
        # rho (all tiers agree)
        rho_estimate=jnp.full((B,), settings.rho, dtype),
        # reference counts the setup rho_vec_update too (src/qp.cpp:34)
        rho_updates=jnp.ones((B,), jnp.int32),
        infeas=jnp.zeros((B,), jnp.int32),
        aa=None,
    )
    if use_aa:
        from sqp_solver_tpu.qp.anderson import anderson_init

        init = init._replace(aa=anderson_init((B,), m_aa, D2, dtype))

    if settings.schedule == "fixed":
        # static fori over ceil(max_iter/seg) chunks: no dynamic loop
        # conditions at all (masks preserve per-problem semantics)
        n_chunks = -(-settings.max_iter // seg)
        final = lax.fori_loop(0, n_chunks, lambda i, c: body(c), init)
    else:
        final = lax.while_loop(cond, body, init)

    status = jnp.where(
        final.failed,
        QPStatus.NUMERICAL_ISSUES,
        jnp.where(
            final.done,
            QPStatus.SOLVED,
            jnp.where(
                final.infeas == 1,
                QPStatus.PRIMAL_INFEASIBLE,
                jnp.where(
                    final.infeas == 2,
                    QPStatus.DUAL_INFEASIBLE,
                    QPStatus.MAX_ITER_EXCEEDED,
                ),
            ),
        ),
    ).astype(jnp.int32)
    info = QPInfo(
        status=status,
        iter=jnp.minimum(final.iter, settings.max_iter),
        rho_updates=final.rho_updates,
        rho_estimate=final.rho_estimate,
        res_prim=final.res_prim,
        res_dual=final.res_dual,
    )
    result = QPResult(x=final.s[:, :n], y=final.yp[:, n:], z=final.s[:, n:], info=info)
    if settings.polish:
        from sqp_solver_tpu.qp.polish import polish_qp

        result = polish_qp(qp, result, settings)
    return result
