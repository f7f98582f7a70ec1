"""Per-problem ADMM QP solver (OSQP algorithm).

Functional re-design of the reference solver core (C4/C7/C9,
``src/qp.cpp:11-157``): the whole solve is one traced program —
``qp_solve(qp, settings, state) -> QPResult`` — built from
``lax.while_loop`` so it jits, vmaps over problem batches, and shards with
``shard_map``.

Loop structure (the traced form of the reference's factorization
economy, ``src/qp.cpp:136-142``: factorize at setup + only on rho updates):

    while not done:                        # rho epochs (outer while_loop)
        factor KKT (only if rho changed)   # lax.cond-gated
        while not done and epoch < adaptive_rho_interval:   # inner while_loop
            run `check_termination` ADMM iterations         # lax.fori_loop
            update residuals, check termination
        estimate rho, decide re-factorization

Each ADMM iteration is two matvecs + the cached-factor solve + elementwise
updates with over-relaxation and box projection — exactly the reference's
iterate math (``src/qp.cpp:84-103, 273-281``) with the simplification
``z_tilde = A @ x_tilde`` (exact-arithmetic identity of the KKT second row),
which removes the dual back-substitution entirely.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.ops.linear_solver import (
    get_linear_solver,
    _mv as _opmv,
    _rmv as _oprmv,
)
from sqp_solver_tpu.qp.classify import (
    RHO_MAX,
    RHO_MIN,
    constr_type_init,
    rho_vec_from_type,
)
from sqp_solver_tpu.utils.precision import hdot
from sqp_solver_tpu.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)
from sqp_solver_tpu.utils.precision import pin_precision

__all__ = ["qp_solve"]



def _linf(v):
    return jnp.max(jnp.abs(v)) if v.size else jnp.zeros((), v.dtype)


class _Carry(NamedTuple):
    x: jax.Array
    z: jax.Array
    y: jax.Array
    rho: jax.Array  # scalar rho
    rho_vec: jax.Array
    factor: dict
    need_refactor: jax.Array  # bool
    iter: jax.Array  # int32, iterations executed
    done: jax.Array  # bool, converged
    failed: jax.Array  # bool, numerical issues
    res_prim: jax.Array
    res_dual: jax.Array
    max_Ax_z: jax.Array
    max_Px_ATy_q: jax.Array
    rho_estimate: jax.Array
    rho_updates: jax.Array  # int32
    infeas: jax.Array  # int32: 0 none, 1 primal certificate, 2 dual
    aa: object  # Anderson-acceleration state dict, or None (static shape)


@pin_precision
def qp_solve(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state: Optional[QPState] = None,
) -> QPResult:
    """Solve ``min 0.5 x'Px + q'x  s.t.  l <= Ax <= u``.

    Pure and traceable: wrap in ``jax.jit`` (settings are static), ``vmap``
    over a batched :class:`QuadraticProblem` to solve many instances in
    lockstep, or call inside other traced code (the SQP loop does).

    ``state`` warm-starts the iterates (functional version of the
    reference's ``warm_start``; see QPState docs).
    """
    settings.validate()
    # BlockSparse P/A (ops/block_sparse.py): the arbitrary-unstructured-
    # sparsity path — the whole loop below is matvec-polymorphic, and the
    # 'cg' backend is matrix-free, so sparse problems reuse it verbatim.
    sparse = hasattr(qp.P, "mv") or hasattr(qp.A, "mv")
    if sparse:
        if settings.linear_solver != "cg":
            raise ValueError(
                "BlockSparse problems require linear_solver='cg' (the "
                "matrix-free backend); factorizing backends need dense "
                f"operands, got {settings.linear_solver!r}"
            )
        for gate, name in (
            (settings.scaling > 0, "scaling"),
            (settings.polish, "polish"),
        ):
            if gate:
                raise ValueError(
                    f"BlockSparse problems do not support settings.{name} "
                    "yet (dense-operand epilogue)"
                )
    if settings.scaling > 0:
        from sqp_solver_tpu.qp.scaling import solve_with_scaling

        return solve_with_scaling(qp_solve, qp, settings, state)
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    dtype = q.dtype
    n, m = qp.n, qp.m

    solver = get_linear_solver(
        settings.linear_solver, settings.block_size, settings.arrow_width
    )
    sigma = jnp.asarray(settings.sigma, dtype)
    alpha = jnp.asarray(settings.alpha, dtype)
    eps_abs = jnp.asarray(settings.eps_abs, dtype)
    eps_rel = jnp.asarray(settings.eps_rel, dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).eps, dtype)  # DIV_BY_ZERO_REGUL

    ctype = constr_type_init(l, u)
    rho_vec0 = rho_vec_from_type(ctype, settings.rho, dtype)

    if state is None:
        state = QPState.zeros(n, m, dtype)

    # Static schedule: inner chunk length and rho-epoch length.  The epoch
    # length is rounded UP to a multiple of the chunk length (matching
    # admm_batched): iterations advance in steps of `seg`, so a non-multiple
    # interval would only hit `iter % interval == 0` at the LCM and delay
    # (or skip) rho adaptation.
    interval = settings.adaptive_rho_interval if settings.adaptive_rho else settings.max_iter
    check = settings.check_termination
    seg = check if check > 0 else min(interval, settings.max_iter)
    interval = -(-interval // seg) * seg

    def admm_chunk(factor, rho_vec, x, z, y):
        rho_inv = 1.0 / rho_vec

        def one_iter(_, xzy):
            x, z, y = xzy
            rhs1 = sigma * x - q
            rhs2 = z - rho_inv * y
            x_t, z_t = solver.solve_xz(
                factor, P, A, sigma, rho_vec, rhs1, rhs2, settings.refine_steps
            )
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_pre = alpha * z_t + (1.0 - alpha) * z
            z_n = jnp.clip(z_pre + rho_inv * y, l, u)  # box projection
            y_n = y + rho_vec * (z_pre - z_n)
            return x_n, z_n, y_n

        return lax.fori_loop(0, seg, one_iter, (x, z, y))

    def update_state(x, z, y):
        """Residuals + norm caches (reference src/qp.cpp:317-331)."""
        Ax = _opmv(A, x)
        Px = _opmv(P, x)
        ATy = _oprmv(A, y)
        max_Ax_z = jnp.maximum(_linf(Ax), _linf(z))
        max_Px_ATy_q = jnp.maximum(_linf(Px), jnp.maximum(_linf(ATy), _linf(q)))
        res_prim = _linf(Ax - z)
        res_dual = _linf(Px + q + ATy)
        return res_prim, res_dual, max_Ax_z, max_Px_ATy_q

    def inner_cond(c: _Carry):
        epoch_end = (c.iter % interval) == 0
        return (
            (~c.done)
            & (~c.failed)
            & (c.infeas == 0)
            & (c.iter < settings.max_iter)
            & (~epoch_end)
        )

    use_aa = settings.acceleration == "anderson"
    m_aa = settings.anderson_memory

    def _combined_res(rp, rd, mz, mq):
        return rp / (mz + tiny) + rd / (mq + tiny)

    def _anderson_step(c, x, z, y):
        """Safeguarded type-II Anderson acceleration of the chunk map.

        The `seg`-iteration ADMM chunk T is a fixed-point map for the
        iterate u = (x, z, y); AA extrapolates through the last
        ``anderson_memory`` chunk outputs (difference-based buffers, so
        bookkeeping stays consistent whether the mixed or the plain point
        was taken).  SAFEGUARD: the extrapolated candidate is accepted
        only if its TRUE combined residual beats the plain chunk output
        (and z is re-projected onto [l, u] to keep the box invariant), so
        the iteration can never be made worse — the standard globalization
        for AA-accelerated ADMM (see PAPERS.md: GMRES-accelerated ADMM;
        AA-II is its nonlinear generalization).  Buffers reset on rho
        re-factorization (the map changes).
        """
        from sqp_solver_tpu.qp.anderson import anderson_extrapolate

        u_in = jnp.concatenate([c.x, c.z, c.y])
        u_T = jnp.concatenate([x, z, y])
        u_aa, pairs, aa_new = anderson_extrapolate(c.aa, u_in, u_T, m_aa)
        x_a = u_aa[:n]
        z_a = jnp.clip(u_aa[n : n + m], l, u)
        y_a = u_aa[n + m :]

        rp_p, rd_p, mz_p, mq_p = update_state(x, z, y)
        rp_a, rd_a, mz_a, mq_a = update_state(x_a, z_a, y_a)
        comb_a = _combined_res(rp_a, rd_a, mz_a, mq_a)
        # termination-aligned safeguard: besides improving the combined
        # residual, the candidate must pass the termination test whenever
        # the plain iterate does — otherwise AA could trade a small dual
        # overshoot for a big primal gain and un-converge a converged
        # chunk, costing an extra `seg` iterations
        term = lambda rp, rd, mz, mq: (rp <= eps_abs + eps_rel * mz) & (
            rd <= eps_abs + eps_rel * mq
        )
        accept = (
            (pairs > 0)
            & jnp.isfinite(comb_a)
            & (comb_a < _combined_res(rp_p, rd_p, mz_p, mq_p))
            & (term(rp_a, rd_a, mz_a, mq_a) | ~term(rp_p, rd_p, mz_p, mq_p))
        )
        sel = lambda a, p: jnp.where(accept, a, p)
        stats = (
            sel(rp_a, rp_p), sel(rd_a, rd_p), sel(mz_a, mz_p), sel(mq_a, mq_p)
        )
        return sel(x_a, x), sel(z_a, z), sel(y_a, y), stats, aa_new

    def inner_body(c: _Carry):
        x, z, y = admm_chunk(c.factor, c.rho_vec, c.x, c.z, c.y)
        stats_pre = None
        if use_aa:
            x, z, y, stats_pre, aa_new = _anderson_step(c, x, z, y)
            c = c._replace(aa=aa_new)
        it = c.iter + seg
        if check > 0 and settings.check_infeasibility:
            # OSQP §3.4: iterate deltas between termination checks are the
            # certificate candidates (see qp.infeasibility)
            from sqp_solver_tpu.qp.infeasibility import infeasibility_certificates

            prim_inf, dual_inf = infeasibility_certificates(
                P, A, q, l, u, x - c.x, y - c.y,
                settings.eps_pinf, settings.eps_dinf,
            )
            c = c._replace(
                infeas=jnp.where(
                    c.infeas > 0,
                    c.infeas,
                    jnp.where(prim_inf, 1, jnp.where(dual_inf, 2, 0)).astype(
                        jnp.int32
                    ),
                )
            )
        if check > 0:
            if stats_pre is not None:
                res_prim, res_dual, max_Ax_z, max_Px_ATy_q = stats_pre
            else:
                res_prim, res_dual, max_Ax_z, max_Px_ATy_q = update_state(x, z, y)
            done = (res_prim <= eps_abs + eps_rel * max_Ax_z) & (
                res_dual <= eps_abs + eps_rel * max_Px_ATy_q
            )
            if settings.check_comp_slack:
                # y supported on interior rows = not a fixed point (see
                # QPSettings.check_comp_slack); z is the PROJECTED
                # iterate, so "at bound" is exact up to the row scale
                # z is the PROJECTED iterate: clamped rows sit EXACTLY at the
                # bound, so the at-bound test can be razor thin (a loose
                # eps_abs-wide band hides the violation in scaled space
                # — measured)
                btol = 64.0 * jnp.finfo(z.dtype).eps
                at_l = z <= l + btol * (1.0 + jnp.abs(l))
                at_u = z >= u - btol * (1.0 + jnp.abs(u))
                dsv = jnp.max(
                    jnp.where(~at_u, jnp.maximum(y, 0.0), 0.0)
                    + jnp.where(~at_l, jnp.maximum(-y, 0.0), 0.0)
                )
                done = done & (dsv <= eps_abs + eps_rel * _linf(y))
            if settings.verbose:
                obj = 0.5 * hdot(x, _opmv(P, x)) + hdot(q, x)
                jax.debug.print(
                    "{it:4d}  {obj:.2e}  {rp:.2e}  {rd:.2e}",
                    it=it,
                    obj=obj,
                    rp=res_prim,
                    rd=res_dual,
                )
            c = c._replace(
                res_prim=res_prim,
                res_dual=res_dual,
                max_Ax_z=max_Ax_z,
                max_Px_ATy_q=max_Px_ATy_q,
                done=done,
            )
        return c._replace(x=x, z=z, y=y, iter=it)

    def outer_cond(c: _Carry):
        return (
            (~c.done) & (~c.failed) & (c.infeas == 0) & (c.iter < settings.max_iter)
        )

    def outer_body(c: _Carry):
        factor = lax.cond(
            c.need_refactor,
            lambda: solver.factor(P, A, sigma, c.rho_vec),
            lambda: c.factor,
        )
        failed = c.failed | (c.need_refactor & solver.is_failure(factor))
        c = c._replace(factor=factor, failed=failed, need_refactor=jnp.zeros((), jnp.bool_))

        # One rho epoch: run inner chunks until done/interval/max_iter.
        # First step unconditionally (iter % interval == 0 at epoch start).
        c = lax.cond(c.failed, lambda c: c, lambda c: inner_body(c), c)
        c = lax.while_loop(inner_cond, inner_body, c)

        if settings.adaptive_rho:
            if check == 0:
                res_prim, res_dual, max_Ax_z, max_Px_ATy_q = update_state(c.x, c.z, c.y)
                c = c._replace(
                    res_prim=res_prim,
                    res_dual=res_dual,
                    max_Ax_z=max_Ax_z,
                    max_Px_ATy_q=max_Px_ATy_q,
                )
            # rho_new = rho * sqrt(normalized primal / dual residual)
            # (reference src/qp.cpp:334-341), clamped to [RHO_MIN, RHO_MAX].
            rp = c.res_prim / (c.max_Ax_z + tiny)
            rd = c.res_dual / (c.max_Px_ATy_q + tiny)
            new_rho = c.rho * jnp.sqrt(rp / (rd + tiny))
            new_rho = jnp.clip(new_rho, RHO_MIN, RHO_MAX)
            tol = settings.adaptive_rho_tolerance
            changed = (new_rho < c.rho / tol) | (new_rho > c.rho * tol)
            do_update = (
                changed
                & (~c.done)
                & (~c.failed)
                & (c.infeas == 0)
                & (c.iter < settings.max_iter)
            )
            rho = jnp.where(do_update, new_rho, c.rho)
            rho_vec = jnp.where(do_update, rho_vec_from_type(ctype, new_rho, dtype), c.rho_vec)
            c = c._replace(
                rho=rho,
                rho_vec=rho_vec,
                need_refactor=do_update,
                rho_estimate=new_rho,
                rho_updates=c.rho_updates + do_update.astype(jnp.int32),
            )
            if use_aa:
                # the chunk map changes with rho: stale AA pairs would
                # extrapolate through a different fixed point
                c = c._replace(
                    aa=dict(
                        c.aa,
                        prev_ok=c.aa["prev_ok"] & ~do_update,
                        pairs=jnp.where(do_update, 0, c.aa["pairs"]),
                    )
                )
        return c

    # Setup factorization (reference src/qp.cpp:37-43) — the one-time
    # expensive step; the loop re-factorizes only on rho updates.
    factor0 = solver.factor(P, A, sigma, rho_vec0)
    zero = jnp.zeros((), dtype)
    init = _Carry(
        x=state.x,
        z=state.z,
        y=state.y,
        rho=jnp.asarray(settings.rho, dtype),
        rho_vec=rho_vec0,
        factor=factor0,
        need_refactor=jnp.zeros((), jnp.bool_),
        iter=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), jnp.bool_),
        failed=solver.is_failure(factor0),
        res_prim=zero,
        res_dual=zero,
        max_Ax_z=zero,
        max_Px_ATy_q=zero,
        # before any adaptive evaluation the best estimate IS the current
        # rho (all tiers agree on this convention; the kernel's adoption
        # slot requires it)
        rho_estimate=jnp.asarray(settings.rho, dtype),
        # the reference counts the setup rho_vec_update too
        # (src/qp.cpp:34 -> info.rho_updates++), so it reports >= 1
        rho_updates=jnp.ones((), jnp.int32),
        infeas=jnp.zeros((), jnp.int32),
        aa=None,
    )
    if use_aa:
        from sqp_solver_tpu.qp.anderson import anderson_init

        init = init._replace(aa=anderson_init((), m_aa, n + 2 * m, dtype))

    final = lax.while_loop(outer_cond, outer_body, init)

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
        # iterations run in chunks of `seg`, so the executed count can
        # overshoot max_iter by up to seg-1; report the reference's cap
        iter=jnp.minimum(final.iter, settings.max_iter),
        rho_updates=final.rho_updates,
        rho_estimate=final.rho_estimate,
        res_prim=final.res_prim,
        res_dual=final.res_dual,
    )
    result = QPResult(x=final.x, y=final.y, z=final.z, info=info)
    if settings.polish:
        from sqp_solver_tpu.qp.polish import polish_qp

        result = polish_qp(qp, result, settings)
    return result
