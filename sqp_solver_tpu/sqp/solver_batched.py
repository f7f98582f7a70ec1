"""Batch-explicit fused SQP solver — the production batched NLP path.

Mirrors :mod:`sqp_solver_tpu.qp.admm_batched`: same algorithm as
``sqp_solve`` + ``vmap`` (Algorithm 18.3 with damped BFGS, posdef repair,
l1 merit line search, optional SOC), re-expressed with an explicit batch
axis so that

* the outer iteration counter and line-search trip counter are scalars;
* per-problem convergence/failure are explicit masks;
* the QP subproblem runs through :func:`qp_solve_fused` (fused ADMM
  chunk, warm-started across outer iterations).

The problem's callables are mapped over the batch with ``vmap`` (they are
cheap elementwise work); all solver linear algebra is explicitly batched.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.qp.admm_batched import qp_solve_fused
from sqp_solver_tpu.qp.types import QPState, QuadraticProblem
from sqp_solver_tpu.sqp import common
from sqp_solver_tpu.sqp.types import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)
from sqp_solver_tpu.utils.precision import pin_precision

__all__ = ["sqp_solve_fused"]



def _mv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v, precision=lax.Precision.HIGHEST)


def _vdot(a, b):
    return jnp.sum(a * b, axis=-1)


def _linf(v):
    return jnp.max(jnp.abs(v), axis=-1)


class _Carry(NamedTuple):
    x: jax.Array  # (B, n)
    lam: jax.Array  # (B, m)
    B: jax.Array  # (B, n, n)
    grad_L: jax.Array  # (B, n)
    step_prev: jax.Array  # (B, n)
    qp_state: QPState  # batched
    mu: jax.Array  # (B,)
    ls_failed: jax.Array  # (B,)
    k: jax.Array  # scalar int32
    iter: jax.Array  # (B,)
    done: jax.Array  # (B,)
    failed: jax.Array  # (B,)
    qp_iter: jax.Array  # (B,)
    prim_norm: jax.Array  # (B,)
    dual_norm: jax.Array  # (B,)
    trace: object  # dict of (max_iter, B, ...) ring buffers, or None


@pin_precision
def sqp_solve_fused(
    problem: NonlinearProblem,
    x0: jax.Array,
    lam0: Optional[jax.Array] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve a batch of NLPs: ``x0`` is (B, n); problem data leaves are
    batched (B, ...) or shared (unbatched)."""
    settings.validate()
    if settings.qp.linear_solver != "schur_cholesky":
        raise ValueError("sqp_solve_fused requires qp.linear_solver='schur_cholesky'")
    dtype = x0.dtype
    B, n = x0.shape
    l, u = problem.l, problem.u
    batched_problem = l.ndim == 2
    m = l.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (B, n, n))
    tiny = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    if lam0 is None:
        lam0 = jnp.zeros((B, m), dtype)

    # ---- batched problem callables -----------------------------------------
    params = problem.params

    def per_problem(fn):
        if fn is None:
            return None
        if params is None:
            return fn
        return fn  # called as fn(x, p) below

    f_raw = per_problem(problem.objective)
    c_raw = per_problem(problem.constraint)
    fl_raw = per_problem(problem.objective_linearized)
    cl_raw = per_problem(problem.constraint_linearized)

    has_params = params is not None

    def vmap_over(fn, out_lin=False):
        """vmap a problem callable over the batch."""
        if has_params:
            return jax.vmap(fn, in_axes=(0, 0))
        return jax.vmap(fn, in_axes=(0,))

    def call(fn_v, x):
        return fn_v(x, params) if has_params else fn_v(x)

    f_b = vmap_over(f_raw)
    c_b = vmap_over(c_raw)
    if fl_raw is not None:
        f_lin_b = vmap_over(fl_raw)
    else:
        f_lin_b = vmap_over(
            (lambda x, p: jax.value_and_grad(f_raw)(x, p))
            if has_params
            else jax.value_and_grad(f_raw)
        )
    if cl_raw is not None:
        c_lin_b = vmap_over(cl_raw)
    else:
        jac = jax.jacfwd if settings.jacobian_mode == "fwd" else jax.jacrev
        if has_params:
            c_lin_b = vmap_over(lambda x, p: (c_raw(x, p), jac(c_raw)(x, p)))
        else:
            c_lin_b = vmap_over(lambda x: (c_raw(x), jac(c_raw)(x)))

    def constraint_norm(cv):
        return common.constraint_norm(cv, l, u, tiny)

    def max_violation(cv):
        return common.max_violation(cv, l, u)

    def posdef_repair(Bm):
        bad = jnp.isnan(Bm).any(axis=(-1, -2))
        Bm = jnp.where(bad[:, None, None], eye, Bm)

        def not_posdef(M):
            return jnp.isnan(jnp.linalg.cholesky(M)).any(axis=(-1, -2))

        if settings.schedule == "fixed":
            # static variant: one Cholesky check, reset-to-identity fallback
            # (BFGS keeps B posdef by construction; failures are rare
            # numerics and a reset is the robust recovery — see the
            # ls_failed reset rationale in sqp/solver.py)
            need = not_posdef(Bm)
            return jnp.where(need[:, None, None], eye, Bm)

        def cond(s):
            M, tau, j = s
            return jnp.any(not_posdef(M)) & (j < 40)

        def body(s):
            M, tau, j = s
            need = not_posdef(M)
            M = jnp.where(need[:, None, None], M + tau * eye, M)
            return M, tau * 10.0, j + 1

        Bm, _, _ = lax.while_loop(
            cond, body, (Bm, jnp.asarray(1e-3, dtype), jnp.int32(0))
        )
        return Bm

    def bfgs_update_batched(Bm, s, y):
        eps = jnp.finfo(dtype).eps
        tiny_ = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        Bs = _mv(Bm, s)
        sBs = _vdot(s, Bs)
        sy = _vdot(s, y)
        damped = sy < 0.2 * sBs
        theta = (0.8 * sBs / jnp.maximum(sBs - sy, tiny_))[:, None]
        r = jnp.where(damped[:, None], theta * y + (1.0 - theta) * Bs, y)
        sr = jnp.where(damped, theta[:, 0] * sy + (1.0 - theta[:, 0]) * sBs, sy)
        B_new = (
            Bm
            - Bs[:, :, None] * Bs[:, None, :] / jnp.maximum(sBs, tiny_)[:, None, None]
            + r[:, :, None] * r[:, None, :] / jnp.maximum(sr, tiny_)[:, None, None]
        )
        return jnp.where((sr < eps)[:, None, None], Bm, B_new)

    # Subproblem infeasibility certificates are disabled BY CONSTRUCTION
    # on every SQP tier (a transiently-certified linearized subproblem
    # truncating early would make tiers diverge); `check_infeasibility` is
    # a QP-level feature.
    inner_qp_settings = dataclasses.replace(settings.qp, check_infeasibility=False)

    def solve_subproblem(Bm, grad_obj, J, lqp, uqp, qp_state):
        qp = QuadraticProblem(P=Bm, q=grad_obj, A=J, l=lqp, u=uqp)
        state = qp_state if settings.qp_warm_start else None
        if inner_qp_settings.scaling > 0:
            # per-problem Ruiz equilibration of every subproblem (the inner
            # solve runs scaled; the result is unscaled + rescored against
            # the true subproblem residuals — see qp.scaling)
            from sqp_solver_tpu.qp.scaling import solve_with_scaling

            return solve_with_scaling(
                qp_solve_fused, qp, inner_qp_settings, state
            )
        return qp_solve_fused(qp, inner_qp_settings, state)

    def merit_weight(mu_prev, p, Bm, grad_obj, c_val, lam_qp):
        return common.merit_weight(
            mu_prev,
            _vdot(grad_obj, p),
            _vdot(p, _mv(Bm, p)),
            constraint_norm(c_val),
            lam_qp,
            settings.rho,
            tiny,
        )

    def line_search(x, p, mu, obj, grad_obj, c_val):
        constr_l1 = constraint_norm(c_val)
        gp = _vdot(grad_obj, p)
        phi = obj + mu * constr_l1
        D = gp - mu * constr_l1

        def eval_merit(alpha):
            x_step = x + alpha[:, None] * p
            phi_step = f_b(x_step, params) if has_params else f_b(x_step)
            cv = c_b(x_step, params) if has_params else c_b(x_step)
            return phi_step + mu * constraint_norm(cv)

        return common.line_search_scan(
            eval_merit, (B,), dtype, phi, D, settings.eta, settings.tau,
            settings.line_search_max_iter,
        )

    def body(c: _Carry) -> _Carry:
        k = c.k + 1
        active = (~c.done) & (~c.failed)

        obj, grad_obj = f_lin_b(c.x, params) if has_params else f_lin_b(c.x)
        c_val, J = c_lin_b(c.x, params) if has_params else c_lin_b(c.x)
        grad_L_here = grad_obj + _mv(J.mT, c.lam)

        if settings.termination == "kkt":
            kkt_ok = (_linf(grad_L_here) <= settings.eps_dual) & (
                max_violation(c_val) <= settings.eps_prim
            )
            newly_done = active & kkt_ok
            c = c._replace(done=c.done | newly_done)
            active = active & ~newly_done

        # damped BFGS with reset on iteration 1 / failed line search
        delta_grad_L = grad_L_here - c.grad_L
        tiny_step = _linf(c.step_prev) <= 1e3 * tiny * (1.0 + _linf(c.x))
        reset = (k == 1) | c.ls_failed
        upd = bfgs_update_batched(c.B, c.step_prev, delta_grad_L)
        Bm = jnp.where(
            reset[:, None, None] if reset.ndim else reset,
            eye,
            jnp.where(tiny_step[:, None, None], c.B, upd),
        )
        Bm = posdef_repair(Bm)

        qp_res = solve_subproblem(Bm, grad_obj, J, l - c_val, u - c_val, c.qp_state)
        p, lam_qp = qp_res.x, qp_res.y
        qp_iter = c.qp_iter + jnp.where(active, qp_res.info.iter, 0)

        if settings.second_order_correction:
            x_p = c.x + p
            cv_p = c_b(x_p, params) if has_params else c_b(x_p)
            d = cv_p - _mv(J, p)
            soc = solve_subproblem(Bm, grad_obj, J, l - d, u - d, qp_res.state)
            p, lam_qp = soc.x, soc.y
            qp_iter = qp_iter + jnp.where(active, soc.info.iter, 0)
            qp_state_next = soc.state
        else:
            qp_state_next = qp_res.state

        p_lam = lam_qp - c.lam
        mu = jnp.where(active, merit_weight(c.mu, p, Bm, grad_obj, c_val, lam_qp), c.mu)
        alpha, ls_ok = line_search(c.x, p, mu, obj, grad_obj, c_val)

        x_new = c.x + alpha[:, None] * p
        lam_new = c.lam + alpha[:, None] * p_lam
        step = alpha[:, None] * p
        prim_norm = alpha * _linf(p)
        dual_norm = alpha * _linf(p_lam)

        # ~isfinite, not isnan: an under-budgeted f32 direction can push
        # a lane through inf long before NaN appears (Rosenbrock stress
        # family, ROADMAP r5 fact 5) — freeze the lane at the last finite
        # iterate instead of letting it run to 1e70
        bad = (~jnp.isfinite(x_new)).any(-1) | (~jnp.isfinite(lam_new)).any(-1)
        x_new = jnp.where((active & ~bad)[:, None], x_new, c.x)
        lam_new = jnp.where((active & ~bad)[:, None], lam_new, c.lam)

        if settings.termination == "kkt":
            done = c.done
        else:
            cv_new = c_b(x_new, params) if has_params else c_b(x_new)
            conv = (
                (prim_norm <= settings.eps_prim)
                & (dual_norm <= settings.eps_dual)
                & (max_violation(cv_new) <= settings.eps_prim)
            )
            done = c.done | (active & conv)

        if settings.record_trace:
            ki = k - 1
            tr = dict(
                x=lax.dynamic_update_index_in_dim(c.trace["x"], x_new, ki, 0),
                lam=lax.dynamic_update_index_in_dim(c.trace["lam"], lam_new, ki, 0),
                alpha=lax.dynamic_update_index_in_dim(
                    c.trace["alpha"], jnp.where(active, alpha, 0.0), ki, 0
                ),
                primal_step_norm=lax.dynamic_update_index_in_dim(
                    c.trace["primal_step_norm"], prim_norm, ki, 0
                ),
                dual_step_norm=lax.dynamic_update_index_in_dim(
                    c.trace["dual_step_norm"], dual_norm, ki, 0
                ),
            )
        else:
            tr = c.trace

        if settings.iteration_callback is not None:
            # live per-iteration hook on the batched tier (reference
            # sqp.hpp:23, invoked src/sqp.cpp:89-91), with the whole batch
            # per call
            jax.debug.callback(settings.iteration_callback, x_new, lam_new, k)

        sel = lambda newv, oldv: jnp.where(
            active.reshape((B,) + (1,) * (newv.ndim - 1)), newv, oldv
        )
        return _Carry(
            x=x_new,
            lam=lam_new,
            B=sel(Bm, c.B),
            grad_L=sel(grad_L_here, c.grad_L),
            step_prev=sel(step, c.step_prev),
            qp_state=jax.tree.map(sel, qp_state_next, c.qp_state),
            mu=mu,
            ls_failed=sel(~ls_ok, c.ls_failed),
            k=k,
            iter=jnp.where(active, k, c.iter),
            done=done,
            failed=c.failed | (active & bad),
            qp_iter=qp_iter,
            prim_norm=sel(prim_norm, c.prim_norm),
            dual_norm=sel(dual_norm, c.dual_norm),
            trace=tr,
        )

    def cond(c: _Carry):
        return jnp.any((~c.done) & (~c.failed)) & (c.k < settings.max_iter)

    zero_b = jnp.zeros((B,), dtype)
    if settings.record_trace:
        T = settings.max_iter
        trace0 = dict(
            x=jnp.zeros((T, B, n), dtype),
            lam=jnp.zeros((T, B, m), dtype),
            alpha=jnp.zeros((T, B), dtype),
            primal_step_norm=jnp.zeros((T, B), dtype),
            dual_step_norm=jnp.zeros((T, B), dtype),
        )
    else:
        trace0 = None
    if settings.iteration_callback is not None:
        # reference calls the hook once with the initial state
        # (src/sqp.cpp:68-70)
        jax.debug.callback(
            settings.iteration_callback, x0, lam0, jnp.zeros((), jnp.int32)
        )
    init = _Carry(
        x=x0,
        lam=lam0,
        B=eye,
        grad_L=jnp.zeros((B, n), dtype),
        step_prev=jnp.zeros((B, n), dtype),
        qp_state=QPState(
            x=jnp.zeros((B, n), dtype),
            z=jnp.zeros((B, m), dtype),
            y=jnp.zeros((B, m), dtype),
        ),
        mu=zero_b,
        ls_failed=jnp.zeros((B,), jnp.bool_),
        k=jnp.zeros((), jnp.int32),
        iter=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), jnp.bool_),
        failed=jnp.zeros((B,), jnp.bool_),
        qp_iter=jnp.zeros((B,), jnp.int32),
        prim_norm=zero_b,
        dual_norm=zero_b,
        trace=trace0,
    )
    if settings.schedule == "fixed":
        final = lax.fori_loop(0, settings.max_iter, lambda i, c: body(c), init)
    else:
        final = lax.while_loop(cond, body, init)

    x_out, lam_out = final.x, final.lam
    if settings.polish:
        # shared multi-pass Newton-KKT polish (sqp.common.polish_nlp) with
        # the TRUE Lagrangian Hessian by autodiff (the BFGS estimate caps
        # the Newton step's gain at ~1 digit; measured 6e-4 -> 8e-8 on the
        # benchmark family)
        def f_lin_u(xx):
            return f_lin_b(xx, params) if has_params else f_lin_b(xx)

        def c_lin_u(xx):
            return c_lin_b(xx, params) if has_params else c_lin_b(xx)

        if has_params:
            lagr = lambda xx, ll, pp: f_raw(xx, pp) + jnp.dot(ll, c_raw(xx, pp))
            hess_fn = jax.vmap(jax.hessian(lagr, argnums=0), in_axes=(0, 0, 0))
            hess_raw = lambda xx, ll: hess_fn(xx, ll, params)
        else:
            lagr = lambda xx, ll: f_raw(xx) + jnp.dot(ll, c_raw(xx))
            hess_raw = jax.vmap(jax.hessian(lagr, argnums=0), in_axes=(0, 0))

        def hess_u(xx, ll):
            # fall back to the BFGS estimate where the true Hessian is NaN
            H = hess_raw(xx, ll)
            bad_h = jnp.isnan(H).any(axis=(-1, -2))
            return jnp.where(bad_h[:, None, None], final.B, H)

        x_out, lam_out, kkt_rescued = common.polish_nlp(
            x_out, lam_out, l, u, f_lin_u, c_lin_u, hess_u, settings
        )
    else:
        kkt_rescued = jnp.zeros((B,), jnp.bool_)

    status = jnp.where(
        final.failed,
        SQPStatus.NUMERICAL_ISSUES,
        jnp.where(
            final.done | kkt_rescued, SQPStatus.SOLVED, SQPStatus.MAX_ITER_EXCEEDED
        ),
    ).astype(jnp.int32)
    info = SQPInfo(
        status=status,
        iter=final.iter,
        qp_solver_iter=final.qp_iter,
        primal_step_norm=final.prim_norm,
        dual_step_norm=final.dual_norm,
    )
    return SQPResult(x=x_out, lam=lam_out, info=info, trace=final.trace)
