"""Per-problem SQP solver — Algorithm 18.3 (Nocedal & Wright).

Functional re-design of the reference outer loop (C12-C16,
``src/sqp.cpp:27-343``): one jitted ``lax.while_loop`` per solve —
linearize (autodiff) → damped BFGS → positive-definiteness repair → ADMM QP
subproblem → optional second-order correction → l1 exact-penalty merit line
search → step + termination.  vmap over batched ``params``/``x0`` runs
thousands of NLP instances in lockstep with per-problem convergence masks.

Deliberate upgrades over the reference (documented quirks):
  * the inner QP warm-starts from the previous outer iteration
    (reference cold-starts every subproblem — quirk Q4, ``src/sqp.cpp:221``);
  * linearization is always autodiff (``jax.value_and_grad`` /
    ``jax.jacfwd``/``jacrev``) unless closed forms are supplied;
  * NaN-poisoned problems get status NUMERICAL_ISSUES and frozen iterates
    instead of crashing the batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.qp.admm import qp_solve
from sqp_solver_tpu.qp.types import QPState, QuadraticProblem
from sqp_solver_tpu.sqp import common
from sqp_solver_tpu.sqp.bfgs import bfgs_update
from sqp_solver_tpu.utils.precision import hdot
from sqp_solver_tpu.sqp.types import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)
from sqp_solver_tpu.utils.precision import pin_precision

__all__ = ["sqp_solve"]



def _linf(v):
    return jnp.max(jnp.abs(v))


def _bind(fn, params):
    """Problem callables take (x) or (x, params) — normalize to f(x)."""
    if fn is None:
        return None
    if params is None:
        return fn
    return lambda x: fn(x, params)


class _Carry(NamedTuple):
    x: jax.Array
    lam: jax.Array
    B: jax.Array  # Lagrangian Hessian approximation
    grad_L: jax.Array
    step_prev: jax.Array
    qp_state: QPState
    mu: jax.Array  # l1 merit penalty weight (monotone non-decreasing)
    ls_failed: jax.Array  # bool: previous line search found no acceptable step
    iter: jax.Array  # int32
    done: jax.Array  # bool
    failed: jax.Array  # bool
    qp_iter: jax.Array  # int32 accumulated inner-QP iterations
    prim_norm: jax.Array
    dual_norm: jax.Array


@pin_precision
def sqp_solve(
    problem: NonlinearProblem,
    x0: jax.Array,
    lam0: Optional[jax.Array] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve ``min f(x)  s.t.  l <= c(x) <= u`` from initial point ``x0``.

    Pure/traceable: jit it, vmap it over batched ``x0``/``problem.params``,
    or shard the batch axis with shard_map.
    """
    settings.validate()
    dtype = x0.dtype
    n = x0.shape[-1]
    m = problem.num_constr
    l, u = problem.l, problem.u
    eye = jnp.eye(n, dtype=dtype)
    tiny = jnp.asarray(jnp.finfo(dtype).eps, dtype)  # DIV_BY_ZERO_REGUL

    if lam0 is None:
        lam0 = jnp.zeros((m,), dtype)

    f = _bind(problem.objective, problem.params)
    c = _bind(problem.constraint, problem.params)
    f_lin = _bind(problem.objective_linearized, problem.params)
    c_lin = _bind(problem.constraint_linearized, problem.params)

    if f_lin is None:
        f_lin = jax.value_and_grad(f)
    if c_lin is None:
        jac = jax.jacfwd if settings.jacobian_mode == "fwd" else jax.jacrev

        def c_lin(x):
            return c(x), jac(c)(x)

    def constraint_norm(cv):
        return common.constraint_norm(cv, l, u, tiny)

    def max_violation(cv):
        return common.max_violation(cv, l, u)

    def posdef_repair(B):
        """Escalating diagonal shift until Cholesky succeeds
        (reference src/sqp.cpp:172-181: tau = 1e-3, x10 each try)."""
        B = jnp.where(jnp.any(jnp.isnan(B)), eye, B)

        def not_posdef(Bm):
            return jnp.any(jnp.isnan(jnp.linalg.cholesky(Bm)))

        def cond(s):
            Bc, tau, k = s
            return not_posdef(Bc) & (k < 40)

        def body(s):
            Bc, tau, k = s
            return Bc + tau * eye, tau * 10.0, k + 1

        B, _, _ = lax.while_loop(cond, body, (B, jnp.asarray(1e-3, dtype), jnp.int32(0)))
        return B

    # subproblem certificates off on every SQP tier (see solver_batched)
    inner_qp_settings = dataclasses.replace(settings.qp, check_infeasibility=False)

    def solve_subproblem(B, grad_obj, J, lqp, uqp, qp_state):
        qp = QuadraticProblem(P=B, q=grad_obj, A=J, l=lqp, u=uqp)
        state = qp_state if settings.qp_warm_start else None
        res = qp_solve(qp, inner_qp_settings, state)
        return res

    def merit_weight(mu_prev, p, B, grad_obj, c_val, lam_qp):
        return common.merit_weight(
            mu_prev,
            hdot(grad_obj, p),
            hdot(p, hdot(B, p)),
            constraint_norm(c_val),
            lam_qp,
            settings.rho,
            tiny,
        )

    def line_search(x, p, mu, obj, grad_obj, c_val):
        constr_l1 = constraint_norm(c_val)
        gp = hdot(grad_obj, p)
        phi = obj + mu * constr_l1
        D = gp - mu * constr_l1

        def eval_merit(alpha):
            x_step = x + alpha * p
            return f(x_step) + mu * constraint_norm(c(x_step))

        return common.line_search_while(
            eval_merit, dtype, phi, D, settings.eta, settings.tau,
            settings.line_search_max_iter,
        )

    def body(carry: _Carry) -> _Carry:
        it = carry.iter + 1

        # --- linearize at current iterate (autodiff; reference src/sqp.cpp:158-159)
        obj, grad_obj = f_lin(carry.x)
        c_val, J = c_lin(carry.x)
        grad_L_here = grad_obj + hdot(J.T, carry.lam)

        if settings.termination == "kkt":
            # Stationarity + feasibility at the *current* iterate, checked
            # before spending a QP solve on it.
            kkt_done = (_linf(grad_L_here) <= settings.eps_dual) & (
                max_violation(c_val) <= settings.eps_prim
            )
            return lax.cond(
                kkt_done,
                lambda: carry._replace(done=jnp.ones((), jnp.bool_)),
                lambda: _step(carry, it, obj, grad_obj, c_val, J, grad_L_here),
            )
        return _step(carry, it, obj, grad_obj, c_val, J, grad_L_here)

    def _step(carry: _Carry, it, obj, grad_obj, c_val, J, grad_L) -> _Carry:
        # --- damped BFGS on the Lagrangian gradient change
        # (reference src/sqp.cpp:161-170)
        delta_grad_L = grad_L - carry.grad_L
        # Skip the update for negligible steps: near convergence s and y are
        # rounding noise and repeated rank-2 updates corrupt B (the failure
        # mode behind the reference's suspended issue #13).
        tiny_step = _linf(carry.step_prev) <= 1e3 * tiny * (1.0 + _linf(carry.x))
        # Reset to identity on iteration 1 (reference src/sqp.cpp:165-167) or
        # after a fully failed line search (curvature information is then
        # unreliable; fresh start beats wandering with a corrupted B).
        reset = (it == 1) | carry.ls_failed
        B = lax.cond(
            reset,
            lambda: eye,
            lambda: lax.cond(
                tiny_step,
                lambda: carry.B,
                lambda: bfgs_update(carry.B, carry.step_prev, delta_grad_L),
            ),
        )
        B = posdef_repair(B)

        # --- QP subproblem: bounds shifted by the constraint value
        # (reference src/sqp.cpp:189-199)
        qp_res = solve_subproblem(B, grad_obj, J, l - c_val, u - c_val, carry.qp_state)
        p, lam_qp = qp_res.x, qp_res.y
        qp_iter = carry.qp_iter + qp_res.info.iter

        if settings.second_order_correction:
            # Re-solve with bounds corrected by the constraint curvature at
            # x + p (Maratos fix; unconditional when enabled, matching the
            # reference's disabled trigger heuristic — quirk Q6,
            # src/sqp.cpp:244-276).
            d = c(carry.x + p) - hdot(J, p)
            soc_res = solve_subproblem(B, grad_obj, J, l - d, u - d, qp_res.state)
            p, lam_qp = soc_res.x, soc_res.y
            qp_iter = qp_iter + soc_res.info.iter
            qp_state_next = soc_res.state
        else:
            qp_state_next = qp_res.state

        p_lam = lam_qp - carry.lam

        # --- merit line search + step (reference src/sqp.cpp:78-87)
        mu = merit_weight(carry.mu, p, B, grad_obj, c_val, lam_qp)
        alpha, ls_ok = line_search(carry.x, p, mu, obj, grad_obj, c_val)
        x_new = carry.x + alpha * p
        lam_new = carry.lam + alpha * p_lam
        step = alpha * p
        prim_norm = alpha * _linf(p)
        dual_norm = alpha * _linf(p_lam)

        # ~isfinite, not isnan: freeze inf-bound runs too (ROADMAP r5 f5)
        failed = jnp.any(~jnp.isfinite(x_new)) | jnp.any(~jnp.isfinite(lam_new))
        x_new = jnp.where(failed, carry.x, x_new)
        lam_new = jnp.where(failed, carry.lam, lam_new)

        if settings.termination == "kkt":
            # convergence is decided by the pre-step KKT check next iteration
            done = jnp.zeros((), jnp.bool_)
        else:
            # --- termination: step norms + constraint violation
            # (reference src/sqp.cpp:125-131)
            done = (
                (prim_norm <= settings.eps_prim)
                & (dual_norm <= settings.eps_dual)
                & (max_violation(c(x_new)) <= settings.eps_prim)
            )

        if settings.iteration_callback is not None:
            jax.debug.callback(settings.iteration_callback, x_new, lam_new, it)

        return _Carry(
            x=x_new,
            lam=lam_new,
            B=B,
            grad_L=grad_L,
            step_prev=step,
            qp_state=qp_state_next,
            mu=mu,
            ls_failed=~ls_ok,
            iter=it,
            done=done,
            failed=failed,
            qp_iter=qp_iter,
            prim_norm=prim_norm,
            dual_norm=dual_norm,
        )

    def cond(carry: _Carry):
        return (~carry.done) & (~carry.failed) & (carry.iter < settings.max_iter)

    if settings.iteration_callback is not None:
        jax.debug.callback(settings.iteration_callback, x0, lam0, jnp.int32(0))

    zero = jnp.zeros((), dtype)
    init = _Carry(
        x=x0,
        lam=lam0,
        B=eye,
        grad_L=jnp.zeros((n,), dtype),
        step_prev=jnp.zeros((n,), dtype),
        qp_state=QPState.zeros(n, m, dtype),
        mu=zero,
        ls_failed=jnp.zeros((), jnp.bool_),
        iter=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), jnp.bool_),
        failed=jnp.zeros((), jnp.bool_),
        qp_iter=jnp.zeros((), jnp.int32),
        prim_norm=zero,
        dual_norm=zero,
    )
    final = lax.while_loop(cond, body, init)

    x_out, lam_out = final.x, final.lam
    if settings.polish:
        # shared multi-pass Newton-KKT polish (sqp.common.polish_nlp):
        # honors polish_passes and refreshes the status from the FINAL
        # point's KKT error, exactly like the batched tiers (round-2
        # review found this tier silently single-pass — a user migrating
        # tiers got different rescue behavior)
        def hess_fn(xx, ll):
            H = jax.hessian(lambda v: f(v) + jnp.dot(ll, c(v)))(xx)
            return jnp.where(jnp.isnan(H).any(), final.B, H)

        x_out, lam_out, kkt_rescued = common.polish_nlp(
            x_out, lam_out, l, u, f_lin, c_lin, hess_fn, settings
        )
    else:
        kkt_rescued = jnp.zeros((), jnp.bool_)

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
    return SQPResult(x=x_out, lam=lam_out, info=info)
