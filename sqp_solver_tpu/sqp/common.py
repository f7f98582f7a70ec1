"""Shared SQP algorithm blocks — ONE text per block, consumed by both
tiers (``sqp/solver.py`` per-problem, ``sqp/solver_batched.py`` fused).

Keeping the merit weight, line search and polish epilogue as one text
each prevents the tiers from drifting apart.  Everything here is
shape-agnostic: arrays carry an optional leading batch axis, reductions
run over ``axis=-1``, and callables are supplied by the tier in whatever
layout it maintains.

Reference provenance: merit weight + line search are the l1 exact-penalty
scheme of ``src/sqp.cpp:277-308`` (C15) with the penalty lower-bounded by
the N&W Thm-17.3 exactness estimate; the polish epilogue has no reference
analog (it is the OSQP-paper polish, upgraded to a multi-pass active-set
refinement with the true Lagrangian Hessian).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "constraint_norm",
    "max_violation",
    "merit_weight",
    "line_search_scan",
    "line_search_while",
    "polish_nlp",
    "replay_trace",
]


def replay_trace(result, callback):
    """Offline replay of a recorded solve through the reference's
    per-iteration callback signature (``sqp.hpp:23``): calls
    ``callback(x_k, lam_k, k)`` for each recorded outer iteration
    ``k = 1..max(iter)``, with the whole batch per call.

    Solve with ``settings.record_trace=True``, then replay
    ``result.trace`` here; ``settings.iteration_callback`` fires the same
    hook live on every tier instead.
    """
    import numpy as np

    if result.trace is None:
        raise ValueError(
            "result has no trace — solve with settings.record_trace=True"
        )
    xs = np.asarray(result.trace["x"])
    lams = np.asarray(result.trace["lam"])
    last = int(np.max(np.asarray(result.info.iter)))
    for k in range(last):
        callback(xs[k], lams[k], k + 1)


def _linf(v):
    return jnp.max(jnp.abs(v), axis=-1)


def constraint_norm(cv, l, u, tiny):
    """l1 violation of l <= c <= u (reference src/sqp.cpp:311-319)."""
    return (
        tiny
        + jnp.sum(jnp.maximum(l - cv, 0.0), axis=-1)
        + jnp.sum(jnp.maximum(cv - u, 0.0), axis=-1)
    )


def max_violation(cv, l, u):
    """linf violation (reference src/sqp.cpp:330-343)."""
    return jnp.maximum(
        0.0, jnp.maximum(jnp.max(l - cv, axis=-1), jnp.max(cv - u, axis=-1))
    )


def merit_weight(mu_prev, gp, pBp, constr_l1, lam_qp, rho, tiny):
    """l1 penalty weight.  Three lower bounds, kept monotone:

    * the reference's merit-model formula (src/sqp.cpp:287), used only
      when the violation is numerically meaningful — with constr_l1 at
      machine eps it degenerates to +/-1e16 garbage;
    * the exactness bound mu > ||lambda*||_inf (N&W Thm 17.3), estimated
      from the QP multipliers — this is what stops the merit function
      from accepting large infeasible steps at feasible iterates;
    * the previous weight (monotone non-decreasing, standard practice).

    ``gp`` = grad_f . p, ``pBp`` = p . (B p) — supplied by the tier in its
    own layout so no matrix work happens here.
    """
    meaningful = constr_l1 > 1e4 * tiny
    raw = (gp + 0.5 * pBp) / ((1.0 - rho) * constr_l1)
    model_mu = jnp.where(meaningful, jnp.maximum(raw, 0.0), 0.0)
    dual_mu = 1.5 * _linf(lam_qp)
    return jnp.maximum(mu_prev, jnp.maximum(model_mu, dual_mu))


def line_search_scan(eval_merit, batch_shape, dtype, phi, D, eta, tau, max_iter):
    """Backtracking on the l1 exact-penalty merit function
    (reference src/sqp.cpp:277-308) as a fixed-trip scan — the batched
    tiers' form (a while_loop would add a host-synced condition per trip).
    Same semantics as the reference's backtracking for-loop
    (src/sqp.cpp:294-306: at most max_iter-1 evaluations).

    ``eval_merit(alpha)`` returns the merit value phi(x + alpha p) with
    alpha shaped ``batch_shape``.  Returns (alpha, accepted): ``accepted``
    False means no step passed Armijo — the caller resets the Hessian
    (curvature information is then unreliable; a fresh start beats
    wandering with a corrupted B).
    """

    def body(carry, _):
        alpha, accepted = carry
        phi_step = eval_merit(alpha)
        ok = phi_step <= phi + alpha * eta * D
        accepted = accepted | ok
        alpha = jnp.where(accepted, alpha, tau * alpha)
        return (alpha, accepted), None

    (alpha, accepted), _ = lax.scan(
        body,
        (jnp.ones(batch_shape, dtype), jnp.zeros(batch_shape, jnp.bool_)),
        None,
        length=max_iter - 1,
        unroll=4,
    )
    return alpha, accepted


def line_search_while(eval_merit, dtype, phi, D, eta, tau, max_iter):
    """Scalar (per-problem tier) variant of the same backtracking scheme,
    with early exit via while_loop (free on the per-problem tier where the
    whole solve is one dynamic loop anyway)."""

    def cond(s):
        alpha, i, accepted = s
        return (~accepted) & (i < max_iter)

    def body(s):
        alpha, i, accepted = s
        phi_step = eval_merit(alpha)
        accepted = phi_step <= phi + alpha * eta * D
        alpha = jnp.where(accepted, alpha, tau * alpha)
        return alpha, i + 1, accepted

    alpha, _, accepted = lax.while_loop(
        cond, body, (jnp.ones((), dtype), jnp.int32(1), jnp.zeros((), jnp.bool_))
    )
    return alpha, accepted


def polish_nlp(
    x_out,
    lam_out,
    l,
    u,
    f_lin,
    c_lin,
    hess_fn,
    settings,
):
    """SQP polish epilogue: ``polish_passes`` Newton-KKT steps on the
    guessed active set with the TRUE Lagrangian Hessian.

    Each pass linearizes at the current point, guesses the active set from
    the multiplier signs (equality rows always active), solves the masked
    equality KKT via the Schur-preconditioned ideal-refined solve
    (:func:`sqp_solver_tpu.qp.polish.kkt_solve_schur_refined`: one batched
    matmul + Cholesky + refinement sweeps), and accepts PER PROBLEM
    where the true re-linearized KKT error improves.  Repeated passes
    re-guess the active set from the polished multipliers — a mini
    active-set iteration that rescues instances whose first guess was
    wrong (degenerate sets).  The exact Hessian gives the full quadratic
    correction where the BFGS estimate caps the Newton step's gain at ~1
    digit (measured 6e-4 -> 8e-8 on the benchmark family).

    Shape-agnostic: works on a single problem ((n,), (m,)) or a leading
    batch.  Tier adapters:
      * ``f_lin(x) -> (obj, grad)``
      * ``c_lin(x) -> (c, J)`` with J batch-first (..., m, n)
      * ``hess_fn(x, lam) -> (..., n, n)`` true Lagrangian Hessian WITH
        any NaN fallback already applied by the tier

    Returns ``(x, lam, kkt_rescued)``; ``kkt_rescued`` flags problems
    whose FINAL point meets the KKT tolerances — a straggler whose
    polished point is optimal is SOLVED even though the loop phase ran
    out of iterations.
    """
    from sqp_solver_tpu.qp.polish import guess_active_set, kkt_solve_schur_refined

    def _mv(M, v):
        return jnp.einsum("...ij,...j->...i", M, v, precision=lax.Precision.HIGHEST)

    def _mtv(M, v):
        return jnp.einsum("...ij,...i->...j", M, v, precision=lax.Precision.HIGHEST)

    def kkt_parts(xx, ll):
        _, g = f_lin(xx)
        cv, J = c_lin(xx)
        stat = _linf(g + _mtv(J, ll))
        viol = max_violation(cv, l, u)
        return stat, viol

    batch_shape = x_out.shape[:-1]
    kkt_rescued = jnp.zeros(batch_shape, jnp.bool_)
    stat_f = viol_f = None
    for _pol_pass in range(settings.polish_passes):
        _, grad_f = f_lin(x_out)
        c_f, J_f = c_lin(x_out)
        # shifted-bound QP around x_out: active rows enforce
        # J dx = b - c(x); equality rows are always active
        act, b_t = guess_active_set(l - c_f, u - c_f, lam_out)
        H = hess_fn(x_out, lam_out)
        J_m = jnp.where(act[..., None], J_f, 0.0)
        dx, nu, fail_pol = kkt_solve_schur_refined(
            H, J_m, act, -grad_f, b_t, nu0=lam_out,
            delta=settings.polish_delta, sweeps=settings.polish_sweeps,
        )
        x_pol = x_out + dx
        lam_pol = jnp.where(act, nu, 0.0)

        bad = jnp.isnan(x_pol).any(-1) | jnp.isnan(lam_pol).any(-1) | fail_pol
        stat_p, viol_p = kkt_parts(x_pol, lam_pol)
        if _pol_pass == 0:
            stat_o, viol_o = kkt_parts(x_out, lam_out)
        else:
            # the previous pass already scored the accepted point
            stat_o, viol_o = stat_f, viol_f
        better = (jnp.maximum(stat_p, viol_p) < jnp.maximum(stat_o, viol_o)) & (
            ~bad
        )
        x_out = jnp.where(better[..., None], x_pol, x_out)
        lam_out = jnp.where(better[..., None], lam_pol, lam_out)
        # status refresh: judge the FINAL point against the KKT tolerances
        stat_f = jnp.where(better, stat_p, stat_o)
        viol_f = jnp.where(better, viol_p, viol_o)
        kkt_rescued = (stat_f <= settings.eps_dual) & (viol_f <= settings.eps_prim)
    return x_out, lam_out, kkt_rescued
