"""Solution polish: active-set refinement after ADMM convergence.

ADMM converges linearly, so at practical tolerances the returned iterates
carry O(eps_abs)-level error — the dominant accuracy limit of the whole
stack (and, through the QP duals, of the SQP's KKT residuals in f32).
Polish takes the converged iterate, guesses the active set from the sign
of the duals (the OSQP recipe, with a relative threshold so eps-noise
duals on inactive rows don't count; EQUALITY rows are always active), and
re-solves the equality-constrained KKT system on that active set.

The KKT solve (:func:`kkt_solve_schur_refined`) eliminates the
multipliers from the regularized system

    [[P + dI,  Ãᵀ], [Ã, -dI]] [dx; nu] = [r1; r2]      (Ã: inactive rows zeroed)

into the SPD n x n Schur matrix M = P + dI + (1/d)ÃᵀÃ — one batched
matmul + one batched Cholesky — then remove the O(d) regularization
bias with iterative refinement against the IDEAL (d-free) active-set
operator.  Each sweep contracts the error by ~d, so a handful of sweeps
reaches the dtype floor.  Measured on the badly-scaled huber family in
f32: ADMM stalls at ~1e-2; a direct d=1e-6 LDLᵀ is unusable (zero Hessian
block ⇒ 1e-6 pivots against O(1) couplings); this scheme reaches ~3e-7 vs
the long-double oracle.  It also removes the need for any (n+m)x(n+m)
factorization anywhere in the polish path.

The polished candidate is accepted PER PROBLEM only where the KKT error
improves, judged lexicographically: (stationarity, violation) first — the
pair that defines SOLVED — then dual-sign error as tiebreaker (a flat max
over all three lets polish trade stationarity for complementarity and
un-solve a solved problem).

(The reference has no analog; this is the polish step the OSQP paper
[PAPERS.md] specifies, §5.2, upgraded with ideal-operator refinement.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.qp.classify import RHO_TOL
from sqp_solver_tpu.qp.types import QPResult, QPSettings, QuadraticProblem

__all__ = [
    "polish_qp", "kkt_solve_schur_refined", "guess_active_set",
    "active_masks", "reclassify_active_set",
]


def _mv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v, precision=lax.Precision.HIGHEST)


def _mtv(M, v):
    return jnp.einsum("...ij,...i->...j", M, v, precision=lax.Precision.HIGHEST)


def _linf(v):
    return jnp.max(jnp.abs(v), axis=-1)


def active_masks(l, u, y):
    """Classify rows from dual signs: ``(eq, act_low, act_up)`` — equality
    rows (the classifier's criterion, u-l < RHO_TOL), and rows active at
    the lower/upper bound (dual meaningfully negative/positive)."""
    eq = (u - l) < RHO_TOL
    ytol = 1e-5 * (1.0 + jnp.max(jnp.abs(y), axis=-1, keepdims=True))
    act_low = (y < -ytol) & ~eq
    act_up = (y > ytol) & ~eq
    return eq, act_low, act_up


def guess_active_set(l, u, y):
    """OSQP-style active-set guess from dual signs, with equality rows
    ALWAYS active: an equality constraint with a small multiplier is
    still a constraint — guessing it inactive re-solves a different
    problem (catastrophic on equality-heavy QPs like the huber family).
    Returns (act, b) with b the target value on active rows (0 on
    inactive)."""
    eq, act_low, act_up = active_masks(l, u, y)
    act = act_low | act_up | eq
    b = jnp.where(
        eq, 0.5 * (l + u), jnp.where(act_low, l, jnp.where(act_up, u, 0.0))
    )
    return act, jnp.where(act, b, 0.0)


def reclassify_active_set(l, u, eq, act_low, act_up, nu, Ax_pol):
    """One active-set iteration step from a polish result: PROMOTE rows
    the polished x visibly violates (a truly-active degenerate row that
    the dual-sign guess dropped reveals itself — x crosses its bound,
    and tiny curvature amplifies the crossing to a visible size), and
    DEMOTE active rows whose equality multiplier came back with the
    wrong sign (forcing an actually-inactive row to its bound yields a
    multiplier fighting the objective — the classic active-set dual
    test).  Both failure modes were measured on the OSQP-paper
    portfolio family's degenerate box rows; neither is visible in the raw
    ADMM iterate's primal OR dual.  Returns (act_low, act_up)."""
    vtol = 1e-9 * (
        1.0
        + jnp.maximum(
            jnp.where(jnp.isfinite(l), jnp.abs(l), 0.0),
            jnp.where(jnp.isfinite(u), jnp.abs(u), 0.0),
        )
    )
    pro_low = jnp.isfinite(l) & (Ax_pol < l - vtol) & ~eq
    pro_up = jnp.isfinite(u) & (Ax_pol > u + vtol) & ~eq
    stol = 1e-12
    new_low = ((act_low & (nu <= stol)) | pro_low) & ~pro_up
    new_up = ((act_up & (nu >= -stol)) | pro_up) & ~pro_low
    return new_low, new_up


def kkt_solve_schur_refined(
    P,
    A_m,
    act,
    r1,
    r2,
    x0=None,
    nu0=None,
    delta: float = 1e-2,
    sweeps: int = 6,
):
    """Solve the ideal active-set KKT system

        P x + Ãᵀnu = r1,   Ã x = r2 (active rows),   nu = 0 (inactive)

    for a (possibly batched) problem, where ``A_m`` has inactive rows
    zeroed and ``r2`` is zero on inactive rows.  Returns (x, nu, fail).

    Preconditioner: Cholesky of M = P + delta I + (1/delta) ÃᵀÃ (SPD,
    batched); each refinement sweep solves the delta-regularized system
    exactly via the Schur form and contracts the remaining error by
    ~delta.  ``x0``/``nu0`` warm-start the sweeps.
    """
    dtype = P.dtype
    n = P.shape[-1]
    with jax.default_matmul_precision("highest"):
        d_c = jnp.asarray(delta, dtype)
        eye = jnp.eye(n, dtype=dtype)
        M = (
            P
            + d_c * eye
            + (1.0 / d_c)
            * jnp.einsum("...mi,...mj->...ij", A_m, A_m, precision=lax.Precision.HIGHEST)
        )
        # Explicit inverse instead of per-sweep triangular solves:
        # Cholesky + one solve against I.  One Newton-Schulz step (two
        # matmuls) recovers backsolve-grade accuracy, and the refinement
        # sweeps against the IDEAL operator absorb the O(eps) inverse
        # error exactly like the delta bias.  Every sweep is then a
        # batched matvec.
        L = jnp.linalg.cholesky(M)
        fail = jnp.isnan(L[..., -1, -1])
        Li = jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(eye, M.shape), lower=True
        )
        Minv = jnp.einsum(
            "...ki,...kj->...ij", Li, Li, precision=lax.Precision.HIGHEST
        )
        Minv = jnp.einsum(
            "...ik,...kj->...ij",
            Minv,
            2.0 * eye - jnp.einsum(
                "...ik,...kj->...ij", M, Minv, precision=lax.Precision.HIGHEST
            ),
            precision=lax.Precision.HIGHEST,
        )

        def solveM(rhs):
            return _mv(Minv, rhs)

        x = jnp.zeros_like(r1) if x0 is None else x0
        nu = jnp.zeros_like(r2) if nu0 is None else jnp.where(act, nu0, 0.0)
        # Stacked-operand sweep form: the textbook sweep is 6 batched
        # matvecs (P x, Ã x, Ã'nu, Ã'res2, M⁻¹·, Ã dx) issued as separate
        # XLA ops.  Stacking S = [P; Ã] yields P·v and Ã·v in ONE contraction,
        # the two transpose-applications merge via Ã'(nu - res2/d), and
        # carrying w = S x across sweeps (linear update w += S dx) removes
        # the re-evaluation — 3 matvecs/sweep, identical mathematics.
        S = jnp.concatenate([P, A_m], axis=-2)
        w = _mv(S, x)
        for _ in range(sweeps):
            res2 = jnp.where(act, r2 - w[..., n:], 0.0)
            dx = solveM(
                r1 - w[..., :n] - _mtv(A_m, nu - (1.0 / d_c) * res2)
            )
            dw = _mv(S, dx)
            nu = nu + jnp.where(act, (dw[..., n:] - res2) / d_c, 0.0)
            x = x + dx
            w = w + dw
    return x, nu, fail


def polish_qp(
    qp: QuadraticProblem,
    result: QPResult,
    settings: QPSettings = QPSettings(),
    delta: float = None,
    refine_steps: int = None,
    passes: int = None,
) -> QPResult:
    """Polish a (possibly batched) QP result.  Shape-polymorphic: works on
    single problems (n,), (m,) and batches (B, n), (B, m).

    ``delta``/``refine_steps``/``passes`` default to
    ``settings.polish_delta`` / ``settings.polish_sweeps`` /
    ``settings.polish_passes``; explicit arguments override.
    """
    if delta is None:
        delta = settings.polish_delta
    if refine_steps is None:
        refine_steps = settings.polish_sweeps
    if passes is None:
        passes = settings.polish_passes
    # pin matmul precision for the WHOLE polish, including the accept
    # guard's KKT residuals: a reduced-precision (TF32) guard would
    # accept/reject candidates on corrupted errors (CLAUDE.md precision
    # rule)
    with jax.default_matmul_precision("highest"):
        return _polish_impl(qp, result, delta, refine_steps, passes)


def _polish_impl(qp, result, delta, refine_steps, passes=1):
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    x, y, z = result.x, result.y, result.z

    # --- per-problem KKT score for the accept guard: the max over
    # stationarity, primal violation AND complementary-slackness
    # violation.  Comp slack must be inside the max (not a lexicographic
    # tie-break): on degenerate families (huber) ADMM can reach
    # rp/rd ~ 1e-7 at a NON-fixed-point whose y is supported on inactive
    # rows (comp slack ~ 0.8, objective 0.4 above optimal) — a
    # lexicographic guard keyed on rp/rd first can never accept the
    # repaired candidate there) ---
    def kkt_err(xx, yy, Ax):
        res_d = _linf(_mv(P, xx) + q + _mtv(A, yy))
        viol = jnp.maximum(
            jnp.max(jnp.where(jnp.isfinite(l), l - Ax, 0.0), axis=-1),
            jnp.max(jnp.where(jnp.isfinite(u), Ax - u, 0.0), axis=-1),
        )
        at_l = Ax <= l + 1e-6 * (1.0 + jnp.abs(l))
        at_u = Ax >= u - 1e-6 * (1.0 + jnp.abs(u))
        dsv = jnp.max(
            jnp.where(~at_u, jnp.maximum(yy, 0.0), 0.0)
            + jnp.where(~at_l, jnp.maximum(-yy, 0.0), 0.0),
            axis=-1,
        )
        return jnp.maximum(jnp.maximum(res_d, viol), dsv)

    eq, act_low, act_up = active_masks(l, u, y)
    best = (x, y, z)
    best_score = kkt_err(x, y, _mv(A, x))
    x_c, nu_c = x, y  # warm-start carriers across passes
    for p in range(passes):
        act = act_low | act_up | eq
        b = jnp.where(
            eq, 0.5 * (l + u), jnp.where(act_low, l, jnp.where(act_up, u, 0.0))
        )
        b = jnp.where(act, b, 0.0)
        A_m = jnp.where(act[..., None], A, 0.0)
        x_pol, nu, fail = kkt_solve_schur_refined(
            P,
            A_m,
            act,
            -q,
            b,
            x0=x_c,
            nu0=nu_c,
            delta=delta,
            sweeps=refine_steps,
        )
        y_pol = jnp.where(act, nu, 0.0)
        with jax.default_matmul_precision("highest"):
            Ax_pol = _mv(A, x_pol)

        # accept per problem only where the KKT score improves (vs the
        # best candidate so far, starting from the raw iterate)
        bad_pol = jnp.isnan(x_pol).any(axis=-1) | fail
        score_new = kkt_err(x_pol, y_pol, Ax_pol)
        better = (score_new < best_score) & (~bad_pol)

        def sel(a, bb, cond=better):
            while cond.ndim < a.ndim:
                cond = cond[..., None]
            return jnp.where(cond, a, bb)

        best = (
            sel(x_pol, best[0]),
            sel(y_pol, best[1]),
            sel(jnp.clip(Ax_pol, l, u), best[2]),
        )
        best_score = jnp.where(better, score_new, best_score)
        if p + 1 < passes:
            act_low, act_up = reclassify_active_set(
                l, u, eq, act_low, act_up, y_pol, Ax_pol
            )
            x_c, nu_c = x_pol, y_pol

    return QPResult(x=best[0], y=best[1], z=best[2], info=result.info)
