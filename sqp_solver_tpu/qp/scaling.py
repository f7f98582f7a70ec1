"""Ruiz equilibration (problem prescaling) for QPs.

The reference library re-implements OSQP's ADMM loop but drops OSQP's
problem scaling entirely — on badly-scaled data (e.g. the huber-fitting
family, models/families.py) the unscaled iteration stalls orders of
magnitude above tolerance, and the effect is much worse in f32 (the
device compute dtype) than in the reference's doubles.  This module supplies the
missing capability as modified Ruiz equilibration of the KKT matrix

    [[P, Aᵀ],
     [A, 0 ]]

with cost normalization (the OSQP paper's §5.1 scaling, re-derived here;
see PAPERS.md arXiv:1711.08013): iteratively scale variable i by
1/√‖KKT col i‖∞ and constraint j by 1/√‖A row j‖∞, then normalize the
cost so ‖∇f‖ is O(1).  The scaled problem is

    P̂ = c·D P D,  q̂ = c·D q,  Â = E A D,  l̂ = E l,  û = E u

with diagonal D (n), E (m) and cost scalar c; solutions map back as

    x = D x̂,   z = E⁻¹ ẑ,   y = E ŷ / c.

Design: a fixed-trip ``lax.fori_loop`` of elementwise ops and
row/column max-reductions — fully fusible by XLA, vmaps over a leading
batch axis (per-problem scalings), and runs identically in every solver
tier because it wraps the problem, not the solver.  Termination inside
the wrapped solver uses *scaled* residuals; :func:`rescore` recomputes
the true (unscaled) residuals afterwards and re-derives the status, so a
scaled solve never reports SOLVED on a point that misses the original
tolerances.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from sqp_solver_tpu.qp.classify import LOOSE_BOUNDS_THRESH
from sqp_solver_tpu.qp.types import (
    QPInfo,
    QPResult,
    QPState,
    QPSettings,
    QPStatus,
    QuadraticProblem,
)

__all__ = [
    "Scaling",
    "ruiz_equilibrate",
    "scale_state",
    "unscale_result",
    "rescore",
    "solve_with_scaling",
]

# per-sweep clamp on the scaling factors (keeps pathological rows/columns
# from driving the cumulative scaling to extremes)
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4
_BIG = 1e20  # loose-bound sentinel, beyond LOOSE_BOUNDS_THRESH


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scaling:
    """Diagonal equilibration factors: x = d·x̂, constraint rows scaled by
    e, cost by scalar c (all per-problem under a leading batch axis)."""

    d: jax.Array  # (..., n)
    e: jax.Array  # (..., m)
    c: jax.Array  # (...,)


def _guard(delta):
    return jnp.clip(
        jnp.where(jnp.isfinite(delta) & (delta > 0.0), delta, 1.0),
        _MIN_SCALING,
        _MAX_SCALING,
    )


def ruiz_equilibrate(
    problem: QuadraticProblem, iters: int = 10
) -> tuple[QuadraticProblem, Scaling]:
    """Equilibrate a QP (single or leading-batch).  Returns the scaled
    problem and the :class:`Scaling` that maps its solutions back."""
    P, q, A, l, u = problem.P, problem.q, problem.A, problem.l, problem.u
    dtype = P.dtype
    n = P.shape[-1]
    m = A.shape[-2]
    batch_shape = P.shape[:-2]

    loose_l = l <= -LOOSE_BOUNDS_THRESH
    loose_u = u >= LOOSE_BOUNDS_THRESH
    # equilibrate with loose sentinels zeroed out of the bound rows (they
    # carry no scale information; the sentinel is restored afterwards)
    l0 = jnp.where(loose_l, 0.0, l)
    u0 = jnp.where(loose_u, 0.0, u)

    d = jnp.ones(batch_shape + (n,), dtype)
    e = jnp.ones(batch_shape + (m,), dtype)
    c = jnp.ones(batch_shape, dtype)

    def body(_, carry):
        P, q, A, l, u, d, e, c = carry
        # KKT column norms: variable column i spans |P[:, i]| and |A[:, i]|;
        # constraint column j spans |A[j, :]| (the Aᵀ block)
        col_norm = jnp.maximum(
            jnp.max(jnp.abs(P), axis=-2), jnp.max(jnp.abs(A), axis=-2)
        )  # (..., n)
        row_norm = jnp.max(jnp.abs(A), axis=-1)  # (..., m)
        dd = _guard(1.0 / jnp.sqrt(col_norm))
        de = _guard(1.0 / jnp.sqrt(row_norm))
        P = dd[..., :, None] * P * dd[..., None, :]
        q = q * dd
        A = de[..., :, None] * A * dd[..., None, :]
        l = l * de
        u = u * de
        # cost normalization (OSQP §5.1): scale the objective so the mean
        # Hessian column norm / gradient norm is O(1)
        pcol = jnp.mean(jnp.max(jnp.abs(P), axis=-2), axis=-1)  # (...,)
        qn = jnp.max(jnp.abs(q), axis=-1)
        g = _guard(1.0 / jnp.maximum(pcol, qn))
        P = P * g[..., None, None]
        q = q * g[..., None]
        return P, q, A, l, u, d * dd, e * de, c * g

    P, q, A, l, u, d, e, c = jax.lax.fori_loop(
        0, iters, body, (P, q, A, l0, u0, d, e, c)
    )

    # --- classification invariance -----------------------------------------
    # The solver classifies rows FROM THE DATA (src/qp.cpp:284-294), so row
    # scaling must not move a row across a classification boundary:
    #  * an INEQUALITY gap e*(u-l) shrunk below RHO_TOL would be solved as
    #    an equality (a different problem);
    #  * a finite bound pushed past LOOSE_BOUNDS_THRESH would make the row
    #    loose (silently dropped).
    # Any positive row scaling is algebraically valid, so correct e per row
    # (equality rows can only shrink their gap — they stay equalities).
    from sqp_solver_tpu.qp.classify import RHO_TOL

    gap0 = problem.u - problem.l
    # gap crossings only matter for rows with BOTH bounds finite: one-sided
    # rows keep an infinite classifier gap through the restored sentinel
    ineq_finite = (gap0 >= RHO_TOL) & ~loose_l & ~loose_u
    eq0 = gap0 < RHO_TOL
    ce_up = jnp.where(
        ineq_finite & ((u - l) < RHO_TOL),
        (1.01 * RHO_TOL) / jnp.maximum(u - l, 1e-30),
        jnp.where(  # equality rows scaled UP cross the other way
            eq0 & ((u - l) >= RHO_TOL),
            (0.5 * RHO_TOL) / jnp.maximum(u - l, 1e-30),
            1.0,
        ),
    )
    bound_mag = jnp.maximum(jnp.abs(jnp.where(loose_l, 0.0, l)),
                            jnp.abs(jnp.where(loose_u, 0.0, u))) * ce_up
    ce_down = jnp.where(
        bound_mag > 0.1 * LOOSE_BOUNDS_THRESH,
        (0.1 * LOOSE_BOUNDS_THRESH) / jnp.maximum(bound_mag, 1e-30),
        1.0,
    )
    ce = ce_up * ce_down
    A = A * ce[..., :, None]
    l = l * ce
    u = u * ce
    e = e * ce

    # restore loose-bound sentinels (never active; keeps the scaled
    # problem's constraint classification identical on loose rows)
    l = jnp.where(loose_l, jnp.asarray(-_BIG, dtype), l)
    u = jnp.where(loose_u, jnp.asarray(_BIG, dtype), u)
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u), Scaling(d=d, e=e, c=c)


def solve_with_scaling(inner_solve, qp, settings, state=None) -> QPResult:
    """The one scale->solve->unscale->polish->rescore pipeline, shared by
    every entry point (a hand-synced copy per caller already diverged once
    on precision pinning).  ``inner_solve(scaled_qp, inner_settings,
    scaled_state)`` runs whichever tier the caller dispatches to; polish
    runs AFTER unscaling, in original coordinates, where the active-set
    thresholds are meaningful."""
    import dataclasses as _dc

    scaled, s = ruiz_equilibrate(qp, settings.scaling)
    # check_comp_slack is stripped from the INNER solve: in scaled space
    # the violation is sub-threshold (unscaling amplifies ~1e4x —
    # measured r5), so the in-loop term is useless there.  The TRUE check
    # happens in rescore() below, on original coordinates, after polish.
    inner = _dc.replace(
        settings, scaling=0, polish=False, check_comp_slack=False
    )
    st = None if state is None else scale_state(state, s)
    res = unscale_result(inner_solve(scaled, inner, st), s)
    if settings.polish:
        from sqp_solver_tpu.qp.polish import polish_qp

        res = polish_qp(qp, res, settings)
    return rescore(qp, res, settings)


def scale_state(state: QPState, s: Scaling) -> QPState:
    """Map a warm-start state from original to scaled coordinates."""
    return QPState(
        x=state.x / s.d,
        z=state.z * s.e,
        y=state.y * s.c[..., None] / s.e,
    )


def unscale_result(result: QPResult, s: Scaling) -> QPResult:
    """Map a scaled-problem result back to original coordinates
    (diagnostics in ``info`` still refer to the scaled problem — follow
    with :func:`rescore` against the original problem)."""
    return QPResult(
        x=result.x * s.d,
        z=result.z / s.e,
        y=result.y * s.e / s.c[..., None],
        info=result.info,
    )


def rescore(
    problem: QuadraticProblem, result: QPResult, settings: QPSettings
) -> QPResult:
    """Recompute true residuals of ``result`` on the ORIGINAL problem and
    re-derive the status against the original tolerances (reference
    termination math, src/qp.cpp:344-361, evaluated unscaled).

    Matmul precision is pinned HERE (not only in callers): the status
    decision must never be made from reduced-precision (TF32) residuals —
    a converged problem would read as MAX_ITER_EXCEEDED (CLAUDE.md: every
    solver entry point pins precision)."""
    with jax.default_matmul_precision("highest"):
        return _rescore_impl(problem, result, settings)


def _rescore_impl(problem, result, settings):
    P, q, A = problem.P, problem.q, problem.A
    x, z, y = result.x, result.z, result.y
    Ax = jnp.einsum("...mn,...n->...m", A, x)
    Px = jnp.einsum("...nk,...k->...n", P, x)
    ATy = jnp.einsum("...mn,...m->...n", A, y)
    linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
    res_prim = linf(Ax - z)
    res_dual = linf(Px + q + ATy)
    eps_prim = settings.eps_abs + settings.eps_rel * jnp.maximum(linf(Ax), linf(z))
    eps_dual = settings.eps_abs + settings.eps_rel * jnp.maximum(
        jnp.maximum(linf(Px), linf(ATy)), linf(q)
    )
    solved = (res_prim <= eps_prim) & (res_dual <= eps_dual)
    if settings.check_comp_slack:
        # TRUE comp-slack violation, original coordinates.  This must be
        # scored HERE, not inside the scaled loop: on degenerate families
        # (huber) the scaled-space violation is sub-threshold while
        # unscaling amplifies it ~1e4x (measured round 5) — exactly the
        # same reason rp/rd are re-scored unscaled.  z is clipped to the
        # bounds on output, so "at bound" is a thin test.
        l_, u_ = problem.l, problem.u
        btol = 64.0 * jnp.finfo(z.dtype).eps
        at_l = z <= l_ + btol * (1.0 + jnp.abs(l_))
        at_u = z >= u_ - btol * (1.0 + jnp.abs(u_))
        dsv = jnp.max(
            jnp.where(~at_u, jnp.maximum(y, 0.0), 0.0)
            + jnp.where(~at_l, jnp.maximum(-y, 0.0), 0.0),
            axis=-1,
        )
        solved = solved & (
            dsv <= settings.eps_abs + settings.eps_rel * linf(y)
        )
    old = result.info.status
    # NUMERICAL_ISSUES and the infeasibility certificates pass through:
    # a certificate of the scaled problem certifies the original (the
    # certificate vector transforms by the same diagonal scaling)
    passthrough = (
        (old == QPStatus.NUMERICAL_ISSUES)
        | (old == QPStatus.PRIMAL_INFEASIBLE)
        | (old == QPStatus.DUAL_INFEASIBLE)
    )
    status = jnp.where(
        passthrough,
        old,
        jnp.where(solved, QPStatus.SOLVED, QPStatus.MAX_ITER_EXCEEDED),
    ).astype(jnp.int32)
    info = QPInfo(
        status=status,
        iter=result.info.iter,
        rho_updates=result.info.rho_updates,
        rho_estimate=result.info.rho_estimate,
        res_prim=res_prim,
        res_dual=res_dual,
    )
    return QPResult(x=x, y=y, z=z, info=info)
