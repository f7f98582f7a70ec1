"""Differentiable QP layer: `jax.grad` THROUGH the solver.

``qp_solve_diff(qp, settings, impl)`` returns the primal solution x*(qp)
with a custom VJP that implicitly differentiates the KKT conditions at
the converged active set (the OptNet scheme, Amos & Kolter 2017) — so a
QP solve can sit inside a learned model, a differentiable-MPC loss, or a
hyperparameter optimization and be trained end-to-end.

The reference C++ library has no analog (no autodiff of any kind); this
is a capability, not a port.

Mathematics.  At the solution, with active rows Ã (bounds b̃) and their
multipliers ν, the KKT system is ``P x + q + Ã'ν = 0, Ã x = b̃``.  For a
loss ℓ(x*) with cotangent g = ∂ℓ/∂x*, the adjoint (dz_x, dz_ν) solves
the SAME (symmetric) KKT system with rhs (-g, 0):

    P dz_x + Ã' dz_ν = -g,      Ã dz_x = 0

and the parameter gradients are outer products:

    ∂ℓ/∂P = ½(dz_x x*' + x* dz_x')        (symmetrized)
    ∂ℓ/∂q = dz_x
    ∂ℓ/∂A = ν dz_x' + dz_ν x*'            (active rows; 0 inactive)
    ∂ℓ/∂b̃ = -dz_ν  → routed to l on lower-active rows, u on
             upper-active rows, and split 50/50 for equality rows
             (whose target is (l+u)/2 — a subgradient choice)

The adjoint solve IS the polish machinery
(:func:`sqp_solver_tpu.qp.polish.kkt_solve_schur_refined`): the Schur
preconditioner + ideal-operator refinement — so the backward pass is
the same batched linear algebra as the forward polish.

Caveats (standard for implicit differentiation of active-set solutions):
the gradient is exact under strict complementarity and LICQ at x*;
at degenerate solutions (weakly-active constraints) it is a subgradient
choice.  Problems whose adjoint factorization fails (``fail`` lanes) or
whose forward solve did not reach SOLVED return zero gradients rather
than NaNs.  Gradient quality tracks forward accuracy: solve with tight
tolerances (eps_abs/eps_rel ≲ 1e-8) and ``polish=True`` — at loose
tolerances, eps-level dual noise can flip the active-set classification
and silently bias the gradient even on SOLVED lanes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from sqp_solver_tpu.qp.polish import (
    active_masks,
    kkt_solve_schur_refined,
)
from sqp_solver_tpu.qp.types import QPSettings, QuadraticProblem

__all__ = ["qp_solve_diff"]


def _outer(a, b):
    return jnp.einsum("...i,...j->...ij", a, b, precision=lax.Precision.HIGHEST)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def qp_solve_diff(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    impl: str = "vmap",
) -> jax.Array:
    """Solve a QP (single or batched) and return x*, differentiably.

    ``jax.grad`` of any scalar function of the result propagates to
    every problem leaf (P, q, A, l, u) via the implicit function theorem
    at the converged active set.  ``impl`` picks the forward tier
    ("vmap" / "fused" — single problems always use the per-problem
    solver).
    """
    x, _, _ = _solve_fwd_parts(qp, settings, impl)
    return x


def _solve_fwd_parts(qp, settings, impl):
    if qp.q.ndim == 1:
        from sqp_solver_tpu.qp.admm import qp_solve

        res = qp_solve(qp, settings)
    else:
        from sqp_solver_tpu.parallel.batch import qp_solve_batch

        res = qp_solve_batch(qp, settings, impl=impl)
    return res.x, res.y, res.info


def _fwd(qp, settings, impl):
    x, y, info = _solve_fwd_parts(qp, settings, impl)
    return x, (qp, x, y, info.status)


def _bwd(settings, impl, residuals, g):
    del impl
    qp, x, y, status = residuals
    P, A, l, u = qp.P, qp.A, qp.l, qp.u
    with jax.default_matmul_precision("highest"):
        eq, act_low, act_up = active_masks(l, u, y)
        act = eq | act_low | act_up
        A_m = jnp.where(act[..., None], A, 0.0)
        nu = jnp.where(act, y, 0.0)

        # adjoint KKT solve: same operator, rhs (-g, 0) — the polish
        # machinery (Schur preconditioner + ideal-operator refinement)
        dz_x, dz_nu, fail = kkt_solve_schur_refined(
            P, A_m, act, -g, jnp.zeros_like(l),
            delta=settings.polish_delta, sweeps=settings.polish_sweeps,
        )
        # failed lanes (non-SPD reduced system) and non-SOLVED forward
        # lanes (MAX_ITER / NUMERICAL_ISSUES / INFEASIBLE: the IFT premise
        # "y is the converged dual" is false) contribute zero gradient
        # instead of poisoning the training step
        ok = jnp.logical_and(~fail, status == 0)
        okx = ok[..., None] if dz_x.ndim > 1 else ok
        dz_x = jnp.where(okx, dz_x, 0.0)
        dz_nu = jnp.where(okx, dz_nu, 0.0)

        dP = 0.5 * (_outer(dz_x, x) + _outer(x, dz_x))
        dq = dz_x
        dA = jnp.where(
            act[..., None], _outer(nu, dz_x) + _outer(dz_nu, x), 0.0
        )
        db = -dz_nu
        dl = jnp.where(act_low, db, 0.0) + jnp.where(eq, 0.5 * db, 0.0)
        du = jnp.where(act_up, db, 0.0) + jnp.where(eq, 0.5 * db, 0.0)
    return (QuadraticProblem(P=dP, q=dq, A=dA, l=dl, u=du),)


qp_solve_diff.defvjp(_fwd, _bwd)
