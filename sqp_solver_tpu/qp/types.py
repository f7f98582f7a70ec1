"""QP problem/settings/status/info containers (JAX pytrees).

Capability parity with the reference containers (see reference
``include/solvers/qp.hpp:15-108``): ``QuadraticProblem`` (C1), solver
settings (C2) and status/info (C3) — redesigned as JAX pytrees so the whole
solver is jit/vmap/shard_map-able.  Field names and defaults mirror the
reference so users can migrate settings 1:1.
"""

from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp

__all__ = [
    "QuadraticProblem",
    "QPSettings",
    "QPStatus",
    "QPInfo",
    "QPState",
    "QPResult",
]


class QPStatus(enum.IntEnum):
    """Solver status codes (int-coded so they vmap; same order as the
    reference enum at ``include/solvers/qp.hpp:70``, extended with the
    OSQP-paper §3.4 infeasibility certificates — the reference can only
    hit MAX_ITER_EXCEEDED on an infeasible problem, src/qp.cpp:147-149)."""

    SOLVED = 0
    MAX_ITER_EXCEEDED = 1
    UNSOLVED = 2
    NUMERICAL_ISSUES = 3
    UNINITIALIZED = 4
    PRIMAL_INFEASIBLE = 5
    DUAL_INFEASIBLE = 6


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuadraticProblem:
    """``minimize 0.5 x'Px + q'x  s.t.  l <= Ax <= u``.

    All leaves are jnp arrays; add a leading batch axis and ``vmap`` the
    solver to batch.  (Reference: C1, ``include/solvers/qp.hpp:15-34``.)
    """

    P: jax.Array  # (n, n) cost Hessian, PSD
    q: jax.Array  # (n,)  cost linear term
    A: jax.Array  # (m, n) constraint matrix
    l: jax.Array  # (m,)  lower bounds (-inf allowed)
    u: jax.Array  # (m,)  upper bounds (+inf allowed)

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    def astype(self, dtype) -> "QuadraticProblem":
        return QuadraticProblem(
            *(jnp.asarray(v, dtype=dtype) for v in (self.P, self.q, self.A, self.l, self.u))
        )


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class QPSettings:
    """ADMM hyperparameters.  Names/defaults match the reference settings
    struct (``include/solvers/qp.hpp:36-68``); static under jit (a new value
    triggers a retrace, like the reference's compile-time specialization).

    Extra knobs beyond the reference:
      * ``linear_solver``: ``"schur_cholesky"`` (default; SPD reduction of
        the KKT system, batch friendly), ``"kkt_ldlt"`` (factorize the
        full quasi-definite KKT matrix, reference-style), or ``"cg"``
        (matrix-free conjugate gradient, mirrors the reference's
        pluggable ``Eigen::ConjugateGradient`` option in
        ``include/unsupported/qp_solver.hpp:135``).
      * ``refine_steps``: iterative-refinement sweeps per linear solve
        (meets tight accuracy bars in f32).
      * ``polish``: one active-set equality re-solve after convergence
        (see ``qp.polish``) — 25-75x solution accuracy at the cost of one
        extra factorization.
      * ``schedule``: ``"early_exit"`` (dynamic while_loop; stops as soon
        as every batch element converges) or ``"fixed"`` (static
        fori_loop over exactly ``max_iter`` iterations with per-problem
        convergence masks).  Fixed schedules contain zero dynamic loop
        conditions and produce a single static compute graph; early exit
        skips the iterations a converged batch no longer needs.
    """

    rho: float = 1e-1
    sigma: float = 1e-6
    alpha: float = 1.0
    eps_rel: float = 1e-3
    eps_abs: float = 1e-3
    max_iter: int = 1000
    check_termination: int = 25
    # warm_start is honored by the stateful wrapper (qp.api.QPSolver):
    # consecutive solve() calls reuse the previous iterate, the intended
    # reference semantics (its reset is a no-op bug, src/qp.cpp:78-82).
    # The functional solvers ignore it: there, passing `state` IS the warm
    # start — explicit state always wins, whatever this flag says.
    warm_start: bool = False
    adaptive_rho: bool = False
    adaptive_rho_tolerance: float = 5.0
    adaptive_rho_interval: int = 25
    verbose: bool = False
    linear_solver: str = "schur_cholesky"
    # block size for the structured backends.  "schur_block_tridiag": the
    # Schur matrix must be block-tridiagonal with this block size, as in
    # stage-wise MPC (models/mpc.py:mpc_qp_stagewise_batch); a banded
    # matrix of bandwidth w is covered by block_size >= w.  "schur_arrow":
    # block size of the block-DIAGONAL leading part; the trailing
    # `arrow_width` variables form the dense coupling border (MPC with
    # cross-stage coupling, factor-model portfolios —
    # models/mpc.py:mpc_qp_coupled_batch).
    block_size: int = 0
    arrow_width: int = 0
    refine_steps: int = 0
    schedule: str = "early_exit"
    polish: bool = False
    # polish hyperparameters (qp.polish): the Schur preconditioner's
    # regularization delta (each refinement sweep contracts the error by
    # ~delta) and the number of ideal-operator sweeps
    polish_delta: float = 1e-2
    polish_sweeps: int = 6
    # OPT-IN third termination term: complementary-slackness violation
    # (max over rows of y+ on rows not at their upper bound + y- on rows
    # not at their lower bound) <= eps_abs + eps_rel*|y|_inf.  OSQP and
    # the reference terminate on rp/rd alone — on degenerate families
    # (huber) ADMM can reach rp/rd ~ 1e-7 at a NON-fixed-point whose y
    # is supported on interior rows (objective 0.4 above optimal,
    # measured round 5) and the rp/rd criterion declares the lane
    # SOLVED there.  The flag adds the term to the in-loop criterion
    # (per-problem + fused tiers) AND to the true-residual status
    # rescore after a scaled solve (qp.scaling.rescore) — the latter is
    # where it bites under Ruiz scaling, because the scaled-space
    # violation is sub-threshold while unscaling amplifies it ~1e4x
    # (measured).  A lane the polish repairs keeps SOLVED; an
    # unrepaired pseudo-converged lane reports MAX_ITER_EXCEEDED
    # instead of a false SOLVED.  Default off = reference semantics.
    check_comp_slack: bool = False
    # Active-set re-solve passes.  Pass k+1 reclassifies from pass k's
    # result: rows the polished x visibly violates are promoted to
    # active, and active rows whose equality multiplier came back with
    # the wrong sign are demoted (one step of classic active-set
    # iteration per extra pass).  2 fixes DEGENERATE active sets that
    # the dual-sign guess cannot see in the ADMM iterate — measured on
    # the OSQP-paper portfolio family (tiny-curvature box rows, oracle
    # multiplier ~0): err_p99 vs the long-double oracle 1.6e-4 -> 4e-8,
    # and it also repaired lasso/svm outlier lanes.  Each pass costs one extra
    # factorization; latency-critical callers set 1.
    polish_passes: int = 2
    # Ruiz equilibration sweeps (qp.scaling): 0 = off (reference
    # semantics — the reference dropped OSQP's scaling entirely).  10 is
    # OSQP's default and rescues badly-scaled problems (e.g. the huber
    # family) that stall unscaled, especially in f32.  Solutions and
    # residuals are reported in ORIGINAL coordinates (rescored after the
    # scaled solve), so results remain drop-in comparable.
    scaling: int = 0
    # Safeguarded type-II Anderson acceleration of the ADMM fixed point
    # at chunk (check_termination) granularity: "none" (reference
    # semantics) or "anderson".  The extrapolated candidate is accepted
    # per chunk only if its TRUE residual beats the plain iterate (and
    # passes the termination test whenever the plain one does), so it can
    # never slow convergence by more than the safeguard's bookkeeping
    # (~2 extra residual evaluations per chunk).  Supported on all tiers:
    # per-problem, vmap and fused.
    acceleration: str = "none"
    anderson_memory: int = 4
    # OSQP §3.4 infeasibility detection from the ADMM iterate deltas at
    # termination-check cadence: a delta-y satisfying the primal
    # certificate conditions proves l <= Ax <= u is infeasible; a delta-x
    # satisfying the dual conditions proves the objective is unbounded
    # below on the feasible set.  Statuses PRIMAL_INFEASIBLE /
    # DUAL_INFEASIBLE.  The reference has no analog (it can only hit
    # MAX_ITER_EXCEEDED on infeasible problems, src/qp.cpp:147-149).
    check_infeasibility: bool = True
    eps_pinf: float = 1e-4
    eps_dinf: float = 1e-4

    def validate(self) -> None:
        if not (self.rho > 0):
            raise ValueError(f"rho must be > 0, got {self.rho}")
        if not (self.sigma > 0):
            raise ValueError(f"sigma must be > 0, got {self.sigma}")
        if not (0 < self.alpha < 2):
            raise ValueError(f"alpha must be in (0, 2), got {self.alpha}")
        if not (self.eps_rel > 0 and self.eps_abs > 0):
            raise ValueError("eps_rel/eps_abs must be > 0")
        if self.max_iter <= 0 or self.check_termination < 0:
            raise ValueError("max_iter must be > 0, check_termination >= 0")
        if not (self.adaptive_rho_tolerance > 1):
            raise ValueError("adaptive_rho_tolerance must be > 1")
        if self.adaptive_rho_interval <= 0:
            raise ValueError("adaptive_rho_interval must be > 0")
        if self.linear_solver not in (
            "schur_cholesky", "schur_cholesky_tri", "schur_cholesky_blocked",
            "kkt_ldlt", "cg", "schur_block_tridiag", "schur_arrow",
        ):
            raise ValueError(f"unknown linear_solver {self.linear_solver!r}")
        if self.linear_solver == "schur_block_tridiag" and self.block_size <= 0:
            raise ValueError(
                "linear_solver='schur_block_tridiag' requires block_size > 0"
            )
        if self.linear_solver == "schur_arrow" and (
            self.block_size <= 0 or self.arrow_width <= 0
        ):
            raise ValueError(
                "linear_solver='schur_arrow' requires block_size > 0 and "
                "arrow_width > 0"
            )
        if not (self.polish_delta > 0.0):
            raise ValueError("polish_delta must be > 0")
        if self.polish_sweeps < 1:
            raise ValueError("polish_sweeps must be >= 1")
        if self.polish_passes < 1:
            raise ValueError("polish_passes must be >= 1")
        if self.schedule not in ("early_exit", "fixed"):
            raise ValueError(f"schedule must be 'early_exit' or 'fixed', got {self.schedule}")
        if self.scaling < 0:
            raise ValueError(f"scaling must be >= 0, got {self.scaling}")
        if self.acceleration not in ("none", "anderson"):
            raise ValueError(
                f"acceleration must be 'none' or 'anderson', got {self.acceleration}"
            )
        if self.anderson_memory <= 0:
            raise ValueError(
                f"anderson_memory must be > 0, got {self.anderson_memory}"
            )
        if not (self.eps_pinf > 0 and self.eps_dinf > 0):
            raise ValueError("eps_pinf/eps_dinf must be > 0")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPInfo:
    """Solve diagnostics (reference ``QPSolverInfo``, ``qp.hpp:72-108``).
    All fields are traced scalars so a batched solve returns batched info."""

    status: jax.Array  # int32, QPStatus code
    iter: jax.Array  # int32
    rho_updates: jax.Array  # int32
    rho_estimate: jax.Array
    res_prim: jax.Array
    res_dual: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPState:
    """Warm-startable iterate (x, z, y).  Pass a previous result's state to
    warm start — this is the *intended* semantics of the reference's
    ``warm_start`` flag (whose cold-start reset is a no-op bug, reference
    ``src/qp.cpp:78-82``), made explicit and functional."""

    x: jax.Array  # (n,) primal
    z: jax.Array  # (m,) auxiliary (constraint-space) iterate
    y: jax.Array  # (m,) dual

    @staticmethod
    def zeros(n: int, m: int, dtype=jnp.float32) -> "QPState":
        return QPState(
            x=jnp.zeros((n,), dtype), z=jnp.zeros((m,), dtype), y=jnp.zeros((m,), dtype)
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPResult:
    """Returned by ``qp_solve``: solution + info + re-usable warm-start state."""

    x: jax.Array  # primal solution
    y: jax.Array  # dual solution
    z: jax.Array  # auxiliary solution (= Ax at convergence)
    info: QPInfo

    @property
    def state(self) -> QPState:
        return QPState(x=self.x, z=self.z, y=self.y)
