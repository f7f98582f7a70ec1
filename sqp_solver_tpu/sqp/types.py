"""SQP problem/settings/status/info containers.

Parity targets: ``NonLinearProblem`` (C10, reference
``include/solvers/sqp.hpp:62-76``), ``sqp_settings_t`` (C11,
``sqp.hpp:13-31``) and the constructor-hardcoded inner-QP settings
(``src/sqp.cpp:14-24``).  Redesigned functional: the problem is a pair of
JAX-traceable callables plus bound arrays — linearizations come from
``jax.grad`` / ``jax.jacfwd`` by default (the reference's test-side
AutoDiffScalar adapter, C17, promoted to the core and only path), with
optional user-supplied closed-form linearizations for parity with the
hand-coded reference problems.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import jax

from sqp_solver_tpu.qp.types import QPSettings

__all__ = [
    "NonlinearProblem",
    "SQPSettings",
    "SQPStatus",
    "SQPInfo",
    "SQPResult",
]


class SQPStatus(enum.IntEnum):
    """Reference enum (``sqp.hpp:33``) + NUMERICAL_ISSUES for per-problem
    failure isolation in batched solves."""

    SOLVED = 0
    MAX_ITER_EXCEEDED = 1
    INVALID_SETTINGS = 2
    NUMERICAL_ISSUES = 3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NonlinearProblem:
    """``minimize f(x)  s.t.  l <= c(x) <= u``.

    ``objective`` and ``constraint`` are JAX-traceable:

    * ``objective(x) -> scalar`` or ``objective(x, params) -> scalar``
    * ``constraint(x) -> (m,)`` or ``constraint(x, params) -> (m,)``

    ``params`` is an arbitrary pytree of problem data (leaf of this pytree,
    so a *batched* ``params`` + ``vmap`` solves a family of problem
    instances through one traced solver — the MPC batching story).

    ``objective_linearized`` / ``constraint_linearized`` optionally override
    autodiff with closed forms: ``objective_linearized(x[, params]) ->
    (obj, grad)``, ``constraint_linearized(x[, params]) -> (c, J)``.
    (The reference's ``NonLinearProblem`` virtuals, sqp.hpp:71-75, ARE
    hand-coded linearizations — autodiff was test-side only there.)
    """

    l: jax.Array
    u: jax.Array
    params: Any = None
    objective: Callable = dataclasses.field(default=None, metadata=dict(static=True))
    constraint: Callable = dataclasses.field(default=None, metadata=dict(static=True))
    objective_linearized: Optional[Callable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    constraint_linearized: Optional[Callable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def num_constr(self) -> int:
        return self.l.shape[-1]


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class SQPSettings:
    """SQP hyperparameters (names/defaults from reference ``sqp.hpp:13-31``).

    ``qp`` carries the inner ADMM settings; its defaults replicate the
    reference constructor's hardcoded values (``src/sqp.cpp:14-24``).

    Extras beyond the reference:
      * ``qp_warm_start`` — carry the inner QP iterates across outer SQP
        iterations (the reference cold-starts every subproblem, an
        acknowledged perf bug — ``src/sqp.cpp:221`` + TODO at ``:273``).
      * ``jacobian_mode`` — ``"fwd"`` (jacfwd, O(n) like the reference's
        forward-mode seeds) or ``"rev"`` (jacrev, better for m >> n).
      * ``termination`` — ``"step_norm"`` (reference semantics: primal/dual
        step infinity-norms + constraint violation, ``src/sqp.cpp:125-131``)
        or ``"kkt"`` (Lagrangian-gradient stationarity + feasibility).  The
        step-norm test can fire at non-stationary points when the line
        search collapses alpha, and conversely never fire once iterates
        oscillate at the optimum; the KKT test is the robust upgrade the
        north star asks for.
    """

    tau: float = 0.5
    eta: float = 0.25
    rho: float = 0.5
    eps_prim: float = 1e-4
    eps_dual: float = 1e-4
    max_iter: int = 100
    line_search_max_iter: int = 20
    second_order_correction: bool = False
    qp: QPSettings = QPSettings(
        rho=1e-1,
        sigma=1e-6,
        alpha=1.6,
        eps_rel=1e-4,
        eps_abs=1e-4,
        max_iter=100,
        check_termination=10,
        warm_start=True,
        adaptive_rho=True,
        adaptive_rho_interval=50,
        # infeasibility certificates are off for SQP subproblems: BFGS
        # subproblems are convex with shifted linearized bounds, and
        # transient certificates would only cut the inner budget — keeping
        # the default off keeps both tiers trajectory-identical
        check_infeasibility=False,
    )
    qp_warm_start: bool = True
    polish: bool = False
    # Newton-KKT polish passes: each pass re-guesses the active set from
    # the current multipliers (a mini active-set iteration); the second
    # pass rescues instances whose first guess was wrong
    polish_passes: int = 2
    # per-pass KKT-solve hyperparameters (see qp.polish)
    polish_delta: float = 1e-2
    polish_sweeps: int = 6
    jacobian_mode: str = "fwd"
    termination: str = "step_norm"
    schedule: str = "early_exit"
    # Per-iteration user hook (reference sqp.hpp:23, called at
    # src/sqp.cpp:68-70,89-91).  Fires live on every tier via
    # jax.debug.callback — per problem on sqp_solve, whole-batch per outer
    # iteration on the fused tier.  record_trace=True plus
    # sqp.common.replay_trace (same signature) replays a solve offline.
    iteration_callback: Optional[Callable] = None
    # Record per-outer-iteration (x, lam, alpha, step norms) into
    # on-device ring buffers returned as result.trace — the batched-path
    # observability equivalent of iteration_callback.
    record_trace: bool = False

    def validate(self) -> None:
        """Eager validation (the reference's ``validate()`` is inverted and
        never called — quirk Q3; we implement the intended check)."""
        if not (0.0 < self.tau < 1.0):
            raise ValueError(f"tau must be in (0,1), got {self.tau}")
        if not (0.0 < self.eta < 1.0):
            raise ValueError(f"eta must be in (0,1), got {self.eta}")
        if not (0.0 < self.rho < 1.0):
            raise ValueError(f"rho must be in (0,1), got {self.rho}")
        if not (self.eps_prim > 0.0 and self.eps_dual > 0.0):
            raise ValueError("eps_prim/eps_dual must be > 0")
        if self.max_iter <= 0 or self.line_search_max_iter <= 0:
            raise ValueError("max_iter/line_search_max_iter must be > 0")
        if self.polish_passes < 0:
            raise ValueError("polish_passes must be >= 0")
        if not (self.polish_delta > 0.0):
            raise ValueError("polish_delta must be > 0")
        if self.polish_sweeps < 1:
            raise ValueError("polish_sweeps must be >= 1")
        if self.jacobian_mode not in ("fwd", "rev"):
            raise ValueError(f"jacobian_mode must be 'fwd' or 'rev', got {self.jacobian_mode}")
        if self.termination not in ("step_norm", "kkt"):
            raise ValueError(
                f"termination must be 'step_norm' or 'kkt', got {self.termination}"
            )
        if self.schedule not in ("early_exit", "fixed"):
            raise ValueError(
                f"schedule must be 'early_exit' or 'fixed', got {self.schedule}"
            )
        self.qp.validate()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SQPInfo:
    """Reference ``Info`` (``sqp.hpp:35-60``) + step norms."""

    status: jax.Array  # int32 SQPStatus code
    iter: jax.Array  # int32
    qp_solver_iter: jax.Array  # int32, accumulated inner iterations
    primal_step_norm: jax.Array
    dual_step_norm: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SQPResult:
    x: jax.Array  # primal solution
    lam: jax.Array  # dual solution (constraint multipliers)
    info: SQPInfo
    # populated when settings.record_trace: dict with per-outer-iteration
    # "x" (max_iter, B, n), "alpha", "primal_step_norm", "dual_step_norm"
    # (max_iter, B) — offline replay of the reference's iteration_callback
    trace: Any = None
