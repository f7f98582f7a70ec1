"""Batched QP families for the MPC / throughput benchmarks.

The driver's north-star config is "4096 independent small QPs per step via
vmap" (BASELINE.json configs[3]).  Two generators:

* :func:`mpc_qp_batch` — condensed receding-horizon MPC for a double
  integrator: one shared (P, A) and per-instance (q, l, u) driven by the
  batch of initial states, the classic embedded-MPC pattern.
* :func:`random_qp_batch` — random strictly-convex box-constrained QPs,
  fully heterogeneous across the batch.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from sqp_solver_tpu.qp.types import QuadraticProblem

__all__ = [
    "mpc_qp_batch",
    "mpc_qp_stagewise_batch",
    "mpc_qp_coupled_batch",
    "mpc_nlp_stagewise_batch",
    "random_qp_batch",
]


def _double_integrator_condensed(horizon: int, dt: float = 0.1):
    """Condense pos/vel double-integrator dynamics over `horizon` steps:
    returns (Su_pos, Sx_pos, Su_vel, Sx_vel) with
    pos = Sx_pos @ x0 + Su_pos @ u, vel likewise."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    nx = 2
    Sx = np.zeros((horizon, nx, nx))
    Su = np.zeros((horizon, nx, horizon))
    Ak = np.eye(nx)
    for k in range(horizon):
        Ak = A @ Ak
        Sx[k] = Ak
        for j in range(k + 1):
            Su[k][:, j] = (np.linalg.matrix_power(A, k - j) @ B)[:, 0]
    return Sx, Su


def mpc_qp_batch(
    batch: int,
    horizon: int = 16,
    dt: float = 0.1,
    u_max: float = 2.0,
    v_max: float = 1.5,
    r_weight: float = 0.1,
    seed: int = 0,
    dtype=jnp.float32,
) -> QuadraticProblem:
    """Batched condensed MPC QP (n = horizon vars, m = 2*horizon constr).

    Decision variable: input sequence u.  Cost: position tracking to the
    origin + input effort.  Constraints: |u| <= u_max (box rows) and
    |vel| <= v_max (dense rows).  The batch axis varies the initial state,
    so P and A are shared and q, l, u vary — broadcast accordingly.
    """
    Sx, Su = _double_integrator_condensed(horizon, dt)
    Sp_x, Sp_u = Sx[:, 0, :], Su[:, 0, :]  # position maps
    Sv_x, Sv_u = Sx[:, 1, :], Su[:, 1, :]  # velocity maps

    P = Sp_u.T @ Sp_u + r_weight * np.eye(horizon)
    # constraints: u box + velocity bounds
    A_mat = np.concatenate([np.eye(horizon), Sv_u], axis=0)

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(batch, 2))

    q = (x0 @ Sp_x.T) @ Sp_u  # (batch, horizon)
    vel_off = x0 @ Sv_x.T  # (batch, horizon)
    l = np.concatenate(
        [np.full((batch, horizon), -u_max), -v_max - vel_off], axis=1
    )
    u = np.concatenate([np.full((batch, horizon), u_max), v_max - vel_off], axis=1)

    return QuadraticProblem(
        P=jnp.asarray(np.broadcast_to(P, (batch, horizon, horizon)), dtype=dtype),
        q=jnp.asarray(q, dtype=dtype),
        A=jnp.asarray(
            np.broadcast_to(A_mat, (batch, 2 * horizon, horizon)), dtype=dtype
        ),
        l=jnp.asarray(l, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
    )


def mpc_qp_stagewise_batch(
    batch: int,
    horizon: int = 16,
    dt: float = 0.1,
    u_max: float = 2.0,
    v_max: float = 1.5,
    p_max: float = 5.0,
    q_weight=(1.0, 0.1),
    r_weight: float = 0.1,
    seed: int = 0,
    dtype=jnp.float32,
):
    """Stage-wise (non-condensed) MPC QP with a block-tridiagonal Schur
    matrix — the structured-KKT benchmark family.

    Decision variable: z = [(u_0, x_1), (u_1, x_2), ..., (u_{T-1}, x_T)]
    in per-stage blocks of size nu + nx = 3 (double integrator).  The cost
    is block-diagonal and every constraint row (dynamics equalities, input
    box, state box) touches at most two adjacent stage blocks, so
    M = P + sigma I + A' rho A is block-tridiagonal with block size 3 —
    solve with ``QPSettings(linear_solver="schur_block_tridiag",
    block_size=3)``.  This is the batched counterpart of the
    reference's sparse QP path (``src/qp.cpp:161-270`` under
    ``QP_SOLVER_USE_SPARSE``): structure exploited in the factorization,
    dense-masked everywhere else.

    Returns (problem, block_size).  P, A are shared across the batch; the
    initial state enters through the k=0 dynamics equality bounds.
    """
    nx, nu = 2, 1
    b = nx + nu
    T = horizon
    n = b * T
    Ad = np.array([[1.0, dt], [0.0, 1.0]])
    Bd = np.array([[0.5 * dt * dt], [dt]])

    # cost: 0.5 sum x_k' Q x_k + u_k' R u_k  (block diagonal)
    Q = np.diag(q_weight)
    P = np.zeros((n, n))
    for k in range(T):
        o = b * k
        P[o : o + nu, o : o + nu] = r_weight * np.eye(nu)
        P[o + nu : o + b, o + nu : o + b] = Q

    # constraints: dynamics equalities (2T rows), u box (T), x box (2T)
    m = nx * T + nu * T + nx * T
    A_mat = np.zeros((m, n))
    r = 0
    dyn_rows = []
    for k in range(T):
        o = b * k
        # x_{k+1} - Ad x_k - Bd u_k = (Ad x0 if k == 0 else 0)
        A_mat[r : r + nx, o : o + nu] = -Bd
        A_mat[r : r + nx, o + nu : o + b] = np.eye(nx)
        if k > 0:
            o_prev = b * (k - 1)
            A_mat[r : r + nx, o_prev + nu : o_prev + b] = -Ad
        dyn_rows.append(r)
        r += nx
    for k in range(T):
        A_mat[r, b * k] = 1.0  # u_k
        r += 1
    for k in range(T):
        o = b * k + nu
        A_mat[r : r + nx, o : o + nx] = np.eye(nx)  # x_{k+1}
        r += nx

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(batch, nx))
    rhs0 = x0 @ Ad.T  # (batch, nx): k=0 dynamics equality value

    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    # dynamics equalities
    l[:, : nx * T] = 0.0
    u[:, : nx * T] = 0.0
    l[:, :nx] = rhs0
    u[:, :nx] = rhs0
    # input box
    l[:, nx * T : nx * T + T] = -u_max
    u[:, nx * T : nx * T + T] = u_max
    # state box (pos, vel per stage)
    xlo = np.tile([-p_max, -v_max], T)
    xhi = np.tile([p_max, v_max], T)
    l[:, nx * T + T :] = xlo
    u[:, nx * T + T :] = xhi

    problem = QuadraticProblem(
        P=jnp.asarray(np.broadcast_to(P, (batch, n, n)), dtype=dtype),
        q=jnp.zeros((batch, n), dtype=dtype),
        A=jnp.asarray(np.broadcast_to(A_mat, (batch, m, n)), dtype=dtype),
        l=jnp.asarray(l, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
    )
    return problem, b


def mpc_qp_coupled_batch(
    batch: int,
    agents: int = 8,
    horizon: int = 4,
    meet_points: int = 2,
    dt: float = 0.25,
    u_max: float = 2.0,
    v_max: float = 1.5,
    p_max: float = 5.0,
    r_weight: float = 0.1,
    w_weight: float = 1e-2,
    seed: int = 0,
    dtype=jnp.float32,
):
    """Multi-agent rendezvous MPC with an ARROW-structured Schur matrix —
    the border-coupled structured-KKT family.

    ``agents`` double integrators each plan a condensed input sequence
    z_k (horizon vars, tracking + effort cost, input box + velocity
    rows), and agent k's TERMINAL POSITION must equal a shared,
    jointly-optimized rendezvous coordinate w_{k mod meet_points}
    (equality rows touching z_k and w only).  No constraint couples two
    agents directly, so M = P + sigma I + A' rho A is arrow: a
    block-diagonal leading part (block size = horizon, one block per
    agent) bordered by ``meet_points`` dense coupling columns — solve
    with ``QPSettings(linear_solver="schur_arrow", block_size=horizon,
    arrow_width=meet_points)``.  Together with the block-tridiagonal
    family this covers the reference's sparse-path ambition
    (``include/solvers/qp.hpp:126-128``,
    ``tests/qp_solver_sparse_test.cpp:51-98``) for bordered structures.

    Returns (problem, block_size, arrow_width).  P, A shared across the
    batch; per-instance initial states enter through q and the coupling
    equality bounds.
    """
    h, S, c = horizon, agents, meet_points
    n = S * h + c
    Sx, Su = _double_integrator_condensed(h, dt)
    Sp_x, Sp_u = Sx[:, 0, :], Su[:, 0, :]
    Sv_x, Sv_u = Sx[:, 1, :], Su[:, 1, :]
    P_blk = Sp_u.T @ Sp_u + r_weight * np.eye(h)

    P = np.zeros((n, n))
    for k in range(S):
        o = h * k
        P[o : o + h, o : o + h] = P_blk
    P[S * h :, S * h :] = w_weight * np.eye(c)

    # rows per agent: input box (h) + velocity bounds (h) + rendezvous
    # equality (1); rows on w only: box (c)
    m = S * (2 * h + 1) + c
    A_mat = np.zeros((m, n))
    r = 0
    for k in range(S):
        o = h * k
        A_mat[r : r + h, o : o + h] = np.eye(h)  # input box
        r += h
        A_mat[r : r + h, o : o + h] = Sv_u  # velocity rows
        r += h
        # terminal position - rendezvous coordinate = -(Sx_pos x0)[h-1]
        A_mat[r, o : o + h] = Sp_u[h - 1]
        A_mat[r, S * h + (k % c)] = -1.0
        r += 1
    A_mat[r : r + c, S * h :] = np.eye(c)  # w box
    assert r + c == m

    rng = np.random.default_rng(seed)
    # keep initial states tight enough that the agents sharing a meet
    # point always have intersecting reachable terminal sets (drift
    # p0 + v0*T stays within +-0.6 vs a +-1.0 controllable envelope at
    # the default horizon/dt/u_max) — every instance is feasible
    x0 = rng.uniform(-0.3, 0.3, size=(batch, S, 2))

    q = np.zeros((batch, n))
    # tracking cost: position sequence to origin given x0 per agent
    q[:, : S * h] = np.einsum("bsx,hx,hj->bsj", x0, Sp_x, Sp_u).reshape(
        batch, S * h
    )
    pos_off = np.einsum("bsx,x->bs", x0, Sp_x[h - 1])  # (batch, S)
    vel_off = np.einsum("bsx,hx->bsh", x0, Sv_x)  # (batch, S, h)

    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    for k in range(S):
        r0 = k * (2 * h + 1)
        l[:, r0 : r0 + h] = -u_max
        u[:, r0 : r0 + h] = u_max
        l[:, r0 + h : r0 + 2 * h] = -v_max - vel_off[:, k]
        u[:, r0 + h : r0 + 2 * h] = v_max - vel_off[:, k]
        l[:, r0 + 2 * h] = -pos_off[:, k]
        u[:, r0 + 2 * h] = -pos_off[:, k]
    l[:, S * (2 * h + 1) :] = -p_max
    u[:, S * (2 * h + 1) :] = p_max

    problem = QuadraticProblem(
        P=jnp.asarray(np.broadcast_to(P, (batch, n, n)), dtype=dtype),
        q=jnp.asarray(q, dtype=dtype),
        A=jnp.asarray(np.broadcast_to(A_mat, (batch, m, n)), dtype=dtype),
        l=jnp.asarray(l, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
    )
    return problem, h, c


def random_qp_batch(
    batch: int,
    n: int = 32,
    m: int = 48,
    seed: int = 0,
    dtype=jnp.float32,
) -> QuadraticProblem:
    """Batch of random strictly-convex QPs with guaranteed-feasible bounds."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(n)
    q = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n)) / np.sqrt(n)
    x_feas = rng.normal(size=(batch, n))
    Ax = np.einsum("bmn,bn->bm", A, x_feas)
    width = rng.uniform(0.1, 2.0, size=(batch, m))
    l = Ax - width
    u = Ax + width
    return QuadraticProblem(
        P=jnp.asarray(P, dtype=dtype),
        q=jnp.asarray(q, dtype=dtype),
        A=jnp.asarray(A, dtype=dtype),
        l=jnp.asarray(l, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
    )


def mpc_nlp_stagewise_batch(
    batch: int,
    horizon: int = 48,
    dt: float = 0.1,
    speed: float = 1.0,
    omega_max: float = 2.0,
    p_max: float = 5.0,
    theta_max: float = 4.0,
    q_weight: float = 1.0,
    r_weight: float = 0.1,
    th_weight: float = 0.01,
    seed: int = 0,
    dtype=jnp.float32,
):
    """Stage-wise NONLINEAR MPC batch — the structured-SQP benchmark NLP.

    Unicycle (Dubins car) steered to a per-problem goal: state
    x = (px, py, theta), control u = omega (turn rate), constant forward
    speed.  Decision variable z = [(u_0, x_1), ..., (u_{T-1}, x_T)] in
    per-stage blocks of size nu + nx = 4; x_0 enters through ``params``.

    Constraints (m = 7 T rows):
      * dynamics equalities  x_{k+1} - x_k - dt (v cos th_k, v sin th_k,
        u_k) = 0   (3 T rows, nonlinear in th_k),
      * turn-rate box |u_k| <= omega_max (T rows),
      * state box on (px, py, theta) (3 T rows).

    Objective: 0.5 sum_k q ||p_k - goal||^2 + r u_k^2 + w th_k^2 — every
    term touches one stage, so the TRUE Lagrangian Hessian is
    block-diagonal in the stage blocks and every Schur matrix
    B + sigma I + J' rho J is block-tridiagonal at block size 4 (the
    structure a block-tridiagonal inner solve on the fused SQP tier would
    exploit; the dense fused tier solves it today).  This is the nonlinear
    counterpart of
    :func:`mpc_qp_stagewise_batch` (the reference exercises only dense
    NLPs — ``tests/sqp_test.cpp`` — so this family is capability beyond
    parity, targeted at the sparse ambition of
    ``include/solvers/qp.hpp:126-129``).

    Returns ``(problem, x_init, block_size)`` with ``x_init`` the
    dynamically feasible zero-control rollout (B, 4 T).
    """
    nx, nu = 3, 1
    b = nx + nu
    T = horizon
    n = b * T
    v = speed

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(batch, nx))
    goal = rng.uniform(-2.0, 2.0, size=(batch, 2))
    params = jnp.asarray(np.concatenate([x0, goal], axis=1), dtype=dtype)

    def objective(z, p):
        goal_p = p[3:5]
        Z = z.reshape(T, b)
        u_ = Z[:, 0]
        X = Z[:, 1:]
        pos = X[:, :2]
        return 0.5 * (
            q_weight * jnp.sum((pos - goal_p[None, :]) ** 2)
            + r_weight * jnp.sum(u_**2)
            + th_weight * jnp.sum(X[:, 2] ** 2)
        )

    def constraint(z, p):
        x0_p = p[:3]
        Z = z.reshape(T, b)
        u_ = Z[:, 0]
        X = Z[:, 1:]                                       # x_1 .. x_T
        Xprev = jnp.concatenate([x0_p[None, :], X[:-1]], axis=0)
        th = Xprev[:, 2]
        step = jnp.stack([v * jnp.cos(th), v * jnp.sin(th), u_], axis=1)
        dyn = (X - Xprev - dt * step).reshape(-1)          # (3 T,)
        return jnp.concatenate([dyn, u_, X.reshape(-1)])

    m = 3 * T + T + 3 * T
    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    l[:, 3 * T : 4 * T] = -omega_max
    u[:, 3 * T : 4 * T] = omega_max
    xlo = np.tile([-p_max, -p_max, -theta_max], T)
    xhi = np.tile([p_max, p_max, theta_max], T)
    l[:, 4 * T :] = xlo
    u[:, 4 * T :] = xhi

    from sqp_solver_tpu.sqp.types import NonlinearProblem

    problem = NonlinearProblem(
        l=jnp.asarray(l, dtype=dtype),
        u=jnp.asarray(u, dtype=dtype),
        params=params,
        objective=objective,
        constraint=constraint,
    )

    # zero-control rollout: dynamically feasible start
    X_init = np.zeros((batch, T, b))
    xk = x0.copy()
    for k in range(T):
        xk = xk + dt * np.stack(
            [v * np.cos(xk[:, 2]), v * np.sin(xk[:, 2]), np.zeros(batch)],
            axis=1,
        )
        X_init[:, k, 1:] = xk
    x_init = jnp.asarray(X_init.reshape(batch, n), dtype=dtype)
    return problem, x_init, b


def mpc_nlp_kkt_residuals(problem, x, lam, horizon, dt=0.1, speed=1.0,
                          q_weight=1.0, r_weight=0.1, th_weight=0.01):
    """Float64 host-side KKT residuals for :func:`mpc_nlp_stagewise_batch`.

    Returns ``(primal_viol, dual_res)`` per batch element — the exact
    objective gradient plus J'lam with the hand-derived unicycle Jacobian,
    evaluated in numpy float64 with no solver code on the path: an
    independent certification of an f32 solve (the same pattern as
    ``models.benchmark.exp_chain_kkt_residuals``).  Pass the generator's
    non-default weights through if overridden.
    """
    T = horizon
    b = 4
    x = np.asarray(x, np.float64)
    lam = np.asarray(lam, np.float64)
    p = np.asarray(problem.params, np.float64)
    B = x.shape[0]
    x0_, goal = p[:, :3], p[:, 3:5]
    v = speed

    Z = x.reshape(B, T, b)
    u_ = Z[:, :, 0]                    # (B, T)
    X = Z[:, :, 1:]                    # (B, T, 3) = x_1 .. x_T
    Xprev = np.concatenate([x0_[:, None, :], X[:, :-1]], axis=1)
    th_prev = Xprev[:, :, 2]

    # objective gradient in z layout
    g = np.zeros_like(Z)
    g[:, :, 0] = r_weight * u_
    g[:, :, 1:3] = q_weight * (X[:, :, :2] - goal[:, None, :])
    g[:, :, 3] = th_weight * X[:, :, 2]

    lam_d = lam[:, : 3 * T].reshape(B, T, 3)
    lam_u = lam[:, 3 * T : 4 * T]
    lam_x = lam[:, 4 * T :].reshape(B, T, 3)

    s = g.copy()
    # dynamics rows k: +I on x_{k+1}, -I - dt D_k on x_k (decision var for
    # k >= 1), -dt e3 on u_k; D_k has only the theta column (unicycle)
    s[:, :, 1:] += lam_d + lam_x
    s[:, :, 0] += -dt * lam_d[:, :, 2] + lam_u
    contrib = -lam_d[:, 1:, :].copy()        # onto x_k, k = 1..T-1
    contrib[:, :, 2] -= dt * v * (
        -np.sin(th_prev[:, 1:]) * lam_d[:, 1:, 0]
        + np.cos(th_prev[:, 1:]) * lam_d[:, 1:, 1]
    )
    s[:, :-1, 1:] += contrib
    dual_res = np.abs(s.reshape(B, -1)).max(axis=1)

    # primal violation: dynamics equality + boxes, all f64
    step = np.stack(
        [v * np.cos(th_prev), v * np.sin(th_prev), u_], axis=2
    )
    dyn = X - Xprev - dt * step
    cv = np.concatenate(
        [dyn.reshape(B, -1), u_, X.reshape(B, -1)], axis=1
    )
    lo = np.asarray(problem.l, np.float64)
    hi = np.asarray(problem.u, np.float64)
    primal_viol = np.maximum(
        np.maximum(cv - hi, lo - cv), 0.0
    ).max(axis=1)
    return primal_viol, dual_res
