"""Multi-chip scaling: shard the problem batch across a device mesh.

The reference is single-threaded CPU (SURVEY.md §2: no parallelism of any
kind); here the *batch axis* is scaled over a 1-D device mesh with
``jax.sharding`` — individual solves never communicate, so the sharded
batched solve is pure SPMD with zero collectives.  Two entry points:

* ``sharded_*_solve_batch`` — ``shard_map`` over the mesh: each device runs
  the fused vmapped solver on its batch shard.  Explicitly
  communication-free by construction.
* plain ``jit`` + ``shard_batch``-placed inputs also works (XLA propagates
  the sharding through the whole program); shard_map is the guarantee.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _shard_map(f, mesh, in_specs, out_specs):
    # check_vma/check_rep must be off: solver loop carries start as
    # replicated zeros but become batch-varying inside the loop body, which
    # the strict varying-axes checker rejects.  The computation itself is
    # embarrassingly parallel (no collectives), so the check buys nothing.
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )

from sqp_solver_tpu.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu.qp.types import QPResult, QPSettings, QuadraticProblem
from sqp_solver_tpu.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = [
    "make_mesh",
    "shard_batch",
    "sharded_qp_solve_batch",
    "sharded_sqp_solve_batch",
]

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or the given) devices with a 'batch' axis."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=(BATCH_AXIS,))


def _batch_spec(tree, mesh: Mesh):
    """PartitionSpec pytree: shard axis 0 of every array leaf."""
    return jax.tree.map(lambda x: P(BATCH_AXIS, *([None] * (x.ndim - 1))), tree)


def shard_batch(tree, mesh: Mesh):
    """Place a batched pytree with axis 0 sharded over the mesh."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P(BATCH_AXIS, *([None] * (x.ndim - 1))))
        ),
        tree,
    )


def sharded_qp_solve_batch(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    mesh: Optional[Mesh] = None,
    impl: str = "vmap",
) -> QPResult:
    """Batch-of-QPs solve, batch axis sharded over the mesh via shard_map.

    ``impl`` selects the per-device solver tier ("vmap" / "fused") — each
    device runs it on its local shard."""
    mesh = mesh or make_mesh()

    def local(qp_shard):
        return qp_solve_batch(qp_shard, settings, impl=impl)

    spec = _batch_spec(qp, mesh)
    out_spec = jax.tree.map(
        lambda _: P(BATCH_AXIS),
        jax.eval_shape(local, qp),
    )
    fn = _shard_map(local, mesh, (spec,), out_spec)
    return jax.jit(fn)(qp)


def sharded_sqp_solve_batch(
    problem: NonlinearProblem,
    x0: jax.Array,
    lam0: Optional[jax.Array] = None,
    settings: SQPSettings = SQPSettings(),
    mesh: Optional[Mesh] = None,
    impl: str = "vmap",
) -> SQPResult:
    """Batch-of-NLPs solve, batch axis sharded over the mesh.

    The problem's data leaves must be batched (leading B) so each device
    receives its shard; use ``jax.tree.map(lambda a: jnp.broadcast_to(...))``
    to batch shared data.  ``impl="fused"`` runs the production tier
    independently on every device's shard — the parallelism stays
    embarrassingly data-parallel, so kernels and collectives never
    interact.
    """
    mesh = mesh or make_mesh()

    def local(prob_shard, x0_shard, lam0_shard):
        return sqp_solve_batch(prob_shard, x0_shard, lam0_shard, settings, impl=impl)

    if lam0 is None:
        m = problem.num_constr
        lam0 = jax.numpy.zeros((x0.shape[0], m), x0.dtype)

    in_specs = (_batch_spec(problem, mesh), P(BATCH_AXIS, None), P(BATCH_AXIS, None))
    out_shapes = jax.eval_shape(local, problem, x0, lam0)
    B_local = x0.shape[0]

    def _leaf_spec(leaf):
        # most result leaves are batch-leading, but the record_trace ring
        # buffers are (max_iter, B, ...): shard their SECOND axis — a
        # blanket P('batch') would concatenate shards along max_iter and
        # silently garble the trace
        if leaf.ndim >= 2 and leaf.shape[0] != B_local and leaf.shape[1] == B_local:
            return P(None, BATCH_AXIS)
        return P(BATCH_AXIS)

    out_spec = jax.tree.map(_leaf_spec, out_shapes)
    fn = _shard_map(local, mesh, in_specs, out_spec)
    return jax.jit(fn)(problem, x0, lam0)
