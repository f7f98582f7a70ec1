"""Precision-pinned matmul helpers + the solver-wide precision decorator.

On Hopper, XLA's default matmul precision lets f32 contractions run on
the tensor cores in TF32, which keeps ~10 mantissa bits (about three
decimal digits) — fine for neural nets, fatal for a linear-system
solver: the Cholesky/Schur pipeline loses those digits and ADMM stops
converging.  Every contraction on
the solver's critical path goes through these helpers so library
accuracy doesn't depend on global config.

``pin_precision`` wraps a whole solver entry point in
``jax.default_matmul_precision("highest")`` — it must cover USER
callables too (objective/constraint autodiff at default precision
poisons the QP data and line-search merit values), which is why entry
points pin the whole trace rather than only their own contractions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["hdot", "hmat", "pin_precision"]


def hmat(a, b):
    """matmul at HIGHEST precision (full f32, no TF32)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def hdot(a, b):
    """dot at HIGHEST precision (vector-vector / matrix-vector)."""
    return jnp.dot(a, b, precision=lax.Precision.HIGHEST)


def pin_precision(fn):
    """Trace ``fn`` entirely at HIGHEST matmul precision (see module docs)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
