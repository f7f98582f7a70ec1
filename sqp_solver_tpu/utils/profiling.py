"""Profiling / observability helpers (SURVEY.md §5: the reference has only
iteration counters; here: wall-clock timing that respects async dispatch,
device trace capture, and solve-statistics summaries)."""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict

import jax
import numpy as np

__all__ = ["time_solve", "trace", "summarize_info"]


def time_solve(fn: Callable, *args, reps: int = 3, **kwargs):
    """Time a jitted solve end-to-end (compile excluded, completion by
    ``block_until_ready``).  Returns (best_seconds, last_result)."""
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile around a block (view with TensorBoard or
    xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def summarize_info(info) -> Dict[str, Any]:
    """Batch solve diagnostics -> a compact dict (status histogram,
    iteration percentiles, residual percentiles)."""
    out: Dict[str, Any] = {}
    status = np.atleast_1d(np.asarray(info.status))
    out["n"] = int(status.size)
    vals, counts = np.unique(status, return_counts=True)
    out["status_counts"] = {int(v): int(c) for v, c in zip(vals, counts)}
    out["solved_frac"] = float(np.mean(status == 0))
    iters = np.atleast_1d(np.asarray(info.iter))
    out["iter_p50"] = float(np.percentile(iters, 50))
    out["iter_p99"] = float(np.percentile(iters, 99))
    for field in ("res_prim", "res_dual", "primal_step_norm", "dual_step_norm"):
        if hasattr(info, field):
            v = np.atleast_1d(np.asarray(getattr(info, field), np.float64))
            out[f"{field}_p50"] = float(np.percentile(v, 50))
    return out
