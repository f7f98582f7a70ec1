"""Machine-learning QP families end-to-end: lasso, huber, SVM, portfolio.

The OSQP-paper benchmark classes (models/families.py) solved as batched
dense QPs in f32 with Ruiz equilibration + active-set polish — the
combination that reaches ~1e-6 accuracy at f32 on badly-scaled data
(huber stalls at ~1e-2 without it).

Run: python examples/ml_qp_families.py   (CPU or GPU)
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from _common import example_setup
from sqp_solver_tpu.models.families import (
    huber_qp_batch,
    lasso_qp_batch,
    portfolio_qp_batch,
    svm_qp_batch,
)
from sqp_solver_tpu.parallel.batch import qp_solve_batch
from sqp_solver_tpu.qp import QPSettings, QPStatus


def main():
    quick = example_setup()  # smoke-mode flag
    settings = QPSettings(
        eps_abs=1e-4,
        eps_rel=1e-4,
        max_iter=500 if quick else 2000,
        adaptive_rho=True,
        scaling=10,  # Ruiz equilibration (OSQP default; reference lacks it)
        polish=True,  # active-set re-solve with ideal-operator refinement
    )
    B = 16 if quick else 64
    fams = [
        ("lasso", lambda: lasso_qp_batch(B, n_features=12, n_samples=24, seed=0)),
        ("huber", lambda: huber_qp_batch(B, n_features=12, n_samples=24, seed=1)),
        ("svm", lambda: svm_qp_batch(B, n_features=12, n_samples=24, seed=2)),
        ("portfolio", lambda: portfolio_qp_batch(B, n_assets=24, n_factors=6, seed=3)),
    ]
    for name, gen in fams:
        problem, meta = gen()
        solve = jax.jit(lambda p: qp_solve_batch(p, settings, impl="fused"))
        res = solve(problem)
        np.asarray(res.x)  # force completion
        t0 = time.perf_counter()
        res = solve(problem)
        x = np.asarray(res.x)
        dt = time.perf_counter() - t0
        status = np.asarray(res.info.status)
        print(
            f"{name:9s}: B={B} nz={problem.P.shape[-1]:3d} m={problem.A.shape[-2]:3d} "
            f"solved={np.mean(status == QPStatus.SOLVED):.3f} "
            f"res_prim={np.max(np.asarray(res.info.res_prim)):.2e} "
            f"time={dt*1e3:.1f}ms"
        )
        if name == "lasso":
            nf = meta["n_features"]
            sparsity = np.mean(np.abs(x[:, :nf]) < 1e-5)
            print(f"           lasso sparsity: {sparsity:.2f} of coefficients at zero")


if __name__ == "__main__":
    main()
