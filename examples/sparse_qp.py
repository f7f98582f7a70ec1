#!/usr/bin/env python
"""Arbitrary unstructured sparsity: BlockSparse operands + matrix-free CG.

The capability the reference reserves for ``Eigen::SimplicialLDLT``
(``include/solvers/qp.hpp:126-129``): the matrix is a static grid of
dense tiles, only nonzero tiles are stored, and the solver runs fully
matrix-free (Jacobi-preconditioned CG on the Schur operator — no Gram,
no factorization, no fill-in).

Run: python examples/sparse_qp.py [--n 2048] [--density 0.05]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np

from _common import example_setup


def main():
    quick = example_setup()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256 if quick else 2048)
    ap.add_argument("--density", type=float, default=0.2 if quick else 0.05)
    ap.add_argument("--bs", type=int, default=32 if quick else 128)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.models.sparse import sparse_qp_pair
    from sqp_solver_tpu.qp import QPSettings, qp_solve

    dense, sparse = sparse_qp_pair(
        n=args.n, m=args.n, bs=args.bs, density=args.density, seed=0,
        dtype=jnp.float32,
    )
    nb, total = sparse.P.nblocks, (args.n // args.bs) ** 2
    print(f"n={args.n}: P holds {nb}/{total} tiles "
          f"({100 * nb / total:.1f}% block density, bs={args.bs})")

    cg = QPSettings(
        linear_solver="cg", eps_abs=1e-4, eps_rel=1e-4, max_iter=2000,
        check_termination=25, adaptive_rho=True,
    )
    solve_sparse = jax.jit(lambda p: qp_solve(p, cg))
    solve_dense = jax.jit(lambda p: qp_solve(p, cg))

    rs = solve_sparse(sparse)
    rd = solve_dense(dense)
    t0 = time.perf_counter()
    rs = solve_sparse(sparse)
    st_s = int(np.asarray(rs.info.status))
    ts = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd = solve_dense(dense)
    st_d = int(np.asarray(rd.info.status))
    td = time.perf_counter() - t0

    gap = float(np.abs(np.asarray(rs.x) - np.asarray(rd.x)).max())
    print(f"sparse-cg : {ts*1e3:7.1f} ms  status={st_s} "
          f"iters={int(np.asarray(rs.info.iter))}")
    print(f"dense-cg  : {td*1e3:7.1f} ms  status={st_d} "
          f"iters={int(np.asarray(rd.info.iter))}")
    print(f"max |x_sparse - x_dense| = {gap:.2e} "
          f"(same operator values, same CG — the representation is the "
          f"only difference)")
    assert st_s == 0 and st_d == 0
    assert gap < 1e-3


if __name__ == "__main__":
    main()
