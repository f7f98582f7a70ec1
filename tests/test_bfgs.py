"""Damped BFGS tests — reference parity (tests/bfgs_test.cpp)."""

import jax.numpy as jnp
import numpy as np

from sqp_solver_tpu.sqp import bfgs_update


def _is_posdef(B):
    return bool(np.all(np.linalg.eigvalsh(np.asarray(B)) > 0))


class TestBFGS:
    def test_converges_to_constant_hessian(self):
        """Reference Test2D_posdef (tests/bfgs_test.cpp:21-43): recovers
        H=diag(2,1) within 10 rank-2 updates, staying posdef throughout."""
        H = jnp.array([[2.0, 0.0], [0.0, 1.0]])
        B = jnp.eye(2)
        for i in range(10):
            step = jnp.array([np.sin(i), np.cos(i)])
            delta_grad = H @ step
            B = bfgs_update(B, step, delta_grad)
            assert _is_posdef(B)
        np.testing.assert_allclose(np.asarray(B), np.asarray(H), atol=1e-3)

    def test_stays_posdef_under_indefinite_hessian(self):
        """Reference Test2D_indefinite (tests/bfgs_test.cpp:45-65): damping
        keeps B posdef even when the true Hessian is indefinite."""
        H = jnp.array([[2.0, 0.0], [0.0, -1.0]])
        B = jnp.eye(2)
        for i in range(10):
            step = jnp.array([np.sin(i), np.cos(i)])
            delta_grad = H @ step
            B = bfgs_update(B, step, delta_grad)
            assert _is_posdef(B)

    def test_zero_step_is_noop(self):
        """NaN-safety: s=0 must return B unchanged (needed because the
        update sits on the untaken branch of a lax.cond under vmap)."""
        B = jnp.array([[2.0, 0.5], [0.5, 1.0]])
        out = bfgs_update(B, jnp.zeros(2), jnp.zeros(2))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(B))
        assert not np.any(np.isnan(np.asarray(out)))

    def test_small_step_regression(self):
        """Reference TestSmallStep (tests/bfgs_test.cpp:67-83, suspended as
        'issue #13' upstream): tiny step + opposing gradient change must not
        destroy positive definiteness.  Our damped update with safe
        denominators passes where the reference was disabled."""
        B = jnp.array([[418.112, 1213.0], [1213.0, 3522.27]], dtype=jnp.float32)
        step = jnp.array([-1.2659e-06, 1.25816e-06], dtype=jnp.float32)
        y = jnp.array([-0.00963563, -0.00957048], dtype=jnp.float32)
        out = bfgs_update(B, step, y)
        assert not np.any(np.isnan(np.asarray(out)))
        assert _is_posdef(out)

    def test_vmap_batch(self):
        import jax

        H = jnp.array([[2.0, 0.0], [0.0, 1.0]])
        B = jnp.stack([jnp.eye(2)] * 4)
        steps = jnp.array([[np.sin(i), np.cos(i)] for i in range(4)])
        ys = steps @ H.T
        out = jax.vmap(bfgs_update)(B, steps, ys)
        assert out.shape == (4, 2, 2)
        for b in np.asarray(out):
            assert _is_posdef(b)
