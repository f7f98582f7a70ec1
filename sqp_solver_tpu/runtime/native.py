"""ctypes bindings for the native C++ QP engine (csrc/native_qp.cpp).

The shared library is built lazily with g++ on first use and cached under
``<checkout>/.native_build`` (or ``$SQP_SOLVER_TPU_CACHE``).  It is the
long-double *oracle* of the conformance tests and of bench.py's accuracy
rows — never a solver fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

from sqp_solver_tpu.qp.types import QPSettings

__all__ = ["native_available", "native_qp_solve", "native_qp_solve_batch"]

_SRC = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "native_qp.cpp"
_LIB = None
_BUILD_ERR: Optional[str] = None


class _CSettings(ctypes.Structure):
    _fields_ = [
        ("rho", ctypes.c_double),
        ("sigma", ctypes.c_double),
        ("alpha", ctypes.c_double),
        ("eps_abs", ctypes.c_double),
        ("eps_rel", ctypes.c_double),
        ("adaptive_rho_tolerance", ctypes.c_double),
        ("max_iter", ctypes.c_int32),
        ("check_termination", ctypes.c_int32),
        ("adaptive_rho_interval", ctypes.c_int32),
        ("adaptive_rho", ctypes.c_int32),
    ]


def _to_c_settings(s: QPSettings) -> _CSettings:
    return _CSettings(
        rho=s.rho,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        max_iter=s.max_iter,
        check_termination=s.check_termination,
        adaptive_rho_interval=s.adaptive_rho_interval,
        adaptive_rho=int(s.adaptive_rho),
    )


def _build() -> Optional[ctypes.CDLL]:
    global _BUILD_ERR
    if not _SRC.exists():
        _BUILD_ERR = f"source not found: {_SRC}"
        return None
    cache = pathlib.Path(
        os.environ.get("SQP_SOLVER_TPU_CACHE", _SRC.parent.parent / ".native_build")
    )
    cache.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = cache / f"libnative_qp_{tag}.so"
    if not so.exists():
        # build under a private name and rename: concurrent test workers
        # may build at once, and none may load a half-written library
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            str(_SRC), "-o", str(tmp), "-lpthread",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            _BUILD_ERR = getattr(e, "stderr", str(e))
            return None
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.nq_solve.restype = ctypes.c_int32
    lib.nq_solve.argtypes = [dp, dp, dp, dp, dp, ctypes.c_int32, ctypes.c_int32,
                             ctypes.POINTER(_CSettings), dp, dp, ip]
    lib.nq_solve_batch.restype = None
    lib.nq_solve_batch.argtypes = [dp, dp, dp, dp, dp, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.POINTER(_CSettings), dp, dp, ip, ip,
                                   ctypes.c_int32]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None and _BUILD_ERR is None:
        _LIB = _build()
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def native_qp_solve(
    P, q, A, l, u, settings: QPSettings = QPSettings()
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Solve one QP at long-double precision.  Returns (x, y, status, iters)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_BUILD_ERR}")
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    n, m = q.shape[0], l.shape[0]
    x = np.zeros(n)
    y = np.zeros(m)
    iters = np.zeros(1, np.int32)
    st = _to_c_settings(settings)
    status = lib.nq_solve(
        _dp(P), _dp(q), _dp(A), _dp(l), _dp(u), n, m, ctypes.byref(st),
        _dp(x), _dp(y), iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return x, y, int(status), int(iters[0])


def native_qp_solve_batch(
    P, q, A, l, u, settings: QPSettings = QPSettings(), n_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Solve a batch of QPs on CPU threads.
    Returns (x (B,n), y (B,m), status (B,), iters (B,))."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_BUILD_ERR}")
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    B, n = q.shape
    m = l.shape[1]
    x = np.zeros((B, n))
    y = np.zeros((B, m))
    status = np.zeros(B, np.int32)
    iters = np.zeros(B, np.int32)
    st = _to_c_settings(settings)
    lib.nq_solve_batch(
        _dp(P), _dp(q), _dp(A), _dp(l), _dp(u), n, m, B, ctypes.byref(st),
        _dp(x), _dp(y),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return x, y, status, iters
