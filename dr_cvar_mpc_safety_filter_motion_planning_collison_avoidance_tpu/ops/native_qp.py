"""ctypes bindings for the native C++ QP solver (native/qp_solver.cpp).

The hot path runs the batched JAX IPM on the GPU (ops/qp_ipm.py); this
module exposes the compiled host solver -- the engine's native
counterpart of the reference's outsourced ECOS/OSQP C solvers
(reference environment.yml:31-33) -- for:
  * CVXPY-free cross-checking of the JAX solver in tests,
  * host-side solves where no accelerator is available.

The shared library is built on demand with `make` (g++); build products
live in native/build/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libqp_oracle.so")

_lib = None


class NativeQPSolution(NamedTuple):
    z: np.ndarray
    lam: np.ndarray
    gap: float
    prim_res: float
    dual_res: float
    iterations: int
    converged: bool


def build_library(force: bool = False) -> str:
    """Compile the shared library if missing or stale; returns its path.

    Staleness is checked against the C++ source's mtime so tests never
    validate against an outdated binary (the build tree is untracked;
    the .so is always produced from source on this host).
    """
    src = os.path.join(_NATIVE_DIR, "qp_solver.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))
    if force or stale:
        subprocess.run(["make", "-B", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.qp_solve.restype = ctypes.c_int
        dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.qp_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, dptr, dptr, dptr, dptr,
            ctypes.c_int, ctypes.c_double, dptr, dptr, dptr,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """True if the native library can be built/loaded on this host."""
    try:
        _load()
        return True
    except Exception:
        return False


def solve_qp_native(P, q, G, h, max_iters: int = 60,
                    tol: float = 1e-9) -> NativeQPSolution:
    """Solve min 0.5 z'Pz + q'z s.t. Gz <= h with the C++ solver."""
    lib = _load()
    P = np.ascontiguousarray(P, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    G = np.ascontiguousarray(G, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    n = q.shape[0]
    m = h.shape[0]
    assert P.shape == (n, n) and G.shape == (m, n)

    z = np.zeros(n)
    lam = np.zeros(m)
    info = np.zeros(4)
    status = lib.qp_solve(n, m, P, q, G, h, max_iters, tol, z, lam, info)
    return NativeQPSolution(
        z=z, lam=lam, gap=float(info[0]), prim_res=float(info[1]),
        dual_res=float(info[2]), iterations=int(info[3]),
        converged=status == 0)
