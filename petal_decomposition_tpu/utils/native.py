"""ctypes bindings for the native host factorization core.

Mirrors the reference's L1 design — a native linalg layer behind a safe
wrapper (src/linalg/lapack.rs's ``Lapack`` trait) — as a C++ shared
library driven through ctypes.  Used when
``config.linalg_backend == "native"`` and as a cross-validation oracle
in tests.

The library is built on first use (``make -C native``, re-run on every
load so a stale build is replaced); loading is lazy and
failure-tolerant: :func:`available` reports whether the backend can be
used.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

__all__ = [
    "available",
    "jacobi_svd",
    "jacobi_eigh",
    "qr",
    "lu_pl",
    "NativeError",
]

_LIB = None
_LOAD_TRIED = False


class NativeError(RuntimeError):
    pass


def _native_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2] / "native"


def _load():
    global _LIB, _LOAD_TRIED
    if _LIB is not None or _LOAD_TRIED:
        return _LIB
    _LOAD_TRIED = True
    so = _native_dir() / "libpetal_native.so"
    # ``make`` runs every time: it rebuilds a library that is older than
    # the committed source or Makefile (one copied from another host,
    # say) and is a no-op otherwise.
    try:
        subprocess.run(
            ["make", "-C", str(_native_dir())],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    dp = ctypes.POINTER(ctypes.c_double)
    lib.petal_jacobi_svd.argtypes = [
        dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp
    ]
    lib.petal_jacobi_svd.restype = ctypes.c_int
    lib.petal_jacobi_eigh.argtypes = [dp, ctypes.c_int, ctypes.c_int, dp, dp]
    lib.petal_jacobi_eigh.restype = ctypes.c_int
    lib.petal_qr.argtypes = [dp, ctypes.c_int, ctypes.c_int, dp]
    lib.petal_qr.restype = ctypes.c_int
    lib.petal_lu_pl.argtypes = [dp, ctypes.c_int, ctypes.c_int, dp]
    lib.petal_lu_pl.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def jacobi_svd(a: np.ndarray, max_sweeps: int = 0):
    """Thin SVD ``a = U diag(s) Vᵀ`` (f64).  Returns (u, s, vt).
    ``max_sweeps <= 0`` selects the library default budget."""
    lib = _load()
    if lib is None:
        raise NativeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    transposed = m < n
    if transposed:
        a = np.ascontiguousarray(a.T)
        m, n = n, m
    u = np.empty((m, n), np.float64)
    s = np.empty((n,), np.float64)
    vt = np.empty((n, n), np.float64)
    rc = lib.petal_jacobi_svd(
        _ptr(a), m, n, int(max_sweeps), _ptr(u), _ptr(s), _ptr(vt)
    )
    if rc != 0:
        raise NativeError("singular value decomposition did not converge")
    if transposed:
        return vt.T, s, u.T
    return u, s, vt


def jacobi_eigh(a: np.ndarray, max_sweeps: int = 0):
    """Symmetric eigendecomposition, ascending eigenvalues (f64).
    ``max_sweeps <= 0`` selects the library default budget."""
    lib = _load()
    if lib is None:
        raise NativeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.float64)
    n = a.shape[0]
    w = np.empty((n,), np.float64)
    v = np.empty((n, n), np.float64)
    rc = lib.petal_jacobi_eigh(_ptr(a), n, int(max_sweeps), _ptr(w), _ptr(v))
    if rc != 0:
        raise NativeError("eigendecomposition did not converge")
    return w, v


def qr(a: np.ndarray):
    """Economy Q (m × min(m, n)) via Householder reflections (f64)."""
    lib = _load()
    if lib is None:
        raise NativeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    k = min(m, n)
    q = np.empty((m, k), np.float64)
    rc = lib.petal_qr(_ptr(a), m, n, _ptr(q))
    if rc != 0:
        raise NativeError("qr factorization failed")
    return q


def lu_pl(a: np.ndarray):
    """Partial-pivot LU → P·L (m × min(m, n)) (f64)."""
    lib = _load()
    if lib is None:
        raise NativeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    k = min(m, n)
    pl = np.empty((m, k), np.float64)
    rc = lib.petal_lu_pl(_ptr(a), m, n, _ptr(pl))
    if rc != 0:
        raise NativeError("lu factorization failed")
    return pl
