"""Linalg abstraction layer — the analogue of the reference's L2.

The reference wraps raw LAPACK behind safe functions ``eigh`` / ``svd`` /
``svddc`` / ``qr`` (ref: src/linalg.rs:39-147).  Here the same surface
dispatches between two interchangeable implementations:

* the in-house solvers (:mod:`.jacobi`, :mod:`.refine`) — Jacobi
  rotations at full working precision (the f64 1e-10 parity band) and
  QDWH-SVD for real dtypes off the CPU (:func:`.jacobi.svd_route`);
* XLA's built-in lowerings — LAPACK on the CPU, cuSOLVER on the GPU.

Semantic notes vs the reference:

* ``svd`` returns the *thin* factorization.  The reference's ``gesvd``
  materializes a full m×m U (linalg.rs:85) but every consumer only reads
  the first min(m,n) columns (``transform_with_u`` slices ``[:, :k]``,
  pca.rs:772; ``svd_flip`` pairs U columns with Vᵀ rows, stopping at
  min(m,n), pca.rs:819) — thin U preserves all user-visible outputs and
  is the only scalable choice on an accelerator.
* ``qr`` matches reference semantics (economy Q, linalg.rs:127-147) but
  not its LQ-of-transpose sign convention; Q is used strictly as an
  orthonormal range basis so any column-sign/rotation difference cancels
  in ``QᵀX`` / ``Q·U_B``.
* ``lu_pl`` reproduces the ``lair`` LU → P·L normalization used between
  the Halko power iterations (ref: pca.rs:709-713) as a pure-JAX
  partial-pivot elimination.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..errors import LinalgError
from .jacobi import jacobi_eigh, jacobi_svd, svd_route

__all__ = [
    "svd",
    "svddc",
    "eigh",
    "qr",
    "cholesky_qr2",
    "lu_pl",
    "svd_flip",
    "mdot",
]


def mdot(a, b):
    """Matmul at the configured precision (default ``highest``: keeps f32
    matmuls in true f32 — a GPU's default f32 dot runs in TF32, which
    keeps about three decimal digits).

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import mdot
    >>> a = np.arange(6.0).reshape(2, 3)
    >>> bool(np.allclose(np.asarray(mdot(a, a.T)), a @ a.T))
    True
    """
    return jnp.dot(a, b, precision=config.matmul_precision)


def _is_high_precision_dtype(dtype) -> bool:
    return jnp.dtype(dtype) in (jnp.float64, jnp.complex128)


def effective_platform() -> str:
    """The platform computations are actually placed on: honors an
    active ``jax.default_device`` override — the complex→host redirect
    runs under ``jax.default_device(cpu)`` while ``default_backend()``
    still reports the accelerator — before falling back to the backend
    default.  The override may be a Device or a platform-name string
    (``jax.default_device("cpu")`` is legal)."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def _use_jacobi(dtype) -> bool:
    backend = config.linalg_backend
    if backend == "jacobi":
        return True
    if backend == "xla":
        return False
    if jnp.dtype(dtype) == jnp.complex128:
        # The complex→host redirect exists precisely to reach host
        # LAPACK (the reference's own c64 backend, lapack.rs:207-210);
        # on an actual CPU placement use it.  Accelerator placements
        # (explicit mesh, complex_device='default') keep the
        # complex-capable Jacobi formulation.
        return effective_platform() != "cpu"
    if _is_high_precision_dtype(dtype):
        return True  # f64: in-house routes meet the 1e-10 parity band
    # f32/c64 SVD off the CPU goes through jacobi_svd (QDWH-SVD for
    # f32 — jacobi.svd_route); whether cuSOLVER's gesvd would serve
    # better on the GPU is unmeasured.  CPU — including the
    # complex→host redirect — keeps LAPACK.
    return effective_platform() != "cpu"


def svd_branch(dtype, m: int, n: int) -> str:
    """Which branch :func:`svd` and :func:`svd_jit_cert` take for an
    ``m×n`` input on the current placement: ``"xla"``
    (``jnp.linalg.svd``) or one of :func:`.jacobi.svd_route`'s."""
    if not _use_jacobi(dtype):
        return "xla"
    return svd_route(dtype, max(m, n), min(m, n))


def _check_converged(off, tol: float, what: str) -> None:
    # ``not (off <= tol)`` so a NaN certificate FAILS the check — a NaN
    # off-diagonal means the factorization itself produced non-finite
    # values (LAPACK info != 0 analogue; ref: linalg.rs:84, 115).
    if config.check_convergence and not (float(off) <= tol):
        raise LinalgError(f"{what} did not converge")


def convergence_tol(dtype, dim: int) -> float:
    """Host-side tolerance for a Jacobi off-diagonal certificate.

    The 2^-45 floor (f64 only; f32's own bound is larger) dates from an
    emulated-f64 route and is kept so that f64 certificates pass or
    fail exactly as before.
    """
    return max(float(jnp.finfo(dtype).eps) * 4, 2.0 ** -45) * (dim ** 0.5)


def check_certificate(off, dtype, dim: int, what: str) -> None:
    """Raise ``LinalgError`` when a convergence certificate exceeds its
    tolerance — the LAPACK ``info != 0`` analogue (ref: linalg.rs:84,115),
    applied post-fit to certificates threaded out of jitted pipelines."""
    _check_converged(off, convergence_tol(dtype, dim), what)


def eigh_route(dtype, n: int) -> str:
    """Which branch :func:`eigh_jit_cert` takes for an ``n×n`` input on
    the current placement:

    * ``"refined"`` — f64 with n > 384 off the CPU: f32 eigh refined to
      f64 by the matmul-only Ogita–Aishima iteration
      (``ops/refine.py``), ~1e-13 relative residuals; the XLA rotation
      loop is n·sweeps sequential matmuls and impractical at that size.
    * ``"jacobi"`` — two-sided Jacobi in XLA (f64 up to n = 384, c128
      off the CPU, or ``linalg_backend="jacobi"``): exact, but
      launch-bound.
    * ``"xla"`` — ``jnp.linalg.eigh`` (LAPACK on the CPU, cuSOLVER on
      the GPU).

    The 384 bound is inherited and not yet measured on the GPU.
    """
    dtype = jnp.dtype(dtype)
    backend = config.linalg_backend
    if (
        backend == "auto"
        and dtype == jnp.float64
        and n > 384
        and effective_platform() != "cpu"
    ):
        return "refined"
    if backend != "xla" and (
        backend == "jacobi"
        or dtype == jnp.float64
        # c128 on an actual CPU placement (the complex→host redirect)
        # takes LAPACK — the reference's own backend.
        or (dtype == jnp.complex128 and effective_platform() != "cpu")
    ):
        return "jacobi"
    return "xla"


def eigh_jit_cert(a):
    """Backend-dispatched eigh safe to call under ``jit``; returns
    ``(w, v, off)`` where ``off`` is the convergence certificate (final
    relative off-diagonal; 0 for direct backends).  Dispatch is by
    dtype and size (:func:`eigh_route`), both trace-time constants.
    Used inside fully-jitted pipelines (ICA iteration, distributed
    fits), whose callers check the certificate host-side afterwards
    (:func:`check_certificate`)."""
    route = eigh_route(a.dtype, a.shape[0])
    if route == "refined":
        from .refine import refined_eigh

        w, v, off_r = refined_eigh(a)
        off = jnp.where(off_r < 1e-8, 0.0, jnp.inf).astype(a.dtype)
        return w, v, off
    if route == "jacobi":
        w, v, off, _ = jacobi_eigh(a)
        return w, v, off
    w, v = jnp.linalg.eigh(a)
    return w, v, jnp.zeros((), jnp.real(w).dtype)


def eigh_jit(a):
    """:func:`eigh_jit_cert` without the certificate."""
    w, v, _ = eigh_jit_cert(a)
    return w, v


def eigh_psd_jit_cert(a):
    """Eigendecomposition of a *positive-semidefinite* symmetric matrix,
    jit-safe, ascending eigenvalues; returns ``(w, v, off)`` with the
    convergence certificate.  Every internal eigh in this library
    (W·Wᵀ decorrelation, Gram whitening, covariance PCA) is PSD; all
    of them dispatch as :func:`eigh_jit_cert` does."""
    return eigh_jit_cert(a)


def eigh_psd_jit(a):
    """:func:`eigh_psd_jit_cert` without the certificate."""
    w, v, _ = eigh_psd_jit_cert(a)
    return w, v


def svd_jit(a, compute_vt: bool = True):
    """Backend-dispatched thin SVD safe to call under ``jit`` (no host
    convergence check)."""
    if _use_jacobi(a.dtype):
        u, s, vt, _, _ = jacobi_svd(a, compute_v=True)
    else:
        u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    return (u, s, vt) if compute_vt else (u, s, None)


def svd_jit_cert(a):
    """Like :func:`svd_jit` but also returns the convergence certificate
    (final relative off-diagonal; 0 for direct backends), so a fully
    jitted fit can surface non-convergence as ``LinalgError`` with one
    host check afterwards."""
    if _use_jacobi(a.dtype):
        u, s, vt, off, _ = jacobi_svd(a, compute_v=True)
        return u, s, vt, off
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    return u, s, vt, jnp.zeros((), s.dtype)


def native_call(fn, a):
    """Run a native factorization under the configured sweep budget,
    mapping ``NativeError`` into the reference error taxonomy — the
    LAPACK ``info != 0`` analogue (linalg.rs:84): every backend
    surfaces non-convergence as ``LinalgError``.

    Since 0.4.0 the native core runs at ``config.jacobi_max_sweeps``
    (default 30) like every other backend — a deliberate unification
    from its previous fixed 60 (cyclic Jacobi converges quadratically,
    typically in < 15 sweeps; the in-house kernels have run at 30
    since round 1 with no observed failure).  Raise the config knob if
    an adversarial input ever trips it."""
    from ..errors import LinalgError
    from ..utils.native import NativeError

    try:
        return fn(a, max_sweeps=config.jacobi_max_sweeps)
    except NativeError as e:
        raise LinalgError(str(e)) from None


def _use_native(dtype, shape=None) -> bool:
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        return False  # native core is real-valued; Jacobi handles complex
    if config.linalg_backend == "native":
        from ..utils import native

        return native.available()
    if (
        config.linalg_backend == "auto"
        and shape is not None
        and config.host_offload_max_elements > 0
        and int(np.prod(shape)) <= config.host_offload_max_elements
        and effective_platform() != "cpu"
    ):
        # Tiny problem on an accelerator: dispatch latency dominates —
        # the host-native core (the reference's own architecture) wins.
        from ..utils import native

        return native.available()
    return False


def svd(a, compute_vt: bool = True):
    """Thin SVD ``a = U diag(s) Vᵀ`` (reference ``svd``/gesvd,
    linalg.rs:70-91).

    Returns ``(u, s, vt)`` with u: (m, k), s: (k,) descending, vt: (k, n)
    or ``None``; k = min(m, n).

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import svd
    >>> a = np.random.default_rng(0).standard_normal((40, 6))
    >>> u, s, vt = svd(a)
    >>> u.shape, s.shape, vt.shape
    ((40, 6), (6,), (6, 6))
    >>> bool(np.all(np.diff(np.asarray(s)) <= 0))  # descending
    True
    >>> rec = np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt)
    >>> bool(np.max(np.abs(rec - a)) < 1e-10)
    True
    """
    a = jnp.asarray(a)
    if not isinstance(a, jax.core.Tracer) and _use_native(a.dtype, a.shape):
        from ..utils import native

        u, s, vt = native_call(native.jacobi_svd, np.asarray(a))
        real = jnp.finfo(a.dtype).dtype
        u = jnp.asarray(u, a.dtype)
        s = jnp.asarray(s, real)
        vt = jnp.asarray(vt, a.dtype) if compute_vt else None
        return u, s, vt
    if _use_jacobi(a.dtype):
        u, s, vt, off, _ = jacobi_svd(a, compute_v=True)
        check_certificate(
            off, s.dtype, max(a.shape), "singular value decomposition"
        )
    else:
        u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    if not compute_vt:
        vt = None
    return u, s, vt


def svddc(a):
    """Economy SVD of a small projected matrix (reference ``svddc``/gesdd,
    linalg.rs:101-122).  Same contract as :func:`svd` but always returns
    vt.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import svddc
    >>> _, s, vt = svddc(np.diag([3.0, 2.0, 1.0]))
    >>> np.asarray(np.round(s, 10)).tolist()
    [3.0, 2.0, 1.0]
    >>> vt.shape
    (3, 3)
    """
    return svd(a, compute_vt=True)


def eigh(a):
    """Hermitian eigendecomposition with *ascending* eigenvalues — the
    LAPACK ``?syev``/``?heev`` convention (reference linalg.rs:39-60).

    Returns ``(w, v)``; eigenvectors are the columns of ``v``.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import eigh
    >>> w, v = eigh(np.array([[2.0, 1.0], [1.0, 2.0]]))
    >>> np.asarray(np.round(w, 10)).tolist()  # ascending
    [1.0, 3.0]
    >>> bool(np.allclose(np.asarray(v).T @ np.asarray(v), np.eye(2)))
    True
    """
    a = jnp.asarray(a)
    if not isinstance(a, jax.core.Tracer) and _use_native(a.dtype, a.shape):
        from ..utils import native

        w, v = native_call(native.jacobi_eigh, np.asarray(a))
        return (
            jnp.asarray(w, jnp.finfo(a.dtype).dtype),
            jnp.asarray(v, a.dtype),
        )
    if _use_jacobi(a.dtype):
        w, v, off, _ = jacobi_eigh(a)
        tol = float(jnp.finfo(w.dtype).eps) * (a.shape[0] ** 0.5) * 4
        _check_converged(off, tol, "eigendecomposition")
        return w, v
    return jnp.linalg.eigh(a)


def qr(a):
    """Economy QR: orthonormal basis of range(a) (reference linalg.rs:127-147,
    which computes it via LQ of the transpose).  Returns Q of shape
    (m, min(m, n)).

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import qr
    >>> q = qr(np.random.default_rng(1).standard_normal((20, 4)))
    >>> q.shape
    (20, 4)
    >>> bool(np.allclose(np.asarray(q).T @ np.asarray(q), np.eye(4)))
    True
    """
    q, _ = jnp.linalg.qr(jnp.asarray(a), mode="reduced")
    return q


def cholesky_qr2(a):
    """Tall-skinny orthonormalization via CholeskyQR2 — the matmul-only QR.

    Two rounds of ``Q = A·chol(AᵀA)⁻ᵀ``; all FLOPs are dense matmuls and the
    only cross-row dependence is the k×k Gram matrix, which becomes a
    single ``psum`` under row sharding.  Orthonormal to working precision
    for cond(A) ≲ 1/√eps, which holds for every use here (the inputs are
    LU/QR-normalized power-iteration panels).

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import cholesky_qr2
    >>> q = cholesky_qr2(np.random.default_rng(2).standard_normal((64, 5)))
    >>> bool(np.max(np.abs(
    ...     np.asarray(q).T @ np.asarray(q) - np.eye(5))) < 1e-12)
    True
    """
    a = jnp.asarray(a)

    def one_round(x):
        g = mdot(x.conj().T, x)
        eye = jnp.eye(g.shape[0], dtype=g.dtype)
        # Tiny diagonal lift guards exactly rank-deficient panels.  The
        # floor is applied to the LIFT (not just the scale): for an
        # all-zero panel (a 1-sample fit's centered panel) eps·scale is
        # 0, and cholesky(0) → 1/0 → NaN.  1e-30 also stays above the
        # f32 exponent range's underflow.
        scale = jnp.real(jnp.trace(g)) / g.shape[0]
        lift = jnp.maximum(jnp.finfo(g.dtype).eps * scale, 1e-30)
        low = jnp.linalg.cholesky(g + lift * eye)  # G = L·Lᴴ
        # Escalating shift (shifted CholeskyQR, Fukaya et al.): the
        # computed Gram of a rank-deficient panel carries matmul error
        # far beyond eps-level (a rank-3 20000×6 panel's Gram has shown
        # a −4.5e-4 eigenvalue against λmax 1.5e6), which makes G+lift
        # indefinite and XLA's Cholesky emits NaNs.  Retry once with a
        # √u·trace shift that dominates any such error; it zeroes the
        # (unresolvable anyway) null directions, matching LAPACK QR's
        # arbitrary-completion semantics, and is only engaged when the
        # first factorization actually failed, so well-conditioned
        # panels — e.g. the 1M-row f32 flagship normalizer — never see
        # the large shift.
        u = max(float(jnp.finfo(g.dtype).eps), 2.0 ** -48)
        big = jnp.maximum(
            (u ** 0.5) * jnp.real(jnp.trace(g)), 1e-30
        )
        bad = jnp.any(jnp.isnan(low))
        low = jnp.where(bad, jnp.linalg.cholesky(g + big * eye), low)
        # Q = X·L⁻ᴴ via a k×k triangular inverse + one dense matmul
        # instead of a triangular solve against n right-hand sides;
        # L⁻¹'s rounding is absorbed by the second round.
        linv = jax.scipy.linalg.solve_triangular(
            low, eye, lower=True
        )
        return mdot(x, linv.conj().T)

    return one_round(one_round(a))


@partial(jax.jit)
def _lu_pl_core(a):
    m, n = a.shape
    k = min(m, n)
    perm = jnp.arange(m)
    rows = jnp.arange(m)
    cols = jnp.arange(n)

    def body(j, carry):
        a, perm = carry
        col = a[:, j]
        mag = jnp.where(rows >= j, jnp.abs(col), -jnp.inf)
        piv = jnp.argmax(mag)
        # Swap rows j and piv (in both the matrix and the permutation).
        rj, rp = a[j, :], a[piv, :]
        a = a.at[j, :].set(rp).at[piv, :].set(rj)
        pj, pp = perm[j], perm[piv]
        perm = perm.at[j].set(pp).at[piv].set(pj)
        pivot = a[j, j]
        safe = jnp.where(pivot == 0, 1, pivot)
        factors = jnp.where(rows > j, a[:, j] / safe, 0)
        # Update only the trailing columns; columns < j hold stored L
        # multipliers and must not be touched.
        urow = jnp.where(cols >= j, a[j, :], 0)
        a = a - jnp.outer(factors, urow)
        # Record the multipliers (L entries) in the lower triangle of col j.
        a = a.at[:, j].set(jnp.where(rows > j, factors, a[:, j]))
        return a, perm

    a, perm = jax.lax.fori_loop(0, k, body, (a, perm))
    # L: unit lower-triangular (m × k), in pivoted row order.
    lower = jnp.tril(a[:, :k], k=-1)
    l = lower + jnp.eye(m, k, dtype=a.dtype)
    # P·L scatters L's rows back to their original positions: row perm[i]
    # of the product is row i of L.
    pl = jnp.zeros_like(l).at[perm, :].set(l)
    return pl


def lu_pl(a):
    """Partial-pivot LU, returning the ``P·L`` factor (m × min(m, n)).

    Reproduces ``lair::decomposition::lu::Factorized::into_pl`` as used by
    the Halko power-iteration normalizer (ref: pca.rs:709-713): ``P·L`` is
    unit-lower-triangular up to a row permutation, providing a cheap
    well-conditioned basis for the iterated range.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import lu_pl
    >>> pl = np.asarray(lu_pl(
    ...     np.random.default_rng(3).standard_normal((30, 4))))
    >>> pl.shape
    (30, 4)
    >>> bool(np.max(np.abs(pl)) <= 1.0 + 1e-12)  # partial pivoting
    True
    """
    return _lu_pl_core(jnp.asarray(a))


@partial(jax.jit)
def svd_flip(u, vt):
    """Deterministic SVD signs (exact port of the reference convention,
    pca.rs:815-850).

    For each column i of ``u`` (paired with row i of ``vt``): find the
    entry of maximum absolute value — *first* occurrence wins ties, as in
    the reference's strict ``>`` scan — and if its real part is negative
    (or, when the real part is exactly zero, its imaginary part is
    negative), negate u's column and vt's row.

    >>> import numpy as np
    >>> from petal_decomposition_tpu.ops.linalg import svd_flip
    >>> u = np.array([[-0.8], [0.6]]); vt = np.array([[1.0, 2.0]])
    >>> uf, vtf = svd_flip(u, vt)  # pivot -0.8 is negative: both flip
    >>> np.asarray(uf).ravel().tolist(), np.asarray(vtf).ravel().tolist()
    ([0.8, -0.6], [-1.0, -2.0])
    """
    k = min(u.shape[1], vt.shape[0])
    ucols = u[:, :k]
    idx = jnp.argmax(jnp.abs(ucols), axis=0)  # first max, like the ref scan
    pivots = jnp.take_along_axis(ucols, idx[None, :], axis=0)[0]
    re = jnp.real(pivots)
    im = jnp.imag(pivots) if jnp.iscomplexobj(pivots) else jnp.zeros_like(re)
    # Rust f64::signum: +1 for +0.0; the reference flips only when the
    # signum is negative.
    basis = jnp.where(re == 0, im, re)
    signs = jnp.where(basis < 0, -1.0, 1.0).astype(u.dtype)
    u = u.at[:, :k].multiply(signs[None, :])
    vt = vt.at[:k, :].multiply(signs[:, None])
    return u, vt
