"""Jacobi SVD and Hermitian eigensolver — the in-house factorization core.

These replace the reference's LAPACK ``?gesvd``/``?gesdd`` (ref:
linalg.rs:70-122 via lapack.rs:103-132, 70-101) and ``?syev``/``?heev``
(ref: linalg.rs:39-60 via lapack.rs:134-184).

One-sided Jacobi converges to full working precision in every dtype,
complex included, and is written as dense matmuls against a (mostly
identity) rotation matrix.  The pair schedule is a static round-robin
tournament, so the whole solve is a fixed-shape
``lax.while_loop(lax.scan(...))`` — fully jittable, no dynamic shapes.
Real f32/f64 inputs off the CPU take the QDWH-SVD route instead
(:func:`svd_route`).

Parallel ordering: the classic chess-tournament (circle method) schedule
runs n/2 disjoint rotations per step and n-1 steps per sweep, touching
every column pair exactly once per sweep.

Two update modes:
  * ``"matmul"``  — build the n×n plane-rotation aggregate J for the step
    and compute ``A @ J`` / ``V @ J``; O(m·n²) per step but one dense
    product.
  * ``"scatter"`` — gather the paired columns, rotate, scatter back;
    O(m·n) per step, better asymptotics for wide matrices.
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config

__all__ = ["jacobi_svd", "jacobi_eigh", "round_robin_pairings", "svd_route"]


@functools.lru_cache(maxsize=None)
def round_robin_pairings(n: int) -> np.ndarray:
    """Static (n-1, n//2, 2) round-robin schedule covering all pairs.

    ``n`` must be even.  Player 0 is fixed; the rest rotate (circle
    method).  Each of the n-1 rounds pairs every index exactly once.
    """
    assert n % 2 == 0 and n >= 2
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append(
            [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        )
        players = [players[0], players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int32)


def _rotation_params(app, aqq, apq, skip_thresh):
    """2x2 Hermitian eigen-rotation parameters, vectorized over pairs.

    Diagonalizes [[app, apq], [conj(apq), aqq]] (app/aqq real ≥ 0).
    Returns real c, s and (complex) phase; the unitary is
    [[c, s·phase], [-s·conj(phase), c]].  Rotations with
    ``|apq| <= skip_thresh`` are skipped (identity), which also guards
    padded zero columns.
    """
    absq = jnp.abs(apq)
    is_complex = jnp.iscomplexobj(apq)
    if is_complex:
        phase = jnp.where(absq > 0, apq / jnp.where(absq > 0, absq, 1), 1.0)
    else:
        phase = jnp.where(apq >= 0, 1.0, -1.0).astype(apq.dtype)
    skip = absq <= skip_thresh
    denom = jnp.where(skip, 1.0, 2.0 * jnp.where(absq > 0, absq, 1))
    tau = (aqq - app) / denom
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0, 1.0, t)  # tau==0, apq!=0 → 45° rotation
    t = jnp.where(skip, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = c * t
    return c, s, phase


def _step_matmul(a, v, p, q, c, s, phase, prec):
    n = a.shape[1]
    cdtype = a.dtype
    j = jnp.zeros((n, n), cdtype)
    c = c.astype(cdtype)
    sp = (s * phase).astype(cdtype)
    snp = (s * jnp.conj(phase)).astype(cdtype)
    j = j.at[p, p].set(c).at[q, q].set(c)
    j = j.at[p, q].set(sp).at[q, p].set(-snp)
    a = jnp.dot(a, j, precision=prec)
    if v is not None:
        v = jnp.dot(v, j, precision=prec)
    return a, v


def _step_scatter(a, v, p, q, c, s, phase):
    cdtype = a.dtype
    c = c.astype(cdtype)
    sp = (s * phase).astype(cdtype)
    snp = (s * jnp.conj(phase)).astype(cdtype)
    ap = jnp.take(a, p, axis=1)
    aq = jnp.take(a, q, axis=1)
    new_p = ap * c - aq * snp
    new_q = ap * sp + aq * c
    a = a.at[:, p].set(new_p).at[:, q].set(new_q)
    if v is not None:
        vp = jnp.take(v, p, axis=1)
        vq = jnp.take(v, q, axis=1)
        v = v.at[:, p].set(vp * c - vq * snp).at[:, q].set(vp * sp + vq * c)
    return a, v


def _offdiag_measure(a, prec):
    """Max off-diagonal of AᴴA relative to the largest column norm² —
    a norm-wise convergence functional.  (A pairwise-relative measure
    stalls on numerically-zero columns, e.g. the rank-deficient
    direction mean-centering creates when n_samples < n_features.)"""
    g = jnp.dot(a.conj().T, a, precision=prec)
    d = jnp.real(jnp.diag(g))
    dmax = jnp.max(d)
    n = a.shape[1]
    offmask = ~jnp.eye(n, dtype=bool)
    absoff = jnp.max(jnp.where(offmask, jnp.abs(g), 0.0))
    return absoff / jnp.where(dmax > 0, dmax, 1)


@partial(jax.jit, static_argnames=("compute_v", "max_sweeps", "update"))
def _jacobi_svd_core(a, *, compute_v: bool, max_sweeps: int, update: str):
    """One-sided Jacobi on the columns of ``a`` (m×n, m ≥ entries any).

    Returns (a_rot, v, off, sweeps): at convergence the columns of
    ``a_rot`` are u_i·σ_i and ``v`` collects the right singular vectors.
    """
    m, n = a.shape
    prec = config.matmul_precision
    real_dtype = jnp.finfo(a.dtype).dtype if not jnp.iscomplexobj(a) else (
        jnp.float32 if a.dtype == jnp.complex64 else jnp.float64
    )
    eps = float(jnp.finfo(real_dtype).eps)
    tol = eps * np.sqrt(max(m, n))

    padded = n % 2 == 1
    if padded:
        a = jnp.pad(a, ((0, 0), (0, 1)))
        n = n + 1

    pairs = jnp.asarray(round_robin_pairings(n))
    v = jnp.eye(n, dtype=a.dtype) if compute_v else None

    def sweep_step(carry, pq):
        a, v = carry
        p, q = pq[:, 0], pq[:, 1]
        ap = jnp.take(a, p, axis=1)
        aq = jnp.take(a, q, axis=1)
        app = jnp.real(jnp.sum(jnp.conj(ap) * ap, axis=0))
        aqq = jnp.real(jnp.sum(jnp.conj(aq) * aq, axis=0))
        apq = jnp.sum(jnp.conj(ap) * aq, axis=0)
        # Per-pair relative threshold (de Rijk): rotate only pairs whose
        # normalized inner product exceeds eps.
        c, s, phase = _rotation_params(
            app, aqq, apq, eps * jnp.sqrt(jnp.abs(app * aqq))
        )
        if update == "matmul":
            a, v = _step_matmul(a, v, p, q, c, s, phase, prec)
        else:
            a, v = _step_scatter(a, v, p, q, c, s, phase)
        return (a, v), None

    def cond(state):
        _, _, off, sweeps = state
        return (off > tol) & (sweeps < max_sweeps)

    def body(state):
        a, v, _, sweeps = state
        (a, v), _ = jax.lax.scan(sweep_step, (a, v), pairs)
        off = _offdiag_measure(a, prec)
        return a, v, off, sweeps + 1

    off0 = jnp.asarray(jnp.inf, real_dtype)
    a, v, off, sweeps = jax.lax.while_loop(
        cond, body, (a, v, off0, jnp.asarray(0, jnp.int32))
    )

    if padded:
        a = a[:, :-1]
        v = v[:-1, :-1] if compute_v else None
    return a, v, off, sweeps


def svd_route(dtype, m: int, n: int) -> str:
    """Which branch :func:`jacobi_svd` takes for an ``m×n`` input
    (``m ≥ n`` after its internal transpose) on the current placement:

    * ``"qdwh"`` — real f32/f64 off the CPU: QDWH-SVD (Nakatsukasa–
      Higham 2013: polar decomposition by QDWH iteration, then eigh of
      the Hermitian factor).  About five iterations of QR/Cholesky plus
      matmuls, backward stable (no Gram κ² squaring), and pure XLA ops,
      so it also partitions under mesh traces.  f32 takes XLA's eigh of
      the Hermitian factor (its ~1e-7 vector accuracy is the f32 noise
      floor); f64 refines an f32 eigh to f64 with the matmul-only
      Ogita–Aishima iteration (``ops/refine.py``).
    * ``"qr+jacobi"`` — large tall inputs elsewhere (complex, or CPU
      under ``linalg_backend="jacobi"``): Householder QR first, so the
      rotation loop works on the n×n R; each of the ~n·sweeps
      sequential steps shrinks from O(m·n) to O(n²) (LAPACK's gesvj
      preconditions the same way).
    * ``"jacobi"`` — the one-sided rotation loop on the input itself;
      small matrices are dispatch-bound, not size-bound.
    """
    from .linalg import effective_platform

    dtype = jnp.dtype(dtype)
    if (
        dtype in (jnp.float32, jnp.float64)
        and effective_platform() != "cpu"
        and n >= 2
    ):
        return "qdwh"
    if m >= 3 * n and m * n >= (1 << 20):
        return "qr+jacobi"
    return "jacobi"


def _qdwh_svd(a, m: int, n: int):
    """Thin SVD via polar decomposition + eigh (f32/f64 real, m ≥ n).

    Returns ``(a_rot_equiv_u_scaled…)`` — to keep the caller's contract
    (columns of ``a_rot`` are uᵢ·σᵢ) we return ``(u·diag(s), v, off)``.
    """
    if m > n:
        q1, r = jnp.linalg.qr(a, mode="reduced")
    else:
        q1, r = None, a
    up, h, _iters, conv = jax.lax.linalg.qdwh(r)
    if a.dtype == jnp.float64:
        from .refine import refined_eigh

        lam, v, off_r = refined_eigh(h)  # ascending, f64-refined
        # Route-appropriate success criterion: the refinement's relative
        # residual ‖HV − VΛ‖∞/λmax reaches ~1e-13 on resolved spectra
        # and stalls near 1e-11..1e-10 on tight clusters (vectors mix
        # within the cluster subspace — LAPACK-equivalent behavior);
        # genuine failures blow past 1e-8 by orders of magnitude.
        ok = conv & (off_r < 1e-8)
    else:
        lam, v = jnp.linalg.eigh(h)  # ascending
        ok = conv
    lam = jnp.maximum(lam[::-1], 0.0)
    v = v[:, ::-1]
    u_small = jnp.dot(up, v, precision=config.matmul_precision)
    u = (
        jnp.dot(q1, u_small, precision=config.matmul_precision)
        if q1 is not None
        else u_small
    )
    a_rot = u * lam[None, :]
    # Certificate: 0 when the route converged, else ∞ (the LAPACK
    # info != 0 analogue).
    off = jnp.where(ok, 0.0, jnp.inf).astype(a.dtype)
    return a_rot, v, off


def jacobi_svd(a, *, compute_v: bool = True, max_sweeps: int | None = None,
               update: str | None = None):
    """Thin SVD via one-sided Jacobi: ``a = U diag(s) Vᴴ``.

    Returns ``(u, s, vt, off, sweeps)`` with u: (m, k), s: (k,) descending,
    vt: (k, n) (or None), k = min(m, n).  ``off`` is the final relative
    off-diagonal (convergence certificate; compare against tolerance to
    detect non-convergence — the LAPACK ``info != 0`` analogue).

    For m < n the problem is transposed internally.
    """
    a = jnp.asarray(a)
    m, n = a.shape
    if max_sweeps is None:
        max_sweeps = config.jacobi_max_sweeps
    if update is None:
        # matmul form is one dense product per step for narrow panels;
        # scatter wins asymptotically for wide ones.
        update = "matmul" if min(m, n) <= 512 else "scatter"

    transposed = m < n
    if transposed:
        a = a.conj().T
        m, n = n, m

    route = svd_route(a.dtype, m, n)
    if route == "qdwh":
        a_rot, v, off = _qdwh_svd(a, m, n)
        sweeps = jnp.asarray(-1, jnp.int32)  # not a sweep count
    elif route == "qr+jacobi":
        q_f, r_f = jnp.linalg.qr(a, mode="reduced")
        r_rot, v, off, sweeps = _jacobi_svd_core(
            r_f, compute_v=True, max_sweeps=max_sweeps, update=update
        )
        a_rot = jnp.dot(q_f, r_rot, precision=config.matmul_precision)
    else:
        a_rot, v, off, sweeps = _jacobi_svd_core(
            a, compute_v=True, max_sweeps=max_sweeps, update=update
        )
    s = jnp.sqrt(jnp.real(jnp.sum(jnp.conj(a_rot) * a_rot, axis=0)))
    order = jnp.argsort(-s)
    s = jnp.take(s, order)
    u = jnp.take(a_rot, order, axis=1) / jnp.where(s > 0, s, 1)
    w = jnp.take(v, order, axis=1)

    if transposed:
        # a_original = (U diag(s) Vᴴ)ᴴ = V diag(s) Uᴴ
        u, w = w, u
    vt = w.conj().T if compute_v else None
    return u, s, vt, off, sweeps


@partial(jax.jit, static_argnames=("max_sweeps", "update"))
def _jacobi_eigh_core(a, *, max_sweeps: int, update: str):
    n = a.shape[0]
    prec = config.matmul_precision
    real_dtype = (
        jnp.float32 if a.dtype in (jnp.complex64, jnp.float32) else jnp.float64
    )
    eps = float(jnp.finfo(real_dtype).eps)
    tol = eps * np.sqrt(n)

    # Enforce exact (Hermitian) symmetry — LAPACK's read-one-triangle
    # semantics.  XLA's ``dot(xᵀ, x)`` is not bitwise symmetric (each
    # entry sums in its own order), and on mean-dominated data the
    # fused centered Gram's asymmetry is amplified by the domination
    # ratio relative to the centered norm (measured: r ≈ 370 ⇒ ~1e-13
    # relative asymmetry).  Two-sided Jacobi cannot reduce the
    # off-diagonal below the input's asymmetry, so without this the
    # sweep loop stalls just above the convergence certificate.
    a = (a + a.conj().T) / 2

    padded = n % 2 == 1
    if padded:
        a = jnp.pad(a, ((0, 1), (0, 1)))
        n = n + 1

    pairs = jnp.asarray(round_robin_pairings(n))
    v = jnp.eye(n, dtype=a.dtype)
    # Absolute skip threshold relative to the matrix norm: per-pair
    # diagonal scaling breaks down for (near-)zero eigenvalues.
    anorm = jnp.maximum(jnp.max(jnp.abs(a)), jnp.asarray(0, real_dtype))

    def sweep_step(carry, pq):
        a, v = carry
        p, q = pq[:, 0], pq[:, 1]
        app = jnp.real(a[p, p])
        aqq = jnp.real(a[q, q])
        apq = a[p, q]
        c, s, phase = _rotation_params(app, aqq, apq, eps * anorm)
        cdtype = a.dtype
        cc = c.astype(cdtype)
        sp = (s * phase).astype(cdtype)
        snp = (s * jnp.conj(phase)).astype(cdtype)
        j = jnp.zeros((n, n), cdtype)
        j = j.at[p, p].set(cc).at[q, q].set(cc)
        j = j.at[p, q].set(sp).at[q, p].set(-snp)
        a = jnp.dot(jnp.dot(j.conj().T, a, precision=prec), j, precision=prec)
        v = jnp.dot(v, j, precision=prec)
        return (a, v), None

    def offdiag(a):
        offmask = ~jnp.eye(n, dtype=bool)
        absoff = jnp.max(jnp.where(offmask, jnp.abs(a), 0.0))
        return absoff / jnp.where(anorm > 0, anorm, 1)

    def cond(state):
        _, _, off, sweeps = state
        return (off > tol) & (sweeps < max_sweeps)

    def body(state):
        a, v, _, sweeps = state
        (a, v), _ = jax.lax.scan(sweep_step, (a, v), pairs)
        return a, v, offdiag(a), sweeps + 1

    off0 = jnp.asarray(jnp.inf, real_dtype)
    a, v, off, sweeps = jax.lax.while_loop(
        cond, body, (a, v, off0, jnp.asarray(0, jnp.int32))
    )

    w = jnp.real(jnp.diag(a))
    if padded:
        w = w[:-1]
        v = v[:-1, :-1]
    order = jnp.argsort(w)  # ascending, matching LAPACK ?syev/?heev
    return jnp.take(w, order), jnp.take(v, order, axis=1), off, sweeps


def jacobi_eigh(a, *, max_sweeps: int | None = None, update: str = "matmul"):
    """Hermitian eigendecomposition via two-sided Jacobi.

    Returns ``(w, v, off, sweeps)`` with eigenvalues ``w`` ascending (the
    LAPACK ``?heev`` convention the reference relies on, linalg.rs:57-59)
    and eigenvectors in the columns of ``v``.
    """
    a = jnp.asarray(a)
    if max_sweeps is None:
        max_sweeps = config.jacobi_max_sweeps
    return _jacobi_eigh_core(a, max_sweeps=max_sweeps, update=update)
