"""Mixed-precision symmetric-eigendecomposition refinement.

For large f64 symmetric matrices (n > 384 off the CPU,
``ops.linalg.eigh_route``), the XLA-formulated Jacobi loop is
launch-bound (n·sweeps sequential matmuls).  Instead, compute a fast
float32 eigendecomposition and *refine* it to float64 working accuracy
with a few Newton-type
steps built entirely from d×d matmuls (Ogita & Aishima, "Iterative
refinement for symmetric eigenvalue decomposition", Japan J. Indust.
Appl. Math. 2018 — a public algorithm, reimplemented here from the
published equations).

One step, given symmetric ``A`` and approximate eigenvectors ``V``:

    R = I − VᵀV                 (orthonormality defect)
    S = Vᵀ A V                  (near-diagonal)
    λ̃_i = S_ii / (1 − R_ii)     (second-order-accurate eigenvalues)
    E_ij = (S_ij + λ̃_j R_ij) / (λ̃_j − λ̃_i)   for resolved gaps
    E_ij = R_ij / 2                            within clusters / diagonal
    V ← V + V·E

First-order analysis (V = X(I+F), X exact): E ≈ −F, so the error
contracts quadratically while eigenvalue gaps are resolved; pairs
closer than the current error level receive only the symmetric
orthonormality correction R/2 — their eigenvectors mix within the
(near-)degenerate subspace, exactly as LAPACK's ``?syev`` is free to
do (ref: linalg.rs:57's contract is any orthonormal eigenbasis).

This is the off-CPU replacement for the reference's ``?syev``/``?heev``
at large n (ref: src/linalg/lapack.rs:134-184): 3 f64 gemms + 1 update
gemm per step, quadratic convergence from an f32 start (2 steps reach
~n·eps64 residuals).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["eigh_refine", "refined_eigh"]


def _step(a, v, lam_max_guard):
    eye = jnp.eye(v.shape[0], dtype=v.dtype)
    r = eye - jnp.dot(v.T, v, precision="highest")
    s = jnp.dot(
        v.T, jnp.dot(a, v, precision="highest"), precision="highest"
    )
    lam = jnp.diagonal(s) / (1.0 - jnp.diagonal(r))
    num = s + lam[None, :] * r
    denom = lam[None, :] - lam[:, None]
    # Trust-region step.  The Rayleigh quotients λ̃ are second-order
    # accurate (error ~ θ²·spread + n·eps·λmax even from an f32-grade
    # start), so the *gap* λ̃_j − λ̃_i reliably separates two regimes:
    #
    # * gap below the f64 noise floor → a genuine (near-)degenerate
    #   cluster.  Freeze the pair (E_ij = 0): any rotation there is
    #   noise-driven churn that keeps re-mixing the cluster basis and
    #   stalls everyone else's convergence; the eigenvectors may mix
    #   within the cluster subspace anyway (LAPACK ``?syev`` has the
    #   same freedom).
    # * resolvable gap → apply the linearized rotation num/denom,
    #   clamped to ±0.5: pairs the f32 start left badly mixed demand
    #   angles beyond the linearization's validity; the clamp turns
    #   them into a monotone relaxation that locks in within a few
    #   steps, after which convergence is quadratic.
    #
    # The diagonal (denom == 0) gets no rotation; column norms are
    # restored by the Cholesky-QR below.
    gap_tol = (
        16.0 * v.shape[0] * jnp.finfo(v.dtype).eps * lam_max_guard
    )
    e_raw = num / jnp.where(denom == 0, 1.0, denom)
    e = jnp.where(
        jnp.abs(denom) > gap_tol, jnp.clip(e_raw, -0.5, 0.5), 0.0
    )
    v = v + jnp.dot(v, e, precision="highest")
    # The first-order update leaves an O(‖E‖²) orthonormality defect —
    # harmless for resolved gaps (E is tiny) but O(1) when the f32
    # start could not order a tight cluster.  One CholeskyQR round
    # restores orthonormality to working precision (VᵀV ≈ I + O(‖E‖²)
    # keeps the Cholesky perfectly conditioned).
    g = jnp.dot(v.T, v, precision="highest")
    low = jnp.linalg.cholesky(g)
    linv = jax.scipy.linalg.solve_triangular(low, eye, lower=True)
    v = jnp.dot(v, linv.T, precision="highest")
    # Certificate ingredients: off-diagonal coupling relative to the
    # spectral scale, and the orthonormality defect (pre-update).
    off_s = jnp.max(jnp.abs(num - jnp.diag(jnp.diagonal(num))))
    off = jnp.maximum(off_s / lam_max_guard, jnp.max(jnp.abs(r)))
    return v, lam, off


@partial(jax.jit, static_argnames=("steps",))
def eigh_refine(a, lam0, v0, steps: int = 3):
    """Refine ``(lam0, v0) ≈ eigh(a)`` to ``a``'s (f64) precision.

    Returns ``(lam, v, off)`` with eigenvalues ascending; ``lam`` is
    the Rayleigh quotient of the final vectors (fresh, not one step
    stale) and ``off`` the relative residual ``‖AV − VΛ‖∞ / λmax`` —
    the honest LAPACK-``info`` analogue for this route (compare against
    a route tolerance ~1e-9, not the Jacobi off-diagonal tolerance:
    tight clusters refine linearly, not quadratically, and stall near
    1e-11..1e-10 — still far inside the f64 parity band).

    >>> import numpy as np, jax.numpy as jnp
    >>> r = np.random.default_rng(1).normal(size=(32, 32))
    >>> a = jnp.asarray(r @ r.T)
    >>> lam32, v32 = np.linalg.eigh(np.asarray(a, np.float32))
    >>> lam, v, off = eigh_refine(a, lam32, v32)
    >>> ref = np.linalg.eigvalsh(np.asarray(a))
    >>> bool(np.max(np.abs(np.asarray(lam) - ref)
    ...             / np.max(ref)) < 1e-9)
    True
    """
    a = jnp.asarray(a)
    v = jnp.asarray(v0, a.dtype)
    lam = jnp.asarray(lam0, a.dtype)
    lam_max_guard = jnp.maximum(jnp.max(jnp.abs(lam)), jnp.finfo(a.dtype).tiny)
    # fori_loop so XLA compiles ONE step body per matrix size instead
    # of `steps` copies.
    v, lam, _ = jax.lax.fori_loop(
        0,
        max(1, steps),
        lambda _, c: _step(a, c[0], lam_max_guard),
        (v, lam, jnp.asarray(jnp.inf, a.dtype)),
    )
    # Fresh eigenvalues (Rayleigh quotients of the refined, orthonormal
    # vectors) and the final residual certificate.
    av = jnp.dot(a, v, precision="highest")
    lam = jnp.einsum("ij,ij->j", v, av)
    off = jnp.max(jnp.abs(av - v * lam[None, :])) / lam_max_guard
    order = jnp.argsort(lam)
    return jnp.take(lam, order), jnp.take(v, order, axis=1), off


@partial(jax.jit, static_argnames=("steps", "levels"))
def refined_eigh(a, steps: int = 3, levels: int = 2):
    """f32 eigendecomposition + f64 refinement, jit-safe.

    The f32 solve (XLA's eigh) resolves gaps down to
    ~eps32·λmax; the Ogita–Aishima steps then square the error for
    every resolved pair.  Eigenpairs whose |λ| sits orders of magnitude
    below λmax can be *fully mixed* by the f32 start (their gaps are
    invisible at f32), which no first-order correction can untangle —
    so after the full-size refinement, the smallest-|λ| half of the
    basis is **re-solved at its own scale** (``levels`` times,
    halving): project ``A`` onto that invariant-ish subspace, run a
    fresh f32 eigh of the (m×m) projection — whose eps32·‖A₂‖
    resolution improves by λmax/λmax(A₂) — refine it in f64, and rotate
    the block.  Two levels recover ~8 extra decades of spectrum.

    Returns ``(lam, v, off)`` ascending; ``off`` is the final relative
    residual ``‖AV − VΛ‖∞ / λmax``.

    >>> import numpy as np, jax.numpy as jnp
    >>> r = np.random.default_rng(0).normal(size=(48, 48))
    >>> a = jnp.asarray(r @ r.T)  # SPD, f64
    >>> lam, v, off = refined_eigh(a)
    >>> ref = np.linalg.eigvalsh(np.asarray(a))
    >>> bool(np.max(np.abs(np.asarray(lam) - ref)
    ...             / np.max(ref)) < 1e-9)
    True
    >>> bool(off < 1e-9)
    True
    """
    a = jnp.asarray(a)
    n = a.shape[0]
    lam32, v32 = jnp.linalg.eigh(a.astype(jnp.float32))
    lam, v, _ = eigh_refine(a, lam32, v32, steps=steps)
    lam_max_guard = jnp.maximum(
        jnp.max(jnp.abs(lam)), jnp.finfo(a.dtype).tiny
    )
    for level in range(levels):
        m = n >> (level + 1)
        if m < 32:
            break
        # The m smallest-|λ| eigenpairs occupy a contiguous window of
        # the ascending order, centered where the spectrum crosses 0.
        neg = jnp.sum((lam < 0).astype(jnp.int32))
        start = jnp.clip(neg - m // 2, 0, n - m)
        vb = jax.lax.dynamic_slice_in_dim(v, start, m, axis=1)
        avb = jnp.dot(a, vb, precision="highest")
        ab = jnp.dot(vb.T, avb, precision="highest")
        ab = (ab + ab.T) / 2
        lamb32, wb32 = jnp.linalg.eigh(ab.astype(jnp.float32))
        lamb, wb, _ = eigh_refine(ab, lamb32, wb32, steps=steps)
        vb = jnp.dot(vb, wb, precision="highest")
        v = jax.lax.dynamic_update_slice_in_dim(v, vb, start, axis=1)
        lam = jax.lax.dynamic_update_slice_in_dim(lam, lamb, start, axis=0)
    if levels > 0 and (n >> 1) >= 32:
        # Cross-block couplings were contaminated by the (formerly
        # O(1)) within-block mixing; with the blocks now clean, one
        # more full-size pass refines them quadratically.
        return eigh_refine(a, lam, v, steps=2)
    av = jnp.dot(a, v, precision="highest")
    lam = jnp.einsum("ij,ij->j", v, av)
    off = jnp.max(jnp.abs(av - v * lam[None, :])) / lam_max_guard
    order = jnp.argsort(lam)
    return jnp.take(lam, order), jnp.take(v, order, axis=1), off
