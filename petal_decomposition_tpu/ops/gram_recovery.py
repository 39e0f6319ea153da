"""Gram-side randomized-SVD recovery: shared d-space algebra.

The single-pass streamed fits (``models/streaming.py``) reduce the
data to the d×d Gram ``Gc = XcᵀXc`` and then need randomized-SVD
factors back out of it; the in-core Gram range finder
(``parallel/distributed.py``) shares the subspace iteration.  This
module holds that pure algebra:

- :func:`gram_subspace` — the power/subspace iteration ``qr((Gc)^q·Ω)``
  (the Gram-side form of the reference's power iteration,
  pca.rs:708-715, carrying the same σ^(2q+1) spectral filter).
- :func:`randomized_gram_recovery` — the in-core finder's exact
  recovery (B = QᵀXc, pca.rs:681-684) reconstructed from Gc's l×l
  algebra with ZERO passes over the data (the streamed fit cannot
  afford one); σ come out UNSQUARED (see the derivation in the
  docstring), so the recovery keeps thin-SVD semantics rather than the
  κ²-sensitive ``sqrt(eig(Gc))``.
- :func:`flip_components` — the U-free deterministic sign convention
  (largest-|·| entry of each component made non-negative; first
  occurrence wins ties, mirroring pca.rs:815-850's strict ``>`` scan).

The streamed caller has no U and keeps :func:`flip_components`
(documented deviation, models/streaming.py module docstring).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .linalg import eigh_psd_jit_cert, mdot

__all__ = [
    "flip_components",
    "gram_subspace",
    "randomized_gram_recovery",
]


def flip_components(vt):
    """Deterministic per-component signs without U: the largest-|·|
    entry of each component (first occurrence wins ties, mirroring the
    reference's strict ``>`` scan) is made non-negative.

    >>> import numpy as np, jax.numpy as jnp
    >>> vt = jnp.asarray([[0.6, -0.8], [-0.8, 0.6]])
    >>> bool(np.allclose(np.asarray(flip_components(vt)),
    ...                  [[-0.6, 0.8], [0.8, -0.6]]))
    True
    """
    idx = jnp.argmax(jnp.abs(vt), axis=1)
    piv = jnp.take_along_axis(vt, idx[:, None], axis=1)[:, 0]
    signs = jnp.where(piv < 0, -1, 1).astype(vt.dtype)
    return vt * signs[:, None]


def gram_subspace(g_sub, omega, n_power_iters: int):
    """``qr((G)^q · Ω)`` — power iterations on the d×d subspace operator
    (tiny d×d×l matmuls; Householder QR between applications because one
    G application squares the condition number, out of CholeskyQR2's
    κ ≲ 1/√eps envelope).

    >>> import numpy as np, jax.numpy as jnp
    >>> g = jnp.asarray(np.diag([9.0, 4.0, 1.0]).astype(np.float32))
    >>> w = gram_subspace(g, jnp.ones((3, 1), jnp.float32), 8)
    >>> bool(abs(float(jnp.abs(w[0, 0])) - 1.0) < 1e-5)  # top eigvec
    True
    """
    w = omega
    for it in range(n_power_iters):
        with jax.named_scope(f"gram_power_{it}"):
            w = jnp.linalg.qr(mdot(g_sub, w), mode="reduced")[0]
    return w


@partial(jax.jit, static_argnames=("n_power_iters", "cfg"))
def randomized_gram_recovery(gc, omega, *, n_power_iters: int, cfg=None):
    """The in-core finder's EXACT recovery, reconstructed from G alone.

    In core, σ come from the projection ``B = QᵀX`` with
    ``Q = orth(X·W)`` — one extra data pass a single-pass stream cannot
    afford.  But every factor of that recovery lives in the l×l algebra
    of G: with ``M₁ = WᵀGW`` (= (XW)ᵀ(XW)) and ``M₂ = WᵀG²W``
    (= (GW)ᵀ(GW)), the symmetric whitener ``S = M₁^(−1/2)`` makes
    ``Q = X·W·S`` orthonormal and ``B·Bᵀ = S·M₂·S``, so σ² are its
    eigenvalues and the feature-space right vectors are
    ``v_j = G·W·S·z_j / σ_j``.  This carries the in-core recovery's
    σ^(2q+1) spectral filter (a naive Ritz ``WᵀGW`` extraction is one
    X-application behind: measured 0.2% σ gap at q=7 on a flat
    spectrum; this closes it to G-precision).  ``S`` is built by eigh
    with a pseudo-inverse cutoff, so rank-deficient sketches degrade
    to zero σ instead of NaN.

    Returns ``(sigma, vt, off)``: σ descending (length l), component
    rows ``vt`` (l×d, orthonormal, :func:`flip_components` signs), and
    the max eigh convergence certificate of the two l×l solves.
    """
    # Orthonormalize the sketch up front so the extraction is valid
    # even at n_power_iters=0 (``gram_subspace`` re-QRs after every
    # G application).
    w = jnp.linalg.qr(omega, mode="reduced")[0]
    w = gram_subspace(gc, w, n_power_iters)
    gw = mdot(gc, w)  # (d, l)
    m1 = mdot(w.T, gw)
    m1 = (m1 + m1.T) / 2
    m2 = mdot(gw.T, gw)
    m2 = (m2 + m2.T) / 2
    lam1, e1, off1 = eigh_psd_jit_cert(m1)  # ascending
    lam1 = jnp.maximum(lam1, 0)
    cut = lam1[-1] * jnp.finfo(lam1.dtype).eps * m1.shape[0]
    ok = lam1 > cut
    inv_sqrt = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, lam1, 1)), 0)
    s_half = e1 * inv_sqrt[None, :].astype(e1.dtype)  # S = s_half·e1ᵀ
    c = mdot(s_half.T, mdot(m2, s_half))  # e1-basis form of S·M₂·S
    c = (c + c.T) / 2
    lam2, z, off2 = eigh_psd_jit_cert(c)  # ascending
    sigma = jnp.sqrt(jnp.maximum(lam2[::-1], 0))
    inv_sigma = jnp.where(sigma > 0, 1.0 / jnp.where(sigma > 0, sigma, 1), 0)
    # v_j = G·W·S·z_j/σ_j; S·z (in the original basis) = s_half·z.
    v = mdot(gw, mdot(s_half, z[:, ::-1])) * inv_sigma[None, :].astype(
        gw.dtype
    )
    # Re-orthonormalize: in exact arithmetic v is orthonormal, but its
    # float orthogonality degrades with κ(M₁) = κ(XW)² (the in-core
    # path avoids this via Householder QR of XW), and σ-cutoff
    # directions are zero columns.  A final thin QR restores exactly
    # orthonormal component rows — leading (well-separated) directions
    # are untouched, dead directions get an orthonormal completion,
    # matching the in-core eigh behavior on rank-deficient data.
    v = jnp.linalg.qr(v, mode="reduced")[0]
    vt = flip_components(v.T)
    return sigma, vt, jnp.maximum(off1, off2)
