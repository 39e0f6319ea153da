"""Centering-fused contractions.

The reference materializes the centered matrix ``X − 1μᵀ`` before every
factorization (pca.rs:216-219, 531; ica.rs:178-188) — an extra n×d
buffer and an extra full HBM pass.  Here the mean is a rank-1
correction that fuses into each matmul algebraically:

    (X − 1μᵀ)·Ω   = X·Ω − 1·(μᵀΩ)
    (X − 1μᵀ)ᵀ·Q  = XᵀQ − μ·(1ᵀQ)
    (X − 1μᵀ)ᵀ(X − 1μᵀ) = XᵀX − n·μμᵀ
    ‖X − 1μᵀ‖²_F  = ‖X‖²_F − n·‖μ‖²

so the data matrix streams from HBM exactly once per contraction and is
never copied.  (Rounding differs from explicit centering at the eps
level; the single-device parity paths keep explicit centering.)

``row_mask`` handles zero-padded rows (uneven sharding): products of the
form X·M pick up ``−μᵀM`` on padded rows from the broadcast term and
must be re-zeroed.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import config
from .linalg import mdot

__all__ = [
    "centered_matmul",
    "centered_rmatmul",
    "centered_gram",
    "gram_acc64",
    "centered_sqnorm",
    "centered_sqnorm_guarded",
]


def _mask_rows(y, n_valid: int | None):
    if n_valid is None or n_valid == y.shape[0]:
        return y
    mask = (jnp.arange(y.shape[0]) < n_valid)[:, None]
    return jnp.where(mask, y, 0)


def centered_matmul(x, m, means, n_valid: int | None = None):
    """``(X − 1μᵀ)·M`` without materializing the centered X.

    >>> import numpy as np, jax.numpy as jnp
    >>> x = jnp.asarray(np.random.default_rng(0).normal(size=(6, 3)))
    >>> m = jnp.asarray(np.random.default_rng(1).normal(size=(3, 2)))
    >>> mu = jnp.mean(x, axis=0)
    >>> bool(np.allclose(centered_matmul(x, m, mu), (x - mu) @ m))
    True
    """
    y = mdot(x, m) - mdot(means, m)[None, :]
    return _mask_rows(y, n_valid)


def centered_rmatmul(x, q, means):
    """``(X − 1μᵀ)ᵀ·Q``.  ``q`` must already be zero on padded rows."""
    return mdot(x.conj().T, q) - jnp.outer(
        jnp.conj(means), jnp.sum(q, axis=0)
    )


# Row chunks of the float32 Gram in :func:`gram_acc64`: at most
# _GRAM_MAX_CHUNKS, none shorter than _GRAM_MIN_CHUNK_ROWS rows, and the
# f32 partials (chunks × d × d) within _GRAM_MAX_PARTIAL_ELEMENTS.
_GRAM_MAX_CHUNKS = 64
_GRAM_MIN_CHUNK_ROWS = 4096
_GRAM_MAX_PARTIAL_ELEMENTS = 1 << 26


def gram_chunks(n: int, d: int) -> int:
    """How many equal row chunks :func:`gram_acc64` splits ``n`` rows
    of width ``d`` into: the largest divisor of ``n`` within the caps,
    preferring multiples of 8 so that a row-sharded input's chunks fall
    whole on each of up to 8 devices.

    >>> gram_chunks(4_000_000, 1024), gram_chunks(1000, 64)
    (64, 1)
    """
    cap = min(
        _GRAM_MAX_CHUNKS,
        n // _GRAM_MIN_CHUNK_ROWS,
        _GRAM_MAX_PARTIAL_ELEMENTS // max(d * d, 1),
    )
    divisors = [c for c in range(1, max(cap, 1) + 1) if n % c == 0]
    return max([c for c in divisors if c % 8 == 0] or divisors)


def gram_acc64(x):
    """``XᴴX`` accumulated over the rows in float64.

    float32 data: the rows split into :func:`gram_chunks` equal chunks,
    each chunk's Gram is one f32 GEMM of a batch, and the partials are
    added in float64 — so the f32 rounding grows with a chunk's rows,
    not with n.  Returns float64 for float32 input; other dtypes get one
    GEMM at their own dtype.  The fits that read σ or the whitening
    straight off the Gram use this: at 4M×1024 on an H100 (80GB HBM3,
    power limit 700 W) one f32 GEMM read σ₁..₃₂ 1.6e-5 off and the
    chunked sum 7.2e-7 (``benchmarks/gram_probe.py``).

    >>> import numpy as np, jax.numpy as jnp
    >>> x = np.random.default_rng(4).normal(size=(8192, 3))
    >>> g = gram_acc64(jnp.asarray(x, jnp.float32))
    >>> g.dtype == jnp.float64, bool(np.allclose(g, x.T @ x, rtol=1e-5))
    (True, True)
    """
    if x.dtype != jnp.float32:
        return mdot(x.conj().T, x)
    n, d = x.shape
    c = gram_chunks(n, d)
    xs = x.reshape(c, n // c, d)
    parts = jnp.einsum("cbi,cbj->cij", xs, xs,
                       precision=config.matmul_precision)
    return jnp.sum(parts.astype(jnp.float64), axis=0)


def centered_gram(x, means, n: int):
    """``(X − 1μᵀ)ᵀ(X − 1μᵀ) = XᵀX − n·μμᵀ`` (padded rows of X are zero
    and contribute nothing to either term), at the data dtype; float32
    data accumulate and center in float64 (:func:`gram_acc64`).

    >>> import numpy as np, jax.numpy as jnp
    >>> x = jnp.asarray(np.random.default_rng(2).normal(size=(8, 3)))
    >>> mu = jnp.mean(x, axis=0)
    >>> xc = x - mu
    >>> bool(np.allclose(centered_gram(x, mu, 8), xc.T @ xc))
    True
    """
    if x.dtype == jnp.float32:
        m = means.astype(jnp.float64)
        return (gram_acc64(x) - n * jnp.outer(m, m)).astype(x.dtype)
    return mdot(x.conj().T, x) - n * jnp.outer(jnp.conj(means), means)


def centered_sqnorm(x, means, n: int):
    """``‖X − 1μᵀ‖²_F = ‖X‖²_F − n·‖μ‖²``.

    >>> import numpy as np, jax.numpy as jnp
    >>> x = jnp.asarray(np.random.default_rng(3).normal(size=(8, 3)))
    >>> mu = jnp.mean(x, axis=0)
    >>> bool(np.allclose(centered_sqnorm(x, mu, 8),
    ...                  np.sum(np.asarray(x - mu) ** 2)))
    True
    """
    return jnp.sum(jnp.abs(x) ** 2) - n * jnp.sum(jnp.abs(means) ** 2)


# Mean-domination guard for the analytic total variance: subtracting
# n·‖μ‖² from ‖X‖²_F loses ~(1 + r) of the input grade at
# r = n·‖μ‖² / ‖Xc‖²_F — measured error ≈ 2·eps·(1 + r) (1.2e-5 at
# r = 87, f32).  The thresholds keep that under the dtype's parity band
# (1e-5 f32 / 1e-10 f64) with ~3× margin; past them the guarded form
# recomputes ‖X − 1μᵀ‖²_F explicitly (one extra data pass, engaged only
# when the data actually is mean-dominated).
_SQNORM_GUARD_RMAX = {"float32": 30.0, "float64": 3e4}


def guarded_sqnorm_from(sq, means, n: int, x, n_valid: int | None = None):
    """Total variance from a precomputed ``sq = ‖X‖²_F``: the analytic
    subtraction when safe, an explicit centered pass past the
    mean-domination threshold (in-graph ``lax.cond``)."""
    import jax

    msq = n * jnp.sum(jnp.abs(means) ** 2)
    tv = sq - msq
    rmax = _SQNORM_GUARD_RMAX[
        "float64" if jnp.real(means).dtype == jnp.float64 else "float32"
    ]
    r = msq / jnp.maximum(jnp.real(tv), jnp.asarray(1e-30, jnp.real(tv).dtype))

    def explicit(_):
        xc = _mask_rows(x - means, n_valid)
        return jnp.sum(jnp.abs(xc) ** 2)

    return jax.lax.cond(r > rmax, explicit, lambda _: tv, None)


def centered_sqnorm_guarded(x, means, n: int, n_valid: int | None = None):
    """``‖X − 1μᵀ‖²_F`` with the mean-domination guard (see
    :func:`guarded_sqnorm_from`)."""
    return guarded_sqnorm_from(
        jnp.sum(jnp.abs(x) ** 2), means, n, x, n_valid
    )
