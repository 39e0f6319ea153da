"""Hi/lo-split f32 matmuls for float64 operands ("ds64").

When full f64 accuracy is *not* required — e.g. the middle stage of the
FastICA mixed-precision polish (`models/fast_ica._ica_par_core`), which
only needs to carry the iterate below ~1e-6 before the true-f64
certification stage takes over — each f64 operand can be split into a
(hi, lo) pair of f32 arrays with ``x == hi + lo`` to ~2⁻⁴⁸ relative,
and the product formed from three f32 passes:

    A·B ≈ Ah·Bh + Ah·Bl + Al·Bh        (Al·Bl ~ 2⁻⁴⁸, dropped)

The dominant error is then the f32 *accumulation* of the Ah·Bh pass
along the contraction axis.  Two regimes, at the FastICA polish shape
(k=64, n=100 000, standard-normal data):

* short contraction (k-length, e.g. W·X): plain f32 accumulation —
  normwise error ~1.3e-7;
* long contraction (n-length, e.g. G·Xᵀ): chunk the contraction into
  ``chunk``-sized pieces accumulated in f32 and sum the per-chunk
  partials in f64 — normwise error ~8e-9 at chunk=512.  Unchunked the
  same product reads ~1.3e-5.

"Normwise" = max|Δ| / max|reference| over the product entries; the
per-entry relative metric is meaningless on the near-zero entries of
a random product.  The products must run at ``precision="highest"``
(``ops.linalg.mdot``): a TF32 pass would lose the lo word entirely.
Whether the three f32 passes beat one native f64 product on a GPU is
not measured yet (ROADMAP A4).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from . import linalg as _linalg

__all__ = ["split_f64", "mm_split_f32", "mm_split_chunked_f64"]


def split_f64(x):
    """Split a float64 array into (hi, lo) float32 with x == hi + lo
    exactly in f64 up to the f32 underflow floor.

    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from petal_decomposition_tpu.ops.splitmm import split_f64
    >>> x = jnp.asarray(np.pi, jnp.float64)
    >>> hi, lo = split_f64(x)
    >>> bool(abs(float(hi.astype(jnp.float64) + lo.astype(jnp.float64))
    ...          - float(x)) < 1e-14)
    True
    """
    x = jnp.asarray(x, jnp.float64)
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def mm_split_f32(a64, bh, bl):
    """``a64 @ (bh + bl)`` to ~1.5e-7 normwise, returned in float32.

    ``a64`` is float64 (split internally); ``(bh, bl)`` a pre-split
    right operand (`split_f64`).  Three f32 passes with plain f32
    accumulation — suited to short contractions (the FastICA W·X gemm,
    contraction = k) feeding an elementwise contrast whose own f32
    evaluation already floors the accuracy at ~eps_f32.
    """
    ah, al = split_f64(a64)
    main = _linalg.mdot(ah, bh)
    cross = _linalg.mdot(ah, bl) + _linalg.mdot(al, bh)
    return main + cross


def mm_split_chunked_f64(g32, bh, bl, *, chunk: int = 512):
    """``g32 @ (bh + bl).T`` contracted over the long (last) axis,
    carried in float64, to ~7e-9 normwise at ``chunk=512``.

    ``g32``: (k, n) float32 (exact — e.g. an f32-evaluated contrast);
    ``(bh, bl)``: (k2, n) pre-split f64 right operand.  The main
    ``g32·bhᵀ`` pass is chunked along n: each ``chunk``-length slice
    accumulates in f32 and the per-chunk partials sum in
    f64, bounding the f32 accumulation length by ``chunk`` instead of
    n.  The lo cross term is ~2⁻²⁴ smaller and accumulates unchunked.
    """
    if g32.dtype != jnp.float32:
        # A float64 left operand would silently promote every pass to
        # an f64 gemm — slower than not splitting at all.  The caller
        # owns the f32 evaluation of g (e.g. the contrast of an f32
        # product).
        raise TypeError(f"g32 must be float32, got {g32.dtype}")
    k, n = g32.shape
    k2 = bh.shape[0]
    nb = n // chunk
    prec = _linalg.config.matmul_precision
    if nb >= 2:
        g3 = g32[:, : nb * chunk].reshape(k, nb, chunk)
        b3 = bh[:, : nb * chunk].reshape(k2, nb, chunk)
        # (k, nb, c) × (k2, nb, c) contracted over c, batched over nb.
        parts = lax.dot_general(
            g3, b3, (((2,), (2,)), ((1,), (1,))), precision=prec
        )  # (nb, k, k2)
        main = jnp.sum(parts.astype(jnp.float64), axis=0)
        tail = _linalg.mdot(g32[:, nb * chunk:], bh[:, nb * chunk:].T)
        main = main + tail.astype(jnp.float64)
    else:
        main = _linalg.mdot(g32, bh.T).astype(jnp.float64)
    cross = _linalg.mdot(g32, bl.T)
    return main + cross.astype(jnp.float64)
