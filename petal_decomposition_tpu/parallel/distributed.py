"""Row-sharded (distributed) fit pipelines.

Each fit here is ONE jitted XLA computation over a row-sharded data
matrix: GSPMD turns every sample-axis contraction into a local
matmul followed by a ``psum`` over the interconnect, per SURVEY
§2.3's mapping of the reference call stacks to collectives:

* mean over samples       → ``psum(Σ local rows)/n``  (replaces pca.rs:207/521)
* Gram/covariance ``XᵀX`` → local matmul + psum       (replaces pca.rs:216-219)
* sketch ``X·Ω`` / ``XᵀY``→ sharded matmul + psum     (replaces pca.rs:707-714)
* projection ``QᵀX``      → psum                      (replaces pca.rs:681)
* ICA ``G·Xᵀ``            → psum                      (replaces ica.rs:332-342)

The k×k / d×d factorizations (eigh, small SVD) operate on replicated
post-psum matrices.  No hand-written collectives: the sharding
annotations on the inputs are the whole distributed programming model.

Mean-centering is fused as a rank-1 correction into every contraction
(:mod:`..ops.centered`), so the data matrix is never copied and streams
from HBM exactly once per pass — the reference's explicit ``X − μ``
materialization (pca.rs:216,531) costs an extra n×d buffer + pass.
Set ``fuse_centering=False`` for bit-closer agreement with the explicit
paths.

Exact PCA at scale uses the Gram/eigh path: the reference's full
``gesvd`` materializes an m×m U (linalg.rs:85) and cannot scale past one
host's memory; the Gram path never forms anything larger than d×d +
the sharded thin U.  (Accuracy trade: singular values through the Gram
square to ~eps·κ(X)²; the single-device Jacobi path remains the 1e-10
parity route.)

``n_valid`` (static) supports zero-padded rows for uneven sharding:
means divide by the true count and every X·M product is re-zeroed on
padded rows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.centered import (
    centered_gram,
    centered_matmul,
    centered_rmatmul,
    centered_sqnorm_guarded,
    gram_acc64,
)
from ..ops.gram_recovery import gram_subspace as _gram_subspace
from ..ops.linalg import (
    cholesky_qr2,
    eigh_psd_jit_cert,
    lu_pl,
    mdot,
    svd_flip,
    svd_jit_cert,
)
from ..utils import rng as rng_util

__all__ = [
    "pca_fit_gram",
    "randomized_pca_fit",
    "resolve_fit_routes",
    "fast_ica_fit",
]


def _masked_center(x, centering: bool, n_valid: int | None):
    """Explicit (non-fused) centering with padded-row masking."""
    n = x.shape[0] if n_valid is None else n_valid
    if centering:
        means = jnp.sum(x, axis=0) / n  # padded rows are zeros
        xc = x - means
    else:
        means = jnp.zeros((x.shape[1],), x.dtype)
        xc = x
    if n != x.shape[0]:
        mask = (jnp.arange(x.shape[0]) < n)[:, None]
        xc = jnp.where(mask, xc, 0)
    return means, xc


def _contractions(x, centering: bool, n_valid: int | None,
                  fuse_centering: bool):
    """Returns ``(means, xm, xtm, gram, sqnorm)`` closures over the
    centered data, fused or explicit."""
    n = x.shape[0] if n_valid is None else n_valid
    if fuse_centering:
        if centering:
            means = jnp.sum(x, axis=0) / n
        else:
            means = jnp.zeros((x.shape[1],), x.dtype)
        return (
            means,
            lambda m: centered_matmul(x, m, means, n_valid),
            lambda q: centered_rmatmul(x, q, means),
            lambda: centered_gram(x, means, n),
            lambda: centered_sqnorm_guarded(x, means, n, n_valid),
        )
    means, xc = _masked_center(x, centering, n_valid)
    return (
        means,
        lambda m: mdot(xc, m),
        lambda q: mdot(xc.conj().T, q),
        lambda: mdot(xc.conj().T, xc),
        lambda: jnp.sum(jnp.abs(xc) ** 2),
    )


@partial(jax.jit, static_argnames=("centering", "n_valid", "fuse_centering",
                                   "n_components", "cfg"))
def pca_fit_gram(x, *, centering: bool = True, n_valid: int | None = None,
                 fuse_centering: bool = True,
                 n_components: int | None = None, cfg=None):
    """Exact PCA via the covariance eigenproblem.

    ``cfg`` is a jit-cache key only (config snapshot); unused in-body.

    ``C = XᵀX`` (one psum), ``eigh(C)`` replicated, thin
    ``U = X·V·σ⁻¹`` sharded.  Returns the same fields as the SVD path —
    U/σ/Vᵀ reproduce the full-SVD factorization including the
    deterministic ``svd_flip`` signs — except that with
    ``n_components`` (static) U holds only the leading columns a
    ``fit_transform`` reads, and only those Vᵀ rows are sign-flipped:
    the full n×min(n, d) U of a tall fit is as large as the data.
    """
    n = x.shape[0] if n_valid is None else n_valid
    d = x.shape[1]
    means, xm, _, gram, _ = _contractions(
        x, centering, n_valid, fuse_centering
    )
    with jax.named_scope("gram"):
        c = gram()  # (d, d), psum over the sample axis
    if fuse_centering and centering:
        # σ come straight from this Gram: the fused rank-1 centering
        # (XᵀX − n·μμᵀ) loses ~(1 + r) of the input grade at
        # r = n‖μ‖²/tr(C).  Unlike the range finder (where the Gram
        # only builds a subspace and recovery is quadratically
        # insensitive), the exact path reads σ² off this matrix, so it
        # uses the tight per-dtype thresholds of the total-variance
        # guard (measured: r ≈ 6.7e3 already costs 3.6e-4 relative σ
        # error at f32 `highest`); past them, rebuild from an
        # explicitly centered copy.
        from ..ops.centered import _SQNORM_GUARD_RMAX

        tr = jnp.real(jnp.trace(c))
        r = n * jnp.sum(jnp.abs(means) ** 2) / jnp.maximum(
            tr, jnp.asarray(1e-30, tr.dtype)
        )
        rmax = _SQNORM_GUARD_RMAX[
            "float64" if tr.dtype == jnp.float64 else "float32"
        ]

        def explicit(_):
            xc = _masked_center(x, centering, n_valid)[1]
            return gram_acc64(xc).astype(x.dtype)

        c = jax.lax.cond(r > rmax, explicit, lambda _: c, None)
    with jax.named_scope("eigh"):
        lam, v, off = eigh_psd_jit_cert(c)  # ascending
    lam = lam[::-1]
    v = v[:, ::-1]
    sigma = jnp.sqrt(jnp.maximum(lam, 0))
    inv_sigma = jnp.where(sigma > 0, 1.0 / jnp.where(sigma > 0, sigma, 1), 0)
    k_full = min(n, d)
    k_u = k_full if n_components is None else min(max(n_components, 1),
                                                  k_full)
    # Sharded thin U; svd_flip signs the first k_u rows of Vᵀ.
    u = xm(v[:, :k_u]) * inv_sigma[:k_u].astype(x.dtype)[None, :]
    u, vt = svd_flip(u, v.conj().T)
    return {
        "u": u,
        "sigma": sigma[:k_full],
        "vt": vt[:k_full, :],
        "means": means,
        "total_variance": jnp.sum(sigma * sigma),
        # Convergence certificate of the d×d eigensolve; checked
        # host-side by the caller (LAPACK info != 0 analogue).
        "off": off,
    }


def _resolve_range_finder(range_finder: str, dtype, n: int, d: int,
                          l: int, *, full_f64: bool = False) -> str:
    """``"auto"`` picks the Gram finder on accelerators when the sketch
    is much narrower than the data (l ≤ d/4) and the data is tall
    (n ≥ 4d and ≥ 32k rows) — the regime where one compute-dense XᵀX
    pass replaces the 2·n_power_iters streaming passes of the direct
    finder.  CPU (reference parity) and complex dtypes stay direct.

    ``full_f64`` (finder runs at f64, i.e. f64 data with
    ``finder_precision="full"``) also stays direct: the d²-deep Gram
    costs ~d/(3l) times the direct finder's flops at the slow f64 rate,
    so the Gram trade only pays when the finder drops to f32 (the
    mixed path)."""
    if range_finder != "auto":
        if range_finder == "gram" and jnp.issubdtype(
            jnp.dtype(dtype), jnp.complexfloating
        ):
            raise ValueError(
                "range_finder='gram' supports real dtypes only"
            )
        return range_finder
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        return "direct"
    if full_f64:
        return "direct"
    from ..ops.linalg import effective_platform

    if effective_platform() == "cpu":
        return "direct"
    if l >= 1 and l <= d // 4 and n >= 4 * d and n >= 32768:
        return "gram"
    return "direct"


# Mean-cancellation guard thresholds per Gram precision: the fused
# uncentered Gram subtracts n·μμᵀ, losing ~(1 + r) of its input grade
# where r = n‖μ‖²/tr(Gc); beyond these ratios the subspace operator is
# recomputed from an explicitly centered copy (3 HBM passes, engaged
# only when the data actually is mean-dominated).  The "default" value
# was rated for one bf16 pass; the GPU runs "default" and "high" f32
# dots in TF32 (10 mantissa bits, like bf16's 8 a lossy grade), and
# the values have not been re-derived for it.
_GRAM_GUARD_RMAX = {"default": 2.0, "high": 1e3, "highest": 1e5}


def _gram_of(xc, precision: str):
    """``XᵀX`` at the requested matmul precision (f32/f64 input).  On
    the GPU an f32 dot at ``"default"`` or ``"high"`` runs in TF32;
    only ``"highest"`` is a true f32 GEMM."""
    return jnp.dot(xc.conj().T, xc, precision=precision)


def _gram_moments(x, centering: bool, n_valid: int | None,
                  fuse_centering: bool, gram_precision: str, n: int):
    """``(means, G_centered, total_variance)`` for the Gram range finder
    (real f32/f64 data; padded rows must be zero).

    The three reductions (Gram at ``gram_precision``, column sums,
    ‖X‖²_F) are written as siblings over one buffer, so XLA can
    multi-output-fuse the two elementwise reductions into one extra
    pass beside the Gram's read.  GSPMD shards all three under a mesh.

    With fused centering the centered Gram is formed as
    ``XᵀX − n·μμᵀ``, which loses ~(1 + r) of the Gram's input grade at
    r = n‖μ‖²/tr(Gc); past the per-precision threshold the subspace
    operator is recomputed from an explicitly centered copy
    (``lax.cond`` — extra passes only when the data is mean-dominated).
    """
    rmax = _GRAM_GUARD_RMAX[gram_precision]

    def _guarded(g_raw, means):
        g_sub = g_raw - n * jnp.outer(jnp.conj(means), means)
        if not centering:
            return g_sub
        r = n * jnp.sum(jnp.abs(means) ** 2) / jnp.maximum(
            jnp.trace(g_sub), jnp.asarray(1e-30, g_sub.dtype)
        )

        def explicit(_):
            xc = _masked_center(x, centering, n_valid)[1]
            return _gram_of(xc, gram_precision)

        return jax.lax.cond(r > rmax, explicit, lambda _: g_sub, None)

    if fuse_centering:
        d = x.shape[1]
        if centering:
            means = jnp.sum(x, axis=0) / n
        else:
            means = jnp.zeros((d,), x.dtype)
        tv = centered_sqnorm_guarded(x, means, n, n_valid)
        with jax.named_scope("gram"):
            g_raw = _gram_of(x, gram_precision)
        return means, _guarded(g_raw, means), tv
    means, xc = _masked_center(x, centering, n_valid)
    tv = jnp.sum(jnp.abs(xc) ** 2)
    with jax.named_scope("gram"):
        g_sub = _gram_of(xc, gram_precision)
    return means, g_sub, tv


def resolve_fit_routes(dtype, n: int, d: int, l: int, *,
                       finder_precision: str = "auto",
                       range_finder: str = "auto",
                       gram_precision: str = "auto") -> dict:
    """The routes :func:`randomized_pca_fit` takes for an ``n×d`` input
    of ``dtype`` with an ``l``-wide sketch on the current placement —
    its ``"auto"`` settings resolved: ``finder_precision`` (``"f32"``
    means the mixed f64 finder), ``range_finder`` and
    ``gram_precision``."""
    from ..ops.linalg import effective_platform

    dtype = jnp.dtype(dtype)
    if finder_precision == "auto":
        finder_precision = (
            "f32"
            if dtype == jnp.float64 and effective_platform() != "cpu"
            else "full"
        )
    # Mixed mode is float64-only: casting complex data to float32
    # would silently discard the imaginary half of the sketch.
    mixed = finder_precision == "f32" and dtype == jnp.float64
    range_finder = _resolve_range_finder(
        range_finder, dtype, n, d, l,
        full_f64=dtype == jnp.float64 and not mixed,
    )
    if gram_precision == "auto":
        gram_precision = "highest" if mixed else "default"
    return {
        "finder_precision": "f32" if mixed else "full",
        "range_finder": range_finder,
        "gram_precision": gram_precision,
    }


@partial(
    jax.jit,
    static_argnames=(
        "n_components",
        "centering",
        "n_oversamples",
        "n_power_iters",
        "normalizer",
        "n_valid",
        "fuse_centering",
        "final_orth",
        "finder_precision",
        "range_finder",
        "gram_precision",
        "cfg",
    ),
)
def randomized_pca_fit(x, key, *, n_components: int, centering: bool = True,
                       n_oversamples: int = 10, n_power_iters: int = 7,
                       normalizer: str = "cholqr2",
                       n_valid: int | None = None,
                       fuse_centering: bool = True,
                       final_orth: str = "auto",
                       finder_precision: str = "full",
                       range_finder: str = "direct",
                       gram_precision: str = "auto", cfg=None):
    """Halko randomized SVD as one sharded XLA computation.

    Mirrors the single-device pipeline (pca.rs:665-718) with the
    matmul-only CholeskyQR2 as the default normalizer: the only
    cross-shard dependencies per power iteration are two psums of
    (k+10)-wide Gram matrices.  With fused centering the
    n×d data streams from HBM exactly ``2·n_power_iters + 2`` times and
    is never copied.

    ``finder_precision`` (static): precision of the *range finder* (the
    sketch + power-iteration gemms, 15 of the pipeline's 16 passes over
    the data):

    * ``"full"``  — everything at the data dtype (reference-faithful).
    * ``"f32"``   — the finder runs in float32; the final
      orthonormalization, projection ``B = QᴴX``, SVD of B, and
      ``U = Q·U_B`` recovery stay at the data dtype.  The finder only
      constructs a subspace; Rayleigh–Ritz recovery makes the singular
      values *quadratically* insensitive to its error (sin²θ ≈ 1e-12
      for an f32-grade basis), so f64 fits keep ~1e-10 σ accuracy while
      the finder's gemms run at the f32 rate.  Requires |x| within
      float32 range.
    * ``"auto"``  — ``"f32"`` for float64 data on an accelerator
      backend, ``"full"`` otherwise (CPU LAPACK-grade f64 gemms are
      already fast; complex stays full).

    ``range_finder`` (static): how the orthonormal range basis Q is
    constructed:

    * ``"direct"`` — the reference's streaming power iteration
      (pca.rs:689-718): 2·n_power_iters + 1 full passes over the data.
    * ``"gram"``   — one compute-dense pass builds ``G = XᵀX``; the
      power iterations then run on the d×d operator (tiny d×d×l
      matmuls, zero data passes) and one more pass forms
      ``Y = X·qr(GᑫΩ)``.  Identical subspace — ``range(X(XᵀX)ᑫΩ)`` —
      in ~3 data passes instead of 2q+2.  The recovery (``B = QᴴX``,
      SVD of B) still projects against the EXACT data, so singular
      values are quadratically insensitive to Gram-precision error.
      The column sums and ‖X‖²_F ride the Gram pass as XLA-sibling-
      fused reductions (see :func:`_gram_moments`).
    * ``"auto"``  — see :func:`_resolve_range_finder`.

    ``gram_precision`` (static): matmul precision of the Gram pass
    (``"default"``, ``"high"``, ``"highest"``; on the GPU the first two
    run f32 in TF32).  ``"auto"`` = ``"default"`` for f32 data (subspace-
    grade only; guarded — see ``_GRAM_GUARD_RMAX``) and ``"highest"``
    for the float64 mixed finder (keeps the f32-grade basis the 1e-10
    σ-accuracy argument needs).
    """
    n = x.shape[0] if n_valid is None else n_valid
    d = x.shape[1]
    means, xm, xtm, _, sqnorm = _contractions(
        x, centering, n_valid, fuse_centering
    )
    l = min(n_components + n_oversamples, n, d)
    routes = resolve_fit_routes(
        x.dtype, n, d, l, finder_precision=finder_precision,
        range_finder=range_finder, gram_precision=gram_precision,
    )
    mixed = routes["finder_precision"] == "f32"
    range_finder = routes["range_finder"]
    gram_precision = routes["gram_precision"]
    tv = None  # total variance; None → sqnorm() pass at the end

    def norm(m):
        if normalizer == "lu":
            return lu_pl(m)
        if normalizer == "qr":
            return jnp.linalg.qr(m, mode="reduced")[0]
        if normalizer == "cholqr2":
            return cholesky_qr2(m)
        return m

    omega = rng_util.normal(key, (d, l), x.dtype)
    if mixed:
        f32 = jnp.float32
        with jax.named_scope("downcast_center"):
            # One pass: read x, write the centered f32 copy the finder
            # iterates on (padded rows re-zeroed).
            xc32 = x.astype(f32) - means.astype(f32) if centering else (
                x.astype(f32)
            )
            if n_valid is not None:
                mask = (jnp.arange(x.shape[0]) < n_valid)[:, None]
                xc32 = jnp.where(mask, xc32, 0)
        if range_finder == "gram":
            with jax.named_scope("gram"):
                g_sub = _gram_of(xc32, gram_precision)
            w = _gram_subspace(g_sub, omega.astype(f32), n_power_iters)
            with jax.named_scope("sketch"):
                q = mdot(xc32, w)
        else:
            with jax.named_scope("sketch"):
                q = mdot(xc32, omega.astype(f32))  # (n, l) sharded
            for it in range(n_power_iters):
                with jax.named_scope(f"power_iter_{it}"):
                    q = mdot(xc32.conj().T, norm(q))  # (d, l) replicated
                    q = mdot(xc32, norm(q))  # (n, l) sharded
        q = q.astype(x.dtype)
    elif range_finder == "gram":
        means, g_sub, tv = _gram_moments(
            x, centering, n_valid, fuse_centering, gram_precision, n
        )
        w = _gram_subspace(g_sub, omega, n_power_iters)
        with jax.named_scope("sketch"):
            # Works for every centering/fusion combination: means are
            # exact and zero when centering is off.
            q = centered_matmul(x, w, means, n_valid)
    else:
        with jax.named_scope("sketch"):
            q = xm(omega)  # (n, l) sharded
        for it in range(n_power_iters):
            with jax.named_scope(f"power_iter_{it}"):
                q = xtm(norm(q))  # (d, l) replicated (psum)
                q = xm(norm(q))  # (n, l) sharded
    # Final orthonormalization: Householder QR matches the reference's
    # economy-QR semantics (linalg.rs:127-147); CholeskyQR2 is the
    # matmul-only choice for sharded fits.  Always at the data dtype.
    if final_orth == "auto":
        final_orth = "qr" if normalizer == "qr" else "cholqr2"
    with jax.named_scope("orthonormalize"):
        q = jnp.linalg.qr(q, mode="reduced")[0] if final_orth == "qr" else (
            cholesky_qr2(q)
        )
    if range_finder == "gram" and not mixed:
        # Projection with the gram-branch means (identical values).
        with jax.named_scope("project"):
            b = centered_rmatmul(x, q, means).conj().T
    else:
        with jax.named_scope("project"):
            b = xtm(q).conj().T  # (l, d) replicated: Qᴴ·Xc via one psum
    with jax.named_scope("svd_b"):
        u_b, sigma, vt, off = svd_jit_cert(b)
    with jax.named_scope("recover_u"):
        u = mdot(q, u_b)  # (n, l) sharded
    u, vt = svd_flip(u, vt)
    return {
        "u": u,
        "sigma": sigma,
        "vt": vt,
        "means": means,
        "total_variance": sqnorm() if tv is None else tv,
        # Certificate of the (k+10)×d projected SVD (the pipeline's only
        # iterative factorization); checked host-side by the caller.
        "off": off,
    }


@partial(jax.jit, static_argnames=("fun", "max_iter", "n_valid",
                                   "fuse_centering", "n_components",
                                   "whiten",
                                   "decorrelation", "precision", "cfg"))
def fast_ica_fit(x, key, *, fun: str = "logcosh", tol: float = 1e-4,
                 max_iter: int = 200, n_valid: int | None = None,
                 fuse_centering: bool = True,
                 n_components: int | None = None,
                 whiten: bool = True,
                 decorrelation: str = "eigh",
                 precision: str = "full", cfg=None):
    """FastICA with Gram/eigh whitening as one sharded XLA computation.

    Whitening reduces over samples once (d×d psum); each ``ica_par``
    step reduces the k×n whitened data against Gᵀ (psum) and solves the
    replicated k×k decorrelation eigenproblem on every device.

    ``whiten=False`` (static): the caller certifies pre-centered,
    pre-whitened data — no centering, no whitening solve; ``ica_par``
    runs on the sharded Xᵀ directly and ``components`` is the square
    unmixing W (sklearn semantics; see ``FastIca._fit_no_whiten``).
    """
    from ..models._common import real_dtype as _real_dtype_of
    from ..models.fast_ica import _ica_par_core

    n = x.shape[0] if n_valid is None else n_valid
    d = x.shape[1]
    if not whiten:
        real = _real_dtype_of(x.dtype)
        w_init = rng_util.normal(key, (d, d), x.dtype)
        with jax.named_scope("ica_par"):
            w, lim, n_iter = _ica_par_core(
                x.T, jnp.asarray(tol, real), max_iter, w_init, fun,
                n_valid=n_valid, decorrelation=decorrelation,
                precision=precision, cfg=cfg,
            )
        from ..models.fast_ica import decorrelation_certificate

        return {
            "components": w,
            "means": jnp.zeros((d,), real),
            "n_iter": n_iter,
            "lim": lim,
            "off": jnp.zeros((), real),
            "w_orth_err": decorrelation_certificate(w),
        }
    k = min(n, d) if n_components is None else min(n_components, n, d)
    means, xm, _, gram, _ = _contractions(x, True, n_valid, fuse_centering)
    with jax.named_scope("whiten_gram"):
        c = gram()  # (d, d) psum
    with jax.named_scope("whiten_eigh"):
        lam, v, whiten_off = eigh_psd_jit_cert(c)
    lam = lam[::-1][:k]
    v_k = v[:, ::-1][:, :k]
    sigma = jnp.sqrt(jnp.maximum(lam, 0))
    # Relative cutoff: degenerate directions whiten to zero (same
    # √-scaled rank tolerance as models.fast_ica._whitening_matrix —
    # a linear max(n, d) factor over-prunes f32 fits at large n).
    cutoff = sigma[0] * jnp.finfo(sigma.dtype).eps * max(
        10.0, 4.0 * max(n, d) ** 0.5
    )
    ok = sigma > cutoff
    inv_sigma = jnp.where(ok, 1.0 / jnp.where(ok, sigma, 1), 0)
    kmat = (v_k * inv_sigma.astype(v_k.dtype)[None, :]).T  # (k, d) replicated
    # X₁ = K·Xᵀ·√n, computed sharded-first: (X·V·σ⁻¹)ᵀ·√n
    y1 = xm(v_k) * inv_sigma.astype(x.dtype)[None, :]
    x1 = (y1 * jnp.sqrt(jnp.asarray(n, x.dtype))).T  # (k, n) col-sharded

    w_init = rng_util.normal(key, (k, k), x.dtype)
    with jax.named_scope("ica_par"):
        w, lim, n_iter = _ica_par_core(
            x1, jnp.asarray(tol, _real_dtype_of(x.dtype)), max_iter,
            w_init, fun,
            n_valid=n_valid,
            decorrelation=decorrelation, precision=precision, cfg=cfg,
        )
    components = mdot(w, kmat)  # (k, d) replicated
    # Decorrelation certificate (projector test — see
    # models.fast_ica.decorrelation_certificate): W·Wᴴ must satisfy
    # G² = G, allowing dead directions when rank(X) < k; per-iteration
    # k×k eigensolves inside the while_loop cannot surface individual
    # certificates, but any failure shows up here.
    from ..models.fast_ica import decorrelation_certificate

    w_orth_err = decorrelation_certificate(w)
    return {
        "components": components,
        "means": means,
        "n_iter": n_iter,
        "lim": lim,
        "off": whiten_off,
        "w_orth_err": w_orth_err,
    }
