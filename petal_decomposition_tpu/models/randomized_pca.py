"""Randomized (Halko) truncated-SVD principal component analysis.

JAX rebuild of the reference's ``RandomizedPca`` /
``RandomizedPcaBuilder`` (ref: pca.rs:317-663) and the private
``randomized_svd`` / ``randomized_range_finder`` pipeline
(ref: pca.rs:665-718).

Reference defaults are preserved and promoted to parameters:

* oversampling k+10 (hardcoded at pca.rs:679) → ``n_oversamples=10``;
* 7 power iterations (hardcoded at pca.rs:680) → ``n_power_iters=7``;
* LU → P·L normalization between power-iteration matmuls
  (pca.rs:709-713) → ``power_iteration_normalizer='lu'``, with ``'qr'``
  (Householder), ``'cholqr2'`` (matmul-only — the choice for row-sharded
  fits, where the k×k Gram is one psum), and ``'none'`` as alternatives;
* total variance is the squared Frobenius norm of the centered data
  (pca.rs:533,537-539), *not* Σσ² — randomized σ are truncated.

The whole pipeline is matmul-dominated: the sketch ``X·Ω``, the 14
power-iteration matmuls, the projection ``Qᵀ·X`` and ``Q·U_B`` are large
dense matmuls; the only factorizations are on (k+10)-wide panels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import config as _config
from ..errors import InvalidInput
from ..ops import linalg as _linalg
from ..ops.linalg import cholesky_qr2, lu_pl, mdot, qr, svd_flip, svddc
from ..utils import rng as rng_util
from . import _common
from .pca import _real_dtype

__all__ = [
    "RandomizedPca",
    "RandomizedPcaBuilder",
    "randomized_svd",
    "randomized_range_finder",
]

_NORMALIZERS = ("lu", "qr", "cholqr2", "none")


def randomized_range_finder(x, size: int, n_iter: int, key,
                            normalizer: str = "lu"):
    """Orthonormal basis approximating range(x) (ref: pca.rs:689-718).

    Gaussian sketch Ω (d × size), Y = X·Ω, then ``n_iter`` power
    iterations alternating Xᵀ·norm(Y) and X·norm(·) with the configured
    normalization, finished with an economy QR.
    """
    if normalizer not in _NORMALIZERS:
        raise ValueError(f"unknown normalizer {normalizer!r}")
    d = x.shape[1]
    omega = rng_util.normal(key, (d, size), x.dtype)
    q = mdot(x, omega)

    def norm(m):
        if normalizer == "lu":
            return lu_pl(m)  # (rows, min) — P·L, ref: pca.rs:709-713
        if normalizer == "qr":
            return qr(m)
        if normalizer == "cholqr2":
            return cholesky_qr2(m)
        return m

    for _ in range(n_iter):
        q = mdot(x.conj().T, norm(q))
        q = mdot(x, norm(q))
    return qr(q)


def randomized_svd(x, n_components: int, key, *, n_oversamples: int = 10,
                   n_power_iters: int = 7,
                   power_iteration_normalizer: str = "lu"):
    """Truncated randomized SVD (ref: pca.rs:665-686).

    Returns ``(u, sigma, vt)`` with l = n_components + n_oversamples
    columns/rows (the caller truncates to k, as the reference does at
    pca.rs:544-547).
    """
    n_random = n_components + n_oversamples  # ref: pca.rs:679
    q = randomized_range_finder(
        x, n_random, n_power_iters, key,
        normalizer=power_iteration_normalizer,
    )
    b = mdot(q.conj().T, x)  # (l, d) — ref: pca.rs:681
    u_b, sigma, vt = svddc(b)  # ref: pca.rs:682
    u = mdot(q, u_b)  # ref: pca.rs:683
    u, vt = svd_flip(u, vt)  # ref: pca.rs:684
    return u, sigma, vt


class RandomizedPca:
    """Halko randomized-SVD PCA (ref: pca.rs:317-551).

    Examples
    --------
    >>> import numpy as np
    >>> from petal_decomposition_tpu import RandomizedPca
    >>> x = np.array([[0., 0.], [3., 4.], [6., 8.]])
    >>> y = RandomizedPca(1, seed=1234567891011121314).fit_transform(x)
    >>> bool(abs(abs(y[0, 0]) - 5.0) < 1e-8)
    True
    """

    def __init__(self, n_components: int, *, seed: int | None = None,
                 key=None, centering: bool = True, n_oversamples: int = 10,
                 n_power_iters: int = 7,
                 power_iteration_normalizer: str = "auto", mesh=None,
                 finder_precision: str = "auto",
                 range_finder: str = "auto",
                 gram_precision: str = "auto"):
        if n_components < 0:
            raise InvalidInput("n_components must be non-negative")
        if power_iteration_normalizer not in ("auto",) + _NORMALIZERS:
            raise ValueError(
                f"unknown normalizer {power_iteration_normalizer!r}"
            )
        self._n_components = int(n_components)
        self._centering = bool(centering)
        self._n_oversamples = int(n_oversamples)
        self._n_power_iters = int(n_power_iters)
        self._mesh = mesh
        # "auto" resolves at fit time (_resolve_normalizer): LU→P·L on
        # CPU — the reference's normalizer, pca.rs:709-713 — and
        # matmul-only CholeskyQR2 on accelerators and meshes, where
        # LU's min(m,n)-step sequential pivoting loop is
        # launch-latency-bound (42 dependent passes over the panel) and
        # would also serialize across shards.
        self._normalizer = power_iteration_normalizer
        if finder_precision not in ("auto", "f32", "full"):
            raise ValueError(f"unknown finder precision {finder_precision!r}")
        if range_finder not in ("auto", "direct", "gram"):
            raise ValueError(f"unknown range finder {range_finder!r}")
        if gram_precision not in ("auto", "default", "high", "highest"):
            raise ValueError(f"unknown gram precision {gram_precision!r}")
        self._range_finder = range_finder
        self._gram_precision = gram_precision
        # Range-finder precision: "auto" runs the sketch/power-iteration
        # gemms of float64 fits in float32 on accelerators (the final
        # projection/SVD stay f64 — quadratic Rayleigh-Ritz recovery
        # keeps ~1e-10 sigma accuracy; see distributed.randomized_pca_fit).
        self._finder_precision = finder_precision
        if key is not None:
            self._key = key
        else:
            # ref: pca.rs:342-359 — explicit u128 seed, else random seed.
            seed = rng_util.random_seed() if seed is None else seed
            self._key = rng_util.key_from_seed(seed)
        self._components = None
        self._means = None
        self._singular = None
        self._total_variance = None
        self._n_samples = 0

    # Constructors mirroring the reference (pca.rs:342-381).
    @classmethod
    def with_seed(cls, n_components: int, seed: int) -> "RandomizedPca":
        return cls(n_components, seed=seed)

    @classmethod
    def with_key(cls, n_components: int, key) -> "RandomizedPca":
        return cls(n_components, key=key)

    # -- accessors (ref: pca.rs:390-419) --------------------------------
    def components(self):
        return self._components

    def mean(self):
        return self._means

    def n_components(self) -> int:
        return self._n_components

    def singular_values(self):
        return self._singular

    def explained_variance_ratio(self):
        """σᵢ²/‖X−μ‖²_F (ref: pca.rs:414-419 with pca.rs:533)."""
        _common.check_fitted(self._singular)
        var = self._singular * self._singular
        return var / self._total_variance

    components_ = property(lambda self: self._components)
    mean_ = property(lambda self: self._means)
    singular_values_ = property(lambda self: self._singular)

    @property
    def explained_variance_ratio_(self):
        return self.explained_variance_ratio()

    @property
    def explained_variance_(self):
        """Per-component variance σᵢ²/(n−1) (sklearn-compatible
        extension; the reference exposes only the ratio,
        pca.rs:100-105)."""
        _common.check_fitted(self._singular)
        denom = max(self._n_samples - 1, 1)
        return (self._singular * self._singular) / denom

    # -- fitting (ref: pca.rs:430-550) ----------------------------------
    def fit(self, x) -> "RandomizedPca":
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x)
        with record_fit(self, x.shape[0], x.shape[1]):
            self._inner_fit(x)
        return self

    def transform(self, x):
        return _common.transform(
            _common.as_matrix(x), self._components, self._means,
            self._centering, mesh=self._mesh,
        )

    def fit_transform(self, x):
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x)
        with record_fit(self, x.shape[0], x.shape[1]):
            u = self._inner_fit(x)
        return _common.transform_with_u(
            u, self._singular_full, self._n_components
        )

    def inverse_transform(self, y):
        return _common.inverse_transform(
            y, self._components, self._means, self._centering,
            mesh=self._mesh,
        )

    def fit_batched(self, blocks,
                    *, block_rows: int | None = None) -> "RandomizedPca":
        """Out-of-core randomized fit from a stream of row blocks (or
        one 2-D array-like sliced host-side, e.g. an ``np.memmap``):
        one pass accumulates the d×d Gram + moments, then the Gram
        range finder's subspace iteration + Rayleigh–Ritz extraction
        run on the accumulated operator — data larger than HBM fits on
        one chip.  Consumes the next PRNG subkey like ``fit``.  No
        reference analogue; accuracy/sign contract in
        :mod:`.streaming`.  Returns ``self``."""
        from . import streaming

        return streaming.stream_fit_randomized(self, blocks,
                                               block_rows=block_rows)

    def transform_batched(self, blocks, *, block_rows: int | None = None):
        """Project a stream block-by-block; returns the stacked (n, k)
        host array."""
        from . import streaming

        return streaming.transform_batched(self, blocks,
                                           block_rows=block_rows)

    def partial_fit(self, x,
                    *, block_rows: int | None = None) -> "RandomizedPca":
        """Incremental out-of-core randomized fit: accumulate ``x``
        into the persistent stream and re-solve (each call consumes the
        next PRNG subkey for its sketch).  Any ``fit``/``fit_batched``
        restarts the stream; accumulator state is process-local (not
        serialized).  Returns ``self``."""
        from . import streaming

        streaming.partial_fit_step(
            self, x, block_rows=block_rows,
            solve=streaming._solve_randomized,
        )
        return self

    def _inner_fit(self, x):
        self._stream = None  # a full fit restarts any partial_fit stream
        # Complex fits on an accelerator run host-side (the
        # reference's c32/c64 support is CPU LAPACK — see
        # _common.complex_host_ctx).
        # An explicit mesh wins: mesh fits are never redirected —
        # but complex on an accelerator mesh is a defined, tested
        # error (see _common.check_mesh_complex).
        if self._mesh is None:
            return _common.run_host_redirected_fit(
                self, x, self._inner_fit_impl
            )
        _common.check_mesh_complex(self._mesh, x.dtype)
        return self._inner_fit_impl(x)

    def _resolve_normalizer(self, x) -> str:
        """Platform-aware ``"auto"``: the default constructor path IS
        the benchmarked path on accelerators."""
        if self._normalizer != "auto":
            return self._normalizer
        if self._mesh is not None:
            return "cholqr2"
        from ..ops.linalg import effective_platform

        return "lu" if effective_platform() == "cpu" else "cholqr2"

    def _inner_fit_impl(self, x):
        k = self._n_components
        _common.check_min_dims(x, k)
        n, d = x.shape

        if n == 0:
            self._singular_full = jnp.zeros((0,), _real_dtype(x.dtype))
            return jnp.zeros((0, d), x.dtype)

        # Successive fits consume successive subkeys — the stateful-RNG
        # contract of the reference (its PCG advances across fits).
        self._key, subkey = jax.random.split(self._key)

        if self._mesh is not None:
            from ..parallel.distributed import randomized_pca_fit
            from ..parallel.mesh import shard_rows_padded

            x_sh, n_true = shard_rows_padded(x, self._mesh)
            # The mesh joins the jit cache key so mesh and single-device
            # traces never alias.
            st = randomized_pca_fit(
                x_sh, subkey,
                n_components=k,
                centering=self._centering,
                n_oversamples=self._n_oversamples,
                n_power_iters=self._n_power_iters,
                normalizer=self._resolve_normalizer(x),
                n_valid=n_true if n_true != x_sh.shape[0] else None,
                finder_precision=self._finder_precision,
                range_finder=self._range_finder,
                gram_precision=self._gram_precision,
                cfg=_config.cache_key() + (self._mesh,),
            )
            u, sigma, vt = st["u"][:n], st["sigma"], st["vt"]
            means = st["means"]
            # Check before mutating: a failed refit must leave a
            # previously fitted model untouched.
            _linalg.check_certificate(
                st["off"], sigma.dtype, d,
                "singular value decomposition",
            )
            self._total_variance = st["total_variance"]
            self._components = vt[:k, :]
            self._n_samples = n
            self._means = means
            self._singular = sigma[:k]
            self._singular_full = sigma
            return u

        # Single-device fit as ONE jitted XLA computation.  On CPU (and
        # for small problems everywhere) the pipeline keeps explicit
        # centering and Householder final QR for reference-parity
        # rounding (the Halko flow is identical to pca.rs:665-718).
        from ..ops.linalg import effective_platform
        from ..parallel.distributed import randomized_pca_fit

        # Large fits on an accelerator take the fast rounding-
        # equivalent route: fused rank-1 centering (no materialized
        # X−μ copy, one less full HBM pass) and matmul-only CholeskyQR2
        # final orthonormalization (Householder QR on a 1M×42 panel is
        # a sequence of dependent panel updates).  Small fits keep the
        # reference-parity rounding — they are launch-latency-bound
        # anyway and the golden-value tests pin their exact outputs.
        accel_fast = (
            effective_platform() != "cpu" and n * d >= (1 << 22)
        )
        final_orth = "cholqr2" if accel_fast else "qr"
        if not accel_fast and effective_platform() != "cpu" and jnp.dtype(
            x.dtype
        ) in (jnp.float64, jnp.complex128):
            # f64 Householder QR chose CholeskyQR2 at every size on the
            # earlier accelerator; not yet re-measured on the GPU.
            final_orth = "cholqr2"
        st = randomized_pca_fit(
            x, subkey,
            n_components=k,
            centering=self._centering,
            n_oversamples=self._n_oversamples,
            n_power_iters=self._n_power_iters,
            normalizer=self._resolve_normalizer(x),
            fuse_centering=accel_fast,
            final_orth=final_orth,
            finder_precision=self._finder_precision,
            range_finder=self._range_finder,
            gram_precision=self._gram_precision,
            cfg=_config.cache_key(),
        )
        u, sigma, vt = st["u"], st["sigma"], st["vt"]
        means = st["means"]
        _linalg.check_certificate(
            st["off"], sigma.dtype, d, "singular value decomposition"
        )
        # Frobenius² of the centered data, NOT σ·σ (ref: pca.rs:533).
        self._total_variance = st["total_variance"]
        self._components = vt[:k, :]
        self._n_samples = n
        self._means = means
        self._singular = sigma[:k]
        self._singular_full = sigma
        return u


class RandomizedPcaBuilder:
    """Builder mirroring ``RandomizedPcaBuilder`` (ref: pca.rs:564-663).

    >>> from petal_decomposition_tpu import RandomizedPcaBuilder
    >>> pca = RandomizedPcaBuilder(1).seed(1234567891011121314).build()
    """

    def __init__(self, n_components: int):
        self._n_components = n_components
        self._seed = None
        self._key = None
        self._centering = True
        self._n_oversamples = 10
        self._n_power_iters = 7
        self._normalizer = "auto"
        self._mesh = None
        self._finder_precision = "auto"
        self._range_finder = "auto"
        self._gram_precision = "auto"

    @classmethod
    def new(cls, n_components: int) -> "RandomizedPcaBuilder":
        return cls(n_components)

    @classmethod
    def with_key(cls, key, n_components: int) -> "RandomizedPcaBuilder":
        b = cls(n_components)
        b._key = key
        return b

    def seed(self, seed: int) -> "RandomizedPcaBuilder":
        self._seed = seed
        return self

    def centering(self, centering: bool) -> "RandomizedPcaBuilder":
        self._centering = centering
        return self

    def n_oversamples(self, n: int) -> "RandomizedPcaBuilder":
        self._n_oversamples = n
        return self

    def n_power_iters(self, n: int) -> "RandomizedPcaBuilder":
        self._n_power_iters = n
        return self

    def power_iteration_normalizer(self, norm: str) -> "RandomizedPcaBuilder":
        self._normalizer = norm
        return self

    def mesh(self, mesh) -> "RandomizedPcaBuilder":
        """Row-shard fits over the given ``jax.sharding.Mesh``."""
        self._mesh = mesh
        return self

    def finder_precision(self, precision: str) -> "RandomizedPcaBuilder":
        """Range-finder precision: ``"auto"`` | ``"f32"`` | ``"full"``
        (see ``distributed.randomized_pca_fit``)."""
        self._finder_precision = precision
        return self

    def range_finder(self, finder: str) -> "RandomizedPcaBuilder":
        """Range-basis construction: ``"auto"`` | ``"direct"`` |
        ``"gram"`` (see ``distributed.randomized_pca_fit``)."""
        self._range_finder = finder
        return self

    def gram_precision(self, precision: str) -> "RandomizedPcaBuilder":
        """Gram-pass matmul precision for the gram range finder and the
        streamed (``fit_batched``/``partial_fit``) accumulation:
        ``"auto"`` | ``"default"`` | ``"high"`` | ``"highest"``.  In-core
        f32 ``"auto"`` is ``"default"`` (the Gram only builds the
        subspace); streamed f32 ``"auto"`` is ``"highest"`` (σ come off
        the Gram at first order).  On the GPU ``"default"`` and
        ``"high"`` run f32 dots in TF32; ``"highest"`` is true f32."""
        self._gram_precision = precision
        return self

    def build(self) -> RandomizedPca:
        return RandomizedPca(
            self._n_components,
            seed=self._seed,
            key=self._key,
            centering=self._centering,
            n_oversamples=self._n_oversamples,
            n_power_iters=self._n_power_iters,
            power_iteration_normalizer=self._normalizer,
            mesh=self._mesh,
            finder_precision=self._finder_precision,
            range_finder=self._range_finder,
            gram_precision=self._gram_precision,
        )
