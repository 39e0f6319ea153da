"""Exact (full-SVD) principal component analysis.

JAX rebuild of the reference's ``Pca``/``PcaBuilder``
(ref: pca.rs:41-283).  The fit is a pure function over jax arrays — mean
centering, thin SVD (in-house routes off the CPU), deterministic sign
flip, component extraction — wrapped in a small stateful class that
mirrors the reference API surface exactly:

``fit`` / ``transform`` / ``fit_transform`` / ``inverse_transform``,
``components()``, ``mean()``, ``n_components()``, ``singular_values()``,
``explained_variance_ratio()`` (ref: pca.rs:78-184).
"""

from __future__ import annotations

import jax.numpy as jnp

from functools import partial

import jax

from ..config import config
from ..errors import InvalidInput, LinalgError
from ..ops import linalg as _linalg
from ..ops.linalg import svd_flip, svd_jit_cert
from . import _common

__all__ = ["Pca", "PcaBuilder"]

# Widest f32 data that ``solver="auto"`` keeps on the direct SVD off the
# CPU.  The bound is that of a retired single-block Jacobi kernel
# (its 400,000-element padded-panel budget), kept so that routing stays
# as it was until the GPU's own crossover is measured.
_DIRECT_SVD_MAX_D = 632


@partial(jax.jit, static_argnames=("centering", "n_valid", "cfg"))
def _fit_exact(x, *, centering: bool, n_valid: int | None = None, cfg=None):
    """Whole exact-SVD fit as one XLA computation: centering, thin SVD
    (:func:`~..ops.linalg.svd_jit_cert`), deterministic sign flip, total
    variance.  A single
    device dispatch instead of one per op — the Rust pipeline's
    inner_fit (pca.rs:195-231) as one compiled program.  ``cfg`` is a
    jit-cache key (config snapshot), unused in-body.

    ``n_valid`` (static): true row count when ``x`` carries zero-padded
    trailing rows for even sharding.  Means divide by the true count and
    padded rows are re-zeroed after centering, so σ/Vᵀ/total variance
    match the unpadded fit exactly (zero rows add only zero singular
    values) and the caller truncates U back to ``n_valid`` rows."""
    n, d = x.shape
    n_eff = n if n_valid is None else n_valid
    if centering:
        # Padded rows are zeros, so the plain column sum is already the
        # sum over true rows.
        means = jnp.sum(x, axis=0) / n_eff
        xc = x - means
    else:
        means = jnp.zeros((d,), x.dtype)
        xc = x
    if n_valid is not None:
        mask = (jnp.arange(n) < n_valid)[:, None]
        xc = jnp.where(mask, xc, 0)
    u, sigma, vt, off = svd_jit_cert(xc)
    u, vt = svd_flip(u, vt)
    return u, sigma, vt, means, sigma @ sigma, off


class Pca:
    """Exact PCA via full SVD (ref: pca.rs:41-232).

    Examples
    --------
    >>> import numpy as np
    >>> from petal_decomposition_tpu import PcaBuilder
    >>> x = np.array([[0., 0.], [1., 1.], [2., 2.]])
    >>> y = PcaBuilder(1).build().fit_transform(x)
    >>> bool(abs(abs(y[0, 0]) - 2 ** 0.5) < 1e-8)
    True
    """

    def __init__(self, n_components: int, *, centering: bool = True,
                 mesh=None, solver: str = "auto"):
        if n_components < 0:
            raise InvalidInput("n_components must be non-negative")
        if solver not in ("auto", "full", "gram"):
            raise ValueError(f"unknown solver {solver!r}")
        self._n_components = int(n_components)
        self._centering = bool(centering)
        self._mesh = mesh
        # "full": thin SVD of the data (1e-10 parity path).
        # "gram": covariance eigenproblem — the scalable row-sharded path
        #   (the reference's full gesvd cannot scale: m×m U, linalg.rs:85).
        # "auto": gram when a mesh is supplied, else full.
        self._solver = solver
        self._components = None  # (k, d)
        self._means = None  # (d,)
        self._singular = None  # (k,) real
        self._total_variance = None  # real scalar
        self._n_samples = 0

    @classmethod
    def new(cls, n_components: int) -> "Pca":
        """Constructor alias mirroring ``Pca::new`` (ref: pca.rs:59-68)."""
        return cls(n_components)

    # -- accessors (ref: pca.rs:78-105) ---------------------------------
    def components(self):
        """Principal axes in feature space, shape (k, d)."""
        return self._components

    def mean(self):
        """Per-feature empirical mean (zeros when centering is off)."""
        return self._means

    def n_components(self) -> int:
        return self._n_components

    def singular_values(self):
        return self._singular

    def explained_variance_ratio(self):
        """σᵢ²/Σσⱼ² over *all* singular values (ref: pca.rs:101-105,224)."""
        _common.check_fitted(self._singular)
        var = self._singular * self._singular
        return var / self._total_variance

    # sklearn-style aliases
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

    # -- fitting --------------------------------------------------------
    def fit(self, x) -> "Pca":
        """Fit the model (ref: pca.rs:116-122).  Returns ``self``."""
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x)
        with record_fit(self, x.shape[0], x.shape[1]):
            self._inner_fit(x)
        return self

    def transform(self, x):
        """Apply the learned projection (ref: pca.rs:130-135)."""
        return _common.transform(
            _common.as_matrix(x), self._components, self._means,
            self._centering, mesh=self._mesh,
        )

    def fit_transform(self, x):
        """Fit and project in one pass, reusing U (ref: pca.rs:153-167)."""
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x)
        with record_fit(self, x.shape[0], x.shape[1]):
            u = self._inner_fit(x)
        return _common.transform_with_u(
            u, self._singular_full, self._n_components
        )

    def inverse_transform(self, y):
        """Back-project to the original space (ref: pca.rs:176-184)."""
        return _common.inverse_transform(
            y, self._components, self._means, self._centering,
            mesh=self._mesh,
        )

    def fit_batched(self, blocks, *, block_rows: int | None = None) -> "Pca":
        """Out-of-core fit from a stream of row blocks (or one 2-D
        array-like sliced host-side, e.g. an ``np.memmap``): one pass
        accumulates the d×d Gram + moments on device, then the
        covariance eigenproblem yields the components — data larger
        than HBM (or host RAM, via memmap) fits on one chip.  No
        reference analogue (its fits require the whole matrix in RAM,
        pca.rs:195-231); accuracy/sign contract in
        :mod:`.streaming`.  Returns ``self``.

        >>> import numpy as np
        >>> from petal_decomposition_tpu import Pca
        >>> x = np.arange(12.0).reshape(6, 2)
        >>> m = Pca(1).fit_batched([x[:4], x[4:]], block_rows=4)
        >>> bool(abs(float(m.singular_values_[0]) - 140 ** 0.5) < 1e-8)
        True
        """
        from . import streaming

        return streaming.stream_fit_exact(self, blocks,
                                          block_rows=block_rows)

    def transform_batched(self, blocks, *, block_rows: int | None = None):
        """Project a stream block-by-block; returns the stacked (n, k)
        host array."""
        from . import streaming

        return streaming.transform_batched(self, blocks,
                                           block_rows=block_rows)

    def partial_fit(self, x, *, block_rows: int | None = None) -> "Pca":
        """Incremental out-of-core fit: accumulate ``x`` (a block, an
        iterable of blocks, or a 2-D array-like) into the persistent
        stream and re-solve, so the model is consistently fitted after
        every call (sklearn ``IncrementalPCA`` semantics).  Any
        ``fit``/``fit_batched`` restarts the stream.  Accumulator state
        is process-local (not serialized).  Returns ``self``."""
        from . import streaming

        streaming.partial_fit_step(
            self, x, block_rows=block_rows, solve=streaming._solve_exact
        )
        return self

    @staticmethod
    def _auto_prefers_gram(x) -> bool:
        """``auto`` keeps the direct SVD (QDWH-SVD off the CPU: backward
        stable, no Gram κ² squaring) except in the genuinely
        Gram-shaped regime — f32, wider than ``_DIRECT_SVD_MAX_D`` (or a
        single column) and n ≥ 8d, where one d×d Gram matmul replaces
        an n-row QR+polar sweep (e.g. the 1M×4096 north-star shape:
        Gram reads X once; the direct QR would dominate).  Accuracy
        trade there: σ through the Gram square to ~eps·κ(X)²; pass
        ``solver="full"`` to force the direct SVD regardless."""
        from ..ops.linalg import effective_platform

        if x.dtype != jnp.float32:
            return False
        if effective_platform() == "cpu":
            return False  # LAPACK handles any width
        n, d = x.shape
        if 2 <= d <= _DIRECT_SVD_MAX_D:
            return False
        return n >= 8 * d

    def _inner_fit(self, x):
        self._stream = None  # a full fit restarts any partial_fit stream
        # Complex fits on an accelerator run host-side (the
        # reference's c32/c64 support is CPU LAPACK — see
        # _common.complex_host_ctx).
        # An explicit mesh wins: mesh fits are never redirected —
        # but complex on an accelerator mesh is a defined, tested
        # error (see _common.check_mesh_complex).
        if self._mesh is None:
            ctx, x = _common.complex_host_ctx(x)
            with ctx:
                return self._inner_fit_impl(x)
        _common.check_mesh_complex(self._mesh, x.dtype)
        return self._inner_fit_impl(x)

    def _inner_fit_impl(self, x):
        """ref: pca.rs:195-231."""
        k = self._n_components
        _common.check_min_dims(x, k)
        n, d = x.shape

        if n == 0:
            # Empty input: the reference's mean_axis returns None and
            # inner_fit early-returns an empty U without updating state
            # (pca.rs:207-211).
            self._singular_full = jnp.zeros((0,), _real_dtype(x.dtype))
            return jnp.zeros((0, d), x.dtype)

        use_gram = self._solver == "gram" or (
            self._solver == "auto"
            and (self._mesh is not None or self._auto_prefers_gram(x))
        )
        n_valid = None
        if self._mesh is not None:
            from ..parallel.mesh import shard_rows_padded

            x, n_true = shard_rows_padded(x, self._mesh)
            n_valid = n_true if n_true != x.shape[0] else None

        # The mesh joins the jit cache key so mesh and single-device
        # traces never alias.
        suffix = () if self._mesh is None else (self._mesh,)
        if use_gram:
            from ..parallel.distributed import pca_fit_gram

            st = pca_fit_gram(
                x, centering=self._centering, n_valid=n_valid,
                n_components=k, cfg=config.cache_key() + suffix,
            )
            u, sigma, vt = st["u"][:n], st["sigma"], st["vt"]
            means = st["means"]
            # Surface eigensolver non-convergence like every other path
            # (LAPACK info != 0 analogue, ref: linalg.rs:84) BEFORE any
            # state mutation — a failed refit must leave a previously
            # fitted model untouched.
            _linalg.check_certificate(
                st["off"], sigma.dtype, d, "eigendecomposition"
            )
            self._total_variance = st["total_variance"]
        elif self._mesh is None and _linalg._use_native(x.dtype, x.shape):
            # Host-native backend, or a tiny problem on an accelerator
            # (dispatch-latency-bound) offloaded to the C++ core.  The
            # whole fit runs host-side: one device→host transfer in,
            # small arrays back.
            import numpy as np

            from ..utils import native

            xh = np.asarray(x)
            if self._centering:
                means_h = xh.mean(axis=0, dtype=np.float64)
                xc = xh - means_h
            else:
                means_h = np.zeros((d,), np.float64)
                xc = xh
            u_h, sigma_h, vt_h = _linalg.native_call(native.jacobi_svd, xc)
            # svd_flip, host-side (reference convention, pca.rs:815-850).
            idx = np.argmax(np.abs(u_h), axis=0)
            piv = u_h[idx, np.arange(u_h.shape[1])]
            signs = np.where(piv < 0, -1.0, 1.0)
            u_h = u_h * signs[None, :]
            vt_h = vt_h * signs[:, None]
            real = jnp.finfo(x.dtype).dtype
            u = jnp.asarray(u_h, x.dtype)
            sigma = jnp.asarray(sigma_h, real)
            vt = jnp.asarray(vt_h, x.dtype)
            means = jnp.asarray(means_h, x.dtype)
            self._total_variance = jnp.asarray(
                float(sigma_h @ sigma_h), real
            )
        else:
            # Mesh + solver='full': the padded, sharded x reaches the
            # jitted SVD directly and the fit masks the padded rows
            # (n_valid).
            u, sigma, vt, means, total_var, off = _fit_exact(
                x, centering=self._centering, n_valid=n_valid,
                cfg=config.cache_key() + suffix,
            )
            u = u[:n]
            if config.check_convergence:
                _linalg.check_certificate(
                    off, sigma.dtype, max(n, d),
                    "singular value decomposition",
                )
            self._total_variance = total_var

        self._components = vt[:k, :]
        self._n_samples = n
        self._means = means
        self._singular = sigma[:k]
        self._singular_full = sigma
        return u


def _real_dtype(dtype):
    dtype = jnp.dtype(dtype)
    if dtype == jnp.complex64:
        return jnp.float32
    if dtype == jnp.complex128:
        return jnp.float64
    return dtype


class PcaBuilder:
    """Builder mirroring the reference's ``PcaBuilder`` (pca.rs:246-283).

    >>> from petal_decomposition_tpu import PcaBuilder
    >>> pca = PcaBuilder(2).centering(False).build()
    """

    def __init__(self, n_components: int):
        self._n_components = n_components
        self._centering = True
        self._mesh = None
        self._solver = "auto"

    @classmethod
    def new(cls, n_components: int) -> "PcaBuilder":
        return cls(n_components)

    def centering(self, centering: bool) -> "PcaBuilder":
        self._centering = centering
        return self

    def mesh(self, mesh) -> "PcaBuilder":
        """Row-shard fits over the given ``jax.sharding.Mesh``."""
        self._mesh = mesh
        return self

    def solver(self, solver: str) -> "PcaBuilder":
        """``'full'`` (thin SVD, 1e-10 parity) or ``'gram'`` (covariance
        eigenproblem, the scalable sharded path)."""
        self._solver = solver
        return self

    def build(self) -> Pca:
        return Pca(
            self._n_components,
            centering=self._centering,
            mesh=self._mesh,
            solver=self._solver,
        )
