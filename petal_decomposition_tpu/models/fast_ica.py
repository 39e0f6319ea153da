"""Parallel (symmetric) FastICA.

JAX rebuild of the reference's ``FastIca``/``FastIcaBuilder``
(ref: ica.rs:41-317) and its math kernels ``ica_par``,
``symmetric_decorrelation`` and ``logcosh`` (ref: ica.rs:319-398).

Fidelity notes:

* ``n_components = min(n_samples, n_features)`` — not user-settable, as
  in the reference (ica.rs:173).
* The whitening matrix K fills **all** feature columns —
  ``K = (U[:, :k] / σ[:k])ᵀ`` — fixing the reference's latent
  uninitialized-memory bug when n_features > n_samples (ica.rs:190-203,
  SURVEY C13).
* ``ica_par``'s convergence functional is the reference's exact variant:
  ``max_i ||row_i(W1)·col_i(W)| − 1|`` (rows of the *new* W against
  columns of the *old* W, ica.rs:344-354) — subtly different from
  sklearn's ``diag(W1·Wᵀ)``.  The iteration cap (200) and tolerance
  (1e-4) match ica.rs:216 and are promoted to parameters.
* Contrast functions: ``logcosh`` (the reference's only contrast,
  ica.rs:383-398) plus ``exp`` and ``cube`` as extensions.

The iteration is a single jitted ``lax.while_loop``: two matmuls
(``W·X`` k×k×n and ``G·Xᵀ`` k×n×k) plus the k×k symmetric decorrelation
(eigh, or the matmul-only Newton–Schulz that ``decorrelation="auto"``
picks on accelerators — see :func:`resolve_decorrelation`) per
step, so the whole solve stays on-device with no host round-trips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import config as _config
from ..errors import InvalidInput
from ..ops import linalg as _linalg
from ..ops import splitmm
from ..ops.linalg import eigh_psd_jit, mdot, svd
from ..utils import rng as rng_util
from . import _common

__all__ = [
    "FastIca",
    "FastIcaBuilder",
    "ica_par",
    "symmetric_decorrelation",
    "symmetric_decorrelation_ns",
    "logcosh",
]

_CONTRASTS = ("logcosh", "exp", "cube")


def symmetric_decorrelation(w):
    """W ← (W·Wᵀ)^(−1/2)·W via eigendecomposition (ref: ica.rs:363-381).

    ``eigh(W·Wᵀ) = E·diag(λ)·Eᵀ``; returns ``E·diag(1/√λ)·Eᵀ·W``.

    Complex deviation (deliberate): the Gram here is the Hermitian
    ``W·Wᴴ``, whereas the reference forms the plain transpose ``W·Wᵀ``
    (ica.rs:369) and hands a non-Hermitian matrix to ``?heev``, which
    silently reads only its lower triangle.  The Hermitian form is the
    mathematically meaningful whitening (real for real W, so the real
    paths are bit-identical to the reference convention).
    """
    w = jnp.asarray(w)
    e, v = eigh_psd_jit(mdot(w, w.conj().T))
    # Pseudo-inverse semantics for numerically dead directions (rank-
    # deficient W, e.g. a whitened channel zeroed by the rank cutoff):
    # λ ≤ λmax·eps·k inverts to 0 instead of inf.  The reference computes
    # 1/√λ unguarded (ica.rs:371-374) and NaNs on such inputs.
    e = jnp.real(e)
    cutoff = e[-1] * jnp.finfo(e.dtype).eps * w.shape[0]
    ok = e > cutoff
    inv_sqrt = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, e, 1)), 0).astype(
        w.dtype
    )
    return mdot(mdot(v * inv_sqrt[None, :], v.conj().T), w)


def symmetric_decorrelation_ns(w, iters: int = 24):
    """Matmul-only symmetric decorrelation via coupled Newton–Schulz.

    Computes the same unique ``(W·Wᵀ)^(−1/2)·W`` as the eigh route but
    with ~3 k×k matmuls per NS step and no eigensolver — the
    launch-friendly choice inside the ICA loop (``decorrelation="ns"``).
    Trace-scaling puts the spectrum of A/c in (0, 1], for which the
    coupled iteration converges globally; iterations needed grow with
    log κ(A) (24 reaches machine precision for κ(A) ≲ 1e5; the eigh
    route stays exact beyond that).
    """
    w = jnp.asarray(w)
    a = mdot(w, w.conj().T)
    k = a.shape[0]
    c = jnp.real(jnp.trace(a))  # ≥ λ_max for SPD
    y = a / c
    eye = jnp.eye(k, dtype=a.dtype)
    z = eye

    def body(_, carry):
        y, z = carry
        t = 1.5 * eye - 0.5 * mdot(z, y)
        return mdot(y, t), mdot(t, z)

    y, z = jax.lax.fori_loop(0, iters, body, (y, z))
    # z ≈ (A/c)^{−1/2}  ⇒  A^{−1/2} = z/√c
    return mdot(z, w) / jnp.sqrt(c).astype(w.dtype)


def _contrast_sums(fun: str, wx, sum_dtype=None):
    """G and the per-row *sum* of g′(wx) for the given contrast.

    ``sum_dtype`` widens the g′ row-sum accumulator (the ds64 polish
    stage evaluates the contrast in f32 but needs the n-length
    reduction carried in f64: an f32 accumulator over 1e5 samples
    costs ~√n·eps_f32 ≈ 2e-5 relative, above that stage's ~1e-7
    update grade)."""
    if fun == "logcosh":
        g = jnp.tanh(wx)
        s = jnp.sum(1.0 - g * g, axis=1, dtype=sum_dtype)
    elif fun == "exp":
        e = jnp.exp(-(wx * wx) / 2.0)
        g = wx * e
        s = jnp.sum((1.0 - wx * wx) * e, axis=1, dtype=sum_dtype)
    elif fun == "cube":
        g = wx ** 3
        s = jnp.sum(3.0 * wx * wx, axis=1, dtype=sum_dtype)
    else:
        raise ValueError(f"unknown contrast function {fun!r}")
    return g, s


# g′(0) per contrast: padded (zero) sample columns each contribute this
# to the g′ row-sum and are subtracted out in the masked iteration.
_GPRIME_AT_ZERO = {"logcosh": 1.0, "exp": 1.0, "cube": 0.0}


def logcosh(x):
    """In-place tanh contrast (ref: ica.rs:383-398).

    Returns ``(tanh(x), mean(1 − tanh²(x), axis=1))`` — G and the
    per-row mean of g′.
    """
    g, s = _contrast_sums("logcosh", jnp.asarray(x))
    return g, s / x.shape[1]


# Below this the f32 convergence functional is dominated by roundoff
# noise (k·eps_f32 rotations per step): the mixed-precision f32 stage
# stops here and hands off to the ds64 stage.
_F32_LIM_FLOOR = 1e-5

# Below this the ds64 stage's convergence functional is dominated by
# the split-gemm + f32-contrast update error (ops/splitmm.py); the
# stage hands off to the true-f64 certification stage.  The one-step
# noise of the ds64 body against the f64 body at 64×100k (|ΔW|∞ ~5e-7,
# |Δlim| ~5e-9) sits >400× under this floor.
_DS64_LIM_FLOOR = 2e-6


@partial(jax.jit, static_argnames=("max_iter", "fun", "n_valid",
                                   "decorrelation", "precision", "cfg"))
def _ica_par_core(x, tol, max_iter: int, w_init, fun: str,
                  n_valid: int | None = None,
                  decorrelation: str = "eigh",
                  precision: str = "full", cfg=None):
    """The FastICA fixed-point iteration (ref: ica.rs:319-361).

    ``n_valid`` (static): number of real sample columns when ``x`` is
    zero-padded for even sharding; reductions are corrected so padded
    columns contribute nothing.

    ``precision`` (static): precision of the fixed-point iteration.
    ``"full"`` iterates at the data dtype (reference-faithful).
    ``"f32"`` (float64 data only) runs a three-stage escalation, each
    stage iterating until its own noise floor (or ``tol``, whichever is
    larger) within the shared ``max_iter`` budget:

    1. *f32 stage* — the k×n data matmuls (the entire per-step cost)
       in float32, to ``_F32_LIM_FLOOR`` (~1e-5);
    2. *ds64 stage* — the same matmuls as hi/lo-split f32 products
       carried in f64 (`ops/splitmm.py`) with an f32 contrast and
       f64-carried reductions/decorrelation, to ``_DS64_LIM_FLOOR``
       (~2e-6);
    3. *f64 stage* — true float64 steps from the ds64 fixed point
       until ``tol``.

    The first two stages also hand off once W itself is stationary at
    their floor (sklearn's row-against-row measure
    ``max_i ||row_i(W1)·row_i(W)| − 1|``): the reference functional
    pairs rows of the new W with columns of the old one and reaches 0
    only at symmetric fixed points, so on most k > 2 problems it never
    falls below a floor, and without this exit the f32 stage would
    spend the whole budget and return an f32-grade W for f64 data.

    The FastICA map is a contraction near its fixed point, so each
    stage inherits the previous stage's basin; the final W satisfies
    the same f64 convergence criterion a full-precision run does, and
    the f64 steps are confined to the last ~decade of convergence.
    Whether the ladder beats ``"full"`` on a GPU, which runs f64
    natively, is not measured yet (ROADMAP A4).  Total iterations never exceed ``max_iter``.
    """
    n_pad = x.shape[1]
    n = n_pad if n_valid is None else n_valid
    pad = n_pad - n
    g0 = _GPRIME_AT_ZERO[fun]
    if decorrelation not in ("eigh", "ns"):
        # "auto" must be resolved by the caller (resolve_decorrelation):
        # this function is backend-agnostic and trace-cached.
        raise ValueError(f"unknown decorrelation {decorrelation!r}")
    decorr = (
        symmetric_decorrelation_ns
        if decorrelation == "ns"
        else symmetric_decorrelation
    )
    # The initial decorrelation acts on an arbitrary random W whose
    # conditioning is unbounded — always use the exact eigh route there.
    w0 = symmetric_decorrelation(w_init)
    p_inv = 1.0 / n  # ref: ica.rs:330

    def measures(w1, w):
        # (reference functional, row-against-row stationarity)
        lim = jnp.max(
            jnp.abs(jnp.abs(jnp.einsum("ij,ji->i", w1, w)) - 1.0)
        )
        step = jnp.max(
            jnp.abs(jnp.abs(jnp.einsum("ij,ij->i", w1, jnp.conj(w))) - 1.0)
        )
        return lim, step

    def make_body(xs):
        def body(state):
            w, _, _, it = state
            # XLA fuses the elementwise contrast into the two k×n gemms.
            gwtx, gsum = _contrast_sums(fun, mdot(w, xs))  # ica.rs:332
            gx = mdot(gwtx, xs.T)
            g_wtx = (gsum - pad * g0) * p_inv
            # W1 = symdecorr(G·Xᵀ/p − diag(g′)·W)   (ref: ica.rs:333-343)
            update = gx * p_inv - g_wtx[:, None] * w
            w1 = decorr(update)
            # lim = max_i ||row_i(W1)·col_i(W)| − 1|  (ref: ica.rs:344-354)
            lim, step = measures(w1, w)
            return w1, lim, step, it + 1

        return body

    def run(xs, tol_s, w_start, budget, stall_s=-1.0):
        # ``stall_s`` < 0: the reference criterion alone.
        body = make_body(xs)

        def cond(state):
            _, lim, step, it = state
            return (lim >= tol_s) & (step >= stall_s) & (it < budget)

        # The carry's lim slot is always real (the body computes
        # ``max(abs(...))``); seeding it with a complex x.dtype would
        # make while_loop reject the carry on complex inputs.
        lim0 = jnp.asarray(jnp.inf, jnp.real(xs).dtype)
        w, lim, _, it = jax.lax.while_loop(
            cond, body, (w_start, lim0, lim0, jnp.asarray(0, jnp.int32))
        )
        return w, lim, it

    def make_body_ds(xh, xl):
        # ds64 stage body: identical update algebra, with the two k×n
        # gemms as split-f32 products (ops/splitmm.py), the
        # contrast at f32, and all k-sized state carried in f64.
        def body(state):
            w, _, _, it = state
            wx32 = splitmm.mm_split_f32(w, xh, xl)
            gwtx, gsum = _contrast_sums(fun, wx32, sum_dtype=jnp.float64)
            gx = splitmm.mm_split_chunked_f64(gwtx, xh, xl)
            g_wtx = (gsum - pad * g0) * p_inv
            update = gx * p_inv - g_wtx[:, None] * w
            w1 = decorr(update)
            lim, step = measures(w1, w)
            return w1, lim, step, it + 1

        return body

    def run_ds(xh, xl, tol_s, w_start, budget):
        body = make_body_ds(xh, xl)

        def cond(state):
            _, lim, step, it = state
            return (lim >= tol_s) & (step >= tol_s) & (it < budget)

        lim0 = jnp.asarray(jnp.inf, jnp.float64)
        w, lim, _, it = jax.lax.while_loop(
            cond, body, (w_start, lim0, lim0, jnp.asarray(0, jnp.int32))
        )
        return w, lim, it

    budget = jnp.asarray(max_iter, jnp.int32)
    if precision == "f32" and x.dtype == jnp.float64:
        f32 = jnp.float32
        tol32 = jnp.maximum(tol, _F32_LIM_FLOOR).astype(f32)
        w32, lim32, n1 = run(x.astype(f32), tol32, w0.astype(f32), budget,
                             stall_s=tol32)
        # Re-orthonormalize at full precision before polishing: the f32
        # W carries ~eps_f32 departures from row-orthonormality.
        w_b = symmetric_decorrelation(w32.astype(x.dtype))
        xh, xl = splitmm.split_f64(x)
        tol_ds = jnp.maximum(tol, _DS64_LIM_FLOOR)
        w_d, lim_d, nd = run_ds(xh, xl, tol_ds, w_b, budget - n1)
        w, lim, n2 = run(x, tol, w_d, budget - n1 - nd)
        # Budget exhausted upstream → later stages never ran; report
        # the last stage that did run's convergence measure (a
        # non-converged fit, as the reference reports via
        # n_iter == max_iter, ica.rs:360).
        lim = jnp.where(
            n2 > 0,
            lim,
            jnp.where(nd > 0, lim_d, lim32.astype(lim.dtype)),
        )
        return w, lim, n1 + nd + n2

    return run(x, tol, w0, budget)


def resolve_iteration_precision(setting: str, dtype) -> str:
    """Eager-context resolution of ``iteration_precision="auto"``:
    ``"f32"`` (iterate in float32, polish in float64) for float64 data
    on an accelerator backend and ``"full"`` everywhere else (f32/complex
    data always iterates at its own dtype).  The accelerator choice was
    made where f64 matmuls were emulated; on a GPU with native f64 it
    is not re-measured yet (ROADMAP A4)."""
    from ..ops.linalg import effective_platform

    if setting != "auto":
        return setting
    return (
        "f32"
        if dtype == jnp.float64 and effective_platform() != "cpu"
        else "full"
    )


def resolve_decorrelation(setting: str) -> str:
    """Eager-context resolution of ``decorrelation="auto"``: the
    matmul-only Newton–Schulz route on accelerators and the eigh route
    on CPU (reference-faithful; a LAPACK-grade k×k ``?syev`` is cheap
    there).  Off the CPU the in-loop k×k eigensolve is
    launch-latency-bound, while NS is a few dense matmuls.  The two
    routes compute the same unique ``(W·Wᵀ)^(−1/2)·W`` to working
    precision on the loop's inputs: each step re-decorrelates, so the
    iterate stays near-orthonormal (κ ≈ 1, inside NS's κ ≲ 1e5
    envelope), and the initial decorrelation of the *unbounded* random
    W always uses eigh (`_ica_par_core`).  Measured operator parity on
    near-orthonormal inputs: ≤ 6e-15 (f64) / ≤ 6e-7 (f32) at
    k ∈ {16, 64, 256}."""
    from ..ops.linalg import effective_platform

    if setting != "auto":
        return setting
    return "ns" if effective_platform() != "cpu" else "eigh"


def ica_par(x, tol, max_iter: int, w_init, fun: str = "logcosh",
            decorrelation: str = "eigh", precision: str = "full"):
    """Symmetric FastICA iteration (ref: ica.rs:319-361).

    ``decorrelation`` accepts ``"auto"`` (resolved per
    :func:`resolve_decorrelation`), ``"eigh"``, or ``"ns"``.

    Returns ``(w, n_iter)``; ``n_iter == max_iter`` when the tolerance was
    never reached, matching the reference's return at ica.rs:360.
    """
    x = jnp.asarray(x)
    w, _, n_iter = _ica_par_core(
        x, jnp.asarray(tol, _common.real_dtype(x.dtype)), int(max_iter),
        jnp.asarray(w_init), fun,
        decorrelation=resolve_decorrelation(decorrelation),
        precision=precision,
        cfg=_config.cache_key(),
    )
    return w, int(n_iter)


class FastIca:
    """FastICA with symmetric decorrelation (ref: ica.rs:41-222).

    Examples
    --------
    >>> import numpy as np
    >>> from petal_decomposition_tpu import FastIcaBuilder
    >>> x = np.array([[0., 0.], [1., 1.], [1., -1.]])
    >>> y = FastIcaBuilder().seed(42).build().fit_transform(x)
    >>> y.shape
    (3, 2)
    """

    def __init__(self, *, seed: int | None = None, key=None,
                 fun: str = "logcosh", tol: float = 1e-4,
                 max_iter: int = 200, whiten: bool = True,
                 whiten_solver: str = "auto",
                 mesh=None, n_components: int | None = None,
                 decorrelation: str = "auto",
                 iteration_precision: str = "auto"):
        if fun not in _CONTRASTS:
            raise ValueError(f"unknown contrast function {fun!r}")
        if whiten_solver not in ("auto", "svd", "eigh"):
            raise ValueError(f"unknown whiten solver {whiten_solver!r}")
        # ``whiten=False`` (SURVEY §5's promoted parameter; sklearn
        # semantics): the caller certifies the data is already centered
        # and whitened — the fit skips centering + whitening entirely,
        # runs ``ica_par`` on Xᵀ as-is, and ``components_`` IS the
        # unmixing W.  The square d×d W leaves no room for a separate
        # n_components.
        self._whiten = bool(whiten)
        if not self._whiten and n_components is not None:
            raise InvalidInput(
                "n_components requires whiten=True (whiten=False fits "
                "the square unmixing W over all features)"
            )
        if decorrelation not in ("auto", "eigh", "ns"):
            raise ValueError(f"unknown decorrelation {decorrelation!r}")
        if iteration_precision not in ("auto", "f32", "full"):
            raise ValueError(
                f"unknown iteration precision {iteration_precision!r}"
            )
        self._decorrelation = decorrelation
        self._iteration_precision = iteration_precision
        self._mesh = mesh
        # The reference pins k = min(n, d) (ica.rs:173); an explicit
        # n_components (north-star extension, sklearn-style) keeps only
        # the top-k whitened directions.
        self._n_components = (
            None if n_components is None else int(n_components)
        )
        if key is not None:
            self._key = key
        else:
            seed = rng_util.random_seed() if seed is None else seed
            self._key = rng_util.key_from_seed(seed)
        self._fun = fun
        self._tol = float(tol)  # ref hardcodes 1e-4 (ica.rs:216)
        self._max_iter = int(max_iter)  # ref hardcodes 200 (ica.rs:216)
        self._whiten_solver = whiten_solver
        self._components = None  # (k, d)
        self._means = None  # (d,)
        self._n_iter = 0

    @classmethod
    def new(cls) -> "FastIca":
        return cls()

    @classmethod
    def with_seed(cls, seed: int) -> "FastIca":
        return cls(seed=seed)

    @classmethod
    def with_key(cls, key) -> "FastIca":
        return cls(key=key)

    def components(self):
        return self._components

    def mean(self):
        return self._means

    @property
    def n_iter_(self) -> int:
        """Iterations used by the last fit (the reference records this
        privately at ica.rs:49,219; exposed here per SURVEY §5)."""
        return self._n_iter

    components_ = property(lambda self: self._components)
    mean_ = property(lambda self: self._means)

    # -- fitting (ref: ica.rs:105-157) ----------------------------------
    def fit(self, x) -> "FastIca":
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x)
        with record_fit(self, x.shape[0], x.shape[1]) as stats:
            self._inner_fit(x)
            stats.n_iter = self._n_iter
        return self

    def fit_batched(self, data, *, block_rows: int | None = None) -> "FastIca":
        """Out-of-core fit in two streamed passes: pass 1 accumulates
        the d×d Gram + moments (→ the eigh whitening K), pass 2 streams
        ``X₁ = K·(X − μ)ᵀ·√n`` into an HBM-resident k×n buffer, and the
        in-core ``ica_par`` runs on it unchanged — the reference's full
        capability (ica.rs:167-221) at n unbounded by host RAM.  ``data``
        must be re-iterable (a 2-D array-like such as ``np.memmap``, a
        sequence of blocks, or a zero-arg callable returning the
        stream); k×n must fit device memory (checked; on a
        single-process mesh the buffer column-shards, so the bound
        scales with mesh.size).  Matches the in-core
        ``whiten_solver="eigh"`` fit at the same key up to
        accumulation roundoff.  Returns ``self``.

        >>> import numpy as np
        >>> from petal_decomposition_tpu import FastIca
        >>> rng = np.random.default_rng(0)
        >>> x = rng.laplace(size=(600, 3)) @ rng.standard_normal((3, 3))
        >>> m = FastIca.with_seed(42).fit_batched([x[:256], x[256:]])
        >>> m.components().shape
        (3, 3)
        """
        from . import streaming

        return streaming.stream_fit_fast_ica(self, data,
                                             block_rows=block_rows)

    def transform_batched(self, blocks, *, block_rows: int | None = None):
        """Unmix a stream block-by-block; returns the stacked (n, k)
        host array."""
        from . import streaming

        return streaming.transform_batched(self, blocks,
                                           block_rows=block_rows)

    @property
    def mixing_(self):
        """The pseudo-inverse of ``components_`` — the estimated mixing
        matrix, shape (d, k) (sklearn-compatible extension; the
        reference exposes no inverse direction at all — FastIca has no
        ``inverse_transform``, SURVEY §3.5).  Computed once per fit:
        the cache is keyed on the components array's identity, so any
        refit (which installs a new array) invalidates it without the
        fit paths having to know about it."""
        _common.check_fitted(self._components)
        cache = getattr(self, "_mixing_cache", None)
        if cache is None or cache[0] is not self._components:
            self._mixing_cache = (
                self._components,
                jnp.linalg.pinv(self._components),
            )
        return self._mixing_cache[1]

    def inverse_transform(self, y):
        """Reconstruct signals in the original feature space:
        ``y·mixing_ᵀ + μ`` (sklearn-compatible extension; exact
        round-trip of ``transform`` when k = d).

        >>> import numpy as np
        >>> from petal_decomposition_tpu import FastIca
        >>> x = np.array([[0., 1.], [2., 0.], [1., 3.], [3., 2.]])
        >>> m = FastIca.with_seed(42).fit(x)
        >>> xr = np.asarray(m.inverse_transform(m.transform(x)))
        >>> bool(np.abs(xr - x).max() < 1e-8)
        True
        """
        y = _common.as_matrix(y)
        _common.check_fitted(self._components)
        if y.shape[1] != self._components.shape[0]:
            raise InvalidInput(
                f"# of columns should be {self._components.shape[0]}"
            )
        target = jnp.promote_types(y.dtype, self._components.dtype)
        ctx, y = _common._maybe_host_ctx(y, target, self._mesh)
        with ctx:
            mixing = _common.colocate(self.mixing_, y)
            means = _common.colocate(self._means, y)
            return mdot(y.astype(target), mixing.T) + means

    def transform(self, x):
        """(x − μ)·Wᵀ (ref: ica.rs:120-131)."""
        x = _common.as_matrix(x)
        _common.check_fitted(self._components)
        if x.shape[1] != self._means.shape[0]:
            raise InvalidInput("too many columns")
        target = jnp.promote_types(x.dtype, self._components.dtype)
        ctx, x = _common._maybe_host_ctx(x, target, self._mesh)
        with ctx:
            components = _common.colocate(self._components, x)
            means = _common.colocate(self._means, x)
            return mdot(x.astype(target) - means, components.T)

    def fit_transform(self, x):
        """Fit, then return ``(components·X_c)ᵀ`` (ref: ica.rs:147-157)."""
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x)
        with record_fit(self, x.shape[0], x.shape[1]) as stats:
            xc = self._inner_fit(x)
            stats.n_iter = self._n_iter
        if xc is None:  # same result via the projection
            return self.transform(x)
        return mdot(xc, self._components.T)

    def _inner_fit(self, x):
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

    def _run_mesh_fit(self, x, *, whiten: bool):
        """Sharded fit scaffolding shared by the whitened and
        whiten=False paths: key split, padded row-sharding, the jitted
        ``fast_ica_fit``, certificate checks (the whitening-eigh
        certificate only exists when whitening ran), and state
        install."""
        from ..parallel.distributed import fast_ica_fit
        from ..parallel.mesh import shard_rows_padded

        self._key, subkey = jax.random.split(self._key)
        x_sh, n_true = shard_rows_padded(x, self._mesh)
        # The mesh joins the jit cache key so mesh and single-device
        # traces never alias.
        st = fast_ica_fit(
            x_sh, subkey,
            fun=self._fun, tol=self._tol, max_iter=self._max_iter,
            n_valid=n_true if n_true != x_sh.shape[0] else None,
            n_components=self._n_components if whiten else None,
            whiten=whiten,
            decorrelation=resolve_decorrelation(self._decorrelation),
            precision=resolve_iteration_precision(
                self._iteration_precision, x.dtype
            ),
            cfg=_config.cache_key() + (self._mesh,),
        )
        if whiten:
            _linalg.check_certificate(
                st["off"], _common.real_dtype(x.dtype), x.shape[1],
                "eigendecomposition",
            )
        check_decorrelation_value(
            st["w_orth_err"], _common.real_dtype(x.dtype)
        )
        self._components = st["components"]
        self._means = st["means"]
        self._n_iter = int(st["n_iter"])
        return None  # fit_transform routes through transform()

    def _inner_fit_impl(self, x):
        """ref: ica.rs:167-221.  Returns the centered data (n × d; the
        reference returns its transpose) for ``fit_transform``, or
        ``None`` where the fit never materialized it."""
        n, d = x.shape
        if not self._whiten:
            if n == 0 or d == 0:
                raise InvalidInput(
                    "whiten=False requires non-empty data (the square "
                    "d x d unmixing W is undefined for empty input)"
                )
            return self._fit_no_whiten(x)
        # Reference default: k = min(n, d), not user-settable (ica.rs:173).
        k = min(n, d)
        if self._n_components is not None:
            if self._n_components > k:
                raise InvalidInput(
                    f"n_components should be at most {k}"
                )
            k = self._n_components
        if k == 0:
            # Degenerate fit: 0 samples, 0 features, or n_components=0.
            # The reference early-returns on 0 rows (ica.rs:174-176) but
            # leaves components/means in their empty build state so a
            # later transform() errors on the column check; here the
            # model is left consistently fitted with an empty component
            # matrix so transform/fit_transform degrade gracefully.
            means = (
                jnp.mean(x, axis=0) if n > 0 else jnp.zeros((d,), x.dtype)
            )
            self._components = jnp.zeros((0, d), x.dtype)
            self._means = means
            self._n_iter = 0
            if n == 0:
                return jnp.zeros((0, d), x.dtype)
            return x - means

        if self._mesh is not None:
            return self._run_mesh_fit(x, whiten=True)

        means = jnp.mean(x, axis=0)  # ref: ica.rs:178-188

        # "auto": the reference-faithful SVD whitening (ica.rs:189)
        # everywhere but f64 on an accelerator, where the Gram/eigh
        # whitening replaces the tall-SVD's Householder QR with one
        # gemm + a small eigh.  Whitening accuracy is tol-bounded by
        # the ICA iteration either way.
        solver = self._whiten_solver
        if solver == "auto":
            solver = (
                "eigh"
                if x.dtype == jnp.float64
                and _linalg.effective_platform() != "cpu"
                else "svd"
            )
        # Centering happens inside each jitted product: at scale every
        # materialized n×d copy is as large as the data.
        kmat, _sigma, whiten_off = _whitening_matrix(x, means, k, solver)
        if solver == "eigh":
            _linalg.check_certificate(
                whiten_off, _common.real_dtype(x.dtype), d,
                "eigendecomposition",
            )
        # X₁ = K·Xᵀ·√n  (ref: ica.rs:204-208; the √n factor makes the
        # whitened rows unit-variance under the 1/n inner product).
        x1 = _whiten_rows(kmat, x, means, _config.matmul_precision)
        x1 = x1 * jnp.sqrt(jnp.asarray(n, x.dtype))

        self._key, subkey = jax.random.split(self._key)
        w_init = rng_util.normal(subkey, (k, k), x.dtype)

        w, n_iter = ica_par(
            x1, self._tol, self._max_iter, w_init, fun=self._fun,
            decorrelation=resolve_decorrelation(self._decorrelation),
            precision=resolve_iteration_precision(
                self._iteration_precision, x.dtype
            ),
        )
        check_decorrelation(w)
        self._components = mdot(w, kmat)  # ref: ica.rs:217
        self._means = means
        self._n_iter = n_iter
        return None


    def _fit_no_whiten(self, x):
        """``whiten=False``: the data is certified pre-centered and
        pre-whitened — ``ica_par`` runs directly on Xᵀ (sklearn
        semantics; no reference analogue, its whitening is hardwired at
        ica.rs:173-208).  ``components_`` is the square unmixing W and
        the stored means are zero, so ``transform`` is ``x·Wᵀ``."""
        n, d = x.shape
        xt = x.T  # (d, n) — no centering, no K, no √n scaling

        if self._mesh is not None:
            return self._run_mesh_fit(x, whiten=False)

        self._key, subkey = jax.random.split(self._key)
        w_init = rng_util.normal(subkey, (d, d), x.dtype)
        w, n_iter = ica_par(
            xt, self._tol, self._max_iter, w_init, fun=self._fun,
            decorrelation=resolve_decorrelation(self._decorrelation),
            precision=resolve_iteration_precision(
                self._iteration_precision, x.dtype
            ),
        )
        check_decorrelation(w)
        self._components = w
        self._means = jnp.zeros((d,), _common.real_dtype(x.dtype))
        self._n_iter = n_iter
        return x

def decorrelation_certificate(w):
    """Certificate that symmetric decorrelation succeeded: ``G = W·Wᴴ``
    must be an **orthogonal projector** (``G² = G``) — the exact
    invariant of the pseudo-inverse decorrelation.  Full-rank fits give
    G = I; when the data's rank is below k (dead whitened channels
    zeroed by the rank cutoff) the update matrix is rank-deficient and
    the decorrelated W's rows span an r-dimensional subspace in an
    arbitrary orientation, so G is a non-diagonal projector — still a
    successful decorrelation.  Any real failure leaves G with
    eigenvalues away from {0, 1}, which ``‖G² − G‖`` detects.
    Per-iteration k×k eigensolves inside the jitted while_loop cannot
    surface individual LAPACK-style errors (ref: linalg.rs:84 checks
    info on every call); failures accumulate into this end-state
    measure instead."""
    g = mdot(w, w.conj().T)
    return jnp.max(jnp.abs(mdot(g, g) - g))


def check_decorrelation_value(
    err, dtype, what: str = "symmetric decorrelation"
) -> None:
    """Raise ``LinalgError`` when a decorrelation certificate value
    exceeds its (loose) tolerance — failures are O(1), so eps**0.25
    separates them cleanly from Newton–Schulz/ds64 working-precision
    residue.  NaN certificates fail the check (``not (err <= tol)``)."""
    from ..config import config as cfg
    from ..errors import LinalgError

    if not cfg.check_convergence:
        return
    tol = float(jnp.finfo(dtype).eps) ** 0.25
    if not (float(err) <= tol):
        raise LinalgError(f"{what} did not converge")


def check_decorrelation(w, what: str = "symmetric decorrelation") -> None:
    """:func:`check_decorrelation_value` on ``w``'s own certificate."""
    check_decorrelation_value(
        decorrelation_certificate(w),
        _common.real_dtype(jnp.asarray(w).dtype),
        what,
    )


@jax.jit
def _centered_gram(x, means):
    """``XcᴴXc`` with ``Xc = X − μ`` formed inside the program (neither
    Xc nor its transpose outlives it); float32 data accumulate in
    float64 (``ops.centered.gram_acc64``)."""
    from ..ops.centered import gram_acc64

    return gram_acc64(x - means).astype(x.dtype)


@partial(jax.jit, static_argnames=("precision",))
def _whiten_rows(kmat, x, means, precision):
    """``K·(X − μ)ᵀ`` with the centered copy and its transpose formed
    inside the program."""
    return jnp.dot(kmat, (x - means).T, precision=precision)


def _whitening_matrix(x, means, k: int, solver: str):
    """K such that K·(X − μ)ᵀ has decorrelated unit-ish rows
    (ref: ica.rs:189-203, with the C13 bug fixed: all d columns filled).

    ``svd``: K = (U[:, :k]/σ[:k])ᵀ from the thin SVD of (X − μ)ᵀ (d × n).
    ``eigh``: same matrix from eigh(XcᵀXc) — U are the eigenvectors of
    the d×d Gram, σ = √λ; one big matmul instead of an SVD of the full
    data, and the Gram reduces over samples (one psum when row-sharded).
    """
    if solver == "svd":
        # svd() raises LinalgError itself on non-convergence.
        u, sigma, _ = svd((x - means).T, compute_vt=False)
        off = jnp.zeros((), jnp.real(sigma).dtype)
        return (*_whitening_from_spectrum(u, sigma, k, max(x.shape)), off)
    return whitening_from_gram(
        _centered_gram(x, means), k, max(x.shape)
    )


def whitening_from_gram(gram, k: int, rank_dim: int):
    """``(K, sigma_k, off)`` from the centered d×d Gram alone — the eigh
    branch of :func:`_whitening_matrix`, usable when the data itself is
    never materialized (the streamed fit accumulates exactly this Gram,
    :mod:`.streaming`).  ``rank_dim`` is max(n, d) for the rank cutoff."""
    lam, vecs, off = _linalg.eigh_psd_jit_cert(gram)  # ascending
    u = vecs[:, ::-1]
    sigma = jnp.sqrt(jnp.maximum(lam[::-1], 0.0))
    return (*_whitening_from_spectrum(u, sigma, k, rank_dim), off)


def _whitening_from_spectrum(u, sigma, k: int, rank_dim: int):
    u_k = u[:, :k]
    sigma_k = sigma[:k]
    # Degenerate directions (σ ≈ 0 relative to σmax — e.g. the rank
    # deficiency created by centering when n_samples ≤ n_features)
    # whiten to zero rather than amplifying roundoff noise by 1/σ.
    # (The reference reads uninitialized memory here — SURVEY C13; this
    # is the fixed behavior.)
    eps = jnp.finfo(sigma_k.dtype).eps
    # Rank tolerance: σ below σmax·eps·4√(max dim) is numerically zero.
    # A bare 10·eps misses directions a few eps above the noise floor
    # (whose 1/σ then amplifies roundoff by ~1e12), while the
    # numpy-style linear max(d, n) factor over-prunes at large sample
    # counts — for float32 with n = 5·10⁵ it reaches 0.06·σmax and
    # silently kills genuinely significant components (κ > ~17).  The
    # √-scaled factor tracks the statistical growth of accumulated
    # rounding instead.
    cutoff = sigma[0] * eps * max(10.0, 4.0 * rank_dim ** 0.5)
    ok = sigma_k > cutoff
    inv = jnp.where(ok, 1.0 / jnp.where(ok, sigma_k, 1), 0)
    kmat = (u_k * inv.astype(u_k.dtype)[None, :]).T
    return kmat, sigma_k


class FastIcaBuilder:
    """Builder mirroring ``FastIcaBuilder`` (ref: ica.rs:244-317).

    >>> from petal_decomposition_tpu import FastIcaBuilder
    >>> ica = FastIcaBuilder().seed(1234567891011121314).build()
    """

    def __init__(self):
        self._seed = None
        self._key = None
        self._fun = "logcosh"
        self._tol = 1e-4
        self._max_iter = 200
        self._whiten = True
        self._whiten_solver = "auto"
        self._mesh = None
        self._n_components = None
        self._decorrelation = "auto"
        self._iteration_precision = "auto"

    @classmethod
    def new(cls) -> "FastIcaBuilder":
        return cls()

    @classmethod
    def with_key(cls, key) -> "FastIcaBuilder":
        b = cls()
        b._key = key
        return b

    def seed(self, seed: int) -> "FastIcaBuilder":
        self._seed = seed
        return self

    def fun(self, fun: str) -> "FastIcaBuilder":
        self._fun = fun
        return self

    def tol(self, tol: float) -> "FastIcaBuilder":
        self._tol = tol
        return self

    def max_iter(self, max_iter: int) -> "FastIcaBuilder":
        self._max_iter = max_iter
        return self

    def whiten(self, whiten: bool) -> "FastIcaBuilder":
        """``False``: the data is certified pre-centered and
        pre-whitened; the fit runs ``ica_par`` directly and
        ``components_`` is the square unmixing W (sklearn semantics;
        extension — the reference's whitening is hardwired,
        ica.rs:173-208)."""
        self._whiten = whiten
        return self

    def whiten_solver(self, solver: str) -> "FastIcaBuilder":
        self._whiten_solver = solver
        return self

    def mesh(self, mesh) -> "FastIcaBuilder":
        """Row-shard fits over the given ``jax.sharding.Mesh``."""
        self._mesh = mesh
        return self

    def n_components(self, n_components: int) -> "FastIcaBuilder":
        """Keep only the top-k whitened directions (extension; the
        reference always uses min(n, d), ica.rs:173)."""
        self._n_components = n_components
        return self

    def decorrelation(self, method: str) -> "FastIcaBuilder":
        """In-loop symmetric decorrelation: ``"eigh"`` (reference-exact),
        ``"ns"`` (matmul-only Newton-Schulz), or
        ``"auto"`` (ns on accelerators, eigh on CPU — see
        :func:`resolve_decorrelation`)."""
        self._decorrelation = method
        return self

    def iteration_precision(self, precision: str) -> "FastIcaBuilder":
        """Fixed-point iteration precision: ``"full"`` (data dtype,
        reference-faithful), ``"f32"`` (float32 iterate + float64
        polish for f64 data — the per-step k×n matmuls run at the f32
        rate), or ``"auto"`` (``"f32"`` for f64 on an accelerator,
        ``"full"`` otherwise)."""
        self._iteration_precision = precision
        return self

    def build(self) -> FastIca:
        return FastIca(
            seed=self._seed,
            key=self._key,
            fun=self._fun,
            tol=self._tol,
            max_iter=self._max_iter,
            whiten=self._whiten,
            whiten_solver=self._whiten_solver,
            mesh=self._mesh,
            n_components=self._n_components,
            decorrelation=self._decorrelation,
            iteration_precision=self._iteration_precision,
        )
