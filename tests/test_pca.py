"""Pca tests — ports of the reference's embedded tests (pca.rs:852-1051)."""

import numpy as np
import pytest

from petal_decomposition_tpu import (
    InvalidInput,
    Pca,
    PcaBuilder,
)


def test_pca_zero_component():
    """ref: pca.rs:862-875."""
    pca = PcaBuilder(0).build()

    x = np.zeros((0, 5), dtype=np.float32)
    y = pca.fit_transform(x)
    assert y.shape == (0, 0)

    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]], dtype=np.float32)
    y = pca.fit_transform(x)
    assert y.shape == (3, 0)


def test_pca_single_sample():
    """ref: pca.rs:877-883."""
    pca = Pca(1)
    x = np.array([[1.0, 1.0]], dtype=np.float32)
    y = pca.fit_transform(x)
    np.testing.assert_array_equal(np.asarray(y), [[0.0]])


def test_pca_golden():
    """ref: pca.rs:885-906 — collinear matrix golden values."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = Pca(1)
    assert pca.n_components() == 1

    y = np.asarray(pca.fit_transform(x))
    assert abs(abs(y[0, 0]) - 5.0) < 1e-10
    assert abs(y[1, 0]) < 1e-10
    assert abs(abs(y[2, 0]) - 5.0) < 1e-10
    z = np.asarray(pca.inverse_transform(y))
    assert np.abs(z - x).max() < 1e-10

    pca = Pca(1)
    pca.fit(x)
    assert pca.n_components() == 1
    assert np.abs(np.asarray(pca.components()) - [[-0.6, -0.8]]).max() < 1e-10
    y = np.asarray(pca.transform(x))
    assert abs(abs(y[0, 0]) - 5.0) < 1e-10
    assert abs(y[1, 0]) < 1e-10
    assert abs(abs(y[2, 0]) - 5.0) < 1e-10


def test_pca_without_centering():
    """ref: pca.rs:908-916."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = PcaBuilder(1).centering(False).build()
    y = np.asarray(pca.fit_transform(x))
    assert abs(abs(y[0, 0]) - 0.0) < 1e-10
    assert abs(y[1, 0] - 5.0) < 1e-10
    assert abs(abs(y[2, 0]) - 10.0) < 1e-10
    # mean() returns zeros when centering is off (pca.rs:261-264 note)
    np.testing.assert_array_equal(np.asarray(pca.mean()), [0.0, 0.0])


def test_pca_explained_variance_ratio():
    """ref: pca.rs:918-933."""
    x = np.array(
        [
            [-1.0, -1.0],
            [-2.0, -1.0],
            [-3.0, -2.0],
            [1.0, 1.0],
            [2.0, 1.0],
            [3.0, 2.0],
        ]
    )
    pca = Pca(2)
    pca.fit(x)
    ratio = np.asarray(pca.explained_variance_ratio())
    assert ratio[0] > 0.99244
    assert ratio[1] < 0.00756


def test_pca_fit_transform_equals_fit_then_transform():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 7))
    y1 = np.asarray(Pca(3).fit_transform(x))
    pca = Pca(3)
    pca.fit(x)
    y2 = np.asarray(pca.transform(x))
    assert np.abs(y1 - y2).max() < 1e-10


def test_pca_f32_tolerance():
    """f32 parity band is 1e-5 against a same-precision reference
    pipeline (BASELINE.md compares like-for-like dtypes)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((60, 10)).astype(np.float32)
    pca = Pca(4)
    y = np.asarray(pca.fit_transform(x))
    assert y.dtype == np.float32

    # Reference algorithm in numpy at float64, compared at the f32 band:
    # singular values are well-conditioned; vectors compare via the
    # projected output which is what users consume.
    xc = x.astype(np.float64)
    xc -= xc.mean(axis=0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    idx = np.argmax(np.abs(u), axis=0)
    signs = np.where(u[idx, np.arange(u.shape[1])] < 0, -1.0, 1.0)
    y_ref = (u * signs)[:, :4] * s[:4]
    scale = np.abs(s[0])
    assert np.abs(y - y_ref).max() / scale < 1e-4


def test_pca_invalid_input_dims():
    """ref: pca.rs:199-204 — every dim must be >= n_components."""
    x = np.zeros((2, 2))
    with pytest.raises(InvalidInput):
        Pca(3).fit(x)


def test_pca_transform_wrong_cols():
    """ref: pca.rs:736-741."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = Pca(1)
    pca.fit(x)
    with pytest.raises(InvalidInput):
        pca.transform(np.zeros((3, 5)))


def test_pca_inverse_transform_wrong_cols():
    """ref: pca.rs:798-803."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = Pca(1)
    pca.fit(x)
    with pytest.raises(InvalidInput):
        pca.inverse_transform(np.zeros((3, 2)))


def test_pca_vs_numpy_reference():
    """Cross-check against a straight numpy/LAPACK implementation of the
    reference algorithm — the 1e-10 f64 parity contract (BASELINE.md)."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((200, 32))
    k = 5

    pca = Pca(k)
    y = np.asarray(pca.fit_transform(x))

    # reference algorithm in numpy
    mu = x.mean(axis=0)
    xc = x - mu
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    # svd_flip
    idx = np.argmax(np.abs(u), axis=0)
    signs = np.where(u[idx, np.arange(u.shape[1])] < 0, -1.0, 1.0)
    u *= signs
    vt *= signs[:, None]
    y_ref = u[:, :k] * s[:k]

    assert np.abs(y - y_ref).max() < 1e-10
    assert np.abs(np.asarray(pca.components()) - vt[:k]).max() < 1e-10
    assert np.abs(np.asarray(pca.singular_values()) - s[:k]).max() < 1e-10
    ratio_ref = s[:k] ** 2 / np.sum(s**2)
    assert (
        np.abs(np.asarray(pca.explained_variance_ratio()) - ratio_ref).max()
        < 1e-12
    )


def test_pca_complex():
    """Complex support (the reference is generic over c32/c64)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 6)) + 1j * rng.standard_normal((30, 6))
    pca = Pca(2)
    y = np.asarray(pca.fit_transform(x))
    assert y.shape == (30, 2)
    pca2 = Pca(2)
    pca2.fit(x)
    y2 = np.asarray(pca2.transform(x))
    assert np.abs(y - y2).max() < 1e-10


def test_pca_gram_solver_wide_matrix():
    """Gram path with n < d (rank-deficient covariance)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((10, 25))
    y_g = np.asarray(Pca(4, solver="gram").fit_transform(x))
    y_f = np.asarray(Pca(4, solver="full").fit_transform(x))
    np.testing.assert_allclose(y_g, y_f, atol=1e-7)


def test_pca_integer_input_upcasts():
    x = np.arange(24).reshape(8, 3)
    pca = Pca(2)
    y = np.asarray(pca.fit_transform(x))
    assert y.dtype == np.float64
    assert np.all(np.isfinite(y))


def test_pca_rank_deficient_centered():
    """Centering n ≤ d data creates a numerically-zero singular
    direction; the fit must converge and stay finite (regression for the
    pairwise-relative convergence-measure stall found on an accelerator)."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((5, 9))
    for backend in ("jacobi",):
        from petal_decomposition_tpu import config

        old = config.linalg_backend
        config.linalg_backend = backend
        try:
            pca = Pca(3)
            y = np.asarray(pca.fit_transform(x))
        finally:
            config.linalg_backend = old
        assert np.all(np.isfinite(y))
        # parity vs numpy on the same data
        mu = x.mean(0)
        u, s, vt = np.linalg.svd(x - mu, full_matrices=False)
        idx = np.argmax(np.abs(u), axis=0)
        sg = np.where(u[idx, np.arange(u.shape[1])] < 0, -1.0, 1.0)
        y_ref = (u * sg)[:, :3] * s[:3]
        assert np.abs(y - y_ref).max() < 1e-9


def test_complex_host_ctx_noop_on_cpu():
    """On a CPU default backend the complex dispatch is a no-op."""
    import contextlib

    import jax.numpy as jnp

    from petal_decomposition_tpu.models._common import complex_host_ctx

    x = jnp.ones((2, 2), jnp.complex128)
    ctx, x2 = complex_host_ctx(x)
    assert isinstance(ctx, contextlib.nullcontext)
    assert x2 is x


def test_real_fit_after_complex_fit_same_model():
    """A real-dtype fit following a complex fit on the same model must
    behave identically to a fresh model's fit (the complex redirect
    must not leave host-committed state — e.g. the PRNG key — that
    would drag later fits onto the CPU)."""
    import jax

    from petal_decomposition_tpu import RandomizedPcaBuilder

    rng = np.random.default_rng(9)
    xc = (rng.standard_normal((100, 8))
          + 1j * rng.standard_normal((100, 8))).astype(np.complex128)
    xr = rng.standard_normal((100, 8))

    model = RandomizedPcaBuilder(3).seed(11).build()
    model.fit(xc)
    y = np.asarray(model.fit_transform(xr))
    assert np.all(np.isfinite(y))
    # A committed key must live on the default backend, not the host
    # (host-committed keys drag real fits' jits onto the CPU).
    if getattr(model._key, "_committed", False):
        dev = list(model._key.devices())[0]
        assert dev.platform == jax.default_backend()
    # Errors inside a redirected fit must not leak a host-committed key.
    bad = (np.zeros((2, 8)) + 0j).astype(np.complex128)
    with pytest.raises(Exception):
        model.fit(bad[:, :1])  # too few columns for n_components=3
    if getattr(model._key, "_committed", False):
        dev = list(model._key.devices())[0]
        assert dev.platform == jax.default_backend()


def test_exact_gram_mean_dominated_sigma():
    """pca_fit_gram with fused rank-1 centering: σ come straight from
    the analytic Gram XᵀX − n·μμᵀ, which cancels catastrophically on
    mean-dominated data — the in-graph guard must rebuild from an
    explicitly centered copy (accelerator configuration; CPU model
    fits center explicitly)."""
    import jax.numpy as jnp
    import numpy as np

    from petal_decomposition_tpu.parallel.distributed import pca_fit_gram

    rng = np.random.default_rng(3)
    x = ((rng.standard_normal((2000, 64)) @ np.diag(np.linspace(1, 10, 64)))
         + 500.0).astype(np.float32)
    st = pca_fit_gram(jnp.asarray(x), fuse_centering=True,
                      cfg=("exact-gram-guard",))
    x64 = x.astype(np.float64)
    s_ref = np.linalg.svd(x64 - x64.mean(0), compute_uv=False)
    s = np.asarray(st["sigma"])[:8]
    assert np.max(np.abs(s - s_ref[:8]) / s_ref[:8]) < 1e-4
