"""Unit tests for the centering-fused contractions (ops/centered.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from petal_decomposition_tpu.ops.centered import (
    centered_gram,
    centered_matmul,
    centered_rmatmul,
    centered_sqnorm,
    gram_acc64,
    gram_chunks,
)


def _setup(seed=0, n=50, d=8, l=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) + 5.0  # offset makes centering matter
    m = rng.standard_normal((d, l))
    q = rng.standard_normal((n, l))
    mu = x.mean(axis=0)
    xc = x - mu
    return x, m, q, mu, xc


def test_centered_matmul():
    x, m, _, mu, xc = _setup()
    got = np.asarray(centered_matmul(jnp.asarray(x), jnp.asarray(m),
                                     jnp.asarray(mu)))
    np.testing.assert_allclose(got, xc @ m, atol=1e-10)


def test_centered_matmul_masks_padded_rows():
    x, m, _, mu, xc = _setup()
    xp = np.vstack([x, np.zeros((3, x.shape[1]))])
    got = np.asarray(
        centered_matmul(jnp.asarray(xp), jnp.asarray(m), jnp.asarray(mu),
                        n_valid=x.shape[0])
    )
    np.testing.assert_allclose(got[: x.shape[0]], xc @ m, atol=1e-10)
    assert np.all(got[x.shape[0]:] == 0)


def test_centered_rmatmul():
    x, _, q, mu, xc = _setup()
    got = np.asarray(centered_rmatmul(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(mu)))
    np.testing.assert_allclose(got, xc.T @ q, atol=1e-9)


def test_centered_gram_and_sqnorm():
    x, _, _, mu, xc = _setup()
    n = x.shape[0]
    got = np.asarray(centered_gram(jnp.asarray(x), jnp.asarray(mu), n))
    np.testing.assert_allclose(got, xc.T @ xc, atol=1e-8)
    got_n = float(centered_sqnorm(jnp.asarray(x), jnp.asarray(mu), n))
    np.testing.assert_allclose(got_n, (xc**2).sum(), atol=1e-8)


@pytest.mark.parametrize("n,d,chunks", [
    (4_000_000, 1024, 64),  # the four-card flagship: whole chunks per card
    (40_000, 64, 8),  # a multiple of 8 beats the larger divisor 5
    (3 * 4096, 8, 3),  # no multiple of 8 fits: the largest divisor
    (1 << 20, 4096, 4),  # the f32 partials' element cap
    (1000, 64, 1),  # under two minimum chunks: one GEMM
    (65_537, 8, 1),  # a prime row count: one GEMM
])
def test_gram_chunks(n, d, chunks):
    assert gram_chunks(n, d) == chunks
    assert n % chunks == 0


@pytest.mark.parametrize("n", [4096, 40_000, 65_536])
def test_gram_acc64_matches_f64(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 16)) * 3.0 + 1.0).astype(np.float32)
    g = gram_acc64(jnp.asarray(x))
    assert g.dtype == jnp.float64
    x64 = x.astype(np.float64)
    ref = x64.T @ x64
    np.testing.assert_allclose(np.asarray(g), ref,
                               atol=1e-6 * np.abs(ref).max())


def test_gram_acc64_other_dtypes_one_gemm():
    x, *_ = _setup()
    g = gram_acc64(jnp.asarray(x))
    assert g.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(g), x.T @ x, rtol=1e-12)


def test_gram_acc64_sharded_matches_unsharded():
    from petal_decomposition_tpu.parallel import make_mesh
    from petal_decomposition_tpu.parallel.mesh import row_sharding

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((65_536, 16)) + 2.0).astype(np.float32)
    mesh = make_mesh(8)
    x_sh = jax.device_put(jnp.asarray(x), row_sharding(mesh))
    g1 = np.asarray(gram_acc64(jnp.asarray(x)))
    g8 = np.asarray(jax.jit(gram_acc64)(x_sh))
    np.testing.assert_allclose(g8, g1, rtol=1e-6)


def test_centered_gram_f32_keeps_dtype_and_centers_in_f64():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((40_000, 8)) + 20.0).astype(np.float32)
    mu = x.astype(np.float64).mean(axis=0)
    got = centered_gram(jnp.asarray(x), jnp.asarray(mu, jnp.float32),
                        x.shape[0])
    assert got.dtype == jnp.float32
    xc = x.astype(np.float64) - mu
    ref = xc.T @ xc
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=1e-4 * np.abs(ref).max())


def test_debugging_helpers():
    import pytest

    from petal_decomposition_tpu.errors import InvalidInput
    from petal_decomposition_tpu.utils.debugging import (
        check_finite,
        nan_debugging,
    )

    check_finite(jnp.ones((2, 2)))
    with pytest.raises(InvalidInput):
        check_finite(jnp.asarray([np.nan, 1.0]))
    with nan_debugging():
        _ = jnp.ones(3) + 1  # clean computation passes
