"""Unit tests for ops/splitmm.py — hi/lo-split f32 matmuls used by
the FastICA ds64 polish stage (fast_ica._ica_par_core stage 2).

The accuracy bars are the module docstring's grades: ~1.5e-7 normwise
for the plain split product (short contraction) and ~1e-8 for the
chunked long contraction, with f32 accumulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import petal_decomposition_tpu  # noqa: F401  (enables x64 at import)
from petal_decomposition_tpu.ops import splitmm


def _normwise(approx, ref):
    approx = np.asarray(approx, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(approx - ref)) / np.max(np.abs(ref))


def test_split_f64_reconstructs():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((64, 257)) * 1e3)
    hi, lo = splitmm.split_f64(x)
    assert hi.dtype == jnp.float32 and lo.dtype == jnp.float32
    recon = hi.astype(jnp.float64) + lo.astype(jnp.float64)
    np.testing.assert_allclose(
        np.asarray(recon), np.asarray(x), rtol=2**-46, atol=0
    )


def test_mm_split_f32_short_contraction():
    """k-length contraction (the FastICA W·X gemm shape)."""
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((64, 64)))
    x = jnp.asarray(rng.standard_normal((64, 4096)))
    xh, xl = splitmm.split_f64(x)
    out = splitmm.mm_split_f32(w, xh, xl)
    assert out.dtype == jnp.float32
    ref = np.asarray(w, np.float64) @ np.asarray(x, np.float64)
    assert _normwise(out, ref) < 1e-6


@pytest.mark.parametrize("n", [4096, 4096 + 123])
def test_mm_split_chunked_f64_long_contraction(n):
    """n-length contraction (the FastICA G·Xᵀ gemm shape), including a
    non-chunk-multiple n exercising the tail path."""
    rng = np.random.default_rng(2)
    g = jnp.asarray(rng.standard_normal((64, n)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((64, n)))
    xh, xl = splitmm.split_f64(x)
    out = splitmm.mm_split_chunked_f64(g, xh, xl, chunk=512)
    assert out.dtype == jnp.float64
    ref = np.asarray(g, np.float64) @ np.asarray(x, np.float64).T
    # CPU's f32 dot lands ~5e-7 at this chunking — the bar is the
    # platform-independent guarantee, an order under the ds64 stage's
    # 2e-6 handoff floor.
    assert _normwise(out, ref) < 1e-6


def test_mm_split_chunked_f64_rejects_f64_left_operand():
    """A float64 g would silently promote every pass to an emulated-f64
    gemm (slower than not splitting); the guard makes it a TypeError."""
    rng = np.random.default_rng(4)
    g64 = jnp.asarray(rng.standard_normal((8, 600)))
    x = jnp.asarray(rng.standard_normal((8, 600)))
    xh, xl = splitmm.split_f64(x)
    with pytest.raises(TypeError, match="float32"):
        splitmm.mm_split_chunked_f64(g64, xh, xl)


def test_mm_split_chunked_f64_small_n_fallback():
    """n < 2·chunk takes the unchunked branch."""
    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.standard_normal((8, 600)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((8, 600)))
    xh, xl = splitmm.split_f64(x)
    out = splitmm.mm_split_chunked_f64(g, xh, xl, chunk=512)
    ref = np.asarray(g, np.float64) @ np.asarray(x, np.float64).T
    assert _normwise(out, ref) < 1e-6
