"""Mixed-precision eigendecomposition refinement (ops/refine.py) and
the f64 QDWH-SVD route it enables — the off-CPU replacement for LAPACK
``?syev``/``?gesvd`` (ref: src/linalg/lapack.rs:103-184)."""

import numpy as np
import pytest

import jax.numpy as jnp

from petal_decomposition_tpu.ops.refine import eigh_refine, refined_eigh


def _sym(lam, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((len(lam), len(lam))))
    a = (q * lam) @ q.T
    return (a + a.T) / 2


def test_eigh_refine_reaches_f64():
    """Well-separated spectrum: quadratic convergence from an f32 start
    to ~f64 working accuracy in 3 matmul-only steps."""
    n = 300
    lam_true = np.linspace(1.0, 2.0, n)
    a = _sym(lam_true)
    lam32, v32 = np.linalg.eigh(a.astype(np.float32))
    lam, v, off = eigh_refine(
        jnp.asarray(a), jnp.asarray(lam32), jnp.asarray(v32, jnp.float64)
    )
    lam, v = np.asarray(lam), np.asarray(v)
    assert float(off) < 1e-12
    assert np.abs(v.T @ v - np.eye(n)).max() < 1e-13
    assert np.abs(a @ v - v * lam).max() / 2.0 < 1e-12
    np.testing.assert_allclose(lam, np.linalg.eigvalsh(a), atol=2e-13)


def test_eigh_refine_wide_dynamic_range():
    """Spectrum spanning 9 decades: tiny-gap pairs at the bottom are
    unresolvable from an f32 start and refine linearly — the residual
    stalls ~1e-10·λmax (inside the parity band) while orthonormality
    stays at working precision."""
    n = 400
    lam_true = np.sort(np.logspace(-9, 0, n))
    a = _sym(lam_true, seed=1)
    lam, v, off = refined_eigh(jnp.asarray(a))
    lam, v = np.asarray(lam), np.asarray(v)
    assert np.abs(v.T @ v - np.eye(n)).max() < 1e-12
    assert np.abs(a @ v - v * lam).max() < 1e-9
    assert float(off) < 1e-8
    np.testing.assert_allclose(lam, np.linalg.eigvalsh(a), atol=1e-9)


def test_eigh_refine_clustered_spectrum():
    """Exact eigenvalue clusters: vectors mix freely within the cluster
    subspace (LAPACK-equivalent freedom) but the decomposition stays
    orthonormal with small residuals and correct eigenvalues."""
    n = 300
    lam_true = np.concatenate(
        [np.full(40, 1.0), np.full(40, 1.0 + 1e-12),
         np.linspace(2.0, 3.0, n - 80)]
    )
    a = _sym(lam_true, seed=2)
    lam, v, off = refined_eigh(jnp.asarray(a))
    lam, v = np.asarray(lam), np.asarray(v)
    assert np.abs(v.T @ v - np.eye(n)).max() < 1e-12
    assert np.abs(a @ v - v * lam).max() / 3.0 < 1e-9
    assert float(off) < 1e-8
    np.testing.assert_allclose(
        np.sort(lam), np.sort(np.linalg.eigvalsh(a)), atol=1e-9
    )


@pytest.mark.parametrize("shape", [(500, 300), (320, 320)])
def test_qdwh_svd_f64_parity(shape):
    """The f64 QDWH-SVD route (polar + refined eigh) vs host LAPACK:
    σ to ~1e-12·σmax, orthonormal factors, reconstruction to working
    precision — on a κ=1e8 matrix the Gram path could not touch."""
    from petal_decomposition_tpu.ops.jacobi import _qdwh_svd

    m, n = shape
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    w, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sig = np.logspace(0, -8, n)  # kappa = 1e8
    a = (u * sig) @ w.T

    a_rot, v, off = _qdwh_svd(jnp.asarray(a), m, n)
    a_rot, v = np.asarray(a_rot), np.asarray(v)
    assert float(off) == 0.0  # route-converged certificate

    s = np.sqrt((a_rot * a_rot).sum(axis=0))
    order = np.argsort(-s)
    s, uu, vv = s[order], a_rot[:, order] / s[order], v[:, order]
    s_ref = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s, s_ref, atol=1e-12 * s_ref[0])
    assert np.abs(vv.T @ vv - np.eye(n)).max() < 1e-10
    assert np.abs(uu.T @ uu - np.eye(n)).max() < 1e-10
    recon = (uu * s) @ vv.T
    assert np.abs(recon - a).max() < 1e-12 * s_ref[0]


def test_refine_fuzz_random_symmetric():
    """Fuzz: random symmetric matrices of assorted sizes vs LAPACK."""
    rng = np.random.default_rng(4)
    for n in (17, 64, 130):
        b = rng.standard_normal((n, n))
        a = (b + b.T) / 2
        lam, v, off = refined_eigh(jnp.asarray(a))
        lam, v = np.asarray(lam), np.asarray(v)
        scale = np.abs(lam).max()
        assert np.abs(v.T @ v - np.eye(n)).max() < 1e-12
        assert np.abs(a @ v - v * lam).max() / scale < 1e-12
        np.testing.assert_allclose(
            lam, np.linalg.eigvalsh(a), atol=1e-12 * scale
        )


def test_qdwh_svd_f64_rank_deficient():
    """The f64 QDWH route on exactly rank-deficient input: QDWH maps
    zero singular values to zero, the refined eigh resolves the null
    space, σ matches LAPACK to ~1e-13·σ₁ with a clean zero tail."""
    from petal_decomposition_tpu.ops.jacobi import _qdwh_svd

    rng = np.random.default_rng(0)
    m, n, r = 600, 400, 30
    a = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    a_rot, v, off = _qdwh_svd(jnp.asarray(a), m, n)
    a_rot = np.asarray(a_rot)
    assert float(off) == 0.0
    assert np.all(np.isfinite(a_rot)) and np.all(np.isfinite(np.asarray(v)))
    s = np.sort(np.sqrt((a_rot * a_rot).sum(axis=0)))[::-1]
    s_ref = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s, s_ref, atol=1e-12 * s_ref[0])
    assert s[r:].max() < 1e-12 * s_ref[0]
