"""Linalg-core tests: the L2 layer (SURVEY §2 C7/C8 analogues).

Backends are exercised explicitly: the in-house solvers are what runs
off the CPU, so they are tested on CPU here against numpy ground truth.
"""

import numpy as np
import pytest

from petal_decomposition_tpu import config
from petal_decomposition_tpu.ops.jacobi import (
    jacobi_eigh,
    jacobi_svd,
    round_robin_pairings,
)
from petal_decomposition_tpu.ops.linalg import (
    cholesky_qr2,
    eigh,
    lu_pl,
    qr,
    svd,
    svd_flip,
)


def test_round_robin_covers_all_pairs():
    for n in (2, 4, 8, 10):
        rounds = round_robin_pairings(n)
        assert rounds.shape == (n - 1, n // 2, 2)
        seen = set()
        for rnd in rounds:
            idx = set()
            for p, q in rnd:
                assert p != q
                idx.update((int(p), int(q)))
                seen.add(frozenset((int(p), int(q))))
            assert idx == set(range(n))
        assert len(seen) == n * (n - 1) // 2


@pytest.mark.parametrize("shape", [(50, 8), (8, 50), (33, 33), (1, 2), (3, 2)])
@pytest.mark.parametrize("update", ["matmul", "scatter"])
def test_jacobi_svd_f64(shape, update):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape)
    u, s, vt, off, _ = jacobi_svd(x, update=update)
    u, s, vt = np.asarray(u), np.asarray(s), np.asarray(vt)
    k = min(shape)
    assert np.abs((u * s) @ vt - x).max() < 1e-12
    assert np.abs(u.T @ u - np.eye(k)).max() < 1e-12
    assert np.abs(vt @ vt.T - np.eye(k)).max() < 1e-12
    sn = np.linalg.svd(x, compute_uv=False)
    assert np.abs(s - sn).max() < 1e-12
    assert np.all(np.diff(s) <= 1e-12)  # descending


def test_jacobi_svd_complex():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 7)) + 1j * rng.standard_normal((20, 7))
    u, s, vt, _, _ = jacobi_svd(x)
    u, s, vt = np.asarray(u), np.asarray(s), np.asarray(vt)
    assert np.abs((u * s) @ vt - x).max() < 1e-12
    assert np.abs(u.conj().T @ u - np.eye(7)).max() < 1e-12


def test_jacobi_svd_zero_matrix():
    u, s, vt, _, _ = jacobi_svd(np.zeros((3, 2)))
    assert np.all(np.asarray(s) == 0)
    assert np.all(np.isfinite(np.asarray(u)))


def test_jacobi_eigh_f64():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((17, 17))
    a = a + a.T
    w, v, off, _ = jacobi_eigh(a)
    w, v = np.asarray(w), np.asarray(v)
    wn = np.linalg.eigvalsh(a)
    assert np.abs(w - wn).max() < 1e-12
    assert np.abs(v @ np.diag(w) @ v.T - a).max() < 1e-12
    assert np.all(np.diff(w) >= -1e-12)  # ascending (LAPACK convention)


def test_jacobi_eigh_complex():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 9)) + 1j * rng.standard_normal((9, 9))
    a = a + a.conj().T
    w, v, _, _ = jacobi_eigh(a)
    w, v = np.asarray(w), np.asarray(v)
    assert np.abs(v @ np.diag(w) @ v.conj().T - a).max() < 1e-11


@pytest.mark.parametrize("backend", ["jacobi", "xla"])
def test_svd_dispatch(backend):
    old = config.linalg_backend
    config.linalg_backend = backend
    try:
        rng = np.random.default_rng(4)
        x = rng.standard_normal((40, 12))
        u, s, vt = svd(x)
        recon = np.asarray(u) * np.asarray(s) @ np.asarray(vt)
        assert np.abs(recon - x).max() < 1e-10
    finally:
        config.linalg_backend = old


def test_eigh_dispatch_ascending():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 8))
    a = a @ a.T
    w, v = eigh(a)
    w = np.asarray(w)
    assert np.all(np.diff(w) >= -1e-12)


@pytest.mark.parametrize("shape", [(10, 4), (4, 10), (8, 8), (100, 12)])
def test_lu_pl_matches_scipy(shape):
    import scipy.linalg as sla

    rng = np.random.default_rng(6)
    a = rng.standard_normal(shape)
    pl = np.asarray(lu_pl(a))
    p, l, _ = sla.lu(a)
    assert np.abs(pl - p @ l).max() < 1e-12


def test_cholesky_qr2():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((200, 16))
    q = np.asarray(cholesky_qr2(a))
    assert np.abs(q.T @ q - np.eye(16)).max() < 1e-13
    # Same column space as a
    assert np.abs(q @ (q.T @ a) - a).max() < 1e-12


def test_qr_economy():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((30, 40))
    q = np.asarray(qr(a))
    assert q.shape == (30, 30)


def test_svd_flip_reference_golden():
    """Exact golden test from the reference (pca.rs:1043-1050)."""
    u = np.array([[2.0, -1.0, 3.0], [-1.0, -3.0, 2.0]])
    v = np.array([[1.0, 1.0], [-2.0, 2.0], [3.0, -3.0]])
    uf, vf = svd_flip(u, v)
    np.testing.assert_array_equal(
        np.asarray(uf), [[2.0, 1.0, 3.0], [-1.0, 3.0, 2.0]]
    )
    np.testing.assert_array_equal(
        np.asarray(vf), [[1.0, 1.0], [2.0, -2.0], [3.0, -3.0]]
    )


def test_linalg_error_on_nonconvergence():
    """LinalgError surfaces when the sweep budget is exhausted — the
    LAPACK info != 0 analogue (ref: linalg.rs:84)."""
    from petal_decomposition_tpu import LinalgError, config as cfg
    from petal_decomposition_tpu.ops import linalg as L

    if cfg.linalg_backend == "xla":
        pytest.skip("direct XLA backend has no sweep budget")

    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 12))
    old = cfg.jacobi_max_sweeps
    cfg.jacobi_max_sweeps = 1  # far too few sweeps to converge
    try:
        with pytest.raises(LinalgError):
            L.svd(a)
    finally:
        cfg.jacobi_max_sweeps = old
    # converges fine with the normal budget
    L.svd(a)


def test_qdwh_svd_matches_lapack():
    """The wide-f32 QDWH-SVD route (ops.jacobi._qdwh_svd) is backward
    stable: sigma to ~eps*sigma1, orthonormal factors, exact
    reconstruction — no Gram kappa^2 squaring.  (Dispatched off the CPU
    for real f32/f64; the function itself is pure XLA and testable on
    CPU.)"""
    import jax.numpy as jnp

    from petal_decomposition_tpu.ops.jacobi import _qdwh_svd

    rng = np.random.default_rng(3)
    n, d = 384, 192
    u0, _ = np.linalg.qr(rng.standard_normal((n, d)))
    v0, _ = np.linalg.qr(rng.standard_normal((d, d)))
    sv = np.logspace(0, -5, d)
    x64 = (u0 * sv) @ v0.T
    a = jnp.asarray(x64, jnp.float32)

    a_rot, v, off = _qdwh_svd(a, n, d)
    s = np.sqrt(np.sum(np.asarray(a_rot, np.float64) ** 2, axis=0))
    assert float(off) == 0.0  # converged
    assert np.abs(s - sv).max() < 3e-6  # backward error ~ eps*sigma1
    u = np.asarray(a_rot, np.float64) / np.where(s > 0, s, 1)
    assert np.abs(u.T @ u - np.eye(d)).max() < 2e-5
    vv = np.asarray(v, np.float64)
    assert np.abs(vv.T @ vv - np.eye(d)).max() < 2e-5
    recon = np.asarray(a_rot, np.float64) @ vv.T
    assert np.abs(recon - x64).max() < 3e-6


def test_effective_platform_honors_default_device():
    """The complex→host redirect runs under jax.default_device(cpu);
    dispatch decisions must see 'cpu' there, not the backend default
    (review finding: host-redirected c64 ran the Jacobi loop instead of
    LAPACK)."""
    import jax

    from petal_decomposition_tpu.ops.linalg import effective_platform

    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        assert effective_platform() == "cpu"


def test_jacobi_eigh_tolerates_asymmetric_input():
    """Regression: XLA grams are not bitwise symmetric; a ~1e-13
    relative asymmetry must not stall the rotation sweeps above the
    convergence certificate (the eigh reads the matrix like LAPACK
    reads one triangle)."""
    from petal_decomposition_tpu.ops.jacobi import jacobi_eigh
    from petal_decomposition_tpu.ops.linalg import convergence_tol

    rng = np.random.default_rng(0)
    b = rng.standard_normal((12, 12))
    a = b @ b.T
    asym = rng.standard_normal((12, 12))
    asym = (asym - asym.T) * (np.abs(a).max() * 1e-13)
    w, v, off, _ = jacobi_eigh(a + asym)
    assert float(off) <= convergence_tol(np.float64, 12)
    np.testing.assert_allclose(
        np.sort(w), np.linalg.eigvalsh(a), rtol=1e-10, atol=1e-10
    )
